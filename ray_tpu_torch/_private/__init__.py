"""The runtime's in-process core (counterpart of ``ray_tpu/_private``)."""
