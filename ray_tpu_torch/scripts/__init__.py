"""The port's command-line tools (counterpart of ``ray_tpu/scripts``)."""
