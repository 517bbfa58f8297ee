"""Utilities of the port (counterpart of ``ray_tpu/util``): so far the
in-process metrics registry, ``util.metrics``."""
