"""Platform pinning for worker processes (counterpart of
``ray_tpu/_private/platform.py``).

A worker process never owns the card: the driver does, and the router keeps
every task that wants it there. JAX pins a worker with ``JAX_PLATFORMS=cpu``;
the port hides the card with ``CUDA_VISIBLE_DEVICES=""``. CUDA reads the
variable once, at its first initialisation in the process, so the pin must
come before anything touches CUDA; setting it after that changes nothing.
"""

from __future__ import annotations

import os
import sys


def pin_cpu_env() -> None:
    """Env-only half of the pin (imports nothing): safe in a fresh process
    before torch has touched CUDA."""
    os.environ["CUDA_VISIBLE_DEVICES"] = ""


def force_cpu_platform() -> None:
    """Pin this process to the CPU and check that the card is hidden.
    Raises when CUDA was initialised before the pin (the card stays
    visible then)."""
    pin_cpu_env()
    torch = sys.modules.get("torch")
    if torch is None:
        return      # CUDA cannot have been initialised: the pin holds
    if torch.cuda.is_available():
        raise RuntimeError(
            "force_cpu_platform(): CUDA was initialised before the pin; "
            "the card is still visible in this process")
