"""Device selection for every entry point of the port.

Counterpart of ``_interpret_default`` / ``_on_tpu`` in
``ray_tpu/ops/attention.py``: the JAX package asks its backend which platform
it is on. The port never guesses: ``device=None`` means the card, and a host
without one is an error, not a quiet fall back to the CPU.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda``; raises if the requested CUDA device is absent.
    ``"cpu"`` (or any explicit device) is honoured as given."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "ray_tpu_torch: no CUDA device is available; pass device='cpu' "
            "to run on the CPU explicitly")
    return dev
