"""JAX's rules for out-of-range indices, on torch tensors.

JAX never raises on an index: a negative index in ``[-n, 0)`` wraps as in
numpy; past that, a plain gather clamps into range, ``take_along_axis``
fills (NaN for floats, INT_MIN for ints) and a scatter drops the write.
Torch raises on the CPU and device-asserts on CUDA (which ends the process's
CUDA context), so every index of the port that could leave its range goes
through one of these two helpers.
"""

from __future__ import annotations

from typing import Tuple

import torch


def gather_index(idx: torch.Tensor, n: int) -> torch.Tensor:
    """Index into an axis of size ``n`` as a JAX gather reads it."""
    return torch.where(idx < 0, idx + n, idx).clamp(0, n - 1)


def wrap_index(idx: torch.Tensor, n: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(wrapped index clamped into range, in-range mask) for an axis of size
    ``n``: where the mask is False a JAX scatter drops the write and
    ``take_along_axis`` fills."""
    in_range = (idx >= -n) & (idx < n)
    return gather_index(idx, n), in_range
