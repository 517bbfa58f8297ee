"""Param conversion from the JAX package's layout.

``LlamaModel.init`` in ``ray_tpu/models/llama.py`` returns a pytree of
stacked-layer f32 arrays. Handed over as numpy arrays (``np.asarray`` of each
leaf), ``params_from_numpy`` turns it into the port's params: the same keys
and shapes, matrices in ``cfg.dtype`` and norm weights in f32, on
``device``.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from ray_tpu_torch._device import DeviceLike, resolve_device
from ray_tpu_torch.models.llama import (NORM_LEAVES, LlamaConfig, Params,
                                        param_shapes)


def params_from_numpy(tree: Mapping, cfg: LlamaConfig,
                      device: DeviceLike = None) -> Params:
    dev = resolve_device(device)

    def leaf(name, arr, shape):
        a = np.array(arr, dtype=np.float32)     # a copy; bf16 widens
        if a.shape != tuple(shape):
            raise ValueError(f"param {name}: shape {a.shape}, expected "
                             f"{tuple(shape)} for this config")
        dtype = torch.float32 if name in NORM_LEAVES else cfg.dtype
        return torch.from_numpy(a).to(device=dev, dtype=dtype)

    shapes = param_shapes(cfg)
    out: Params = {}
    for name, shape in shapes.items():
        if name == "layers":
            out["layers"] = {n: leaf(n, tree["layers"][n], s)
                             for n, s in shape.items()}
        else:
            out[name] = leaf(name, tree[name], shape)
    return out
