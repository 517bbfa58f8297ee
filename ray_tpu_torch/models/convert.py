"""Param conversion from the JAX package's layout.

``LlamaModel.init`` in ``ray_tpu/models/llama.py`` returns a pytree of
stacked-layer f32 arrays. Handed over as numpy arrays (``np.asarray`` of each
leaf), ``params_from_numpy`` turns it into the port's params: the same keys
and shapes on ``device``, norm weights in f32 and the matrices in
``param_dtype`` (``None``: ``cfg.dtype``, for serving; ``torch.float32``
keeps every leaf as JAX's ``init`` returns it, for training).
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch

from ray_tpu_torch._device import DeviceLike, resolve_device
from ray_tpu_torch.models.llama import (NORM_LEAVES, LlamaConfig, Params,
                                        param_shapes)


def params_from_numpy(tree: Mapping, cfg: LlamaConfig,
                      device: DeviceLike = None,
                      param_dtype: Optional[torch.dtype] = None) -> Params:
    dev = resolve_device(device)
    matrix_dtype = param_dtype or cfg.dtype

    def leaf(name, arr, shape):
        a = np.array(arr, dtype=np.float32)     # a copy; bf16 widens
        if a.shape != tuple(shape):
            raise ValueError(f"param {name}: shape {a.shape}, expected "
                             f"{tuple(shape)} for this config")
        dtype = torch.float32 if name in NORM_LEAVES else matrix_dtype
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
