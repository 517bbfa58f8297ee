"""MLP classifier — BASELINE.md config 1 (Fashion-MNIST), counterpart of
``ray_tpu/models/mlp.py``.

Params are ``{"layers": [{"w", "b"}, ...]}``, a list as in JAX, all f32 with
He init. ``cfg.dtype`` rounds the input only: JAX's ``x @ w`` promotes it to
the f32 weights' type, so the products are f32 whatever the dtype.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import torch

from ray_tpu_torch._device import DeviceLike
from ray_tpu_torch.models.common import (Leaf, init_params, model_device,
                                         token_nll)

Params = Dict[str, object]


@dataclasses.dataclass(frozen=True)
class MLPConfig:
    in_dim: int = 784
    hidden: Sequence[int] = (512, 512)
    num_classes: int = 10
    dtype: torch.dtype = torch.float32


class MLPModel:
    F32_LEAVES = ("w", "b")

    def __init__(self, cfg: MLPConfig, device: DeviceLike = None,
                 mesh=None):
        """``mesh`` is kept, as JAX keeps it; the MLP declares no param
        shardings, so ``make_train_step`` trains it on one device even when
        given a mesh, as JAX does."""
        self.cfg = cfg
        self.mesh = mesh
        self.device = model_device(device, mesh)

    @staticmethod
    def param_spec(cfg: MLPConfig) -> Params:
        dims = [cfg.in_dim, *cfg.hidden, cfg.num_classes]
        return {"layers": [{"w": Leaf((d_in, d_out), (2.0 / d_in) ** 0.5),
                            "b": Leaf((d_out,))}
                           for d_in, d_out in zip(dims[:-1], dims[1:])]}

    def init(self, seed: int = 0,
             param_dtype: Optional[torch.dtype] = None) -> Params:
        """He-init weights, zero biases; f32 whatever ``param_dtype``, as
        JAX's ``init`` returns them."""
        return init_params(self.param_spec(self.cfg), seed, self.device,
                           torch.float32, self.F32_LEAVES)

    def apply(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        """x [B, in_dim] -> logits [B, num_classes] (f32)."""
        x = x.to(self.device).to(self.cfg.dtype).float()
        layers = params["layers"]
        for layer in layers[:-1]:
            x = torch.relu(x @ layer["w"] + layer["b"])
        last = layers[-1]
        return x @ last["w"] + last["b"]

    def loss(self, params: Params, x: torch.Tensor,
             labels: torch.Tensor) -> torch.Tensor:
        return token_nll(self.apply(params, x), labels).mean()

    def accuracy(self, params: Params, x: torch.Tensor,
                 labels: torch.Tensor) -> torch.Tensor:
        pred = self.apply(params, x).argmax(-1)
        return (pred == labels.to(self.device)).float().mean()
