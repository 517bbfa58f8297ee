"""Param conversion from the JAX package's layout.

Each family's ``init`` in ``ray_tpu/models/`` returns a pytree of f32 arrays
(stacked layers for the transformers, a list of layers for the MLP). Handed
over as numpy arrays (``jax.tree.map(np.asarray, tree)``),
``params_from_numpy`` turns it into the port's params for the family of
``cfg``: the same keys, nesting and shapes (each family's ``param_spec``) on
``device``, the leaves the family keeps in f32 (``F32_LEAVES``: norms, the
MoE router, ViT's head bias, all of the MLP) in f32 and the others in
``param_dtype`` (``None``: ``cfg.dtype``, for serving; ``torch.float32``
keeps every leaf as JAX's ``init`` returns it, for training). With a
``mesh``, each leaf of a family that declares param shardings is placed with
its placements (``param_shardings``): this is how JAX params reach a sharded
port model. A Llama tree whose layers JAX's ``stack_stages`` stacked by
pipeline stage ([S, L/S, ...]) converts as it is, and on a mesh takes
``PipelinedLlama``'s placements (the mesh's pp must be S).
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch

from ray_tpu_torch._device import DeviceLike
from ray_tpu_torch.models.common import (Leaf, at_path, build_tree,
                                         model_device)
from ray_tpu_torch.models.gpt2 import GPT2Config, GPT2Model
from ray_tpu_torch.models.llama import LlamaConfig, LlamaModel, Params
from ray_tpu_torch.models.llama_pp import PipelinedLlama, stacked_param_spec
from ray_tpu_torch.models.mlp import MLPConfig, MLPModel
from ray_tpu_torch.models.moe import MoEConfig, MoEModel
from ray_tpu_torch.models.vit import ViTConfig, ViTModel
from ray_tpu_torch.parallel.mesh import distribute

# config class -> model class; MoEConfig before LlamaConfig, its base
FAMILIES = ((MoEConfig, MoEModel), (LlamaConfig, LlamaModel),
            (GPT2Config, GPT2Model), (ViTConfig, ViTModel),
            (MLPConfig, MLPModel))


def model_class(cfg):
    """The port's model class for a config of any family."""
    for config_cls, model_cls in FAMILIES:
        if isinstance(cfg, config_cls):
            return model_cls
    raise TypeError(f"no model family for config {type(cfg).__name__}")


def params_from_numpy(tree: Mapping, cfg, device: DeviceLike = None,
                      param_dtype: Optional[torch.dtype] = None, mesh=None,
                      rules: Optional[dict] = None) -> Params:
    dev = model_device(device, mesh)
    model = model_class(cfg)
    dtype = param_dtype or cfg.dtype
    spec = model.param_spec(cfg)
    # JAX's pipelined Llama stacks the layers by stage: [S, L/S, ...]
    stages = (np.shape(tree["layers"]["wq"])[0] if model is LlamaModel
              and np.ndim(tree["layers"]["wq"]) == 5 else 0)
    if stages:
        spec = stacked_param_spec(cfg, stages)
    shardings = None
    if mesh is not None and stages:
        pipe = PipelinedLlama(cfg, mesh, device=dev)
        if pipe.num_stages != stages:
            raise ValueError(f"params stacked for {stages} stages, the "
                             f"mesh has pp={pipe.num_stages}")
        shardings = pipe.param_shardings()
    elif mesh is not None and hasattr(model, "param_shardings"):
        shardings = model(cfg, device=dev, mesh=mesh,
                          rules=rules).param_shardings()

    def leaf(path, spec: Leaf):
        # a copy; bf16 widens
        a = np.array(at_path(tree, path), dtype=np.float32)
        if a.shape != spec.shape:
            name = "/".join(map(str, path))
            raise ValueError(f"param {name}: shape {a.shape}, expected "
                             f"{spec.shape} for this config")
        out = torch.float32 if path[-1] in model.F32_LEAVES else dtype
        t = torch.from_numpy(a).to(device=dev, dtype=out)
        if shardings is None:
            return t
        return distribute(t, mesh, at_path(shardings, path))

    return build_tree(spec, leaf)
