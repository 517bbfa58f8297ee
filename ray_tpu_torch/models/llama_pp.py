"""Pipeline-parallel Llama: the flagship model on a ``pp`` mesh axis
(counterpart of ``ray_tpu/models/llama_pp.py``).

The stacked layer params get a leading ``[num_stages, layers_per_stage,
...]`` dim over ``pp`` (``stack_stages``), and the GPipe schedule of
``parallel/pipeline.py`` runs each stage's layers where they live. The 3D
recipe of JAX's module: ``pp`` for stages; ``dp``/``fsdp`` as plain data
parallelism of the microbatches (stage weights are whole over fsdp inside
the stage, ``STAGE_SPECS``); ``tp`` as Megatron tensor parallelism inside
each stage (``LlamaModel.local_block``: heads and ffn over tp, its two
collectives a block); ``sp``/``ep`` must be 1. The embedding and the LM
head run outside the pipelined section (the un-pipelined twin
``LlamaModel``'s, on DTensors), so a stage keeps the hidden state's shape.
Inside the stage attention goes through the dispatcher: on the card at
head_dim 128, the flash kernel.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict

from ray_tpu_torch._device import DeviceLike
from ray_tpu_torch.models.common import (init_params, layer_views,
                                         model_device, remat)
from ray_tpu_torch.models.llama import (LAYER_SPECS, NORM_LEAVES,
                                        LlamaConfig, LlamaModel, Params,
                                        param_spec)
from ray_tpu_torch.ops.attention import attention
from ray_tpu_torch.ops.norms import rms_norm
from ray_tpu_torch.parallel.mesh import axis_size, placements
from ray_tpu_torch.parallel.pipeline import pipelined

# each stacked-stage leaf [S, l, ...]: the stage dim over pp, Megatron's tp
# split on the head and ffn dims, the rest whole
STAGE_SPECS: Dict[str, tuple] = {name: ("pp", None) + spec
                                 for name, spec in LAYER_SPECS.items()}


def stack_stages(params: Params, num_stages: int) -> Params:
    """Reshape the stacked-layer leaves [L, ...] -> [S, L/S, ...]: stage s
    holds layers ``s*L/S .. (s+1)*L/S - 1``, the order the un-pipelined
    model applies them."""
    out = dict(params)
    out["layers"] = {
        k: p.reshape((num_stages, p.shape[0] // num_stages)
                     + tuple(p.shape[1:]))
        for k, p in params["layers"].items()}
    return out


def unstack_stages(params: Params) -> Params:
    """Inverse of :func:`stack_stages`."""
    out = dict(params)
    out["layers"] = {k: p.reshape((p.shape[0] * p.shape[1],)
                                  + tuple(p.shape[2:]))
                     for k, p in params["layers"].items()}
    return out


def stacked_param_spec(cfg: LlamaConfig, num_stages: int) -> Params:
    """``LlamaModel``'s param tree with the layers stacked by stage. Drawn
    leaf by leaf in order, it holds the same numbers as a ``LlamaModel``
    init of the same seed, stacked."""
    spec = param_spec(cfg)
    spec["layers"] = {
        k: dataclasses.replace(leaf, shape=(num_stages,
                                            leaf.shape[0] // num_stages)
                               + leaf.shape[1:])
        for k, leaf in spec["layers"].items()}
    return spec


class PipelinedLlama:
    """Stage-split Llama driven by the GPipe microbatch schedule, with
    ``LlamaModel``'s functional surface (``init`` / ``apply`` / ``loss`` /
    ``param_shardings``), so ``make_train_step`` and ``shard_batch`` drive
    it unchanged."""

    F32_LEAVES = NORM_LEAVES

    def __init__(self, cfg: LlamaConfig, mesh, *, num_microbatches: int = 2,
                 device: DeviceLike = None):
        self.cfg = cfg
        self.mesh = mesh
        self.rules = None
        self.num_microbatches = num_microbatches
        self.num_stages = axis_size(mesh, "pp")
        if self.num_stages < 2:
            raise ValueError(
                f"PipelinedLlama needs a pp>=2 mesh axis, got "
                f"pp={self.num_stages}; use LlamaModel for pp=1")
        if cfg.n_layers % self.num_stages != 0:
            raise ValueError(
                f"n_layers={cfg.n_layers} not divisible by "
                f"pp={self.num_stages}")
        if axis_size(mesh, "sp") != 1 or axis_size(mesh, "ep") != 1:
            raise ValueError(
                "PipelinedLlama composes pp x dp x fsdp x tp; sp/ep must "
                "be 1 (context parallelism lives in LlamaModel)")
        tp = axis_size(mesh, "tp")
        if cfg.n_heads % tp or cfg.n_kv_heads % tp or cfg.ffn_dim % tp:
            raise ValueError(
                f"n_heads/n_kv_heads/ffn_dim must divide tp={tp}")
        self.device = model_device(device, mesh)
        # the un-pipelined twin: the embedding, the LM head and the block
        self._base = LlamaModel(cfg, device=self.device, mesh=mesh)

    # -- init / shardings --------------------------------------------------
    def param_spec(self) -> Params:
        return stacked_param_spec(self.cfg, self.num_stages)

    def init(self, seed: int = 0, param_dtype=None) -> Params:
        """The same numbers as ``LlamaModel(cfg).init(seed, ...)``, the
        layers stacked by stage and each leaf placed as it is drawn."""
        return init_params(self.param_spec(), seed, self.device,
                           param_dtype or self.cfg.dtype, self.F32_LEAVES,
                           self.mesh, self.param_shardings())

    def param_shardings(self):
        out = dict(self._base.param_shardings())
        spec = self.param_spec()["layers"]
        out["layers"] = {name: placements(self.mesh, STAGE_SPECS[name],
                                          leaf.shape)
                         for name, leaf in spec.items()}
        return out

    # -- stage body (on local shards: collectives are explicit) ------------
    def _stage_fn(self, local_layers: Params, x):
        """One stage: its layers [l, ...] (local tp shards) applied in order
        to x [b, S, d] by ``LlamaModel.local_block``, attention through the
        dispatcher, each layer recomputed in the backward under
        ``cfg.remat``."""
        cfg = self.cfg
        block = functools.partial(
            self._base.local_block,
            attend=lambda q, k, v: attention(q, k, v, causal=True))
        if cfg.remat:
            block = remat(block)
        for layer in layer_views(local_layers, cfg.dtype, self.F32_LEAVES):
            x = block(x, layer)
        return x

    # -- forward -----------------------------------------------------------
    def apply(self, params: Params, tokens):
        """tokens [B, S] -> logits [B, S, V] (f32)."""
        base = self._base
        x = base._embed(params, base._tokens(tokens))
        run = pipelined(self._stage_fn, self.mesh,
                        num_microbatches=self.num_microbatches,
                        param_specs={name: STAGE_SPECS[name]
                                     for name in params["layers"]})
        x = run(params["layers"], x)
        x = rms_norm(x, params["norm_f"], eps=self.cfg.norm_eps)
        return base._lm_head(params, x)

    # the objective of LlamaModel, through the pipelined apply
    loss = LlamaModel.loss
    _cross_entropy = LlamaModel._cross_entropy
