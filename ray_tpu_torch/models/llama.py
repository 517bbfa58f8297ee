"""Llama-3 family: the training forward and the KV-cache inference paths
(counterpart of ``ray_tpu/models/llama.py``).

Params keep the JAX package's pytree layout — a dict of stacked-layer
tensors (``wq [L, d, H, hd]``, ``wo [L, H, hd, d]``, ...) — so a JAX param
tree converts 1:1 (``models/convert.py``). Differences of idiom:

- every weight is cast to ``cfg.dtype`` at its use, as JAX casts with
  ``.astype(dt)``. Training keeps every leaf in f32 (``init(...,
  param_dtype=torch.float32)``, as JAX's ``init`` returns it) so autograd
  reaches f32 leaves; serving stores the matrices, the embedding and the LM
  head in ``cfg.dtype`` once (the same numbers), where the cast is a no-op
  that returns the tensor itself. Norm weights stay f32;
- ``lax.scan`` over layers is a Python loop over per-layer views of the
  stacked tensors (one cast and one ``unbind`` per leaf and call, so the
  backward stacks each leaf's gradient once); ``jax.checkpoint`` per layer is
  ``torch.utils.checkpoint`` (``remat``);
- JAX's donated functional cache/pool updates are in-place ``index_put_``
  writes here: ``forward_step`` and ``decode_step_paged`` MUTATE the cache or
  pool they are given (and return it). Callers that need the old state
  ``clone()`` it first;
- out-of-range indices follow JAX: gathers clamp (token ids, rope
  positions) and scatters drop (cache writes past the cache); a pool write
  that JAX drops lands in the pool's scratch block, which nothing reads.

On a mesh (``mesh=``, a ``DeviceMesh`` of ``ray_tpu_torch.parallel``) every
leaf is a DTensor with the placements of ``param_logical_axes`` under the
rules (``param_shardings``), and the activations are constrained where JAX
constrains them (``_constrain``): DTensor's propagation takes GSPMD's place.
The embedding is JAX's vocab-parallel lookup (``common.embed_lookup``), and
attention runs on each rank's local batch rows and heads. On an ``sp`` axis
above 1 the sequence is sharded too, and attention is JAX's context
parallelism: ring attention (``ops/ring_attention.py``) or Ulysses
(``ops/ulysses.py``). The flash kernel's ``flash_block_q/k`` tiles are
not carried over: the CUDA kernel picks its own tiles, and an option that
does nothing on the card is left out.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy,
                                    create_selective_checkpoint_contexts)

from ray_tpu_torch._device import DeviceLike
from ray_tpu_torch.models.common import (Leaf, as_global, embed_lookup,
                                         init_params, layer_views,
                                         leaf_shardings, model_device, remat,
                                         token_nll)
from ray_tpu_torch.ops.attention import (NEG_INF, attention,
                                         blockwise_attention,
                                         flash_attention, repeat_kv)
from ray_tpu_torch.ops.indexing import gather_index, wrap_index
from ray_tpu_torch.ops.norms import rms_norm
from ray_tpu_torch.ops.ring_attention import (ring_attention,
                                              ring_attention_sharded)
from ray_tpu_torch.ops.rope import apply_rope, rope_frequencies
from ray_tpu_torch.ops.ulysses import (ulysses_attention,
                                       ulysses_attention_sharded)
from ray_tpu_torch.parallel.collectives import axis_index, psum, pvary
from ray_tpu_torch.parallel.mesh import (axis_size, distribute,
                                         named_sharding, placements,
                                         replicated, shard_constraint,
                                         shard_map_compat, summed_over)

Params = Dict[str, object]


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 128_256
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    ffn_dim: int = 14_336
    max_seq_len: int = 8192
    rope_theta: float = 500_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: torch.dtype = torch.bfloat16
    # recompute each layer in the backward (JAX's jax.checkpoint per layer):
    # "full" recomputes everything, "dots" saves the matmul outputs and
    # recomputes the rest (JAX's dots_saveable)
    remat: bool = True
    remat_policy: str = "full"
    # training attention (JAX name in brackets): "kernel" = the hand-written
    # flash kernel of ops/attention.py ("flash"; its plain version on CPU
    # tensors); "blockwise" = online softmax over key chunks in plain
    # PyTorch ("xla"); "ring" / "ulysses" = JAX's context parallelism on an
    # sp axis above 1; "auto" = the dispatcher, which "ring" and "ulysses"
    # also reach without sp (JAX's default "ring" on one device). On sp > 1
    # "ulysses" runs Ulysses, "kernel" is refused and every other name
    # runs ring, as in JAX.
    attention_impl: str = "auto"
    # KV-cache decode attention: "reference" masked fallback (JAX "xla") or
    # the hand-written CUDA "kernel" (JAX "pallas"; its plain version on
    # CPU tensors) — ops/paged_attention.py, ops/decode_attention.py.
    decode_attention: str = "reference"

    def __post_init__(self):
        if self.attention_impl not in ("auto", "kernel", "blockwise",
                                       "ring", "ulysses"):
            raise ValueError(
                f"attention_impl must be 'auto', 'kernel', 'blockwise', "
                f"'ring' or 'ulysses', got {self.attention_impl!r}")
        if self.remat_policy not in ("full", "dots"):
            raise ValueError(
                f"remat_policy must be 'full' or 'dots', "
                f"got {self.remat_policy!r}")
        if self.decode_attention not in ("reference", "kernel"):
            raise ValueError(
                f"decode_attention must be 'reference' or 'kernel', "
                f"got {self.decode_attention!r}")

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    def num_params(self) -> int:
        d, f, v = self.dim, self.ffn_dim, self.vocab_size
        kv = self.n_kv_heads * self.head_dim
        per_layer = d * d + 2 * d * kv + d * d + 3 * d * f + 2 * d
        heads = 0 if self.tie_embeddings else v * d
        return v * d + self.n_layers * per_layer + d + heads

    # -- presets (sizes match the public Llama-3 family) --
    @staticmethod
    def llama3_8b() -> "LlamaConfig":
        return LlamaConfig()

    @staticmethod
    def llama3_1b() -> "LlamaConfig":
        return LlamaConfig(dim=2048, n_layers=16, n_heads=32, n_kv_heads=8,
                           ffn_dim=8192)

    @staticmethod
    def bench_400m(max_seq_len: int = 2048) -> "LlamaConfig":
        """~440M params, the JAX preset's widths; head_dim 128 and the
        flash kernel, as the JAX preset defaults to its flash kernel."""
        return LlamaConfig(vocab_size=32_000, dim=1024, n_layers=24,
                           n_heads=8, n_kv_heads=4, ffn_dim=4096,
                           max_seq_len=max_seq_len, attention_impl="kernel")

    @staticmethod
    def debug(vocab_size: int = 256, max_seq_len: int = 128) -> "LlamaConfig":
        return LlamaConfig(vocab_size=vocab_size, dim=64, n_layers=2,
                           n_heads=4, n_kv_heads=2, ffn_dim=128,
                           max_seq_len=max_seq_len, remat=False)


NORM_LEAVES = ("attn_norm", "mlp_norm", "norm_f")


def param_spec(cfg: LlamaConfig) -> Dict[str, object]:
    """The param tree of ``LlamaModel.init`` in the JAX package, the same
    nesting (``{"embed", "layers": {...}, "norm_f", "lm_head"}``): matrices
    N(0, 1/fan_in), norm weights ones."""
    d, hd, L, f = cfg.dim, cfg.head_dim, cfg.n_layers, cfg.ffn_dim
    spec = {
        "embed": Leaf((cfg.vocab_size, d), d ** -0.5),
        "layers": {
            "attn_norm": Leaf((L, d), fill=1.0),
            "wq": Leaf((L, d, cfg.n_heads, hd), d ** -0.5),
            "wk": Leaf((L, d, cfg.n_kv_heads, hd), d ** -0.5),
            "wv": Leaf((L, d, cfg.n_kv_heads, hd), d ** -0.5),
            "wo": Leaf((L, cfg.n_heads, hd, d), d ** -0.5),
            "mlp_norm": Leaf((L, d), fill=1.0),
            "w_gate": Leaf((L, d, f), d ** -0.5),
            "w_up": Leaf((L, d, f), d ** -0.5),
            "w_down": Leaf((L, f, d), f ** -0.5),
        },
        "norm_f": Leaf((d,), fill=1.0),
    }
    if not cfg.tie_embeddings:
        spec["lm_head"] = Leaf((d, cfg.vocab_size), d ** -0.5)
    return spec


# Logical axis names per param leaf (parallel/mesh.py DEFAULT_RULES).
def param_logical_axes(cfg: LlamaConfig) -> Params:
    axes = {
        "embed": ("vocab", "embed_in"),
        "layers": {
            "attn_norm": (None, "embed_in"),
            "wq": (None, "embed_in", "heads", None),
            "wk": (None, "embed_in", "kv_heads", None),
            "wv": (None, "embed_in", "kv_heads", None),
            "wo": (None, "heads", None, "embed_in"),
            "mlp_norm": (None, "embed_in"),
            "w_gate": (None, "embed_in", "mlp"),
            "w_up": (None, "embed_in", "mlp"),
            "w_down": (None, "mlp", "embed_in"),
        },
        "norm_f": ("embed_in",),
    }
    if not cfg.tie_embeddings:
        axes["lm_head"] = ("embed_in", "vocab")
    return axes


# The layout of one layer's leaves inside ``LlamaModel.local_block``:
# heads and ffn over tp (Megatron's column/row split), the rest whole
LAYER_SPECS: Dict[str, tuple] = {
    "attn_norm": (None,),
    "wq": (None, "tp", None),
    "wk": (None, "tp", None),
    "wv": (None, "tp", None),
    "wo": ("tp", None, None),
    "mlp_norm": (None,),
    "w_gate": (None, "tp"),
    "w_up": (None, "tp"),
    "w_down": ("tp", None),
}


_MATMULS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
            torch.ops.aten.addmm.default)


def _save_matmuls(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy of ``remat_policy="dots"``: keep the
    matmul outputs, recompute the rest (``dots_saveable``)."""
    return (CheckpointPolicy.MUST_SAVE if op in _MATMULS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def take_last(x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """``x[n, lengths[n] - 1]`` for x [N, T, ...]; a row whose length is
    out of range reads NaN, as JAX's ``take_along_axis`` fills it."""
    idx, valid = wrap_index(
        lengths.to(device=x.device, dtype=torch.int64) - 1, x.shape[1])
    rows = x[torch.arange(x.shape[0], device=x.device), idx]
    shape = (-1,) + (1,) * (rows.dim() - 1)
    return torch.where(valid.view(shape), rows,
                       torch.full_like(rows, float("nan")))


class LlamaModel:
    """Functional model: ``init`` makes params, ``apply``/``loss`` run the
    training forward, the step methods the KV-cache forward. All tensors
    live on ``self.device``.

    ``mesh``/``rules`` (optional) shard the params and constrain the
    activations (the training forward; serving stays on one device). The
    device defaults to the mesh's device type."""

    def __init__(self, cfg: LlamaConfig, device: DeviceLike = None,
                 mesh=None, rules: Optional[Dict] = None):
        self.cfg = cfg
        self.mesh = mesh
        self.rules = rules
        self.device = model_device(device, mesh)
        self._sp = axis_size(mesh, "sp")
        if self._sp > 1 and cfg.attention_impl == "kernel":
            raise ValueError(
                "attention_impl='kernel' is a single-device kernel; with an "
                "sp>1 mesh use 'ring' or 'ulysses' context parallelism")
        self._angles = rope_frequencies(cfg.head_dim, cfg.max_seq_len,
                                        theta=cfg.rope_theta,
                                        device=self.device)
        # the plain table for local_block
        self._local_angles = self._angles
        if mesh is not None:
            self._angles = distribute(self._angles, mesh, replicated(mesh))

    # the leaves kept in f32 whatever the compute dtype (JAX casts every
    # other leaf with ``.astype(dt)`` at use)
    F32_LEAVES = NORM_LEAVES
    param_spec = staticmethod(param_spec)
    param_logical_axes = staticmethod(param_logical_axes)

    # -- init ---------------------------------------------------------------
    def init(self, seed: int = 0,
             param_dtype: Optional[torch.dtype] = None) -> Params:
        """Random params after ``param_spec``, drawn one leaf at a time on
        the device. Matrices are stored in ``param_dtype``; ``None`` is
        ``cfg.dtype`` (serving), ``torch.float32`` gives the f32 leaves
        training updates. Norm weights are f32. On a mesh each leaf is
        drawn whole, as without one, and placed at once
        (``param_shardings``): the same numbers, sharded."""
        return init_params(self.param_spec(self.cfg), seed, self.device,
                           param_dtype or self.cfg.dtype, self.F32_LEAVES,
                           self.mesh, None if self.mesh is None
                           else self.param_shardings())

    # -- sharding helpers ---------------------------------------------------
    def _constrain(self, x, *names):
        if self.mesh is None:
            return x
        return shard_constraint(x, self.mesh, *names, rules=self.rules)

    def param_shardings(self):
        """The tree of DTensor placements of the params on the mesh (JAX's
        NamedSharding pytree)."""
        return leaf_shardings(self.param_spec(self.cfg),
                              self.param_logical_axes(self.cfg), self.mesh,
                              self.rules)

    # -- shared pieces -----------------------------------------------------
    def _layers(self, params: Params) -> List[Dict[str, torch.Tensor]]:
        """Per-layer views of ``params["layers"]``, the matrices in
        ``cfg.dtype`` (the bf16 serving leaves themselves)."""
        return layer_views(params["layers"], self.cfg.dtype, self.F32_LEAVES)

    def _embed(self, params: Params, tokens: torch.Tensor) -> torch.Tensor:
        # gather, then cast: the same numbers as JAX's cast-then-gather
        # without casting the whole table
        table = params["embed"]
        if self.mesh is not None:
            # JAX's _embed_lookup: a plain (clamping) gather unless the
            # vocabulary is sharded over tp
            x = embed_lookup(table, tokens, self.mesh, self.rules,
                             clamp=axis_size(self.mesh, "tp") == 1,
                             dtype=self.cfg.dtype)
            return self._constrain(x, "batch", "seq", "embed")
        return table[gather_index(tokens, table.shape[0])].to(self.cfg.dtype)

    def _lm_head(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        head = (params["embed"].t() if self.cfg.tie_embeddings
                else params["lm_head"]).to(self.cfg.dtype)
        if self._sp > 1:
            return self._local_head(x, head).float()
        logits = self._constrain(x @ head, "batch", "seq", "vocab")
        return logits.float()

    def _qkv(self, layer: Dict[str, torch.Tensor], x, positions):
        """Pre-norm q/k/v projections of one layer with rope applied.
        x [B, T, d] -> q [B, T, H, hd], k/v [B, T, Hkv, hd] in cfg.dtype."""
        cfg = self.cfg
        B, T, d = x.shape
        h = rms_norm(x, layer["attn_norm"], eps=cfg.norm_eps)
        q = (h @ layer["wq"].reshape(d, -1)).view(B, T, cfg.n_heads, -1)
        k = (h @ layer["wk"].reshape(d, -1)).view(B, T, cfg.n_kv_heads, -1)
        v = (h @ layer["wv"].reshape(d, -1)).view(B, T, cfg.n_kv_heads, -1)
        q = self._constrain(q, "batch", "seq", "heads", None)
        q = apply_rope(q, self._angles, positions)
        k = apply_rope(k, self._angles, positions)
        return q, k, v

    def _attn_out(self, layer, x, o):
        """Attention output projection + residual. o [B, T, H, hd]."""
        B, T = o.shape[:2]
        o = o.reshape(B, T, -1) @ layer["wo"].reshape(-1, self.cfg.dim)
        return x + self._constrain(o, "batch", "seq", "embed")

    def _mlp(self, layer, x):
        """The pre-norm SwiGLU MLP block + residual."""
        h = rms_norm(x, layer["mlp_norm"], eps=self.cfg.norm_eps)
        gate = h @ layer["w_gate"]
        up = h @ layer["w_up"]
        ff = self._constrain(F.silu(gate) * up, "batch", "seq", "mlp")
        return x + self._constrain(ff @ layer["w_down"], "batch", "seq",
                                   "embed")

    def _masked_attention(self, q, k, v, mask):
        """Softmax attention in f32 with ``mask`` [B, Tq, Tk] (True =
        attend); ``p`` is cast to the compute dtype before the value
        product, as the JAX einsums do."""
        cfg = self.cfg
        kk = repeat_kv(k, cfg.n_heads)
        vv = repeat_kv(v, cfg.n_heads)
        s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kk.float())
        s = s * (cfg.head_dim ** -0.5)
        s = torch.where(mask[:, None], s, NEG_INF)
        p = torch.softmax(s, dim=-1)
        return torch.einsum("bhqk,bkhd->bqhd", p.to(cfg.dtype), vv)

    # -- training forward --------------------------------------------------
    def _attention(self, q, k, v, positions):
        """Causal attention of one layer. On an sp axis above 1: Ulysses
        ("ulysses") or ring attention (any other name) on DTensors, for
        ``MoEModel``'s layers (Llama's own run ``_cp_block``). Otherwise the
        flash kernel ("kernel") or the blockwise path ("blockwise") when
        positions are implicit, else the dispatcher."""
        impl = self.cfg.attention_impl
        if self._sp > 1:
            if impl == "ulysses":
                return ulysses_attention_sharded(q, k, v, self.mesh,
                                                 causal=True)
            return ring_attention_sharded(q, k, v, self.mesh, causal=True)
        if impl == "kernel" and positions is None:
            return flash_attention(q, k, v, True)
        if impl == "blockwise" and positions is None:
            return blockwise_attention(q, k, v, causal=True)
        return attention(q, k, v, causal=True, positions_q=positions,
                         positions_k=positions)

    def _block(self, x, layer: Dict[str, torch.Tensor], positions):
        if self._sp > 1:
            return self._cp_block(x, layer)
        q, k, v = self._qkv(layer, x, positions)
        o = self._attention(q, k, v, positions)
        return self._mlp(layer, self._attn_out(layer, x, o))

    # -- layers on local shards (sp > 1, and the pipeline's stages) --------
    def local_block(self, x, layer: Dict[str, torch.Tensor], attend,
                    positions: Optional[torch.Tensor] = None):
        """One layer on this rank's local shards, inside
        ``shard_map_compat``: x [B, T, d] whole over tp, the layer's leaves
        laid out as ``LAYER_SPECS`` (heads and ffn over tp, Megatron's
        column/row split), ``attend(q, k, v)`` the attention on local
        heads. Megatron's collectives over tp: the normed input enters the
        tp-split products through ``pvary`` (its gradient summed over tp)
        and each half's output leaves through ``psum`` (its gradient passed
        through), as JAX's transposes do. ``positions`` are this rank's
        rope positions (0..T-1 when None)."""
        cfg, mesh = self.cfg, self.mesh
        B, T, d = x.shape
        h = pvary(rms_norm(x, layer["attn_norm"], eps=cfg.norm_eps), mesh,
                  "tp")
        q = (h @ layer["wq"].reshape(d, -1)).view(B, T, -1, cfg.head_dim)
        k = (h @ layer["wk"].reshape(d, -1)).view(B, T, -1, cfg.head_dim)
        v = (h @ layer["wv"].reshape(d, -1)).view(B, T, -1, cfg.head_dim)
        q = apply_rope(q, self._local_angles, positions)
        k = apply_rope(k, self._local_angles, positions)
        o = attend(q, k, v).reshape(B, T, -1) @ layer["wo"].reshape(-1, d)
        x = x + psum(o, mesh, "tp")
        h = pvary(rms_norm(x, layer["mlp_norm"], eps=cfg.norm_eps), mesh,
                  "tp")
        ff = F.silu(h @ layer["w_gate"]) * (h @ layer["w_up"])
        return x + psum(ff @ layer["w_down"], mesh, "tp")

    def _cp_block(self, x, layer: Dict[str, torch.Tensor]):
        """A layer on an sp axis above 1: ``local_block`` on each rank's
        batch rows and sequence chunk with ring or Ulysses attention (JAX's
        GSPMD layer around ``ring/ulysses_attention_sharded``; DTensor's
        propagation over a sequence sharded inside a flattened matmul dim
        takes minutes an op on three mesh axes). fsdp's shards of the
        weights are gathered for the layer; their gradients are sums over
        the ranks that saw other tokens."""
        mesh = self.mesh
        names = list(layer)
        x_pl = named_sharding(mesh, "batch", "seq", "embed",
                              rules=self.rules)
        w_pl = [placements(mesh, LAYER_SPECS[n], layer[n].shape)
                for n in names]
        g_pl = [summed_over(mesh, pl, ("dp", "fsdp", "sp")) for pl in w_pl]
        cp = (ulysses_attention if self.cfg.attention_impl == "ulysses"
              else ring_attention)

        def body(x, *leaves):
            T = x.shape[1]
            pos = axis_index(mesh, "sp") * T + torch.arange(T,
                                                            device=x.device)
            return self.local_block(
                x, dict(zip(names, leaves)),
                lambda q, k, v: cp(q, k, v, mesh, causal=True), pos)

        fn = shard_map_compat(body, mesh, (x_pl, *w_pl), x_pl,
                              in_grad_specs=(x_pl, *g_pl))
        return fn(x, *(layer[n] for n in names))

    def _local_head(self, x, head):
        """The LM head on each rank's rows and sequence chunk (sp > 1): the
        vocabulary over tp, fsdp's shards of the head gathered."""
        mesh = self.mesh
        x_pl = named_sharding(mesh, "batch", "seq", "embed",
                              rules=self.rules)
        h_pl = placements(mesh, (None, "tp"), head.shape)
        out_pl = named_sharding(mesh, "batch", "seq", "vocab",
                                rules=self.rules)
        fn = shard_map_compat(
            torch.matmul, mesh, (x_pl, h_pl), out_pl,
            in_grad_specs=(summed_over(mesh, x_pl, ("tp",)),
                           summed_over(mesh, h_pl, ("dp", "fsdp", "sp"))))
        return fn(x, head)

    def apply(self, params: Params, tokens: torch.Tensor,
              positions: Optional[torch.Tensor] = None) -> torch.Tensor:
        """tokens [B, S] int -> logits [B, S, V] (f32). With ``cfg.remat``
        each layer is recomputed in the backward: its forward runs twice a
        training step, the flash kernel's included."""
        cfg = self.cfg
        block = self._block
        if cfg.remat:
            kwargs = {}
            if cfg.remat_policy == "dots":
                kwargs["context_fn"] = functools.partial(
                    create_selective_checkpoint_contexts, _save_matmuls)
            block = remat(self._block, **kwargs)
        x = self._embed(params, self._tokens(tokens))
        positions = self._positions(positions)
        for layer in self._layers(params):
            x = block(x, layer, positions)
        x = rms_norm(x, params["norm_f"], eps=cfg.norm_eps)
        return self._lm_head(params, x)

    def loss(self, params: Params, tokens: torch.Tensor,
             targets: torch.Tensor,
             mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Mean next-token cross-entropy (f32); with ``mask`` the mean over
        the masked-in tokens. A target outside the vocabulary reads NaN, as
        JAX's ``take_along_axis`` fills it."""
        return self._cross_entropy(self.apply(params, tokens), targets, mask)

    def _tokens(self, tokens):
        """Tokens on the device (a DTensor on a mesh stays as it is)."""
        if self.mesh is None:
            return tokens.to(self.device)
        return tokens

    def _positions(self, positions):
        """Explicit positions on the device; on a mesh, whole on every rank
        (the rope table and the dispatcher read them there)."""
        if positions is None:
            return None
        if self._sp > 1:
            raise NotImplementedError(
                "explicit positions are not supported with sp>1: the "
                "context-parallel causal mask assumes contiguous 0..S-1")
        if self.mesh is None:
            return positions.to(self.device)
        positions = torch.as_tensor(positions)
        return as_global(positions, self.mesh, *([None] * positions.dim()),
                         rules=self.rules, device=self.device)

    def _cross_entropy(self, logits, targets, mask=None) -> torch.Tensor:
        nll = token_nll(logits, targets)
        if mask is not None:
            if self.mesh is None:
                mask = mask.to(device=self.device, dtype=nll.dtype)
            else:
                mask = as_global(torch.as_tensor(mask).to(nll.dtype),
                                 self.mesh, "batch", "seq", rules=self.rules,
                                 device=self.device)
            return (nll * mask).sum() / mask.sum().clamp(min=1)
        return nll.mean()

    # -- dense KV cache ----------------------------------------------------
    def init_kv_cache(self, batch: int, max_seq: int) -> Params:
        """Slot-major cache: [L, B, S, Hkv, D] per k/v, in cfg.dtype."""
        cfg = self.cfg
        shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
        return {"k": torch.zeros(shape, dtype=cfg.dtype, device=self.device),
                "v": torch.zeros(shape, dtype=cfg.dtype, device=self.device)}

    @torch.no_grad()
    def forward_step(self, params: Params, tokens: torch.Tensor,
                     cache: Params, offsets: torch.Tensor
                     ) -> Tuple[torch.Tensor, Params]:
        """Unified prefill/decode step with KV cache.

        tokens [B, T] — T = padded prompt length (prefill) or 1 (decode)
        offsets [B]   — how many tokens each slot has already cached
        Returns (logits [B, T, V] f32, cache). The cache is updated IN PLACE
        (JAX returns a new one) and returned.
        """
        cfg = self.cfg
        B, T = tokens.shape
        S = cache["k"].shape[2]
        dev = self.device
        offsets = offsets.to(device=dev, dtype=torch.int64)
        q_pos = offsets[:, None] + torch.arange(T, device=dev)[None, :]
        # JAX drops scatters past the cache; keep only in-range writes
        # (one host sync per call, none per layer)
        p_idx, write = wrap_index(q_pos, S)
        all_in = bool(write.all())
        b_idx = torch.arange(B, device=dev)[:, None].expand(B, T)
        if not all_in:
            b_idx, p_idx = b_idx[write], p_idx[write]
        kernel = T == 1 and cfg.decode_attention == "kernel"
        if kernel:
            from ray_tpu_torch.ops.decode_attention import \
                ragged_decode_attention_kernel
        else:
            mask = (torch.arange(S, device=dev)[None, None, :]
                    <= q_pos[:, :, None])                           # [B,T,S]
        x = self._embed(params, tokens.to(dev))
        for l, layer in enumerate(self._layers(params)):
            q, k_new, v_new = self._qkv(layer, x, q_pos)
            k_cache, v_cache = cache["k"][l], cache["v"][l]
            # in-place scatter of the new k/v at each slot's write offsets
            # (JAX: a donated k_cache.at[...].set)
            k_cache[b_idx, p_idx] = k_new if all_in else k_new[write]
            v_cache[b_idx, p_idx] = v_new if all_in else v_new[write]
            if kernel:
                # single-token decode: the ragged kernel skips KV rows past
                # each slot's live length
                o = ragged_decode_attention_kernel(
                    q[:, 0], k_cache, v_cache, q_pos[:, 0] + 1)[:, None]
            else:
                o = self._masked_attention(q, k_cache, v_cache, mask)
            x = self._mlp(layer, self._attn_out(layer, x, o))
        x = rms_norm(x, params["norm_f"], eps=cfg.norm_eps)
        return self._lm_head(params, x), cache

    # -- paged KV cache (llm/engine.py + llm/paged_cache.py) ---------------
    def init_kv_pool(self, num_blocks: int, block_size: int) -> Params:
        """Block-pool cache: k/v [L, num_blocks, block_size, Hkv, D] in
        cfg.dtype, shared by every slot via per-slot block tables."""
        cfg = self.cfg
        shape = (cfg.n_layers, num_blocks, block_size, cfg.n_kv_heads,
                 cfg.head_dim)
        return {"k": torch.zeros(shape, dtype=cfg.dtype, device=self.device),
                "v": torch.zeros(shape, dtype=cfg.dtype, device=self.device)}

    @torch.no_grad()
    def decode_step_paged(self, params: Params, tokens: torch.Tensor,
                          pool: Params, block_tables: torch.Tensor,
                          offsets: torch.Tensor
                          ) -> Tuple[torch.Tensor, Params]:
        """One decode step for every slot against the block pool.

        tokens [B] (each slot's last sampled token)
        pool   k/v [L, NB, bs, Hkv, D] — updated IN PLACE and returned; its
               last block is the engine's scratch block, which no table
               row of a live slot names
        block_tables [B, MAXB] physical ids (logical order)
        offsets [B] tokens already cached per slot
        Returns (logits [B, V] f32, pool). Slots whose table rows point at
        garbage compute garbage that the engine masks.
        """
        cfg = self.cfg
        dev = self.device
        NB, bs = pool["k"].shape[1:3]
        tables = block_tables.to(device=dev, dtype=torch.int64)
        offsets = offsets.to(device=dev, dtype=torch.int64)
        B, maxb = tables.shape
        col, col_ok = wrap_index(offsets // bs, maxb)
        dest_block, block_ok = wrap_index(
            tables.gather(1, col[:, None])[:, 0], NB)
        dest_off = offsets % bs
        # JAX's take_along_axis fills a column past the table with INT_MIN
        # and its scatter then drops the write. Such writes (and any block
        # id past the pool) go to the scratch block here, which nothing
        # reads: the same visible pool, with no wait for the card
        dest_block = torch.where(col_ok & block_ok, dest_block, NB - 1)
        # int32 once per step: what the kernel takes
        lengths = (offsets + 1).to(torch.int32)
        tables_i32 = tables.to(torch.int32)
        q_pos = offsets[:, None]
        impl = cfg.decode_attention
        from ray_tpu_torch.ops.paged_attention import paged_decode_attention
        x = self._embed(params, tokens.to(dev)[:, None])           # [B,1,d]
        for l, layer in enumerate(self._layers(params)):
            q, k_new, v_new = self._qkv(layer, x, q_pos)
            k_pool, v_pool = pool["k"][l], pool["v"][l]
            # each slot writes its own private tail block in place (JAX: a
            # donated k_pool.at[...].set). Inactive slots all write the
            # scratch block: duplicate indices, no defined winner — as in
            # JAX's scatter — and nobody reads it.
            k_pool[dest_block, dest_off] = k_new[:, 0]
            v_pool[dest_block, dest_off] = v_new[:, 0]
            o = paged_decode_attention(q[:, 0], k_pool, v_pool, tables_i32,
                                       lengths, impl=impl)
            x = self._mlp(layer, self._attn_out(layer, x, o[:, None]))
        x = rms_norm(x, params["norm_f"], eps=cfg.norm_eps)
        return self._lm_head(params, x)[:, 0], pool

    @torch.no_grad()
    def prefill_with_prefix(self, params: Params, tokens: torch.Tensor,
                            prefix_k: torch.Tensor, prefix_v: torch.Tensor,
                            prefix_len: torch.Tensor, lengths: torch.Tensor
                            ) -> Tuple[torch.Tensor, Params]:
        """Suffix prefill attending over a cached (shared) prefix.

        tokens   [N, Tb] suffix tokens (right-padded)
        prefix_k/v [L, N, Pmax, Hkv, D] dense prefix K/V gathered from the
                 pool, right-padded past ``prefix_len``
        prefix_len [N] valid prefix tokens
        lengths  [N] valid suffix tokens
        Returns (last-token logits [N, V], suffix K/V [L, N, Tb, Hkv, D]) —
        the caller scatters the suffix K/V into fresh pool blocks.
        """
        cfg = self.cfg
        dev = self.device
        N, Tb = tokens.shape
        Pmax = prefix_k.shape[2]
        prefix_len = prefix_len.to(device=dev, dtype=torch.int64)
        # absolute positions: suffix token t sits at prefix_len + t; padded
        # prefix rows get a position PAST every query so the causal mask
        # drops them
        pos_q = prefix_len[:, None] + torch.arange(Tb, device=dev)[None, :]
        ar = torch.arange(Pmax, device=dev)[None, :]
        pos_prefix = torch.where(ar < prefix_len[:, None], ar,
                                 torch.full_like(ar, 2 ** 30))
        pos_k = torch.cat([pos_prefix.expand(N, Pmax), pos_q], dim=1)
        mask = pos_q[:, :, None] >= pos_k[:, None, :]             # [N,Tb,P+Tb]
        shape = (cfg.n_layers, N, Tb, cfg.n_kv_heads, cfg.head_dim)
        k_out = torch.empty(shape, dtype=cfg.dtype, device=dev)
        v_out = torch.empty(shape, dtype=cfg.dtype, device=dev)
        x = self._embed(params, tokens.to(dev))
        for l, layer in enumerate(self._layers(params)):
            q, k_new, v_new = self._qkv(layer, x, pos_q)
            k_all = torch.cat([prefix_k[l].to(cfg.dtype), k_new], dim=1)
            v_all = torch.cat([prefix_v[l].to(cfg.dtype), v_new], dim=1)
            o = self._masked_attention(q, k_all, v_all, mask)
            x = self._mlp(layer, self._attn_out(layer, x, o))
            k_out[l], v_out[l] = k_new, v_new
        x = rms_norm(x, params["norm_f"], eps=cfg.norm_eps)
        last = take_last(x, lengths)                               # [N, d]
        return self._lm_head(params, last), {"k": k_out, "v": v_out}
