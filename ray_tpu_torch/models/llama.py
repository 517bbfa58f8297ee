"""Llama-3 family, KV-cache inference paths (counterpart of
``ray_tpu/models/llama.py``).

Params keep the JAX package's pytree layout — a dict of stacked-layer
tensors (``wq [L, d, H, hd]``, ``wo [L, H, hd, d]``, ...) — so a JAX param
tree converts 1:1 (``models/convert.py``). Differences of idiom:

- the matrices, the embedding and the LM head are stored in ``cfg.dtype``
  once (JAX casts its f32 params with ``.astype(dt)`` at every use: the
  same numbers); the norm weights stay f32;
- ``lax.scan`` over layers is a Python loop over the stacked tensors;
- JAX's donated functional cache/pool updates are in-place ``index_put_``
  writes here: ``forward_step`` and ``decode_step_paged`` MUTATE the cache or
  pool they are given (and return it). Callers that need the old state
  ``clone()`` it first;
- out-of-range indices follow JAX: gathers clamp (token ids, rope
  positions) and scatters drop (cache writes past the cache); a pool write
  that JAX drops lands in the pool's scratch block, which nothing reads.

``apply``, ``loss`` and remat belong to the training slice (not ported yet).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ray_tpu_torch._device import DeviceLike, resolve_device
from ray_tpu_torch.ops.attention import NEG_INF, repeat_kv
from ray_tpu_torch.ops.indexing import gather_index, wrap_index
from ray_tpu_torch.ops.norms import rms_norm
from ray_tpu_torch.ops.rope import apply_rope, rope_frequencies

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
    # KV-cache decode attention: "reference" masked fallback (JAX "xla") or
    # the hand-written CUDA "kernel" (JAX "pallas"; its plain version on
    # CPU tensors) — ops/paged_attention.py, ops/decode_attention.py.
    decode_attention: str = "reference"

    def __post_init__(self):
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
        """~440M params (the JAX preset's widths; its flash-attention
        default waits for the training slice)."""
        return LlamaConfig(vocab_size=32_000, dim=1024, n_layers=24,
                           n_heads=8, n_kv_heads=4, ffn_dim=4096,
                           max_seq_len=max_seq_len)

    @staticmethod
    def debug(vocab_size: int = 256, max_seq_len: int = 128) -> "LlamaConfig":
        return LlamaConfig(vocab_size=vocab_size, dim=64, n_layers=2,
                           n_heads=4, n_kv_heads=2, ffn_dim=128,
                           max_seq_len=max_seq_len)


def param_shapes(cfg: LlamaConfig) -> Dict[str, object]:
    """Leaf shapes of the param tree (``LlamaModel.init`` in the JAX
    package), the same nesting: ``{"embed", "layers": {...}, "norm_f",
    "lm_head"}``."""
    d, hd, L = cfg.dim, cfg.head_dim, cfg.n_layers
    shapes = {
        "embed": (cfg.vocab_size, d),
        "layers": {
            "attn_norm": (L, d),
            "wq": (L, d, cfg.n_heads, hd),
            "wk": (L, d, cfg.n_kv_heads, hd),
            "wv": (L, d, cfg.n_kv_heads, hd),
            "wo": (L, cfg.n_heads, hd, d),
            "mlp_norm": (L, d),
            "w_gate": (L, d, cfg.ffn_dim),
            "w_up": (L, d, cfg.ffn_dim),
            "w_down": (L, cfg.ffn_dim, d),
        },
        "norm_f": (d,),
    }
    if not cfg.tie_embeddings:
        shapes["lm_head"] = (d, cfg.vocab_size)
    return shapes


NORM_LEAVES = ("attn_norm", "mlp_norm", "norm_f")


def _fan_in(name: str, cfg: LlamaConfig) -> int:
    return cfg.ffn_dim if name == "w_down" else cfg.dim


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
    """Functional model: ``init`` makes params; the step methods run the
    KV-cache forward. All tensors live on ``self.device``."""

    def __init__(self, cfg: LlamaConfig, device: DeviceLike = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self._angles = rope_frequencies(cfg.head_dim, cfg.max_seq_len,
                                        theta=cfg.rope_theta,
                                        device=self.device)

    # -- init ---------------------------------------------------------------
    def init(self, seed: int = 0) -> Params:
        """Random params, N(0, 1/fan_in) matrices and unit norms, drawn one
        leaf at a time on the device so the peak stays at one f32 leaf.
        (``jax.random`` streams cannot be reproduced: to compare with the
        JAX package, convert its params with ``models.convert``.)"""
        cfg = self.cfg
        gen = torch.Generator(device=self.device).manual_seed(int(seed))

        def leaf(name, shape):
            if name in NORM_LEAVES:
                return torch.ones(shape, dtype=torch.float32,
                                  device=self.device)
            x = torch.randn(shape, generator=gen, dtype=torch.float32,
                            device=self.device)
            x.mul_(_fan_in(name, cfg) ** -0.5)
            return x.to(cfg.dtype)

        shapes = param_shapes(cfg)
        params: Params = {}
        for name, shape in shapes.items():
            if name == "layers":
                params["layers"] = {n: leaf(n, s) for n, s in shape.items()}
            else:
                params[name] = leaf(name, shape)
        return params

    # -- shared pieces -----------------------------------------------------
    def _embed(self, params: Params, tokens: torch.Tensor) -> torch.Tensor:
        table = params["embed"]
        return table[gather_index(tokens, table.shape[0])]

    def _lm_head(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        head = (params["embed"].t() if self.cfg.tie_embeddings
                else params["lm_head"])
        return (x @ head).float()

    def _qkv(self, layer: Dict[str, torch.Tensor], l: int, x, positions):
        """Pre-norm q/k/v projections of layer ``l`` with rope applied.
        x [B, T, d] -> q [B, T, H, hd], k/v [B, T, Hkv, hd] in cfg.dtype."""
        cfg = self.cfg
        B, T, d = x.shape
        h = rms_norm(x, layer["attn_norm"][l], eps=cfg.norm_eps)
        q = (h @ layer["wq"][l].reshape(d, -1)).view(B, T, cfg.n_heads, -1)
        k = (h @ layer["wk"][l].reshape(d, -1)).view(B, T, cfg.n_kv_heads, -1)
        v = (h @ layer["wv"][l].reshape(d, -1)).view(B, T, cfg.n_kv_heads, -1)
        q = apply_rope(q, self._angles, positions)
        k = apply_rope(k, self._angles, positions)
        return q, k, v

    def _out_and_mlp(self, layer, l: int, x, o):
        """Attention output projection + residual, then the SwiGLU MLP
        block. o [B, T, H, hd]."""
        cfg = self.cfg
        B, T = o.shape[:2]
        x = x + o.reshape(B, T, -1) @ layer["wo"][l].reshape(-1, cfg.dim)
        h = rms_norm(x, layer["mlp_norm"][l], eps=cfg.norm_eps)
        gate = h @ layer["w_gate"][l]
        up = h @ layer["w_up"][l]
        return x + (F.silu(gate) * up) @ layer["w_down"][l]

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
        layers = params["layers"]
        for l in range(cfg.n_layers):
            q, k_new, v_new = self._qkv(layers, l, x, q_pos)
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
            x = self._out_and_mlp(layers, l, x, o)
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
        layers = params["layers"]
        for l in range(cfg.n_layers):
            q, k_new, v_new = self._qkv(layers, l, x, q_pos)
            k_pool, v_pool = pool["k"][l], pool["v"][l]
            # each slot writes its own private tail block in place (JAX: a
            # donated k_pool.at[...].set). Inactive slots all write the
            # scratch block: duplicate indices, no defined winner — as in
            # JAX's scatter — and nobody reads it.
            k_pool[dest_block, dest_off] = k_new[:, 0]
            v_pool[dest_block, dest_off] = v_new[:, 0]
            o = paged_decode_attention(q[:, 0], k_pool, v_pool, tables_i32,
                                       lengths, impl=impl)
            x = self._out_and_mlp(layers, l, x, o[:, None])
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
        layers = params["layers"]
        for l in range(cfg.n_layers):
            q, k_new, v_new = self._qkv(layers, l, x, pos_q)
            k_all = torch.cat([prefix_k[l].to(cfg.dtype), k_new], dim=1)
            v_all = torch.cat([prefix_v[l].to(cfg.dtype), v_new], dim=1)
            o = self._masked_attention(q, k_all, v_all, mask)
            x = self._out_and_mlp(layers, l, x, o)
            k_out[l], v_out[l] = k_new, v_new
        x = rms_norm(x, params["norm_f"], eps=cfg.norm_eps)
        last = take_last(x, lengths)                               # [N, d]
        return self._lm_head(params, last), {"k": k_out, "v": v_out}
