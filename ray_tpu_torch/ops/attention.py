"""Attention: the plain PyTorch versions and the flash-attention kernel.

Counterpart of ``ray_tpu/ops/attention.py``:

- ``reference_attention`` — plain softmax attention in f32 (GQA-aware,
  causal or full, optional explicit positions), differentiable;
- ``blockwise_attention`` — online softmax over key chunks with a
  recomputed (``torch.utils.checkpoint``) body: the memory-light
  differentiable path and the flash kernel's backward;
- ``flash_attention_kernel`` — for CUDA tensors it launches the hand-written
  kernel of ``csrc/flash_attention.cu`` (which replaces the Pallas
  ``_flash_fwd_kernel``); for CPU tensors it runs ``_flash_forward_plain``,
  a plain PyTorch version of the Pallas kernel block by block;
- ``flash_attention`` — the ``torch.autograd.Function`` around it: forward
  through the kernel, backward a recompute through ``blockwise_attention``,
  as JAX's custom VJP does;
- ``attention`` — the dispatcher.

On a mesh (DTensor q/k/v) ``flash_attention``, ``blockwise_attention`` and
``attention`` run on each rank's local shards (``local_map``, JAX's
``shard_map``): attention is independent across batch rows and heads, so the
batch may be sharded over any axes and the heads over tp; the kernel sees
plain local tensors, and its recompute backward runs on them too. GQA stays
right because query heads and kv heads are split into the same number of
contiguous blocks (query head ``h`` of a block still reads kv head
``h // group`` of that block); a kv-head count the head shards do not divide
raises. A sharded sequence or head_dim raises too, as JAX's single-device
kernel refuses an sp>1 mesh: context parallelism is ``ops/ring_attention.py``
and ``ops/ulysses.py``.

The Pallas ``block_q``/``block_k`` and ``interpret`` arguments are gone: the
CUDA kernel picks its own tiles, and the plain version keeps the Pallas
defaults (``PALLAS_BLOCK``). Shapes follow the JAX package: [batch, seq,
heads, head_dim].
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.distributed.tensor import DTensor, Replicate
from torch.utils.checkpoint import checkpoint

from ray_tpu_torch.parallel.mesh import replicated, shard_map_compat

NEG_INF = -1e30
# the Pallas kernel's default block_q = block_k, the plain version's tiles
PALLAS_BLOCK = 128
# dtype codes of the CUDA launchers (csrc/*.cu)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def repeat_kv(k: torch.Tensor, num_q_heads: int) -> torch.Tensor:
    """GQA: repeat kv heads to match q heads. [B,S,Hkv,D] -> [B,S,H,D]
    (kv head g serves q heads g*G .. g*G+G-1, as ``jnp.repeat``)."""
    num_kv = k.shape[-2]
    if num_kv == num_q_heads:
        return k
    return torch.repeat_interleave(k, num_q_heads // num_kv, dim=-2)


def check_kernel_tensors(name: str, q, k, v, *others) -> None:
    """What every CUDA launcher of the port takes: one CUDA device, q/k/v of
    one dtype (bfloat16 or float32), contiguous, 16-byte aligned. Raises
    ValueError on anything else."""
    tensors = (q, k, v, *others)
    if q.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {q.device}")
    if any(t.device != q.device for t in tensors):
        raise ValueError(f"{name}: all operands must be on {q.device}")
    if q.dtype not in DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"{name}: q/k/v must share dtype bfloat16 or "
                         f"float32, got {q.dtype}/{k.dtype}/{v.dtype}")
    if any(not t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: operands must be contiguous")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError(f"{name}: q/k/v must be 16-byte aligned")


def _per_shard(fn, q, k, v, *rest):
    """``fn(q, k, v, *rest)`` on each rank's local shards of DTensor q/k/v
    [B, S, H(kv), D], laid out as ``q``: batch over any axes, heads over
    any; k/v are moved to the same placements first. ``rest`` (explicit
    positions, or None) are whole on every rank."""
    mesh = q.device_mesh
    # a sum still to do (a product over a sharded contraction) is done
    pl = tuple(Replicate() if p.is_partial() else p for p in q.placements)
    head_shards = 1
    for i, p in enumerate(pl):
        if p.is_shard() and p.dim not in (0, 2):
            raise ValueError(
                f"attention on a mesh: q placements {pl}; only the batch "
                "and head dims may be sharded (a sequence sharded over sp "
                "takes attention_impl='ring' or 'ulysses')")
        if p.is_shard(2):
            head_shards *= mesh.size(i)
    if k.shape[2] % head_shards:
        raise ValueError(f"attention on a mesh: {k.shape[2]} kv heads not "
                         f"divisible by the {head_shards} head shards (tp)")
    whole = [replicated(mesh) if isinstance(r, DTensor) else None
             for r in rest]
    return shard_map_compat(fn, mesh, (pl, pl, pl, *whole), list(pl))(
        q, k, v, *rest)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def reference_attention(q, k, v, *, causal: bool = True,
                        positions_q: Optional[torch.Tensor] = None,
                        positions_k: Optional[torch.Tensor] = None,
                        scale: Optional[float] = None) -> torch.Tensor:
    """Plain softmax attention in f32, fully differentiable. ``p`` is cast
    to ``v``'s dtype before the value product, as the JAX einsum does."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    k = repeat_kv(k, q.shape[-2])
    v = repeat_kv(v, q.shape[-2])
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        if positions_q is None:
            positions_q = torch.arange(q.shape[1], device=q.device)
        if positions_k is None:
            positions_k = torch.arange(k.shape[1], device=q.device)
        mask = positions_q.to(q.device)[:, None] \
            >= positions_k.to(q.device)[None, :]
        s = torch.where(mask[None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v)


def blockwise_attention(q, k, v, *, causal: bool = True, block_k: int = 512,
                        scale: Optional[float] = None) -> torch.Tensor:
    """Memory-light differentiable attention: online softmax over key
    chunks whose body is recomputed in the backward (JAX wraps the scan body
    in ``jax.checkpoint``), so forward and backward hold O(S·block_k) scores
    instead of O(S²)."""
    head_dim = q.shape[-1]
    scale = scale if scale is not None else head_dim ** -0.5
    k = repeat_kv(k, q.shape[-2])
    v = repeat_kv(v, q.shape[-2])
    batch, seq_q, heads, _ = q.shape
    seq_k = k.shape[1]
    bk = min(block_k, seq_k)
    pad = -seq_k % bk                    # pad keys; padding masked below
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    rows = torch.arange(seq_q, device=q.device)

    def body(acc, m, l, ki, kb, vb):
        s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kb.float()) * scale
        cols = ki * bk + torch.arange(bk, device=q.device)
        mask = cols[None, :] < seq_k
        if causal:
            mask = mask & (rows[:, None] >= cols[None, :])
        s = torch.where(mask[None, None], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = alpha * l + p.sum(dim=-1, keepdim=True)
        a = torch.einsum("bhqk,bkhd->bqhd", p, vb.float())
        return acc * alpha.transpose(1, 2) + a, m_new, l

    acc = torch.zeros((batch, seq_q, heads, head_dim), dtype=torch.float32,
                      device=q.device)
    m = torch.full((batch, heads, seq_q, 1), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((batch, heads, seq_q, 1), dtype=torch.float32,
                    device=q.device)
    for ki in range(k.shape[1] // bk):
        kb, vb = k[:, ki * bk:(ki + 1) * bk], v[:, ki * bk:(ki + 1) * bk]
        acc, m, l = checkpoint(body, acc, m, l, ki, kb, vb,
                               use_reentrant=False, preserve_rng_state=False)
    l = torch.where(l == 0.0, 1.0, l)
    return (acc / l.transpose(1, 2)).to(q.dtype)


def _flash_forward_plain(q, k, v, *, causal: bool) -> torch.Tensor:
    """Plain version of the Pallas ``_flash_fwd_kernel``, block by block at
    its default tiles: q/k/v padded to whole blocks (padded keys masked,
    padded V rows zero), key blocks above the causal diagonal skipped,
    products accumulated in f32 from the input dtype, ``p`` cast to ``v``'s
    dtype before the value product, ``l == 0 -> 1``."""
    batch, seq_q, heads, head_dim = q.shape
    seq_k = k.shape[1]
    scale = head_dim ** -0.5
    bq, bk = min(PALLAS_BLOCK, seq_q), min(PALLAS_BLOCK, seq_k)
    nq, nk = -(-seq_q // bq), -(-seq_k // bk)
    k = repeat_kv(k, heads)
    v = repeat_kv(v, heads)
    pad = torch.nn.functional.pad
    q = pad(q, (0, 0, 0, 0, 0, nq * bq - seq_q))
    k = pad(k, (0, 0, 0, 0, 0, nk * bk - seq_k))
    v = pad(v, (0, 0, 0, 0, 0, nk * bk - seq_k))
    out = torch.empty((batch, nq * bq, heads, head_dim), dtype=q.dtype,
                      device=q.device)
    for qi in range(nq):
        qb = q[:, qi * bq:(qi + 1) * bq].float()
        rows = qi * bq + torch.arange(bq, device=q.device)
        acc = torch.zeros((batch, heads, bq, head_dim), dtype=torch.float32,
                          device=q.device)
        m = torch.full((batch, heads, bq, 1), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros_like(m)
        for ki in range(nk):
            if causal and ki * bk >= (qi + 1) * bq:
                continue                                  # pl.when skip
            kb = k[:, ki * bk:(ki + 1) * bk]
            vb = v[:, ki * bk:(ki + 1) * bk]
            s = torch.einsum("bqhd,bkhd->bhqk", qb, kb.float()) * scale
            cols = ki * bk + torch.arange(bk, device=q.device)
            mask = cols[None, :] < seq_k
            if causal:
                mask = mask & (rows[:, None] >= cols[None, :])
            s = torch.where(mask[None, None], s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new)
            l = alpha * l + p.sum(dim=-1, keepdim=True)
            acc = acc * alpha + torch.einsum(
                "bhqk,bkhd->bhqd", p.to(v.dtype).float(), vb.float())
            m = m_new
        l = torch.where(l == 0.0, 1.0, l)
        out[:, qi * bq:(qi + 1) * bq] = (acc / l).transpose(1, 2).to(q.dtype)
    return out[:, :seq_q]


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------

def _check_flash_shapes(q, k, v) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape \
            or k.shape[0] != q.shape[0] or k.shape[-1] != q.shape[-1]:
        raise ValueError("flash_attention: expected q [B,S,H,D] and k/v "
                         "[B,S,Hkv,D] of one batch and head_dim")
    if k.shape[2] < 1 or q.shape[2] % k.shape[2]:
        raise ValueError(f"flash_attention: {q.shape[2]} query heads not a "
                         f"multiple of {k.shape[2]} kv heads")


def _launch_flash(q, k, v, causal: bool, scale: float) -> torch.Tensor:
    from ray_tpu_torch import _build
    name = "flash_attention_kernel"
    check_kernel_tensors(name, q, k, v)
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    if D % 8 or D > 256:
        raise ValueError(f"{name}: head_dim must be a multiple of 8 up to "
                         f"256, got {D}")
    if B > 65535 or H > 65535:
        raise ValueError(f"{name}: batch and heads must be at most 65535")
    lib = _build.load_library("flash_attention")
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.rt_flash_attention_forward(
            DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), B, Sq, Sk, H, Hkv, D, int(causal), float(scale),
            stream)
    _build.check(err, name)
    return out


def flash_attention_kernel(q, k, v, causal: bool = True) -> torch.Tensor:
    """The hand-written flash-attention forward for CUDA tensors, the plain
    version of the Pallas kernel for CPU tensors. No fallback between the
    two: a CUDA tensor the kernel cannot take raises. Sq and Sk may differ;
    causal masking is then aligned top-left (row r sees keys 0..r), as in
    the JAX kernel. Not differentiable: ``flash_attention`` is."""
    _check_flash_shapes(q, k, v)
    if q.device.type == "cpu":
        return _flash_forward_plain(q, k, v, causal=causal)
    out = _launch_flash(q, k, v, causal, q.shape[-1] ** -0.5)
    flash_attention_kernel.launches += 1
    return out


flash_attention_kernel.launches = 0


class FlashAttention(torch.autograd.Function):
    """Forward through the kernel; backward recomputes through
    ``blockwise_attention`` and differentiates that (``_flash_bwd_rule``):
    O(S·block) memory both ways, and no backward kernel."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool):
        ctx.causal = causal
        ctx.save_for_backward(q, k, v)
        return flash_attention_kernel(q, k, v, causal)

    @staticmethod
    def backward(ctx, grad):
        saved = ctx.saved_tensors
        need = ctx.needs_input_grad[:3]
        with torch.enable_grad():
            q, k, v = (t.detach().requires_grad_(n) for t, n in
                       zip(saved, need))
            out = blockwise_attention(q, k, v, causal=ctx.causal)
            wrt = [t for t, n in zip((q, k, v), need) if n]
            grads = iter(torch.autograd.grad(out, wrt, grad))
        return (*(next(grads) if n else None for n in need), None)


def flash_attention(q, k, v, causal: bool = True) -> torch.Tensor:
    """Flash attention with the kernel's forward and a blockwise-recompute
    backward; q [B,S,H,D], k/v [B,S,Hkv,D], made contiguous for the kernel
    (GPT-2 and ViT split q/k/v out of one fused projection). On DTensors,
    the kernel runs on each rank's local shards."""
    if isinstance(q, DTensor):
        return _per_shard(lambda a, b, c: flash_attention(a, b, c, causal),
                          q, k, v)
    return FlashAttention.apply(q.contiguous(), k.contiguous(),
                                v.contiguous(), causal)


def attention(q, k, v, *, causal: bool = True,
              positions_q: Optional[torch.Tensor] = None,
              positions_k: Optional[torch.Tensor] = None,
              use_flash: Optional[bool] = None) -> torch.Tensor:
    """Dispatcher. With ``use_flash=None`` the flash kernel runs when the
    tensors are on the card and tile cleanly (no explicit positions,
    ``head_dim % 128 == 0``, ``S >= 128``), the counterpart of JAX's "on TPU
    and tiles cleanly"; otherwise ``reference_attention``. DTensors run on
    each rank's local shards, explicit positions whole on each."""
    if isinstance(q, DTensor):
        return _per_shard(lambda a, b, c, pq, pk: attention(
            a, b, c, causal=causal, positions_q=pq, positions_k=pk,
            use_flash=use_flash), q, k, v, positions_q, positions_k)
    if use_flash is None:
        use_flash = (q.device.type == "cuda" and positions_q is None
                     and positions_k is None and q.shape[-1] % 128 == 0
                     and q.shape[1] >= 128)
    if use_flash:
        return flash_attention(q, k, v, causal)
    return reference_attention(q, k, v, causal=causal,
                               positions_q=positions_q,
                               positions_k=positions_k)
