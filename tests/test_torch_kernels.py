"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one; none imports
JAX, so the file runs on a machine that has only the port's dependencies:

    python -m pytest tests/test_torch_kernels.py -m gpu

The plain versions are held against the JAX package on the CPU by
tests/test_torch_ops.py. Tolerances: f32 inputs at the repo's own f32 bars
(rtol 2e-5 / atol 2e-6 ragged, 1e-4 paged, rtol 2e-4 / atol 2e-5 flash),
sums taken in another order; bf16 outputs mostly relative, within two bf16
ulps (rtol 1.6e-2), with an atol of 5e-3 for outputs near 0 (as
chip_smoke.py holds them).
"""

import dataclasses

import numpy as np
import pytest
import torch

from ray_tpu_torch.models import LlamaConfig, LlamaModel, MoEConfig, MoEModel
from ray_tpu_torch.ops import attention as tattn
from ray_tpu_torch.ops import decode_attention as tdec
from ray_tpu_torch.ops import paged_attention as tpaged
from ray_tpu_torch.train.spmd import param_leaves

pytestmark = pytest.mark.gpu

TOL = {torch.float32: {"ragged": (2e-5, 2e-6), "paged": (1e-4, 1e-4),
                       "flash": (2e-4, 2e-5)},
       torch.bfloat16: {"ragged": (1.6e-2, 5e-3), "paged": (1.6e-2, 5e-3),
                        "flash": (1.6e-2, 5e-3)}}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card, not on this host)")
    return torch.device("cuda")


def _rand(rng, shape, dtype, dev):
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(
        device=dev, dtype=dtype)


PAGED = [
    # (B, H, Hkv, D, bs, NB, maxb, lengths)
    (4, 8, 4, 128, 16, 32, 6, [1, 16, 37, 96]),     # tests/test_llm_paged.py
    (3, 4, 2, 16, 8, 16, 4, [0, 13, 32]),           # empty slot, full table
    (2, 32, 8, 128, 32, 70, 32, [1024, 517]),       # Llama-3-8B widths
    (2, 16, 2, 256, 8, 12, 5, [40, 7]),             # G=8, D=256: >48 KB smem
    (5, 6, 6, 8, 3, 40, 7, [21, 1, 2, 20, 9]),      # MHA, odd block size
    # split-KV edges: lengths on and beside chunk edges (128 rows), an
    # empty slot, a table width (33 * 32) that is no multiple of the chunk
    (6, 32, 8, 128, 32, 200, 33, [0, 1, 255, 256, 257, 1024]),
    (3, 64, 8, 128, 16, 100, 20, [255, 320, 0]),    # G=8, width 320
    (4, 8, 8, 64, 32, 40, 9, [257, 288, 1, 256]),   # G=1, width 288
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", PAGED)
def test_paged_kernel_matches_plain(dev, case, dtype):
    B, H, Hkv, D, bs, NB, maxb, lengths = case
    rng = np.random.default_rng(len(lengths) + D)
    q = _rand(rng, (B, H, D), dtype, dev)
    kp = _rand(rng, (NB, bs, Hkv, D), dtype, dev)
    vp = _rand(rng, (NB, bs, Hkv, D), dtype, dev)
    tables = torch.from_numpy(rng.permutation(NB)[:B * maxb]
                              .reshape(B, maxb).astype(np.int32)).to(dev)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    before = tpaged.paged_decode_attention_kernel.launches
    out = tpaged.paged_decode_attention_kernel(q, kp, vp, tables, lens)
    torch.cuda.synchronize()
    assert tpaged.paged_decode_attention_kernel.launches == before + 1
    plain = tpaged._paged_decode_plain(q, kp, vp, tables, lens,
                                       scale=D ** -0.5)
    rtol, atol = TOL[dtype]["paged"]
    assert out.dtype == dtype and out.shape == q.shape
    torch.testing.assert_close(out.float(), plain.float(), rtol=rtol,
                               atol=atol)


RAGGED = [
    # (B, S, H, Hkv, D, lengths)
    (4, 256, 8, 2, 32, [1, 100, 200, 256]),     # tests/test_ops.py
    (2, 96, 4, 4, 16, [37, 96]),                # S not a multiple of 32/64
    (3, 1024, 32, 8, 128, [1, 513, 1024]),      # Llama-3-8B widths
    (2, 40, 8, 1, 64, [0, 39]),                 # empty slot, G=8
    (6, 1056, 32, 8, 128, [0, 1, 255, 256, 257, 1024]),   # chunk edges
    (3, 300, 16, 2, 128, [300, 0, 256]),        # G=8, 2 chunks
    (2, 513, 4, 4, 32, [513, 1]),               # G=1, 3 chunks
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", RAGGED)
def test_ragged_kernel_matches_plain(dev, case, dtype):
    B, S, H, Hkv, D, lengths = case
    rng = np.random.default_rng(S + D)
    q = _rand(rng, (B, H, D), dtype, dev)
    k = _rand(rng, (B, S, Hkv, D), dtype, dev)
    v = _rand(rng, (B, S, Hkv, D), dtype, dev)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    out = tdec.ragged_decode_attention_kernel(q, k, v, lens)
    torch.cuda.synchronize()
    plain = tdec._ragged_decode_plain(q, k, v, lens, block_k=64,
                                      scale=D ** -0.5)
    rtol, atol = TOL[dtype]["ragged"]
    torch.testing.assert_close(out.float(), plain.float(), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("paged", [True, False])
def test_split_partials_and_merge_match_plain(dev, paged, dtype):
    """Each live chunk's partial (m, l, acc) against the plain online
    softmax over that chunk, and the merge kernel against
    ``_merge_splits_plain`` on the kernel's own partials."""
    B, H, Hkv, D, bs, maxb = 6, 32, 8, 128, 32, 33
    lengths = [0, 1, 255, 256, 257, 1024]
    rng = np.random.default_rng(21)
    q = _rand(rng, (B, H, D), dtype, dev)
    kp = _rand(rng, (B * maxb, bs, Hkv, D), dtype, dev)
    vp = _rand(rng, (B * maxb, bs, Hkv, D), dtype, dev)
    tables = torch.from_numpy(rng.permutation(B * maxb).reshape(B, maxb)
                              .astype(np.int32)).to(dev)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    split_rows, n_split = tdec.decode_split_plan(maxb * bs)
    scratch = tdec.split_scratch(B, n_split, H, D, dev)
    scale = D ** -0.5
    if paged:
        out = tpaged._launch_paged(q, kp, vp, tables, lens, scale, scratch)
        tab = tables.long()

        def kv_block(i):
            return kp[tab[:, i]], vp[tab[:, i]]
        nblk, blk = maxb, bs
    else:
        k = kp[tables.long()].reshape(B, maxb * bs, Hkv, D)
        v = vp[tables.long()].reshape(B, maxb * bs, Hkv, D)
        out = tdec._launch_ragged(q, k, v, lens, scale, scratch)

        def kv_block(i):
            return k[:, i * 32:(i + 1) * 32], v[:, i * 32:(i + 1) * 32]
        nblk, blk = maxb * bs // 32, 32
    torch.cuda.synchronize()
    part_acc, part_ml = scratch
    for c in range(n_split):
        m, l, acc = tdec.online_decode_state(
            q, lens, nblk, blk, kv_block, scale, lo=c * split_rows,
            hi=(c + 1) * split_rows)
        for b, n in enumerate(lengths):
            if c * split_rows >= n:
                continue                        # never written, never read
            torch.testing.assert_close(part_ml[b, c, :, 0], m[b, :, 0],
                                       rtol=1e-5, atol=1e-5)
            torch.testing.assert_close(part_ml[b, c, :, 1], l[b, :, 0],
                                       rtol=1e-4, atol=1e-5)
            torch.testing.assert_close(part_acc[b, c], acc[b], rtol=1e-4,
                                       atol=1e-4)
    merged = tdec._merge_splits_plain(part_acc, part_ml, lens, split_rows,
                                      dtype)
    rtol, atol = (1e-5, 1e-6) if dtype == torch.float32 else (1.6e-2, 5e-3)
    torch.testing.assert_close(out.float(), merged.float(), rtol=rtol,
                               atol=atol)
    assert not out[0].any()                     # the empty slot gives 0


def test_kernel_wrappers_refuse_what_the_kernel_cannot_take(dev):
    q = torch.zeros(2, 4, 12, device=dev)                 # D not % 8
    k = torch.zeros(2, 8, 2, 12, device=dev)
    lens = torch.ones(2, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="head_dim"):
        tdec.ragged_decode_attention_kernel(q, k, k, lens)
    q = torch.zeros(2, 4, 16, device=dev, dtype=torch.float16)
    k = torch.zeros(2, 8, 2, 16, device=dev, dtype=torch.float16)
    with pytest.raises(ValueError, match="dtype"):
        tdec.ragged_decode_attention_kernel(q, k, k, lens)
    q = torch.zeros(2, 4, 16, device=dev)
    k = torch.zeros(2, 8, 2, 16, device=dev)
    with pytest.raises(ValueError, match="same|on"):
        tdec.ragged_decode_attention_kernel(q, k, k, lens.cpu())
    with pytest.raises(ValueError, match="contiguous"):
        tdec.ragged_decode_attention_kernel(
            q, k.transpose(1, 2).contiguous().transpose(1, 2), k, lens)


FLASH = [
    # (B, S, H, Hkv, D, causal)
    (2, 256, 4, 2, 32, True),                   # tests/test_ops.py
    (2, 256, 4, 2, 32, False),
    (1, 192, 2, 2, 16, True),                   # S % 64 != 0
    (2, 2048, 8, 4, 128, True),                 # bench_400m widths
    (1, 100, 4, 1, 8, True),                    # D=8, G=4
    (2, 130, 6, 3, 96, True),                   # D padded to 128
    (1, 77, 2, 2, 256, False),                  # D=256: >48 KB smem
    (3, 64, 2, 1, 24, True),                    # one tile
    # the wgmma kernel (bf16, D=128) at its edges: partial last query and
    # key tiles, and B*H*tiles leaving a partial last wave on 132 SMs
    (1, 130, 4, 2, 128, True),
    (1, 130, 4, 2, 128, False),
    (2, 1000, 8, 4, 128, True),
    (2, 1000, 8, 4, 128, False),
    (1, 2047, 9, 3, 128, True),
    (1, 2047, 9, 3, 128, False),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FLASH)
def test_flash_kernel_matches_plain(dev, case, dtype):
    B, S, H, Hkv, D, causal = case
    rng = np.random.default_rng(S + D + H)
    q = _rand(rng, (B, S, H, D), dtype, dev)
    k = _rand(rng, (B, S, Hkv, D), dtype, dev)
    v = _rand(rng, (B, S, Hkv, D), dtype, dev)
    before = tattn.flash_attention_kernel.launches
    out = tattn.flash_attention_kernel(q, k, v, causal)
    torch.cuda.synchronize()
    assert tattn.flash_attention_kernel.launches == before + 1
    plain = tattn._flash_forward_plain(q, k, v, causal=causal)
    rtol, atol = TOL[dtype]["flash"]
    assert out.dtype == dtype and out.shape == q.shape
    torch.testing.assert_close(out.float(), plain.float(), rtol=rtol,
                               atol=atol)


FLASH_SQ_SK = [
    # (B, Sq, Sk, H, Hkv, D): causal aligned top-left, as in JAX
    (2, 96, 160, 4, 2, 128),                    # the wgmma kernel
    (2, 160, 96, 4, 2, 128),
    (1, 300, 1000, 2, 1, 128),
    (2, 96, 160, 4, 2, 32),                     # the mma.sync kernel
    (2, 160, 96, 4, 2, 32),
]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FLASH_SQ_SK)
def test_flash_kernel_sq_ne_sk_matches_plain(dev, case, dtype, causal):
    B, Sq, Sk, H, Hkv, D = case
    rng = np.random.default_rng(Sq + Sk + D)
    q = _rand(rng, (B, Sq, H, D), dtype, dev)
    k = _rand(rng, (B, Sk, Hkv, D), dtype, dev)
    v = _rand(rng, (B, Sk, Hkv, D), dtype, dev)
    out = tattn.flash_attention_kernel(q, k, v, causal)
    torch.cuda.synchronize()
    plain = tattn._flash_forward_plain(q, k, v, causal=causal)
    rtol, atol = TOL[dtype]["flash"]
    assert out.dtype == dtype and out.shape == q.shape
    torch.testing.assert_close(out.float(), plain.float(), rtol=rtol,
                               atol=atol)


def test_flash_function_grads_match_reference(dev):
    """tests/test_ops.py:341-360: the kernel forward plus the blockwise
    recompute backward against autograd through the reference, f32."""
    rng = np.random.default_rng(2)
    q, k, v = (_rand(rng, (1, 128, 2, 16), torch.float32, dev)
               .requires_grad_() for _ in range(3))
    out = tattn.flash_attention(q, k, v, True)
    grads = torch.autograd.grad((out ** 2).sum(), (q, k, v))
    ref = torch.autograd.grad(
        (tattn.reference_attention(q, k, v) ** 2).sum(), (q, k, v))
    for a, b in zip(grads, ref):
        torch.testing.assert_close(a, b, rtol=5e-3, atol=5e-4)


def test_attention_dispatcher_takes_the_kernel_on_the_card(dev):
    rng = np.random.default_rng(3)
    q = _rand(rng, (1, 128, 4, 128), torch.bfloat16, dev)
    k = _rand(rng, (1, 128, 2, 128), torch.bfloat16, dev)
    before = tattn.flash_attention_kernel.launches
    tattn.attention(q, k, k)
    assert tattn.flash_attention_kernel.launches == before + 1
    tattn.attention(q[:, :64], k[:, :64], k[:, :64])      # S < 128
    pos = torch.arange(128, device=dev)
    tattn.attention(q, k, k, positions_q=pos, positions_k=pos)
    assert tattn.flash_attention_kernel.launches == before + 1


def test_flash_function_takes_views_of_a_fused_projection(dev):
    """GPT-2 and ViT split q/k/v out of one [B, S, 3, H, D] projection: the
    views are not contiguous, and the Function hands the kernel copies."""
    rng = np.random.default_rng(4)
    qkv = _rand(rng, (2, 256, 3, 4, 128), torch.bfloat16, dev)
    q, k, v = qkv.unbind(2)
    assert not q.is_contiguous()
    before = tattn.flash_attention_kernel.launches
    out = tattn.flash_attention(q, k, v, True)
    assert tattn.flash_attention_kernel.launches == before + 1
    torch.testing.assert_close(out, tattn.flash_attention_kernel(
        q.contiguous(), k.contiguous(), v.contiguous(), True), rtol=0,
        atol=0)


def test_moe_kernel_path_on_the_card(dev):
    """MoE (debug widths, f32) through the flash kernel: two launches a
    layer under remat, the loss and gradients of the blockwise path."""
    cfg = dataclasses.replace(MoEConfig.debug_moe(), dtype=torch.float32,
                              attention_impl="kernel", remat=True)
    rng = np.random.default_rng(8)
    tokens = torch.from_numpy(rng.integers(0, 256, (2, 128))).to(dev)
    targets = torch.roll(tokens, -1, dims=1)
    params = MoEModel(cfg, device=dev).init(0, param_dtype=torch.float32)
    leaves = param_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    results = []
    for impl in ("kernel", "blockwise"):
        model = MoEModel(dataclasses.replace(cfg, attention_impl=impl),
                         device=dev)
        before = tattn.flash_attention_kernel.launches
        loss = model.loss(params, tokens, targets)
        grads = torch.autograd.grad(loss, leaves)
        torch.cuda.synchronize()
        results.append((loss, grads,
                        tattn.flash_attention_kernel.launches - before))
    (loss, grads, launches), (ref_loss, ref_grads, ref_launches) = results
    assert (launches, ref_launches) == (2 * cfg.n_layers, 0)
    torch.testing.assert_close(loss, ref_loss, rtol=1e-5, atol=1e-6)
    for a, b in zip(grads, ref_grads):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6)


def test_flash_wrapper_refuses_what_the_kernel_cannot_take(dev):
    q = torch.zeros(1, 16, 2, 12, device=dev)             # D not % 8
    with pytest.raises(ValueError, match="head_dim"):
        tattn.flash_attention_kernel(q, q, q)
    q = torch.zeros(1, 16, 2, 16, device=dev)
    with pytest.raises(ValueError, match="dtype"):
        tattn.flash_attention_kernel(q.half(), q.half(), q.half())
    with pytest.raises(ValueError, match="contiguous"):
        tattn.flash_attention_kernel(q.transpose(1, 2).contiguous()
                                     .transpose(1, 2), q, q)


@pytest.mark.parametrize("remat,policy", [(False, "full"), (True, "full"),
                                          (True, "dots")])
def test_training_launches_and_remat_policies(dev, remat, policy):
    """Through the model on the card: the kernel runs once a layer in the
    forward and once more in the backward under remat (the forward re-runs;
    the backward itself launches none), and every policy gives the same
    loss and gradients. f32, so the comparison is tight."""
    cfg = dataclasses.replace(LlamaConfig.debug(vocab_size=512),
                              dtype=torch.float32, attention_impl="kernel")
    rng = np.random.default_rng(7)
    tokens = torch.from_numpy(rng.integers(0, 512, (2, 128))).to(dev)
    targets = torch.roll(tokens, -1, dims=1)

    def loss_and_grads(cfg):
        model = LlamaModel(cfg, device=dev)
        params = model.init(0, param_dtype=torch.float32)
        leaves = [params["embed"], *params["layers"].values()]
        for p in leaves:
            p.requires_grad_(True)
        before = tattn.flash_attention_kernel.launches
        loss = model.loss(params, tokens, targets)
        grads = torch.autograd.grad(loss, leaves)
        torch.cuda.synchronize()
        return loss, grads, tattn.flash_attention_kernel.launches - before

    ref_loss, ref_grads, _ = loss_and_grads(cfg)
    loss, grads, launches = loss_and_grads(dataclasses.replace(
        cfg, remat=remat, remat_policy=policy))
    assert launches == (2 if remat else 1) * cfg.n_layers
    torch.testing.assert_close(loss, ref_loss, rtol=1e-6, atol=1e-6)
    for a, b in zip(grads, ref_grads):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)
