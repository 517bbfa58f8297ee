"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one; none imports
JAX, so the file runs on a machine that has only the port's dependencies:

    python -m pytest tests/test_torch_kernels.py -m gpu

The plain versions are held against the JAX package on the CPU by
tests/test_torch_ops.py. Tolerances: f32 inputs at the repo's own f32 bars
(rtol 2e-5 / atol 2e-6 ragged, 1e-4 paged), sums taken in another order;
bf16 outputs mostly relative, within two bf16 ulps (rtol 1.6e-2), with an
atol of 5e-3 for outputs near 0 (as chip_smoke.py holds them).
"""

import numpy as np
import pytest
import torch

from ray_tpu_torch.ops import decode_attention as tdec
from ray_tpu_torch.ops import paged_attention as tpaged

pytestmark = pytest.mark.gpu

TOL = {torch.float32: {"ragged": (2e-5, 2e-6), "paged": (1e-4, 1e-4)},
       torch.bfloat16: {"ragged": (1.6e-2, 5e-3), "paged": (1.6e-2, 5e-3)}}


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
