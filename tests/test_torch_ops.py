"""Ops of the PyTorch port held against the JAX package on the CPU.

The same numpy inputs (from a seed) go through ``ray_tpu`` and
``ray_tpu_torch``; the Pallas kernels run in interpret mode, as the JAX
package's own tests run them. The CUDA kernels themselves are held against
these plain versions on the card by tests/test_torch_kernels.py.
"""

import ast
import importlib
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops import decode_attention as jdec
from ray_tpu.ops import paged_attention as jpaged
from ray_tpu.ops.norms import layer_norm as j_layer_norm
from ray_tpu.ops.norms import rms_norm as j_rms_norm
from ray_tpu.ops.rope import apply_rope as j_apply_rope
from ray_tpu.ops.rope import rope_frequencies as j_rope_frequencies
from ray_tpu_torch.ops import decode_attention as tdec
from ray_tpu_torch.ops import paged_attention as tpaged
from ray_tpu_torch.ops import attention as tattn
from ray_tpu_torch.ops.attention import repeat_kv
from ray_tpu_torch.ops.norms import layer_norm, rms_norm
from ray_tpu_torch.ops.rope import apply_rope, rope_frequencies

REPO = pathlib.Path(__file__).resolve().parents[1]
# the module: ``ray_tpu.ops`` re-exports a function under the same name
jattn = importlib.import_module("ray_tpu.ops.attention")


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


# ---------------------------------------------------------------------------
# norms and rope
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(2, 5, 64), (3, 48)])
def test_norms_match_jax(shape):
    rng = np.random.default_rng(0)
    x = rng.normal(size=shape).astype(np.float32)
    w = rng.normal(size=shape[-1:]).astype(np.float32)
    b = rng.normal(size=shape[-1:]).astype(np.float32)
    np.testing.assert_allclose(
        rms_norm(_t(x), _t(w)).numpy(),
        np.asarray(j_rms_norm(jnp.asarray(x), jnp.asarray(w))), rtol=1e-5)
    np.testing.assert_allclose(
        layer_norm(_t(x), _t(w), _t(b)).numpy(),
        np.asarray(j_layer_norm(jnp.asarray(x), jnp.asarray(w),
                                jnp.asarray(b))), rtol=1e-5, atol=1e-6)


def test_rms_norm_bf16_casts_back():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(4, 32)).astype(np.float32)
    w = rng.normal(size=(32,)).astype(np.float32)
    out = rms_norm(_t(x, torch.bfloat16), _t(w))
    assert out.dtype == torch.bfloat16
    ref = j_rms_norm(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w))
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32), rtol=1e-2,
                               atol=1e-2)


def test_rope_matches_jax_with_and_without_positions():
    rng = np.random.default_rng(2)
    hd, max_s = 16, 64
    ang = rope_frequencies(hd, max_s, device="cpu")
    j_ang = j_rope_frequencies(hd, max_s)
    np.testing.assert_array_equal(ang.numpy(), np.asarray(j_ang))
    x = rng.normal(size=(2, 7, 4, hd)).astype(np.float32)
    np.testing.assert_allclose(
        apply_rope(_t(x), ang).numpy(),
        np.asarray(j_apply_rope(jnp.asarray(x), j_ang)), rtol=1e-5,
        atol=1e-6)
    # positions past the table clamp to its last row, as JAX's gather does
    pos = np.array([[0, 3, 9, 40, 63, 64, 100],
                    [5, 6, 7, 8, 70, 71, 200]], np.int32)
    np.testing.assert_allclose(
        apply_rope(_t(x), ang, torch.from_numpy(pos)).numpy(),
        np.asarray(j_apply_rope(jnp.asarray(x), j_ang, jnp.asarray(pos))),
        rtol=1e-5, atol=1e-6)


def test_repeat_kv_matches_jnp_repeat():
    x = np.arange(2 * 3 * 2 * 4, dtype=np.float32).reshape(2, 3, 2, 4)
    np.testing.assert_array_equal(repeat_kv(_t(x), 6).numpy(),
                                  np.repeat(x, 3, axis=-2))


# ---------------------------------------------------------------------------
# ragged decode attention (tests/test_ops.py shapes and tolerances)
# ---------------------------------------------------------------------------

def _ragged_inputs(seed, B, S, H, Hkv, D, lengths):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, H, D)).astype(np.float32)
    k = rng.normal(size=(B, S, Hkv, D)).astype(np.float32)
    v = rng.normal(size=(B, S, Hkv, D)).astype(np.float32)
    return q, k, v, np.asarray(lengths, np.int32)


RAGGED_CASES = [
    # (seed, B, S, H, Hkv, D, lengths, block_k)
    (7, 4, 256, 8, 2, 32, [1, 100, 200, 256], 64),
    (8, 2, 96, 4, 4, 16, [37, 96], 64),          # S not a multiple of block
    (9, 3, 40, 4, 2, 8, [0, 13, 40], 16),        # an empty slot, tail block
]


@pytest.mark.parametrize("case", RAGGED_CASES)
def test_ragged_reference_matches_jax(case):
    seed, B, S, H, Hkv, D, lengths, _ = case
    q, k, v, lens = _ragged_inputs(seed, B, S, H, Hkv, D, lengths)
    ref = jdec.ragged_decode_attention_reference(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lens))
    out = tdec.ragged_decode_attention_reference(
        _t(q), _t(k), _t(v), torch.from_numpy(lens))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-5,
                               atol=2e-6)


@pytest.mark.parametrize("case", RAGGED_CASES)
def test_ragged_plain_kernel_matches_pallas_interpret(case):
    seed, B, S, H, Hkv, D, lengths, block_k = case
    q, k, v, lens = _ragged_inputs(seed, B, S, H, Hkv, D, lengths)
    jargs = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
             jnp.asarray(lens))
    pallas = jdec.ragged_decode_attention_pallas(*jargs, block_k=block_k,
                                                 interpret=True)
    out = tdec._ragged_decode_plain(_t(q), _t(k), _t(v),
                                    torch.from_numpy(lens), block_k=block_k,
                                    scale=D ** -0.5)
    np.testing.assert_allclose(out.numpy(), np.asarray(pallas), rtol=2e-5,
                               atol=2e-6)
    # the wrapper on CPU tensors: the plain version at the Pallas default
    # block, and no kernel launch is counted
    pallas = jdec.ragged_decode_attention_pallas(*jargs, interpret=True)
    before = tdec.ragged_decode_attention_kernel.launches
    out = tdec.ragged_decode_attention_kernel(
        _t(q), _t(k), _t(v), torch.from_numpy(lens))
    np.testing.assert_allclose(out.numpy(), np.asarray(pallas), rtol=2e-5,
                               atol=2e-6)
    assert tdec.ragged_decode_attention_kernel.launches == before


def test_ragged_dispatcher_and_dtype():
    q, k, v, lens = _ragged_inputs(3, 2, 24, 4, 2, 8, [5, 24])
    args = (_t(q, torch.bfloat16), _t(k, torch.bfloat16),
            _t(v, torch.bfloat16), torch.from_numpy(lens))
    ref = tdec.ragged_decode_attention(*args, impl="reference")
    ker = tdec.ragged_decode_attention(*args, impl="kernel")
    assert ref.dtype == ker.dtype == torch.bfloat16
    np.testing.assert_allclose(ker.float().numpy(), ref.float().numpy(),
                               atol=0.05, rtol=0.05)


# ---------------------------------------------------------------------------
# paged decode attention (tests/test_llm_paged.py shapes and tolerances)
# ---------------------------------------------------------------------------

def _paged_inputs(seed, B, H, Hkv, D, bs, NB, maxb, lengths):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, H, D)).astype(np.float32)
    kp = rng.normal(size=(NB, bs, Hkv, D)).astype(np.float32)
    vp = rng.normal(size=(NB, bs, Hkv, D)).astype(np.float32)
    tables = rng.permutation(NB)[:B * maxb].reshape(B, maxb).astype(np.int32)
    return q, kp, vp, tables, np.asarray(lengths, np.int32)


PAGED_CASES = [
    # (seed, B, H, Hkv, D, bs, NB, maxb, lengths)
    (0, 4, 8, 4, 128, 16, 32, 6, [1, 16, 37, 96]),
    (1, 2, 4, 2, 16, 8, 16, 4, [13, 27]),
    (2, 3, 4, 1, 8, 4, 16, 5, [0, 4, 19]),
]


@pytest.mark.parametrize("case", PAGED_CASES)
def test_paged_reference_matches_jax(case):
    q, kp, vp, tables, lens = _paged_inputs(*case)
    ref = jpaged.paged_decode_attention_reference(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(tables), jnp.asarray(lens))
    out = tpaged.paged_decode_attention_reference(
        _t(q), _t(kp), _t(vp), torch.from_numpy(tables),
        torch.from_numpy(lens))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("case", PAGED_CASES)
def test_paged_plain_kernel_matches_pallas_interpret(case):
    q, kp, vp, tables, lens = _paged_inputs(*case)
    pallas = jpaged.paged_decode_attention_pallas(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(tables), jnp.asarray(lens), interpret=True)
    before = tpaged.paged_decode_attention_kernel.launches
    out = tpaged.paged_decode_attention(
        _t(q), _t(kp), _t(vp), torch.from_numpy(tables),
        torch.from_numpy(lens), impl="kernel")
    np.testing.assert_allclose(out.numpy(), np.asarray(pallas), rtol=1e-4,
                               atol=1e-4)
    assert tpaged.paged_decode_attention_kernel.launches == before


def test_paged_table_past_pool_clamps_like_jax():
    q, kp, vp, tables, lens = _paged_inputs(4, 2, 4, 2, 16, 8, 6, 3,
                                            [20, 24])
    tables[0, 1] = 99                   # past the pool: JAX clamps to NB-1
    args_j = [jnp.asarray(a) for a in (q, kp, vp, tables, lens)]
    args_t = [_t(q), _t(kp), _t(vp), torch.from_numpy(tables),
              torch.from_numpy(lens)]
    np.testing.assert_allclose(
        tpaged.paged_decode_attention_reference(*args_t).numpy(),
        np.asarray(jpaged.paged_decode_attention_reference(*args_j)),
        rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(
        tpaged.paged_decode_attention_kernel(*args_t).numpy(),
        np.asarray(jpaged.paged_decode_attention_pallas(
            *args_j, interpret=True)), rtol=1e-4, atol=1e-4)


def test_paged_wrapper_rejects_bad_shapes():
    q, kp, vp, tables, lens = _paged_inputs(5, 2, 4, 2, 16, 8, 8, 2, [3, 9])
    with pytest.raises(ValueError):
        tpaged.paged_decode_attention_kernel(
            _t(q), _t(kp), _t(vp)[:, :4], torch.from_numpy(tables),
            torch.from_numpy(lens))
    with pytest.raises(ValueError):
        tpaged.paged_decode_attention_kernel(
            _t(q), _t(kp), _t(vp), torch.from_numpy(tables),
            torch.from_numpy(lens[:1]))


# ---------------------------------------------------------------------------
# split-KV decode (the kernels' chunking and merge, in plain PyTorch)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("width,plan", [(1024, (128, 8)), (1000, (128, 8)),
                                        (257, (128, 3)), (256, (128, 2)),
                                        (40, (128, 1)), (0, (128, 1))])
def test_decode_split_plan_covers_the_table(width, plan):
    split_rows, n_split = tdec.decode_split_plan(width)
    assert (split_rows, n_split) == plan
    assert split_rows % 32 == 0 and n_split * split_rows >= width


# lengths on and beside chunk edges, an empty slot, a full table
SPLIT_LENGTHS = [0, 1, 128, 255, 256, 257, 600]


@pytest.mark.parametrize("G", [1, 4])
def test_split_ragged_plain_matches_jax_reference(G):
    q, k, v, lens = _ragged_inputs(12, 7, 600, 2 * G, 2, 8, SPLIT_LENGTHS)
    # S = 600 walked in 64-row blocks (padded to 640): five 128-row chunks,
    # the last one partly past the cache
    ref = jdec.ragged_decode_attention_reference(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lens))
    kt = torch.nn.functional.pad(_t(k), (0, 0, 0, 0, 0, 40))    # 600 -> 640
    vt = torch.nn.functional.pad(_t(v), (0, 0, 0, 0, 0, 40))
    out = tdec.split_decode_plain(
        _t(q), torch.from_numpy(lens), 10, 64,
        lambda i: (kt[:, i * 64:(i + 1) * 64], vt[:, i * 64:(i + 1) * 64]),
        8 ** -0.5)
    # the empty slot: 0, as the Pallas kernel gives (l == 0 -> 1); the
    # masked reference averages V uniformly there
    assert not out[0].any()
    np.testing.assert_allclose(out[1:].numpy(), np.asarray(ref)[1:],
                               rtol=1e-5, atol=1e-6)


def test_split_paged_plain_matches_jax_reference():
    # width 40 * 16 = 640 rows: five 128-row chunks
    lengths = [0, 256, 257, 513, 640, 17]
    q, kp, vp, tables, lens = _paged_inputs(13, 6, 8, 2, 16, 16, 241, 40,
                                            lengths)
    ref = jpaged.paged_decode_attention_reference(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(tables), jnp.asarray(lens))
    kp_t, vp_t = _t(kp), _t(vp)
    tab = torch.from_numpy(tables).long()
    out = tdec.split_decode_plain(
        _t(q), torch.from_numpy(lens), 40, 16,
        lambda i: (kp_t[tab[:, i]], vp_t[tab[:, i]]), 16 ** -0.5)
    assert not out[0].any()                  # the empty slot, as above
    np.testing.assert_allclose(out[1:].numpy(), np.asarray(ref)[1:],
                               rtol=1e-5, atol=1e-6)


def test_merge_splits_plain_reads_only_live_chunks():
    """Chunks that start at or past a slot's length are never read (the
    kernel leaves them unwritten), and one chunk merges to itself."""
    rng = np.random.default_rng(14)
    acc = torch.from_numpy(rng.normal(size=(3, 4, 2, 8)).astype(np.float32))
    ml = torch.from_numpy(np.stack(
        [rng.normal(size=(3, 4, 2)), rng.uniform(1, 3, (3, 4, 2))],
        -1).astype(np.float32))
    lens = torch.tensor([0, 256, 700])
    acc[0] = acc[1, 1:] = acc[2, 3] = float("nan")     # never written
    ml[0] = ml[1, 1:] = ml[2, 3] = float("nan")
    out = tdec._merge_splits_plain(acc, ml, lens, 256, torch.float32)
    assert torch.isfinite(out).all() and not out[0].any()
    torch.testing.assert_close(out[1], acc[1, 0] / ml[1, 0, :, 1:])
    w = torch.exp(ml[2, :3, :, 0] - ml[2, :3, :, 0].amax(0))        # [3,H]
    want = (w[..., None] * acc[2, :3]).sum(0) / \
        (w * ml[2, :3, :, 1]).sum(0)[:, None]
    torch.testing.assert_close(out[2], want)


def test_cuda_operand_checks_refuse_cpu_tensors():
    q, k, v, lens = _ragged_inputs(6, 2, 16, 4, 2, 8, [3, 9])
    with pytest.raises(ValueError, match="no kernel for device"):
        tdec.check_cuda_operands("x", _t(q), _t(k), _t(v),
                                 torch.from_numpy(lens))


def test_build_needs_nvcc(monkeypatch, tmp_path):
    """The kernels build on first use only; without nvcc the error says
    so (and importing the ops built nothing)."""
    from ray_tpu_torch import _build
    assert _build.BUILD_DIR.parts[-2:] == ("build", "ray_tpu_torch")
    assert _build.library_path("decode_attention").name.startswith(
        "libdecode_attention-")
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr("torch.utils.cpp_extension.CUDA_HOME",
                        str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()


# ---------------------------------------------------------------------------
# training attention: reference, blockwise, flash (tests/test_ops.py shapes
# and tolerances)
# ---------------------------------------------------------------------------

def _qkv_inputs(seed, B, S, H, Hkv, D):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, S, H, D)).astype(np.float32),
            rng.normal(size=(B, S, Hkv, D)).astype(np.float32),
            rng.normal(size=(B, S, Hkv, D)).astype(np.float32))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("heads", [(4, 4), (4, 2)])
def test_reference_attention_matches_jax(causal, heads):
    H, Hkv = heads
    q, k, v = _qkv_inputs(10, 2, 24, H, Hkv, 16)
    out = tattn.reference_attention(_t(q), _t(k), _t(v), causal=causal)
    ref = jattn.reference_attention(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), causal=causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)


def test_reference_attention_positions_match_jax():
    q, k, v = _qkv_inputs(11, 2, 12, 4, 2, 8)
    pos_q = np.array([3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14], np.int32)
    pos_k = np.array([0, 2, 4, 6, 8, 10, 12, 14, 16, 18, 20, 22], np.int32)
    out = tattn.reference_attention(
        _t(q), _t(k), _t(v), positions_q=torch.from_numpy(pos_q),
        positions_k=torch.from_numpy(pos_k))
    ref = jattn.reference_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        positions_q=jnp.asarray(pos_q), positions_k=jnp.asarray(pos_k))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("causal", [True, False])
def test_blockwise_attention_matches_jax(causal):
    q, k, v = _qkv_inputs(3, 2, 40, 4, 2, 8)           # 40 % 16 != 0
    out = tattn.blockwise_attention(_t(q), _t(k), _t(v), causal=causal,
                                    block_k=16)
    ref = jattn.blockwise_attention(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), causal=causal,
                                    block_k=16)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-4,
                               atol=2e-5)
    # and against the port's own reference, as the JAX test holds it
    np.testing.assert_allclose(
        out.numpy(), tattn.reference_attention(
            _t(q), _t(k), _t(v), causal=causal).numpy(), rtol=2e-4,
        atol=2e-5)


def test_blockwise_attention_grad_matches_jax():
    q, k, v = _qkv_inputs(3, 2, 40, 4, 2, 8)
    jk, jv = jnp.asarray(k), jnp.asarray(v)
    jgrad = jax.grad(lambda q_: jattn.blockwise_attention(
        q_, jk, jv, block_k=16).sum())(jnp.asarray(q))
    tq = _t(q).requires_grad_()
    tattn.blockwise_attention(tq, _t(k), _t(v), block_k=16).sum().backward()
    np.testing.assert_allclose(tq.grad.numpy(), np.asarray(jgrad),
                               rtol=1e-4, atol=1e-5)


FLASH_CASES = [
    # (seed, B, S, H, Hkv, D, causal): tests/test_ops.py:314-338
    (0, 2, 256, 4, 2, 32, True),
    (0, 2, 256, 4, 2, 32, False),
    (1, 1, 192, 2, 2, 16, True),                # tail block
]


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_plain_matches_pallas_interpret(case):
    seed, B, S, H, Hkv, D, causal = case
    q, k, v = _qkv_inputs(seed, B, S, H, Hkv, D)
    pallas = jattn.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal, 128, 128, True)
    before = tattn.flash_attention_kernel.launches
    out = tattn.flash_attention_kernel(_t(q), _t(k), _t(v), causal)
    assert tattn.flash_attention_kernel.launches == before
    np.testing.assert_allclose(out.numpy(), np.asarray(pallas), rtol=2e-4,
                               atol=2e-5)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sq,sk", [(96, 160), (160, 96)])
def test_flash_plain_sq_ne_sk_matches_pallas_interpret(sq, sk, causal):
    """Sq != Sk, causal aligned top-left as in the JAX kernel."""
    rng = np.random.default_rng(sq + sk)
    q = rng.normal(size=(1, sq, 4, 16)).astype(np.float32)
    k = rng.normal(size=(1, sk, 2, 16)).astype(np.float32)
    v = rng.normal(size=(1, sk, 2, 16)).astype(np.float32)
    pallas = jattn.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal, 128, 128, True)
    out = tattn.flash_attention_kernel(_t(q), _t(k), _t(v), causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(pallas), rtol=2e-4,
                               atol=2e-5)


def test_flash_plain_bf16_matches_pallas_interpret():
    q, k, v = _qkv_inputs(4, 1, 160, 4, 2, 32)
    jargs = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
    pallas = jattn.flash_attention(*jargs, True, 128, 128, True)
    out = tattn.flash_attention_kernel(*(_t(a, torch.bfloat16)
                                         for a in (q, k, v)), True)
    assert out.dtype == torch.bfloat16
    # the same bf16 inputs and f32 sums; outputs within two bf16 ulps
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(pallas, np.float32), rtol=1.6e-2,
                               atol=5e-3)


def test_flash_function_grads_match_jax():
    q, k, v = _qkv_inputs(2, 1, 128, 2, 2, 16)

    def f_flash(q, k, v):
        return (jattn.flash_attention(q, k, v, True, 64, 64, True) ** 2).sum()

    jgrads = jax.grad(f_flash, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (_t(a).requires_grad_() for a in (q, k, v))
    (tattn.flash_attention(tq, tk, tv, True) ** 2).sum().backward()
    for t, j in zip((tq, tk, tv), jgrads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j), rtol=5e-3,
                                   atol=5e-4)
    # inputs that need no grad get none
    tq = _t(q).requires_grad_()
    (tattn.flash_attention(tq, _t(k), _t(v), True) ** 2).sum().backward()
    assert tq.grad is not None


def test_attention_dispatcher_takes_the_reference_on_cpu():
    q, k, v = _qkv_inputs(5, 1, 128, 4, 2, 128)        # tiles cleanly
    before = tattn.flash_attention_kernel.launches
    out = tattn.attention(_t(q), _t(k), _t(v))
    ref = tattn.reference_attention(_t(q), _t(k), _t(v))
    assert torch.equal(out, ref)
    assert tattn.flash_attention_kernel.launches == before
    ref = jattn.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)


def test_flash_wrapper_rejects_bad_shapes():
    q, k, v = _qkv_inputs(6, 1, 16, 3, 2, 8)            # 3 % 2 != 0
    with pytest.raises(ValueError, match="multiple"):
        tattn.flash_attention_kernel(_t(q), _t(k), _t(v))
    with pytest.raises(ValueError, match="expected"):
        tattn.flash_attention_kernel(_t(q)[0], _t(k), _t(v))
    with pytest.raises(ValueError, match="no kernel for device"):
        tattn.check_kernel_tensors("x", _t(q), _t(k), _t(v))


# ---------------------------------------------------------------------------
# the port imports nothing of JAX
# ---------------------------------------------------------------------------

def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_imports_neither_jax_nor_ray_tpu():
    files = sorted((REPO / "ray_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 10
    for path in files:
        roots = set(_imported_roots(path))
        assert not roots & {"jax", "jaxlib", "ray_tpu"}, (path, roots)


def _imports_with_scope(path):
    """(root, inside a function) for each absolute import of ``path``."""
    tree = ast.parse(path.read_text(), filename=str(path))
    found = []

    def visit(node, in_function):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.Import):
                found.extend((a.name.split(".")[0], in_function)
                             for a in child.names)
            elif isinstance(child, ast.ImportFrom) and child.level == 0:
                found.append((child.module.split(".")[0], in_function))
            visit(child, in_function or isinstance(
                child, (ast.FunctionDef, ast.AsyncFunctionDef)))

    visit(tree, False)
    return found


def test_port_imports_only_the_stdlib_torch_and_numpy():
    """The card's machine has torch and numpy, not optax, pyarrow or JAX:
    the port and chip_smoke.py import nothing else outside the stdlib and
    the port itself. The one exception copies JAX's tokenizer: a lazy
    ``transformers`` import inside a function of ``llm/tokenizer.py``."""
    import sys
    allowed = set(sys.stdlib_module_names) | {"torch", "numpy",
                                              "ray_tpu_torch"}
    files = sorted((REPO / "ray_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    lazy = []
    for path in files:
        for root, in_function in _imports_with_scope(path):
            if root == "transformers" and path.name == "tokenizer.py":
                assert in_function, path
                lazy.append(path)
                continue
            assert root in allowed, (path, root)
    assert lazy == [REPO / "ray_tpu_torch" / "llm" / "tokenizer.py"]
