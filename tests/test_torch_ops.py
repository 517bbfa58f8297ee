"""Ops of the PyTorch port held against the JAX package on the CPU.

The same numpy inputs (from a seed) go through ``ray_tpu`` and
``ray_tpu_torch``; the Pallas kernels run in interpret mode, as the JAX
package's own tests run them. The CUDA kernels themselves are held against
these plain versions on the card by tests/test_torch_kernels.py.
"""

import ast
import pathlib

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
from ray_tpu_torch.ops.attention import repeat_kv
from ray_tpu_torch.ops.norms import layer_norm, rms_norm
from ray_tpu_torch.ops.rope import apply_rope, rope_frequencies

REPO = pathlib.Path(__file__).resolve().parents[1]


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
