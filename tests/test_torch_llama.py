"""Llama KV-cache paths of the PyTorch port held against the JAX package.

Debug widths only. JAX params (from ``LlamaModel.init``) are converted with
``params_from_numpy``; inputs come from a numpy seed. In f32 (both sides)
the bar is rtol 1e-4 / atol 1e-4; in bf16 it is the JAX package's own bf16
bar for decode (atol 0.15, rtol 0.05; tests/test_llm_paged.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models.llama import LlamaConfig as JConfig
from ray_tpu.models.llama import LlamaModel as JModel
from ray_tpu_torch.models import LlamaConfig, LlamaModel, params_from_numpy
from ray_tpu_torch.ops.rope import rope_frequencies

F32 = dict(rtol=1e-4, atol=1e-4)
BF16 = dict(rtol=0.05, atol=0.15)
TOL = {"f32": F32, "bf16": BF16}


def _configs(prec, decode="reference", vocab=512, max_seq=128):
    jcfg = JConfig.debug(vocab_size=vocab, max_seq_len=max_seq)
    tcfg = LlamaConfig.debug(vocab_size=vocab, max_seq_len=max_seq)
    if prec == "f32":
        jcfg = dataclasses.replace(jcfg, dtype=jnp.float32)
        tcfg = dataclasses.replace(tcfg, dtype=torch.float32)
    jcfg = dataclasses.replace(
        jcfg, decode_attention="pallas" if decode == "kernel" else "xla")
    tcfg = dataclasses.replace(tcfg, decode_attention=decode)
    return jcfg, tcfg


@pytest.fixture(scope="module")
def jax_params():
    jcfg, _ = _configs("f32")
    return JModel(jcfg).init(jax.random.key(0))


def _models(jax_params, prec, decode="reference"):
    jcfg, tcfg = _configs(prec, decode)
    tree = jax.tree.map(np.asarray, jax_params)
    return (JModel(jcfg), jax_params, LlamaModel(tcfg, device="cpu"),
            params_from_numpy(tree, tcfg, device="cpu"))


def _np(x):
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor)
                      else np.asarray(x, np.float32))


def test_default_device_is_cuda_and_raises_without_one():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    _, tcfg = _configs("f32")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LlamaModel(tcfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_numpy({}, tcfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rope_frequencies(tcfg.head_dim, tcfg.max_seq_len)


def test_config_presets_and_validation():
    cfg = LlamaConfig.llama3_8b()
    assert (cfg.dim, cfg.n_layers, cfg.n_heads, cfg.n_kv_heads,
            cfg.head_dim, cfg.ffn_dim, cfg.vocab_size) == (
        4096, 32, 32, 8, 128, 14336, 128256)
    for name in ("llama3_8b", "llama3_1b", "bench_400m", "debug"):
        assert getattr(LlamaConfig, name)().num_params() == \
            getattr(JConfig, name)().num_params()
    assert cfg.dtype == torch.bfloat16
    with pytest.raises(ValueError):
        LlamaConfig(decode_attention="pallas")


def test_init_layout_dtypes_and_seed():
    _, tcfg = _configs("bf16")
    model = LlamaModel(tcfg, device="cpu")
    p1, p2 = model.init(3), model.init(3)
    jshapes = jax.tree.map(lambda a: a.shape, JModel(_configs("bf16")[0])
                           .init(jax.random.key(0)))
    assert p1["layers"]["wq"].shape == jshapes["layers"]["wq"]
    assert p1["lm_head"].shape == jshapes["lm_head"]
    assert p1["layers"]["wq"].dtype == torch.bfloat16
    assert p1["layers"]["attn_norm"].dtype == torch.float32
    assert torch.equal(p1["layers"]["w_down"], p2["layers"]["w_down"])
    std = p1["layers"]["w_gate"].float().std().item()
    assert abs(std - 64 ** -0.5) < 0.01


@pytest.mark.parametrize("prec", ["f32", "bf16"])
def test_forward_step_prefill_then_decode(jax_params, prec):
    jm, jp, tm, tp = _models(jax_params, prec)
    rng = np.random.default_rng(0)
    B, T, S = 3, 6, 16
    toks = rng.integers(0, 512, (B, T)).astype(np.int32)
    offs = np.array([0, 2, 5], np.int32)
    jc = jm.init_kv_cache(B, S)
    tc = tm.init_kv_cache(B, S)
    jl, jc = jm.forward_step(jp, jnp.asarray(toks), jc, jnp.asarray(offs))
    tl, tc2 = tm.forward_step(tp, torch.from_numpy(toks), tc,
                              torch.from_numpy(offs))
    assert tc2 is tc                                   # updated in place
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL[prec])
    np.testing.assert_allclose(_np(tc["k"]), _np(jc["k"]), **TOL[prec])
    # T == 1 decode step: reference and kernel (plain on CPU) against JAX
    step = rng.integers(0, 512, (B, 1)).astype(np.int32)
    offs2 = offs + T
    jl2, jc2 = jm.forward_step(jp, jnp.asarray(step), jc,
                               jnp.asarray(offs2))
    for decode in ("reference", "kernel"):
        _, tcfg = _configs(prec, decode)
        model = LlamaModel(tcfg, device="cpu")
        cache = {k: v.clone() for k, v in tc.items()}
        tl2, cache = model.forward_step(tp, torch.from_numpy(step), cache,
                                        torch.from_numpy(offs2))
        np.testing.assert_allclose(_np(tl2), _np(jl2), **TOL[prec])
        np.testing.assert_allclose(_np(cache["v"]), _np(jc2["v"]),
                                   **TOL[prec])


def test_forward_step_drops_writes_past_the_cache(jax_params):
    jm, jp, tm, tp = _models(jax_params, "f32")
    toks = np.arange(8, dtype=np.int32).reshape(2, 4) + 5
    offs = np.array([1, 6], np.int32)          # slot 1 writes past S=8
    jl, jc = jm.forward_step(jp, jnp.asarray(toks), jm.init_kv_cache(2, 8),
                             jnp.asarray(offs))
    tl, tc = tm.forward_step(tp, torch.from_numpy(toks),
                             tm.init_kv_cache(2, 8), torch.from_numpy(offs))
    np.testing.assert_allclose(_np(tl), _np(jl), **F32)
    np.testing.assert_allclose(_np(tc["k"]), _np(jc["k"]), **F32)


def _live_pool(rng, model, B, NB, bs, maxb):
    """Random pool contents and distinct block tables (scratch = NB-1)."""
    cfg = model.cfg
    shape = (cfg.n_layers, NB, bs, cfg.n_kv_heads, cfg.head_dim)
    k = rng.normal(size=shape).astype(np.float32)
    v = rng.normal(size=shape).astype(np.float32)
    tables = rng.permutation(NB - 1)[:B * maxb].reshape(B, maxb)
    return k, v, tables.astype(np.int32)


@pytest.mark.parametrize("prec", ["f32", "bf16"])
@pytest.mark.parametrize("decode", ["reference", "kernel"])
def test_decode_step_paged(jax_params, prec, decode):
    jm, jp, tm, tp = _models(jax_params, prec, decode)
    rng = np.random.default_rng(1)
    B, NB, bs, maxb = 4, 16, 8, 3
    k, v, tables = _live_pool(rng, tm, B, NB, bs, maxb)
    tables[2:] = NB - 1                     # two idle slots on scratch
    offs = np.array([5, 17, 0, 0], np.int32)
    toks = np.array([7, 300, 0, 0], np.int32)
    jdt = jnp.float32 if prec == "f32" else jnp.bfloat16
    jpool = {"k": jnp.asarray(k, jdt), "v": jnp.asarray(v, jdt)}
    tpool = {"k": torch.from_numpy(k).to(tm.cfg.dtype),
             "v": torch.from_numpy(v).to(tm.cfg.dtype)}
    jl, jpool = jm.decode_step_paged(jp, jnp.asarray(toks), jpool,
                                     jnp.asarray(tables), jnp.asarray(offs))
    tl, tpool2 = tm.decode_step_paged(tp, torch.from_numpy(toks), tpool,
                                      torch.from_numpy(tables),
                                      torch.from_numpy(offs))
    assert tpool2 is tpool
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL[prec])
    # pools agree everywhere but the scratch block (duplicate writes)
    for name in ("k", "v"):
        np.testing.assert_allclose(_np(tpool[name])[:, :NB - 1],
                                   _np(jpool[name])[:, :NB - 1],
                                   **TOL[prec])


def test_decode_step_paged_drops_write_past_table(jax_params):
    jm, jp, tm, tp = _models(jax_params, "f32")
    rng = np.random.default_rng(2)
    B, NB, bs, maxb = 2, 10, 4, 2
    k, v, tables = _live_pool(rng, tm, B, NB, bs, maxb)
    offs = np.array([3, 8], np.int32)             # slot 1: column 2 >= maxb
    toks = np.array([1, 2], np.int32)
    jl, jpool = jm.decode_step_paged(
        jp, jnp.asarray(toks), {"k": jnp.asarray(k), "v": jnp.asarray(v)},
        jnp.asarray(tables), jnp.asarray(offs))
    tpool = {"k": torch.from_numpy(k), "v": torch.from_numpy(v)}
    tl, _ = tm.decode_step_paged(tp, torch.from_numpy(toks), tpool,
                                 torch.from_numpy(tables),
                                 torch.from_numpy(offs))
    np.testing.assert_allclose(_np(tl), _np(jl), **F32)
    # the dropped write lands in the scratch block (NB-1), which no table
    # names; every other block matches JAX, slot 1's included
    for name in ("k", "v"):
        np.testing.assert_allclose(_np(tpool[name])[:, :NB - 1],
                                   _np(jpool[name])[:, :NB - 1], **F32)


@pytest.mark.parametrize("prec", ["f32", "bf16"])
def test_prefill_with_prefix(jax_params, prec):
    jm, jp, tm, tp = _models(jax_params, prec)
    rng = np.random.default_rng(3)
    cfg = tm.cfg
    N, Tb, Pmax = 3, 8, 16
    shape = (cfg.n_layers, N, Pmax, cfg.n_kv_heads, cfg.head_dim)
    pk = rng.normal(size=shape).astype(np.float32)
    pv = rng.normal(size=shape).astype(np.float32)
    toks = rng.integers(0, 512, (N, Tb)).astype(np.int32)
    plen = np.array([16, 8, 120], np.int32)        # rope past max_seq clamps
    slen = np.array([8, 3, 1], np.int32)
    jdt = jnp.float32 if prec == "f32" else jnp.bfloat16
    jl, jkv = jm.prefill_with_prefix(
        jp, jnp.asarray(toks), jnp.asarray(pk, jdt), jnp.asarray(pv, jdt),
        jnp.asarray(plen), jnp.asarray(slen))
    tl, tkv = tm.prefill_with_prefix(
        tp, torch.from_numpy(toks), torch.from_numpy(pk).to(cfg.dtype),
        torch.from_numpy(pv).to(cfg.dtype), torch.from_numpy(plen),
        torch.from_numpy(slen))
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL[prec])
    np.testing.assert_allclose(_np(tkv["k"]), _np(jkv["k"]), **TOL[prec])
    np.testing.assert_allclose(_np(tkv["v"]), _np(jkv["v"]), **TOL[prec])


def test_prefill_with_prefix_length_out_of_range_like_jax(jax_params):
    """take_along_axis semantics: length 0 wraps to the last row, a length
    past the bucket reads NaN."""
    jm, jp, tm, tp = _models(jax_params, "f32")
    cfg = tm.cfg
    shape = (cfg.n_layers, 2, 8, cfg.n_kv_heads, cfg.head_dim)
    z = np.zeros(shape, np.float32)
    toks = np.ones((2, 4), np.int32)
    plen, slen = np.array([8, 0], np.int32), np.array([0, 5], np.int32)
    jl, _ = jm.prefill_with_prefix(jp, jnp.asarray(toks), jnp.asarray(z),
                                   jnp.asarray(z), jnp.asarray(plen),
                                   jnp.asarray(slen))
    tl, _ = tm.prefill_with_prefix(tp, torch.from_numpy(toks),
                                   torch.from_numpy(z), torch.from_numpy(z),
                                   torch.from_numpy(plen),
                                   torch.from_numpy(slen))
    assert np.isnan(np.asarray(jl)[1]).all() and torch.isnan(tl[1]).all()
    np.testing.assert_allclose(_np(tl)[0], _np(jl)[0], **F32)
