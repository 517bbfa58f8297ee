"""Context parallelism of the PyTorch port held against the JAX package:
ring and Ulysses attention over an ``sp`` mesh axis, Llama trained on
fsdp 2 x sp 2 x tp 2 with each, what an sp>1 mesh refuses, and explicit
positions on a mesh.

JAX runs in this process on the 8 virtual CPU devices of tests/conftest.py;
the port's ranks are gloo CPU processes (``spawn_ranks``) running the JAX-free
bodies of tests/torch_rank_bodies.py, one spawn of 4 ranks and one of 8 for
the module, in a thread while JAX computes. Inputs from numpy seeds; weights
are JAX's, converted with ``params_from_numpy``. Bars are JAX's own: ring
and Ulysses forward rtol 2e-4 / atol 2e-5, ring gradients rtol 1e-4 / atol
1e-5, Ulysses gradients rtol 2e-3 / atol 2e-4 (tests/test_ops.py:87-240);
the train steps tests/test_torch_spmd.py's; positions rtol 1e-4.
"""

import dataclasses
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

import torch_rank_bodies as bodies
from ray_tpu.models import LlamaConfig as JLlamaConfig
from ray_tpu.models import LlamaModel as JLlamaModel
from ray_tpu.ops.attention import reference_attention as j_reference
from ray_tpu.ops.ring_attention import ring_attention_sharded as j_ring
from ray_tpu.ops.ulysses import ulysses_attention_sharded as j_ulysses
from ray_tpu.parallel import mesh as jmesh
from ray_tpu.train.spmd import make_train_step as j_make_train_step
from ray_tpu.train.spmd import shard_batch as j_shard_batch
from ray_tpu_torch.parallel import spawn_ranks
from test_torch_spmd import _assert_params, _jax_named

FWD = dict(rtol=2e-4, atol=2e-5)
# name -> (mesh, port attention_impl, JAX attention_impl)
STEPS = {"ring-fsdp2-sp2-tp2": (dict(fsdp=2, sp=2, tp=2), "ring", "ring"),
         "ulysses-fsdp2-sp2-tp2": (dict(fsdp=2, sp=2, tp=2), "ulysses",
                                   "ulysses")}


def _normal(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def _op_inputs():
    """tests/test_ops.py's cases: (q, k, v[, cotangent]) as numpy."""
    out = {}
    rng = np.random.default_rng(0)
    out["ring"] = (_normal(rng, 2, 32, 4, 8), _normal(rng, 2, 32, 2, 8),
                   _normal(rng, 2, 32, 2, 8))
    q = _normal(np.random.default_rng(1), 1, 16, 2, 4)
    out["ring_full"] = (q, q, q)
    rng = np.random.default_rng(2)
    out["ring_grad"] = tuple(_normal(rng, 1, 32, 2, 4) for _ in range(4))
    rng = np.random.default_rng(3)
    out["ulysses"] = (_normal(rng, 2, 32, 4, 8), _normal(rng, 2, 32, 2, 8),
                      _normal(rng, 2, 32, 2, 8))
    rng = np.random.default_rng(4)
    out["ulysses_ring"] = tuple(_normal(rng, 1, 64, 4, 8) for _ in range(3))
    rng = np.random.default_rng(5)
    out["ulysses_grad"] = tuple(_normal(rng, 1, 32, 4, 8) for _ in range(4))
    z = np.zeros((1, 32, 3, 8), np.float32)        # 3 heads, sp=4
    out["ulysses_heads"] = (z, z, z)
    return out


def _jmesh(n):
    return Mesh(np.array(jax.devices()[:n]), ("sp",))


def _jax_op(fn, n, q, k, v, cot=None, **kw):
    q, k, v = (jnp.asarray(t) for t in (q, k, v))

    def run(q, k, v):
        return fn(q, k, v, _jmesh(n), batch_axes=(), head_axis=None, **kw)
    if cot is None:
        return np.asarray(jax.jit(run)(q, k, v))
    grads = jax.jit(jax.grad(lambda *a: (run(*a) * jnp.asarray(cot)).sum(),
                             argnums=(0, 1, 2)))(q, k, v)
    return np.asarray(jax.jit(run)(q, k, v)), [np.asarray(g) for g in grads]


def _jax_reference_grads(q, k, v, cot):
    return [np.asarray(g) for g in jax.grad(
        lambda *a: (j_reference(*a, causal=True) * jnp.asarray(cot)).sum(),
        argnums=(0, 1, 2))(*(jnp.asarray(t) for t in (q, k, v)))]


def _llama_cfg():
    return dataclasses.replace(JLlamaConfig.debug(), dtype=jnp.float32)


def _tokens(seed=0):
    return np.random.default_rng(seed).integers(0, 256, (4, 32))


@pytest.fixture(scope="module")
def runs():
    """The port's results (one spawn of 4 ranks, one of 8) and JAX's
    two-step references on the same meshes."""
    inputs = _op_inputs()
    tree = jax.tree.map(np.asarray, JLlamaModel(_llama_cfg()).init(
        jax.random.key(0)))
    tokens = _tokens()
    pos_tokens = tokens[:, :16]
    positions = np.array([3, 5, 6, 9, 10, 11, 20, 21, 22, 23, 30, 31, 40,
                          41, 42, 43])
    cases = [(name, "llama", spec, tree, tokens,
              dict(attention_impl=impl))
             for name, (spec, impl, _) in STEPS.items()]

    def port():
        four = spawn_ranks(4, bodies.context_four, inputs, tree, pos_tokens,
                           positions)[0]
        eight = spawn_ranks(8, bodies.two_steps, cases)[0]
        return four, eight

    with ThreadPoolExecutor(1) as pool:
        port_future = pool.submit(port)
        jax_steps = {}
        host = (jnp.asarray(tokens, jnp.int32),
                jnp.asarray(np.roll(tokens, -1, 1), jnp.int32))
        for name, (spec, _, jimpl) in STEPS.items():
            cfg = dataclasses.replace(_llama_cfg(), attention_impl=jimpl)
            s = jmesh.MeshSpec(**spec)
            mesh = jmesh.build_mesh(s, jax.devices()[:s.num_devices])
            ts = j_make_train_step(JLlamaModel(cfg, mesh=mesh), mesh=mesh)
            params, opt = ts.init_fn(jax.random.key(0))
            grad = _jax_named(jax.grad(JLlamaModel(cfg).loss)(
                jax.tree.map(jnp.asarray, tree), *host))
            batch = j_shard_batch(host, ts)
            metrics = []
            for _ in range(2):
                params, opt, m = ts.step_fn(params, opt, batch)
                metrics.append((float(m["loss"]), float(m["grad_norm"])))
            jax_steps[name] = (metrics, _jax_named(params), grad)
        s = jmesh.MeshSpec(dp=2, tp=2)
        mesh = jmesh.build_mesh(s, jax.devices()[:4])
        jpos = np.asarray(JLlamaModel(_llama_cfg(), mesh=mesh).apply(
            jax.tree.map(jnp.asarray, tree), jnp.asarray(pos_tokens),
            jnp.asarray(positions)))
        four, eight = port_future.result()
    return {"inputs": inputs, "tree": tree, "four": four, "eight": eight,
            "jax_steps": jax_steps, "jax_positions": jpos}


# ---------------------------------------------------------------------------
# ring attention (tests/test_ops.py:87-139)
# ---------------------------------------------------------------------------

def test_ring_attention_sp4_matches_jax_and_the_reference(runs):
    q, k, v = runs["inputs"]["ring"]
    got = runs["four"]["ops"]["ring"]
    np.testing.assert_allclose(got, _jax_op(j_ring, 4, q, k, v), **FWD)
    np.testing.assert_allclose(got, np.asarray(j_reference(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True)), **FWD)


def test_ring_attention_noncausal_sp2(runs):
    q, k, v = runs["inputs"]["ring_full"]
    got = runs["four"]["ops"]["ring_full"]
    np.testing.assert_allclose(got, _jax_op(j_ring, 2, q, k, v,
                                            causal=False), **FWD)
    np.testing.assert_allclose(got, np.asarray(j_reference(
        jnp.asarray(q), jnp.asarray(q), jnp.asarray(q), causal=False)),
        **FWD)


def test_ring_attention_gradients_match_jax(runs):
    q, k, v, cot = runs["inputs"]["ring_grad"]
    out, grads = runs["four"]["ops"]["ring_grad"]
    jout, jgrads = _jax_op(j_ring, 4, q, k, v, cot)
    np.testing.assert_allclose(out, jout, **FWD)
    for a, b, c in zip(grads, jgrads, _jax_reference_grads(q, k, v, cot)):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(a, c, rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# Ulysses (tests/test_ops.py:169-240)
# ---------------------------------------------------------------------------

def test_ulysses_sp4_with_grouped_kv_matches_jax(runs):
    """Hkv 2 on sp 4: the lcm(Hkv, sp) repeat before the swap."""
    q, k, v = runs["inputs"]["ulysses"]
    got = runs["four"]["ops"]["ulysses"]
    np.testing.assert_allclose(got, _jax_op(j_ulysses, 4, q, k, v), **FWD)
    np.testing.assert_allclose(got, np.asarray(j_reference(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True)), **FWD)


def test_ulysses_matches_ring(runs):
    uly, ring = runs["four"]["ops"]["ulysses_ring"]
    np.testing.assert_allclose(uly, ring, **FWD)
    q, k, v = runs["inputs"]["ulysses_ring"]
    np.testing.assert_allclose(uly, _jax_op(j_ulysses, 4, q, k, v), **FWD)


def test_ulysses_gradients_match_jax(runs):
    q, k, v, cot = runs["inputs"]["ulysses_grad"]
    out, grads = runs["four"]["ops"]["ulysses_grad"]
    jout, jgrads = _jax_op(j_ulysses, 4, q, k, v, cot)
    np.testing.assert_allclose(out, jout, **FWD)
    for a, b, c in zip(grads, jgrads, _jax_reference_grads(q, k, v, cot)):
        np.testing.assert_allclose(a, b, rtol=2e-3, atol=2e-4)
        np.testing.assert_allclose(a, c, rtol=2e-3, atol=2e-4)


def test_ulysses_refuses_heads_sp_does_not_divide(runs):
    err = runs["four"]["ops"]["ulysses_heads"]
    assert err.startswith("ValueError") and "divisible" in err
    with pytest.raises(ValueError, match="divisible"):
        _jax_op(j_ulysses, 4, *runs["inputs"]["ulysses_heads"])


# ---------------------------------------------------------------------------
# Llama on fsdp 2 x sp 2 x tp 2, and what sp > 1 refuses
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(STEPS))
def test_llama_context_parallel_steps_match_jax(runs, name):
    """Two AdamW steps with ring or Ulysses attention against JAX's on the
    same mesh and against the port's one-device steps."""
    jmetrics, jparams, grad = runs["jax_steps"][name]
    (metrics, params, placed), (plain_metrics, plain_params, _) = \
        runs["eight"][name]
    start = _jax_named(runs["tree"])
    np.testing.assert_allclose(np.array(metrics), np.array(jmetrics),
                               rtol=1e-4)
    _assert_params(params, jparams, start, grad, f"{name} vs JAX")
    np.testing.assert_allclose(np.array(metrics), np.array(plain_metrics),
                               rtol=1e-4)
    _assert_params(params, plain_params, start, grad,
                   f"{name} vs one device")
    assert "Shard(dim=2)" in placed["layers/wq"]          # heads over tp


def test_sp_mesh_refuses_explicit_positions(runs):
    err = runs["four"]["sp_positions"]
    assert err.startswith("NotImplementedError") and "sp>1" in err


def test_explicit_positions_on_a_mesh_match_jax(runs):
    """The repaired refusal: positions on a dp 2 x tp 2 mesh compute as
    JAX's ``LlamaModel(cfg, mesh).apply(params, tokens, positions)``."""
    np.testing.assert_allclose(runs["four"]["positions"],
                               runs["jax_positions"], rtol=1e-4, atol=1e-5)
