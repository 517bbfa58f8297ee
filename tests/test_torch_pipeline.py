"""Pipeline and expert parallelism of the PyTorch port held against the JAX
package: ``pipelined`` against running the stages in order, the
stage-stacked param layout, ``PipelinedLlama``'s loss and SGD step against
JAX's on the same meshes, its refusals, and the MoE's expert all-to-all
trained on dp 2 x tp 2 x ep 2 and ep 4.

JAX runs in this process on the 8 virtual CPU devices of tests/conftest.py;
the port's ranks are gloo CPU processes (``spawn_ranks``; one spawn of 8
ranks and one of 4 for the module, in a thread while JAX computes) running
the JAX-free bodies of tests/torch_rank_bodies.py. Bars are JAX's own:
``pipelined`` rtol 1e-4 / atol 1e-5 (tests/test_parallel.py:62-112),
``PipelinedLlama``'s loss rtol 2e-5 / atol 2e-5 and its SGD step's params
rtol 5e-4 / atol 5e-5 (tests/test_pipeline_llama.py:51-120); the MoE steps
tests/test_torch_spmd.py's.
"""

import dataclasses
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_rank_bodies as bodies
from ray_tpu.models import MoEConfig as JMoEConfig
from ray_tpu.models import MoEModel as JMoEModel
from ray_tpu.models.llama import LlamaConfig as JLlamaConfig
from ray_tpu.models.llama import LlamaModel as JLlamaModel
from ray_tpu.models.llama_pp import PipelinedLlama as JPipelinedLlama
from ray_tpu.models.llama_pp import stack_stages as j_stack
from ray_tpu.parallel import mesh as jmesh
from ray_tpu.parallel.pipeline import pipelined as j_pipelined
from ray_tpu.train.spmd import make_train_step as j_make_train_step
from ray_tpu.train.spmd import shard_batch as j_shard_batch
from ray_tpu_torch.models import MoEConfig, MoEModel, params_from_numpy
from ray_tpu_torch.models.llama_pp import stack_stages, unstack_stages
from ray_tpu_torch.parallel import spawn_ranks
from test_torch_spmd import _assert_params, _jax_named

PP = dict(rtol=1e-4, atol=1e-5)
# name -> mesh of the expert all-to-all's two AdamW steps
MOE = {"alltoall-dp2-tp2-ep2": dict(dp=2, tp=2, ep=2),
       "alltoall-ep4": dict(ep=4)}


def _jcfg(**kw):
    """tests/test_pipeline_llama.py's config."""
    base = dict(vocab_size=128, dim=32, n_layers=4, n_heads=4, n_kv_heads=2,
                ffn_dim=64, max_seq_len=32, remat=False, dtype=jnp.float32)
    base.update(kw)
    return JLlamaConfig(**base)


def _jmesh(**axes):
    s = jmesh.MeshSpec(**axes)
    return jmesh.build_mesh(s, jax.devices()[:s.num_devices])


def _tokens(batch, seed):
    return np.random.default_rng(seed).integers(0, 128, (batch, 32))


def _tanh_stage(w, x):
    return jnp.tanh(x @ w)


def _inputs():
    rng = np.random.default_rng(0)
    fwd = ((rng.normal(size=(4, 16, 16)) * 0.3).astype(np.float32),
           rng.normal(size=(32, 16)).astype(np.float32))
    grad = ((rng.normal(size=(2, 8, 8)) * 0.3).astype(np.float32),
            rng.normal(size=(32, 8)).astype(np.float32))
    return {"forward": fwd, "grad": grad, "tokens": _tokens(4, 0),
            "tokens8": _tokens(8, 1)}


def _moe_tree():
    cfg = dataclasses.replace(JMoEConfig.debug_moe(), dtype=jnp.float32)
    return jax.tree.map(np.array, JMoEModel(cfg).init(jax.random.key(0)))


def _jax_side(inputs, params, moe_tree):
    """JAX's references: ``pipelined`` and its gradient, the pipelined
    losses, the SGD steps (pipelined and pp=1) and the MoE steps."""
    out = {}
    ws, batch = (jnp.asarray(t) for t in inputs["forward"])
    out["forward"] = np.asarray(jax.jit(j_pipelined(
        _tanh_stage, _jmesh(**jmesh.MeshSpec.auto(8, pp=4).sizes()),
        num_microbatches=8))(ws, batch))
    ws, batch = (jnp.asarray(t) for t in inputs["grad"])
    run = j_pipelined(_tanh_stage,
                      _jmesh(**jmesh.MeshSpec.auto(8, pp=2).sizes()),
                      num_microbatches=4)
    out["grad"] = np.asarray(jax.jit(jax.grad(
        lambda w: jnp.mean(run(w, batch) ** 2)))(ws))
    cfg = _jcfg()
    for name, mesh, micro, p, tok in (
            ("loss_pp2", _jmesh(pp=2, dp=2, tp=2), 2, params[0],
             inputs["tokens"]),
            ("loss_pp4", _jmesh(pp=4, dp=2), 4, params[1],
             inputs["tokens8"])):
        stages = mesh.shape["pp"]
        tok = jnp.asarray(tok, jnp.int32)
        model = JPipelinedLlama(cfg, mesh, num_microbatches=micro)
        out[name] = (float(model.loss(j_stack(p, stages), tok,
                                      jnp.roll(tok, -1, axis=1))),
                     float(JLlamaModel(cfg).loss(p, tok,
                                                 jnp.roll(tok, -1, axis=1))))
    tok = jnp.asarray(inputs["tokens"], jnp.int32)
    host = (tok, jnp.roll(tok, -1, axis=1))
    mesh = _jmesh(pp=2, dp=2, tp=2)
    # both inits draw params[0] (key 0), the pipelined one stacked
    ts = j_make_train_step(JPipelinedLlama(cfg, mesh, num_microbatches=2),
                           optax.sgd(1e-2), mesh=mesh, donate=False)
    p1, o1 = ts.init_fn(jax.random.key(0))
    p1, _, m1 = ts.step_fn(p1, o1, j_shard_batch(host, ts))
    ts0 = j_make_train_step(JLlamaModel(cfg), optax.sgd(1e-2), donate=False)
    p0, o0 = ts0.init_fn(jax.random.key(0))
    p0, _, m0 = ts0.step_fn(p0, o0, host)
    out["sgd"] = (float(m1["loss"]), _jax_named(p1), float(m0["loss"]),
                  _jax_named(p0))
    out["moe"] = {}
    tokens = np.random.default_rng(0).integers(0, 256, (4, 32))
    host = (jnp.asarray(tokens, jnp.int32),
            jnp.asarray(np.roll(tokens, -1, 1), jnp.int32))
    mcfg = dataclasses.replace(JMoEConfig.debug_moe(), dtype=jnp.float32,
                               moe_dispatch="alltoall")
    for name, spec in MOE.items():
        mesh = _jmesh(**spec)
        model = JMoEModel(mcfg, mesh=mesh)
        ts = j_make_train_step(model, mesh=mesh)
        p, opt = ts.init_fn(jax.random.key(0))
        grad = _jax_named(jax.jit(jax.grad(model.loss))(p, *host))
        batch = j_shard_batch(host, ts)
        metrics = []
        for _ in range(2):
            p, opt, m = ts.step_fn(p, opt, batch)
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
        out["moe"][name] = (metrics, _jax_named(p), grad, tokens)
    return out


@pytest.fixture(scope="module")
def runs():
    inputs = _inputs()
    cfg = _jcfg()
    params = [JLlamaModel(cfg).init(jax.random.key(k)) for k in (0, 1)]
    trees = {"pp2": jax.tree.map(np.array, j_stack(params[0], 2)),
             "pp4": jax.tree.map(np.array, j_stack(params[1], 4))}
    moe_tree = _moe_tree()
    tokens = np.random.default_rng(0).integers(0, 256, (4, 32))
    cases = [(name, "moe", spec, moe_tree, tokens,
              dict(moe_dispatch="alltoall")) for name, spec in MOE.items()]

    def port():
        eight = spawn_ranks(8, bodies.pipeline_eight, inputs, trees,
                            cases[:1])[0]
        eight["moe"].update(spawn_ranks(4, bodies.two_steps, cases[1:])[0])
        return eight

    with ThreadPoolExecutor(1) as pool:
        port_future = pool.submit(port)
        jax_out = _jax_side(inputs, params, moe_tree)
        port_out = port_future.result()
    return {"inputs": inputs, "jax": jax_out, "port": port_out,
            "params": params, "moe_tree": moe_tree}


# ---------------------------------------------------------------------------
# the GPipe schedule (tests/test_parallel.py:62-112)
# ---------------------------------------------------------------------------

def test_pipelined_matches_running_the_stages_in_order(runs):
    """pp 4 (x dp 2), 8 microbatches."""
    ws, batch = runs["inputs"]["forward"]
    want = batch
    for w in ws:
        want = np.tanh(want @ w)
    got = runs["port"]["forward"]
    np.testing.assert_allclose(got, want, **PP)
    np.testing.assert_allclose(got, runs["jax"]["forward"], **PP)


def test_pipelined_gradient_matches_the_stages_in_order(runs):
    """pp 2 (x dp 4), 4 microbatches: the backward runs every exchange in
    reverse on every rank."""
    ws, batch = (torch.from_numpy(t) for t in runs["inputs"]["grad"])
    ws.requires_grad_(True)
    x = batch
    for i in range(ws.shape[0]):
        x = torch.tanh(x @ ws[i])
    (x ** 2).mean().backward()
    got = runs["port"]["grad"]
    assert np.abs(got).sum() > 0
    np.testing.assert_allclose(got, ws.grad.numpy(), **PP)
    np.testing.assert_allclose(got, runs["jax"]["grad"], **PP)


# ---------------------------------------------------------------------------
# PipelinedLlama (tests/test_pipeline_llama.py)
# ---------------------------------------------------------------------------

def test_stack_unstack_roundtrip(runs):
    tree = jax.tree.map(np.array, runs["params"][0])
    cfg = bodies.pp_config()
    params = params_from_numpy(tree, cfg, device="cpu",
                               param_dtype=torch.float32)
    stacked = stack_stages(params, 2)
    assert tuple(stacked["layers"]["wq"].shape[:2]) == (2, 2)
    # JAX's stacked layout converts as it is, and unstacks to the same
    jstacked = params_from_numpy(jax.tree.map(np.array, j_stack(
        runs["params"][0], 2)), cfg, device="cpu",
        param_dtype=torch.float32)
    for name, t in stacked["layers"].items():
        assert torch.equal(t, jstacked["layers"][name])
    back = unstack_stages(stacked)
    for name, t in back["layers"].items():
        assert torch.equal(t, params["layers"][name])


@pytest.mark.parametrize("name", ["loss_pp2", "loss_pp4"])
def test_pipelined_llama_loss_matches_jax_and_pp1(runs, name):
    """pp 2 x dp 2 x tp 2 with 2 microbatches; pp 4 x dp 2 with 4."""
    jloss, jloss_pp1 = runs["jax"][name]
    got = runs["port"][name]
    assert np.isfinite(got)
    np.testing.assert_allclose(got, jloss, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got, jloss_pp1, rtol=2e-5, atol=2e-5)


def test_pipelined_llama_sgd_step_matches_jax(runs):
    """One SGD step on pp 2 x dp 2 x tp 2: the gradient flows back through
    the schedule, and the updated params match JAX's pipelined step and its
    pp=1 step."""
    loss, params = runs["port"]["sgd"]
    jloss, jparams, jloss_pp1, jparams_pp1 = runs["jax"]["sgd"]
    np.testing.assert_allclose(loss, jloss, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(loss, jloss_pp1, rtol=2e-5, atol=2e-5)
    assert set(params) == set(jparams)
    for name, t in params.items():
        np.testing.assert_allclose(t, jparams[name], rtol=5e-4, atol=5e-5,
                                   err_msg=name)
        flat = t.reshape((-1,) + t.shape[2:]) if name.startswith(
            "layers/") else t
        np.testing.assert_allclose(flat, jparams_pp1[name], rtol=5e-4,
                                   atol=5e-5, err_msg=name)


def test_pipelined_llama_refuses_what_jax_refuses(runs):
    err = runs["port"]["refusals"]
    assert err["pp1"].startswith("ValueError") and "pp>=2" in err["pp1"]
    assert err["layers"].startswith("ValueError") and "not divisible" in \
        err["layers"]
    assert err["sp"].startswith("ValueError") and "sp/ep" in err["sp"]


# ---------------------------------------------------------------------------
# the MoE's expert all-to-all (tests/test_ops.py:245-266, MULTICHIP's mesh)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(MOE))
def test_moe_alltoall_steps_match_jax(runs, name):
    """Two AdamW steps of the all-to-all scheme against JAX's on the same
    mesh; the router's gradient runs through the ep mean of the aux loss."""
    jmetrics, jparams, grad, _ = runs["jax"]["moe"][name]
    (metrics, params, placed), = runs["port"]["moe"][name]
    start = _jax_named(runs["moe_tree"])
    np.testing.assert_allclose(np.array(metrics), np.array(jmetrics),
                               rtol=1e-4)
    _assert_params(params, jparams, start, grad, f"{name} vs JAX")
    assert not np.array_equal(params["layers/router"],
                              start["layers/router"])
    assert placed["layers/e_gate"][-1] == "Shard(dim=1)"      # over ep


def test_moe_alltoall_needs_a_mesh():
    cfg = dataclasses.replace(MoEConfig.debug_moe(), dtype=torch.float32,
                              moe_dispatch="alltoall")
    model = MoEModel(cfg, device="cpu")
    tokens = torch.zeros((2, 8), dtype=torch.int64)
    with pytest.raises(ValueError, match="needs a device mesh"):
        model.loss(model.init(0, param_dtype=torch.float32), tokens, tokens)
