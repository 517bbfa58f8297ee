"""The port's sharded train step held against the JAX package's on the same
meshes, its undonated step (``donate=False``), and the GPT-2 DP example
(the Llama FSDP example is in tests/test_torch_parallel.py).

JAX runs in this process on the 8 virtual CPU devices of tests/conftest.py:
``make_train_step(model, mesh=mesh)`` from its sharded init, two steps of
its default ``optax.adamw(3e-4, weight_decay=0.1)``. The port's ranks
(``spawn_ranks``, gloo, tests/torch_rank_bodies.py) start from the same
params, converted with ``params_from_numpy(..., mesh=)``, and take two steps
of the default AdamW on the same mesh and two on one device. Debug widths,
f32, batch 4 x 32.

Bars (tests/test_torch_train.py's): loss and grad norm rtol 1e-4; params
after two steps rtol 1e-4, atol 1e-5, except where JAX's first gradient is
at f32 rounding level (0 < |g| < 1e-7), whose elements are held to Adam's
step bound (2.2 x lr), as tests/test_torch_models.py does; the sharded port
against its own one-device step at the same bars.
"""

import dataclasses
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_rank_bodies as bodies
from ray_tpu.models import GPT2Config as JGPT2Config
from ray_tpu.models import GPT2Model as JGPT2Model
from ray_tpu.models import LlamaConfig as JLlamaConfig
from ray_tpu.models import LlamaModel as JLlamaModel
from ray_tpu.models import MoEConfig as JMoEConfig
from ray_tpu.models import MoEModel as JMoEModel
from ray_tpu.parallel import mesh as jmesh
from ray_tpu.train.spmd import make_train_step as j_make_train_step
from ray_tpu.train.spmd import shard_batch as j_shard_batch
from ray_tpu_torch.examples import train_gpt2_dp
from ray_tpu_torch.models import LlamaConfig, LlamaModel, params_from_numpy
from ray_tpu_torch.parallel import spawn_ranks
from ray_tpu_torch.train import make_train_step, shard_batch
from ray_tpu_torch.train.spmd import param_leaves

LR = 3e-4
JAX = {"llama": (JLlamaConfig.debug, JLlamaModel),
       "gpt2": (JGPT2Config.debug, JGPT2Model),
       "moe": (JMoEConfig.debug_moe, JMoEModel)}
# name -> (family, mesh, port config overrides)
CASES = {
    "llama-fsdp2-tp2": ("llama", dict(fsdp=2, tp=2), {}),
    "gpt2-fsdp2-tp2": ("gpt2", dict(fsdp=2, tp=2), {}),
    "moe-ep4": ("moe", dict(ep=4), {}),
    "llama-kernel-dp2-tp2": ("llama", dict(dp=2, tp=2),
                             dict(attention_impl="kernel")),
    "llama-dp2-fsdp2-tp2": ("llama", dict(dp=2, fsdp=2, tp=2), {}),
    "gpt2-dp2": ("gpt2", dict(dp=2), {}),
}


def _tokens(seed=0):
    return np.random.default_rng(seed).integers(0, 256, (4, 32))


def _jax_named(tree):
    return {"/".join(str(k.key) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _jax_case(family, spec):
    make, cls = JAX[family]
    cfg = dataclasses.replace(make(), dtype=jnp.float32)
    s = jmesh.MeshSpec(**spec)
    mesh = jmesh.build_mesh(s, jax.devices()[:s.num_devices])
    return cls(cfg), cls(cfg, mesh=mesh), mesh


@pytest.fixture(scope="module")
def runs():
    """Per case: the starting params (numpy, JAX's init), JAX's metrics of
    two sharded steps, its params after them and its first gradient; and
    the port's two steps, its ranks (one spawn per rank count) running in a
    thread while JAX steps here."""
    tokens = _tokens()
    host = (jnp.asarray(tokens, jnp.int32),
            jnp.asarray(np.roll(tokens, -1, 1), jnp.int32))
    starts = {name: jax.tree.map(np.array, _jax_case(family, spec)[0].init(
        jax.random.key(0))) for name, (family, spec, _) in CASES.items()}
    by_ranks = {}
    for name, (family, spec, kw) in CASES.items():
        n = int(np.prod(list(spec.values())))
        by_ranks.setdefault(n, []).append(
            (name, family, spec, starts[name], tokens, kw))

    def port():
        out = {}
        for n, cases in by_ranks.items():
            out.update(spawn_ranks(n, bodies.two_steps, cases)[0])
        return out

    with ThreadPoolExecutor(1) as pool:
        port_future = pool.submit(port)
        jax_out = {}
        for name, (family, spec, _) in CASES.items():
            plain, model, mesh = _jax_case(family, spec)
            ts = j_make_train_step(model, mesh=mesh)
            params, opt = ts.init_fn(jax.random.key(0))
            grad = _jax_named(jax.grad(plain.loss)(
                jax.tree.map(jnp.asarray, starts[name]), *host))
            batch = j_shard_batch(host, ts)
            metrics = []
            for _ in range(2):
                params, opt, m = ts.step_fn(params, opt, batch)
                metrics.append((float(m["loss"]), float(m["grad_norm"])))
            jax_out[name] = (starts[name], metrics, _jax_named(params), grad)
        return jax_out, port_future.result()


def _assert_params(got, want, start, grad, what):
    """rtol 1e-4 / atol 1e-5, rounding-level gradients held to Adam's
    bound instead."""
    assert set(got) == set(want)
    noise = {n: (np.abs(g) < 1e-7) & (g != 0) for n, g in grad.items()}
    assert sum(int(m.sum()) for m in noise.values()) <= 0.01 * sum(
        t.size for t in got.values())
    for name, t in got.items():
        keep = ~noise[name]
        np.testing.assert_allclose(t[keep], want[name][keep], rtol=1e-4,
                                   atol=1e-5, err_msg=f"{what} {name}")
        for moved in (t, want[name]):
            assert np.all(np.abs(moved - start[name])[~keep] <= 2.2 * LR)
        assert not np.array_equal(t, start[name]), name       # it moved


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_steps_match_jax_on_the_same_mesh(runs, name):
    start, jmetrics, jparams, grad = runs[0][name]
    (metrics, params, placed), (plain_metrics, plain_params, _) = \
        runs[1][name]
    start = _jax_named(start)
    for (loss, gnorm), (jloss, jgnorm) in zip(metrics, jmetrics):
        np.testing.assert_allclose(loss, jloss, rtol=1e-4)
        np.testing.assert_allclose(gnorm, jgnorm, rtol=1e-4)
    _assert_params(params, jparams, start, grad, f"{name} vs JAX")
    # and against the port's own one-device step
    np.testing.assert_allclose(np.array(metrics), np.array(plain_metrics),
                               rtol=1e-4)
    _assert_params(params, plain_params, start, grad,
                   f"{name} vs one device")
    family, spec, _ = CASES[name]
    # every leaf is a DTensor; the sharded ones are sharded as declared
    assert len(placed) == len(params)
    if family == "moe":
        assert placed["layers/e_gate"] == ["Shard(dim=1)"]      # over ep
    if "tp" in spec:
        assert "Shard(dim=2)" in placed["layers/w_gate" if family == "llama"
                                        else "layers/w_up"]


# ---------------------------------------------------------------------------
# donate=False (ROADMAP C1)
# ---------------------------------------------------------------------------

def _llama():
    cfg = dataclasses.replace(LlamaConfig.debug(max_seq_len=32),
                              dtype=torch.float32)
    return LlamaModel(cfg, device="cpu")


def test_make_train_step_takes_donate_and_batch_axes():
    """The keywords of JAX's make_train_step (the old TypeError)."""
    ts = make_train_step(_llama(), donate=False, batch_axes=("dp",))
    params, opt = ts.init_fn(0)
    tokens = _tokens()
    _, _, m = ts.step_fn(params, opt, shard_batch(
        (tokens, np.roll(tokens, -1, 1)), ts))
    assert np.isfinite(float(m["loss"]))


def test_undonated_steps_leave_their_inputs_and_agree():
    """Two donate=False steps from one set of params and optimizer (moments
    already moved) give identical results and leave the inputs bit for bit
    as they were, as JAX's undonated steps do; a donated step then moves
    them."""
    model = _llama()
    ts = make_train_step(model, donate=False)
    donated = make_train_step(model)
    params, opt = donated.init_fn(0)
    tokens = _tokens(1)
    batch = shard_batch((tokens, np.roll(tokens, -1, 1)), ts)
    donated.step_fn(params, opt, batch)              # moments are non-zero
    before = [p.detach().clone() for p in param_leaves(params)]
    state = {i: {k: v.clone() for k, v in s.items()}
             for i, s in opt.state_dict()["state"].items()}
    runs = [ts.step_fn(params, opt, batch) for _ in range(2)]
    for p, b in zip(param_leaves(params), before):
        assert torch.equal(p, b)
    for i, s in opt.state_dict()["state"].items():
        for k, v in s.items():
            assert torch.equal(v, state[i][k]), (i, k)
    (p1, o1, m1), (p2, o2, m2) = runs
    assert p1 is not params and o1 is not opt
    assert torch.equal(m1["loss"], m2["loss"])
    assert torch.equal(m1["grad_norm"], m2["grad_norm"])
    for a, b, c in zip(param_leaves(p1), param_leaves(p2), before):
        assert torch.equal(a, b) and not torch.equal(a, c)
    assert int(o1.state_dict()["state"][0]["step"]) == 2
    # the undonated step equals a donated one from the same state
    _, _, m3 = donated.step_fn(params, opt, batch)
    assert torch.equal(m3["loss"], m1["loss"])
    for a, b in zip(param_leaves(params), param_leaves(p1)):
        assert torch.equal(a, b)


def test_undonated_steps_match_jaxs():
    """Two undonated steps of JAX and of the port from the same params:
    the same loss (rtol 1e-4), JAX's inputs and the port's untouched."""
    jm = JLlamaModel(dataclasses.replace(JLlamaConfig.debug(max_seq_len=32),
                                         dtype=jnp.float32))
    jts = j_make_train_step(jm, donate=False)
    jp, jo = jts.init_fn(jax.random.key(0))
    start = jax.tree.map(np.array, jp)
    tokens = _tokens(2)
    jbatch = (jnp.asarray(tokens), jnp.asarray(np.roll(tokens, -1, 1)))
    model = _llama()
    ts = make_train_step(model, donate=False)
    tp = params_from_numpy(start, model.cfg, device="cpu",
                           param_dtype=torch.float32)
    to = ts.opt_init(tp)
    batch = shard_batch((tokens, np.roll(tokens, -1, 1)), ts)
    for _ in range(2):
        _, _, jm_ = jts.step_fn(jp, jo, jbatch)
        _, _, tm = ts.step_fn(tp, to, batch)
        np.testing.assert_allclose(float(tm["loss"]), float(jm_["loss"]),
                                   rtol=1e-4)
    assert all(np.array_equal(np.asarray(a), b) for a, b in zip(
        jax.tree.leaves(jp), jax.tree.leaves(start)))
    assert not to.state_dict()["state"]              # never stepped


# ---------------------------------------------------------------------------
# the examples, on CPU ranks
# ---------------------------------------------------------------------------

def test_gpt2_dp_example_trains_on_four_ranks():
    runs = spawn_ranks(4, train_gpt2_dp._rank, True, 3)
    losses = runs[0]["losses"]
    assert losses[-1] < losses[0]
    assert all(r["losses"] == losses for r in runs)
    assert "dp=4" in runs[0]["mesh"]
