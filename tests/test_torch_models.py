"""The model families of the PyTorch port held against the JAX package: the
MLP, GPT-2, ViT, the einsum-dispatch MoE and its router math.

Debug widths (``*.debug()``, a 64 -> 32 -> 32 -> 10 MLP), seq 32. JAX params
(f32, from each family's ``init``) are converted with ``params_from_numpy``;
inputs come from a numpy seed. MoE attention paths: the port's ``"kernel"``
(its plain version on CPU tensors) against JAX's ``"flash"`` (the Pallas
kernel in interpret mode), ``"blockwise"`` against ``"xla"``. Bars:
``topk_dispatch`` dispatch equal, combine and aux rtol 1e-6; f32 logits, loss
and gradients rtol 1e-4; bf16 loss rtol 1e-3 (tests/test_ops.py:378); two
Adam steps (``optax.adam(1e-3)`` against ``torch.optim.Adam(lr=1e-3)``, as
tests/test_model_zoo.py trains) rtol 1e-4, params atol 1e-5 (a wrong step
moves a weight by ~lr).
"""

import copy
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_tpu.models import GPT2Config as JGPT2Config
from ray_tpu.models import GPT2Model as JGPT2Model
from ray_tpu.models import LlamaConfig as JLlamaConfig
from ray_tpu.models import MLPConfig as JMLPConfig
from ray_tpu.models import MLPModel as JMLPModel
from ray_tpu.models import MoEConfig as JMoEConfig
from ray_tpu.models import MoEModel as JMoEModel
from ray_tpu.models import ViTConfig as JViTConfig
from ray_tpu.models import ViTModel as JViTModel
from ray_tpu.ops.moe_dispatch import topk_dispatch as j_topk_dispatch
from ray_tpu.train.spmd import make_train_step as j_make_train_step
from ray_tpu_torch.bench import run_family
from ray_tpu_torch.models import (GPT2Config, GPT2Model, LlamaConfig,
                                  MLPConfig, MLPModel, MoEConfig, MoEModel,
                                  ViTConfig, ViTModel, params_from_numpy)
from ray_tpu_torch.ops.moe_dispatch import topk_dispatch
from ray_tpu_torch.train import make_train_step, shard_batch
from ray_tpu_torch.train.spmd import param_leaves

SEQ = 32
JAX_IMPL = {"kernel": "flash", "blockwise": "xla"}
FAMILIES = ("mlp", "gpt2", "vit", "moe")
F32 = dict(rtol=1e-4, atol=1e-5)


def _configs(family, prec="f32", **kw):
    """(JAX config, port config) of a family at debug widths; ``family``
    "moe" is the kernel path, "moe-blockwise" the blockwise one."""
    jdt, tdt = ((jnp.float32, torch.float32) if prec == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    if family == "mlp":
        widths = dict(in_dim=64, hidden=(32, 32), num_classes=10)
        return (JMLPConfig(dtype=jdt, **widths),
                MLPConfig(dtype=tdt, **widths))
    if family == "gpt2":
        return (dataclasses.replace(JGPT2Config.debug(), dtype=jdt, **kw),
                dataclasses.replace(GPT2Config.debug(), dtype=tdt, **kw))
    if family == "vit":
        return (dataclasses.replace(JViTConfig.debug(), dtype=jdt, **kw),
                dataclasses.replace(ViTConfig.debug(), dtype=tdt, **kw))
    impl = family.partition("-")[2] or "kernel"
    return (dataclasses.replace(JMoEConfig.debug_moe(), dtype=jdt,
                                attention_impl=JAX_IMPL[impl], **kw),
            dataclasses.replace(MoEConfig.debug_moe(), dtype=tdt,
                                attention_impl=impl, **kw))


MODELS = {JMLPConfig: (JMLPModel, MLPModel), JGPT2Config: (JGPT2Model,
                                                           GPT2Model),
          JViTConfig: (JViTModel, ViTModel), JMoEConfig: (JMoEModel,
                                                          MoEModel)}


def _models(family, prec="f32", **kw):
    jcfg, tcfg = _configs(family, prec, **kw)
    jm, tm = MODELS[type(jcfg)]
    return jm(jcfg), tm(tcfg, device="cpu")


def _batch(family, seed=0, scale=1):
    """A numpy batch of the family: (inputs, targets); ``scale`` times the
    images, or times the rows and the length of the token batch."""
    rng = np.random.default_rng(seed)
    if family == "mlp":
        return (rng.normal(size=(16 * scale, 64)).astype(np.float32),
                rng.integers(0, 10, 16 * scale).astype(np.int32))
    if family == "vit":
        return (rng.normal(size=(4 * scale, 32, 32, 3)).astype(np.float32),
                rng.integers(0, 10, 4 * scale).astype(np.int32))
    tokens = rng.integers(0, 256, (2 * scale, SEQ * scale)).astype(np.int32)
    return tokens, np.roll(tokens, -1, axis=1)


@pytest.fixture(scope="module")
def jax_trees():
    """f32 JAX params of each family, as numpy trees."""
    return {f: jax.tree.map(np.asarray,
                            _models(f)[0].init(jax.random.key(0)))
            for f in FAMILIES}


def _port_params(tree, model):
    return params_from_numpy(tree, model.cfg, device="cpu",
                             param_dtype=torch.float32)


def _named(tree, prefix=""):
    """(name, leaf) of a tree of dicts and lists, names like "layers/0/w"."""
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        if isinstance(v, (dict, list)):
            yield from _named(v, f"{prefix}{k}/")
        else:
            yield prefix + str(k), v


def _jax_named(tree):
    def key(k):
        return str(k.key if hasattr(k, "key") else k.idx)
    return {"/".join(key(k) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


# ---------------------------------------------------------------------------
# the router math
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("E,K,cf", [(4, 2, 1.25), (8, 2, 0.5), (4, 1, 1.0)])
def test_topk_dispatch_matches_jax(E, K, cf):
    T, D = 48, 16
    rng = np.random.default_rng(E * 10 + K)
    x = rng.normal(size=(T, D)).astype(np.float32)
    router = (rng.normal(size=(D, E)) * 0.1).astype(np.float32)
    C = max(1, int(cf * T * K / E))
    jd, jc, ja = j_topk_dispatch(jnp.asarray(x), jnp.asarray(router), E, K,
                                 C, 1e-3, 1e-2)
    td, tc, ta = topk_dispatch(torch.from_numpy(x), torch.from_numpy(router),
                               E, K, C, 1e-3, 1e-2)
    assert td.dtype == torch.bool and tc.dtype == torch.float32
    assert td.shape == (T, E, C)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-6)
    np.testing.assert_allclose(ta.item(), float(ja), rtol=1e-6)
    # every kept token sits in a slot of its own: no slot holds two tokens
    assert int(td.sum(0).max()) <= 1
    if cf < 1:
        assert int(td.sum()) < T * K          # capacity dropped some tokens


# ---------------------------------------------------------------------------
# each family against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", ["mlp", "gpt2", "vit", "moe",
                                    "moe-blockwise"])
def test_f32_logits_and_loss_match_jax(jax_trees, family):
    jm, tm = _models(family)
    tree = jax_trees[family.partition("-")[0]]
    x, y = _batch(family, 1)
    jp = jax.tree.map(jnp.asarray, tree)
    tp = _port_params(tree, tm)
    logits = tm.apply(tp, torch.from_numpy(x))
    assert logits.dtype == torch.float32
    np.testing.assert_allclose(logits.detach().numpy(),
                               np.asarray(jm.apply(jp, jnp.asarray(x))),
                               **F32)
    jl = jm.loss(jp, jnp.asarray(x), jnp.asarray(y))
    tl = tm.loss(tp, torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-4)
    if family.startswith("moe"):
        mask = (np.random.default_rng(2).random(y.shape) < 0.7) \
            .astype(np.float32)
        jl = jm.loss(jp, jnp.asarray(x), jnp.asarray(y), jnp.asarray(mask))
        tl = tm.loss(tp, torch.from_numpy(x), torch.from_numpy(y),
                     torch.from_numpy(mask))
        np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-4)
        _, jaux = jm.apply_with_aux(jp, jnp.asarray(x))
        _, taux = tm.apply_with_aux(tp, torch.from_numpy(x))
        np.testing.assert_allclose(taux.item(), float(jaux), rtol=1e-4)


@pytest.mark.parametrize("family", FAMILIES)
def test_f32_gradients_match_jax(jax_trees, family):
    jm, tm = _models(family)
    x, y = _batch(family, 3)
    jgrads = _jax_named(jax.grad(jm.loss)(
        jax.tree.map(jnp.asarray, jax_trees[family]), jnp.asarray(x),
        jnp.asarray(y)))
    tp = _port_params(jax_trees[family], tm)
    leaves = param_leaves(tp)
    for p in leaves:
        p.requires_grad_(True)
    loss = tm.loss(tp, torch.from_numpy(x), torch.from_numpy(y))
    grads = dict(zip((n for n, _ in _named(tp)),
                     torch.autograd.grad(loss, leaves)))
    assert set(grads) == set(jgrads)
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), jgrads[name], rtol=1e-4,
                                   atol=1e-6, err_msg=name)


@pytest.mark.parametrize("family", FAMILIES)
def test_bf16_loss_matches_jax(jax_trees, family):
    """Two bf16 computations of one f32 function: each rounds on its own
    (JAX's own bf16 ViT loss on 4 images lies 5e-3 from its f32 loss), so
    the batch is large enough (16 images; 4 x 64 tokens, where a routing
    flip of one token moves the MoE loss less) that the rounding averages
    below the bar."""
    jm, tm = _models(family, "bf16")
    x, y = _batch(family, 2, scale=2 if family == "gpt2" else 4)
    jl = jm.loss(jax.tree.map(jnp.asarray, jax_trees[family]),
                 jnp.asarray(x), jnp.asarray(y))
    tl = tm.loss(_port_params(jax_trees[family], tm), torch.from_numpy(x),
                 torch.from_numpy(y))
    assert tl.dtype == torch.float32
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-3)


@pytest.mark.parametrize("family", FAMILIES)
def test_two_adam_steps_match_jax(family):
    """make_train_step against JAX's with Adam(1e-3) on both sides, remat
    on where the family has it, f32.

    Adam's step is ~lr * g / (|g| + eps): where the first gradient is at f32
    rounding level (0 < |g| < 1e-7: GPT-2's key bias, whose gradient is zero in
    exact arithmetic since softmax ignores a shift shared by all keys, or a
    sum that nearly cancels) the two packages' noise moves the weight by up
    to ±lr each. Those elements are held to Adam's step bound instead."""
    lr = 1e-3
    kw = {} if family == "mlp" else dict(remat=True)
    jm, tm = _models(family, **kw)
    x, y = _batch(family, 5)
    jts = j_make_train_step(jm, optimizer=optax.adam(lr))
    jp, jo = jts.init_fn(jax.random.key(0))
    start = jax.tree.map(np.array, jp)          # before the donated steps
    noise = {n: (np.abs(g) < 1e-7) & (g != 0) for n, g in _jax_named(
        jax.grad(jm.loss)(jp, jnp.asarray(x), jnp.asarray(y))).items()}
    ts = make_train_step(tm, optimizer=lambda ps: torch.optim.Adam(ps, lr=lr))
    tp = _port_params(start, tm)
    to = ts.opt_init(tp)
    jbatch = (jnp.asarray(x), jnp.asarray(y))
    tbatch = shard_batch((x, y), ts)
    for _ in range(2):
        jp, jo, jmet = jts.step_fn(jp, jo, jbatch)
        tp, to, tmet = ts.step_fn(tp, to, tbatch)
        np.testing.assert_allclose(tmet["loss"].item(), float(jmet["loss"]),
                                   rtol=1e-4)
        np.testing.assert_allclose(tmet["grad_norm"].item(),
                                   float(jmet["grad_norm"]), rtol=1e-4)
    jflat, sflat = _jax_named(jp), _jax_named(start)
    tflat = {n: t.detach().numpy() for n, t in _named(tp)}
    assert set(tflat) == set(jflat)
    n_noise = sum(int(m.sum()) for m in noise.values())
    assert n_noise <= 0.01 * sum(t.size for t in tflat.values())
    for name, t in tflat.items():
        keep = ~noise[name]
        np.testing.assert_allclose(t[keep], jflat[name][keep], rtol=1e-4,
                                   atol=1e-5, err_msg=name)
        for moved in (t, jflat[name]):
            assert np.all(np.abs(moved - sflat[name])[~keep] <= 2.2 * lr)
        assert not np.array_equal(t, sflat[name]), name         # it moved


@pytest.mark.parametrize("family", ["mlp", "vit"])
def test_accuracy_matches_jax(jax_trees, family):
    jm, tm = _models(family)
    x, y = _batch(family, 6)
    ja = jm.accuracy(jax.tree.map(jnp.asarray, jax_trees[family]),
                     jnp.asarray(x), jnp.asarray(y))
    ta = tm.accuracy(_port_params(jax_trees[family], tm),
                     torch.from_numpy(x), torch.from_numpy(y))
    assert ta.item() == pytest.approx(float(ja))


def test_vit_patchify_matches_jax():
    jm, tm = _models("vit")
    x, _ = _batch("vit", 7)
    np.testing.assert_array_equal(
        tm._patchify(torch.from_numpy(x)).numpy(),
        np.asarray(jm._patchify(jnp.asarray(x))))


def test_gpt2_token_ids_out_of_range_read_as_jax(jax_trees):
    """JAX's gather clamps a token id past the vocabulary and wraps one in
    [-V, 0); so does the port's embedding."""
    jm, tm = _models("gpt2")
    tokens = np.array([[0, 255, 256, 1000, -1, -256, 7, 3]], np.int32)
    jl = jm.apply(jax.tree.map(jnp.asarray, jax_trees["gpt2"]),
                  jnp.asarray(tokens))
    tl = tm.apply(_port_params(jax_trees["gpt2"], tm),
                  torch.from_numpy(tokens))
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl), **F32)


def test_gpt2_causality():
    """As tests/test_model_zoo.py: a token changes no logit before it."""
    _, tm = _models("gpt2")
    params = tm.init(0, param_dtype=torch.float32)
    t1 = torch.zeros((1, 16), dtype=torch.int64)
    t2 = t1.clone()
    t2[0, 12] = 9
    l1, l2 = tm.apply(params, t1), tm.apply(params, t2)
    np.testing.assert_allclose(l1[0, :12].detach().numpy(),
                               l2[0, :12].detach().numpy(), atol=1e-4)
    assert not torch.allclose(l1[0, 12:], l2[0, 12:])


@pytest.mark.parametrize("family", ["gpt2", "vit", "moe"])
def test_remat_gives_the_same_loss_and_gradients(jax_trees, family):
    x, y = _batch(family, 4)
    results = []
    for remat in (False, True):
        _, tm = _models(family, remat=remat)
        tp = _port_params(jax_trees[family], tm)
        leaves = param_leaves(tp)
        for p in leaves:
            p.requires_grad_(True)
        loss = tm.loss(tp, torch.from_numpy(x), torch.from_numpy(y))
        results.append((loss, torch.autograd.grad(loss, leaves)))
    (l0, g0), (l1, g1) = results
    np.testing.assert_allclose(l1.item(), l0.item(), rtol=1e-6)
    for a, b in zip(g0, g1):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-5,
                                   atol=1e-7)


@pytest.mark.parametrize("family", FAMILIES)
def test_families_train_through_make_train_step(family):
    """The default AdamW from the port's own init: the loss falls."""
    _, tm = _models(family)
    ts = make_train_step(tm)
    params, opt = ts.init_fn(0)
    assert all(p.dtype == torch.float32 for p in param_leaves(params))
    batch = shard_batch(_batch(family, 8), ts)
    losses = [ts.step_fn(params, opt, batch)[2]["loss"].item()
              for _ in range(8)]
    assert all(math.isfinite(v) for v in losses)
    assert losses[-1] < losses[0]


def test_run_family_mlp_on_the_cpu():
    """The MLP's run of the card benchmark at its full size (0.67 M params,
    256 rows); off the card no MFU and no kernel launch."""
    out = run_family("mlp", device="cpu")
    assert out["params"] == 784 * 512 + 512 + 512 * 512 + 512 + 512 * 10 + 10
    assert (out["device"], out["unit"], out["mfu"]) == ("cpu", "images",
                                                        None)
    assert out["batch"] == 256 and out["flash_launches"] == 0
    assert out["per_sec"] > 0 and out["loss_last"] < out["loss_first"]


# ---------------------------------------------------------------------------
# MoE specifics
# ---------------------------------------------------------------------------

def test_moe_aux_is_positive_and_added_to_the_loss(jax_trees):
    _, tm = _models("moe")
    tp = _port_params(jax_trees["moe"], tm)
    x, y = _batch("moe", 9)
    logits, aux = tm.apply_with_aux(tp, torch.from_numpy(x))
    assert aux.dtype == torch.float32 and aux.item() > 0
    ce = tm._cross_entropy(logits, torch.from_numpy(y))
    np.testing.assert_allclose(
        tm.loss(tp, torch.from_numpy(x), torch.from_numpy(y)).item(),
        (ce + aux).item(), rtol=1e-6)
    assert "e_gate" in tp["layers"] and "w_gate" not in tp["layers"]


def test_moe_router_stays_f32_in_bf16(jax_trees):
    _, tm = _models("moe", "bf16")
    tp = params_from_numpy(jax_trees["moe"], tm.cfg, device="cpu")
    assert tp["layers"]["router"].dtype == torch.float32
    assert tp["layers"]["e_gate"].dtype == torch.bfloat16
    layer = tm._layers(tp)[0]
    assert layer["router"].dtype == torch.float32
    assert layer["e_down"].dtype == torch.bfloat16


def test_moe_alltoall_needs_a_mesh_as_in_jax():
    jm, tm = _models("moe", moe_dispatch="alltoall")
    x, y = _batch("moe", 10)
    with pytest.raises(ValueError, match="needs a device mesh"):
        jm.loss(jm.init(jax.random.key(0)), jnp.asarray(x), jnp.asarray(y))
    with pytest.raises(ValueError, match="needs a device mesh"):
        tm.loss(tm.init(0), torch.from_numpy(x), torch.from_numpy(y))
    with pytest.raises(ValueError, match="moe_dispatch"):
        MoEConfig(moe_dispatch="ring")


# ---------------------------------------------------------------------------
# trees, configs and the converter
# ---------------------------------------------------------------------------

def test_param_leaves_walks_the_mlp_list():
    _, tm = _models("mlp")
    params = tm.init(0)
    assert isinstance(params["layers"], list)
    leaves = param_leaves(params)
    assert [tuple(p.shape) for p in leaves] == [
        (64, 32), (32,), (32, 32), (32,), (32, 10), (10,)]
    opt = make_train_step(tm).opt_init(params)
    assert all(p.requires_grad for p in leaves)
    assert len(opt.param_groups[0]["params"]) == 6


FULL_WIDTH = {
    "mlp": (JMLPConfig(), MLPConfig()),
    "gpt2_125m": (JGPT2Config.gpt2_125m(), GPT2Config.gpt2_125m()),
    "vit_l16": (JViTConfig.vit_l16(), ViTConfig.vit_l16()),
    "moe_400m": (
        JMoEConfig(**{f: getattr(JLlamaConfig.bench_400m(), f) for f in (
            "vocab_size", "dim", "n_layers", "n_heads", "n_kv_heads",
            "ffn_dim", "max_seq_len")}),
        MoEConfig(**{f: getattr(LlamaConfig.bench_400m(), f) for f in (
            "vocab_size", "dim", "n_layers", "n_heads", "n_kv_heads",
            "ffn_dim", "max_seq_len")})),
}


@pytest.mark.parametrize("name", list(FULL_WIDTH))
def test_full_width_layouts_match_jax(name):
    """Every leaf of the port's tree at the published widths has the shape
    of JAX's (``jax.eval_shape``: nothing is drawn)."""
    jcfg, tcfg = FULL_WIDTH[name]
    jm, tm = MODELS[type(jcfg)]
    shapes = {n: tuple(s.shape) for n, s in _named(
        jax.eval_shape(jm(jcfg).init, jax.random.key(0)))}
    spec = {n: leaf.shape for n, leaf in _named(tm.param_spec(tcfg))}
    assert spec == shapes
    if name == "gpt2_125m":
        assert tcfg.num_params() == jcfg.num_params()
        assert 124e6 < sum(math.prod(s) for s in spec.values()) < 125e6
    if name == "vit_l16":
        assert 303e6 < sum(math.prod(s) for s in spec.values()) < 305e6


@pytest.mark.parametrize("family", FAMILIES)
def test_params_from_numpy_keeps_each_familys_f32_leaves(jax_trees, family):
    _, tm = _models(family, "bf16")
    tree = jax_trees[family]
    tp = params_from_numpy(tree, tm.cfg, device="cpu")
    jflat = _jax_named(tree)
    for name, t in _named(tp):
        want = (torch.float32 if name.rsplit("/", 1)[-1]
                in type(tm).F32_LEAVES else torch.bfloat16)
        assert t.dtype == want, name
        np.testing.assert_array_equal(
            t.float().numpy(),
            torch.tensor(jflat[name]).to(want).float().numpy())
    bad = copy.deepcopy(tree)
    if family == "mlp":
        bad["layers"][0]["w"] = bad["layers"][0]["w"][:-1]
    else:
        key = next(iter(bad["layers"]))
        bad["layers"][key] = bad["layers"][key][:, :-1]
    with pytest.raises(ValueError, match="expected"):
        params_from_numpy(bad, tm.cfg, device="cpu")


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    for cfg, model in ((MLPConfig(), MLPModel), (GPT2Config.debug(),
                                                 GPT2Model),
                       (ViTConfig.debug(), ViTModel),
                       (MoEConfig.debug_moe(), MoEModel)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            model(cfg)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            params_from_numpy({}, cfg)
