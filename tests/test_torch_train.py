"""The training slice of the PyTorch port held against the JAX package.

Debug widths, seq <= 64. JAX params (f32, from ``LlamaModel.init``) are
converted with ``params_from_numpy(..., param_dtype=torch.float32)``; tokens
come from a numpy seed. Attention paths: the port's ``"kernel"`` (its plain
version on CPU tensors) against JAX's ``"flash"`` (the Pallas kernel in
interpret mode), ``"blockwise"`` against ``"xla"``. Bars: f32 logits, loss
and gradients rtol 1e-4; bf16 loss rtol 1e-3 (tests/test_ops.py:378); two
AdamW steps at rtol 1e-4, params at atol 1e-5 (a wrong step moves a weight
by ~lr = 3e-4).
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models.llama import LlamaConfig as JConfig
from ray_tpu.models.llama import LlamaModel as JModel
from ray_tpu.train.spmd import make_train_step as j_make_train_step
from ray_tpu_torch.bench import run_train
from ray_tpu_torch.models import LlamaConfig, LlamaModel, params_from_numpy
from ray_tpu_torch.train import make_train_step, shard_batch
from ray_tpu_torch.train.spmd import param_leaves

VOCAB, SEQ = 256, 64
JAX_IMPL = {"kernel": "flash", "blockwise": "xla"}


def _configs(impl, prec="f32", tie=False, remat=False, policy="full"):
    kw = dict(vocab_size=VOCAB, max_seq_len=SEQ)
    jcfg = dataclasses.replace(
        JConfig.debug(**kw), attention_impl=JAX_IMPL[impl],
        tie_embeddings=tie, remat=remat, remat_policy=policy,
        dtype=jnp.float32 if prec == "f32" else jnp.bfloat16)
    tcfg = dataclasses.replace(
        LlamaConfig.debug(**kw), attention_impl=impl, tie_embeddings=tie,
        remat=remat, remat_policy=policy,
        dtype=torch.float32 if prec == "f32" else torch.bfloat16)
    return jcfg, tcfg


@pytest.fixture(scope="module")
def jax_trees():
    """f32 JAX params, untied and tied, as numpy trees."""
    out = {}
    for tie in (False, True):
        jcfg, _ = _configs("kernel", tie=tie)
        out[tie] = jax.tree.map(np.asarray, JModel(jcfg).init(
            jax.random.key(0)))
    return out


def _batch(seed=0, B=2):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, VOCAB, (B, SEQ)).astype(np.int32)
    mask = (rng.random((B, SEQ)) < 0.7).astype(np.float32)
    return tokens, np.roll(tokens, -1, axis=1), mask


def _torch_params(tree, tcfg):
    return params_from_numpy(tree, tcfg, device="cpu",
                             param_dtype=torch.float32)


@pytest.mark.parametrize("impl", ["kernel", "blockwise"])
@pytest.mark.parametrize("tie", [False, True])
def test_apply_and_loss_match_jax_f32(jax_trees, impl, tie):
    jcfg, tcfg = _configs(impl, tie=tie)
    tree = jax_trees[tie]
    tokens, targets, mask = _batch(1)
    jm, tm = JModel(jcfg), LlamaModel(tcfg, device="cpu")
    tp = _torch_params(tree, tcfg)
    jtree = jax.tree.map(jnp.asarray, tree)
    logits = tm.apply(tp, torch.from_numpy(tokens))
    assert logits.dtype == torch.float32
    np.testing.assert_allclose(
        logits.detach().numpy(),
        np.asarray(jm.apply(jtree, jnp.asarray(tokens))), rtol=1e-4,
        atol=1e-4)
    for m in (None, mask):
        jl = jm.loss(jtree, jnp.asarray(tokens), jnp.asarray(targets),
                     None if m is None else jnp.asarray(m))
        tl = tm.loss(tp, torch.from_numpy(tokens), torch.from_numpy(targets),
                     None if m is None else torch.from_numpy(m))
        np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-4)


@pytest.mark.parametrize("impl", ["kernel", "blockwise"])
def test_loss_matches_jax_bf16(jax_trees, impl):
    jcfg, tcfg = _configs(impl, prec="bf16")
    tokens, targets, _ = _batch(2)
    jl = JModel(jcfg).loss(jax.tree.map(jnp.asarray, jax_trees[False]),
                           jnp.asarray(tokens), jnp.asarray(targets))
    tm = LlamaModel(tcfg, device="cpu")
    tl = tm.loss(_torch_params(jax_trees[False], tcfg),
                 torch.from_numpy(tokens), torch.from_numpy(targets))
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-3)


def _grads(model, params, tokens, targets):
    leaves = param_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss = model.loss(params, torch.from_numpy(tokens),
                      torch.from_numpy(targets))
    return loss, dict(zip(_names(params), torch.autograd.grad(loss, leaves)))


def _names(params, prefix=""):
    for k, v in params.items():
        if isinstance(v, dict):
            yield from _names(v, prefix + k + "/")
        else:
            yield prefix + k


def test_loss_gradients_match_jax(jax_trees):
    jcfg, tcfg = _configs("kernel")
    tokens, targets, _ = _batch(3)
    jtree = jax.tree.map(jnp.asarray, jax_trees[False])
    jgrads = jax.grad(JModel(jcfg).loss)(jtree, jnp.asarray(tokens),
                                         jnp.asarray(targets))
    flat = {"/".join(str(k.key) for k in path): np.asarray(g)
            for path, g in jax.tree_util.tree_flatten_with_path(jgrads)[0]}
    _, grads = _grads(LlamaModel(tcfg, device="cpu"),
                      _torch_params(jax_trees[False], tcfg), tokens, targets)
    assert set(grads) == set(flat)
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), flat[name], rtol=1e-4,
                                   atol=1e-6, err_msg=name)


def test_remat_policies_give_the_same_loss_and_gradients(jax_trees):
    tokens, targets, _ = _batch(4)
    results = []
    for remat, policy in ((False, "full"), (True, "full"), (True, "dots")):
        _, tcfg = _configs("kernel", remat=remat, policy=policy)
        results.append(_grads(LlamaModel(tcfg, device="cpu"),
                              _torch_params(jax_trees[False], tcfg),
                              tokens, targets))
    (loss0, g0), *rest = results
    for loss, g in rest:
        np.testing.assert_allclose(loss.item(), loss0.item(), rtol=1e-6)
        for name in g0:
            np.testing.assert_allclose(g[name].numpy(), g0[name].numpy(),
                                       rtol=1e-5, atol=1e-7, err_msg=name)


def test_two_train_steps_match_jax(jax_trees):
    """make_train_step against JAX's (optax.adamw(3e-4, weight_decay=0.1)
    against torch AdamW), full remat, the flash path, f32."""
    jcfg, tcfg = _configs("kernel", remat=True)
    tokens, targets, _ = _batch(5)
    jts = j_make_train_step(JModel(jcfg))
    jp, jo = jts.init_fn(jax.random.key(0))
    start = jax.tree.map(np.array, jp)          # before the donated steps
    ts = make_train_step(LlamaModel(tcfg, device="cpu"))
    tp = _torch_params(start, tcfg)
    to = ts.opt_init(tp)
    jbatch = (jnp.asarray(tokens), jnp.asarray(targets))
    tbatch = shard_batch((tokens, targets), ts)
    for _ in range(2):
        jp, jo, jm = jts.step_fn(jp, jo, jbatch)
        tp2, to2, tm = ts.step_fn(tp, to, tbatch)
        assert tp2 is tp and to2 is to                  # updated in place
        np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]),
                                   rtol=1e-4)
        np.testing.assert_allclose(tm["grad_norm"].item(),
                                   float(jm["grad_norm"]), rtol=1e-4)
    tflat = dict(zip(_names(tp), param_leaves(tp)))
    sflat = dict(zip(_names(tp), param_leaves(
        _torch_params(start, tcfg))))
    jflat = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert len(jflat) == len(tflat)
    for path, j in jflat:
        name = "/".join(str(k.key) for k in path)
        np.testing.assert_allclose(tflat[name].detach().numpy(),
                                   np.asarray(j), rtol=1e-4, atol=1e-5,
                                   err_msg=name)
        assert not torch.equal(tflat[name], sflat[name])     # it moved


def test_step_fn_reports_its_phases_in_order():
    """The phase hook a profiler uses sees the one step implementation."""
    model = LlamaModel(LlamaConfig.debug(), device="cpu")
    ts = make_train_step(model)
    params, opt = ts.init_fn(0)
    tokens, targets, _ = _batch(5)
    batch = shard_batch((tokens, targets), ts)
    seen = []
    _, _, m = ts.step_fn(params, opt, batch, on_phase=seen.append)
    assert seen == ["forward", "backward", "optimizer"]
    assert math.isfinite(m["loss"].item())


def test_make_train_step_refuses_a_mesh():
    """A mesh is a DeviceMesh of ray_tpu_torch.parallel (the sharded step
    itself is tests/test_torch_spmd.py's)."""
    _, tcfg = _configs("kernel")
    with pytest.raises(TypeError, match="DeviceMesh"):
        make_train_step(LlamaModel(tcfg, device="cpu"), mesh=object())


def test_run_train_on_the_cpu():
    out = run_train(device="cpu", batch=2, seq=128, steps=1, warmup=1,
                    config=LlamaConfig.debug())
    assert math.isfinite(out["loss_first"]) and math.isfinite(
        out["loss_last"]) and math.isfinite(out["grad_norm"])
    assert out["device"] == "cpu" and out["mfu"] == "not measured"
    assert out["flash_launches"] == 0 and out["tokens_per_sec"] > 0


def test_config_training_fields():
    cfg = LlamaConfig.bench_400m()
    assert (cfg.attention_impl, cfg.remat, cfg.remat_policy) == (
        "kernel", True, "full")
    assert cfg.num_params() == 443_073_536 == JConfig.bench_400m() \
        .num_params()
    assert LlamaConfig.debug().remat is False
    for bad in (dict(attention_impl="flash"), dict(remat_policy="x")):
        with pytest.raises(ValueError):
            LlamaConfig(**bad)
    params = LlamaModel(LlamaConfig.debug(), device="cpu").init(
        0, param_dtype=torch.float32)
    assert all(p.dtype == torch.float32 for p in param_leaves(params))
