"""Rank bodies of the port's mesh tests (tests/test_torch_parallel.py,
tests/test_torch_spmd.py, tests/test_torch_context.py,
tests/test_torch_pipeline.py, tests/test_torch_rl_group.py).

``spawn_ranks`` runs each of these on CPU ranks joined by gloo, in fresh
processes that import this module: it imports torch, numpy and the port
only, never JAX (the test modules do). Inputs arrive as numpy arrays and
results go back as numpy arrays, which the tests hold against JAX.
"""

from __future__ import annotations

import dataclasses
import logging
import os

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard

from ray_tpu_torch.models import (GPT2Config, GPT2Model, LlamaConfig,
                                  LlamaModel, MoEConfig, MoEModel,
                                  params_from_numpy)
from ray_tpu_torch.models.common import embed_lookup
from ray_tpu_torch.parallel import (MeshSpec, build_mesh, distribute,
                                    mesh_from_string, named_sharding)
from ray_tpu_torch.parallel.mesh import active_mesh, local_mesh_devices
from ray_tpu_torch.train import make_train_step, shard_batch
from ray_tpu_torch.train.checkpoint import Checkpoint
from ray_tpu_torch.train.spmd import mirror_shardings, param_leaves

# DTensor warns on every nested redistribution and on gloo's missing
# all-to-all; the tests read results, not logs
logging.getLogger("torch.distributed").setLevel(logging.ERROR)
logging.getLogger("torch._logging").setLevel(logging.ERROR)

CFG = {"llama": (LlamaConfig.debug, LlamaModel),
       "gpt2": (GPT2Config.debug, GPT2Model),
       "moe": (MoEConfig.debug_moe, MoEModel)}


def _config(family: str, **kw):
    make, model = CFG[family]
    return dataclasses.replace(make(), dtype=torch.float32, **kw), model


def _full(x) -> np.ndarray:
    t = x.full_tensor() if isinstance(x, DTensor) else x
    return t.detach().numpy()


def _named(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _named(v, prefix + k + "/")
        else:
            yield prefix + k, v


# ---------------------------------------------------------------------------
# tests/test_torch_parallel.py
# ---------------------------------------------------------------------------

def mesh_axes():
    """build_mesh / mesh_from_string on 8 ranks."""
    mesh = build_mesh(MeshSpec.auto(8, tp=2), device="cpu")
    other = mesh_from_string("dp=2,tp=2,sp=2", device="cpu")
    return {"names": mesh.mesh_dim_names,
            "shape": tuple(mesh.mesh.shape),
            "ranks": mesh.mesh.flatten().tolist(),
            "sp": other.size(other.mesh_dim_names.index("sp")),
            "active": active_mesh(mesh).mesh_dim_names,
            "devices": local_mesh_devices(), "world": dist.get_world_size()}


def layouts(spec: dict, trees: dict):
    """Each family's local shards on ``spec`` (from the JAX params in
    ``trees``) and, for Llama, the sharded init against the unsharded
    one."""
    mesh = build_mesh(MeshSpec(**spec), device="cpu")
    out = {}
    for family, tree in trees.items():
        cfg, model_cls = _config(family)
        params = params_from_numpy(tree, cfg, mesh=mesh,
                                   param_dtype=torch.float32)
        out[family] = {n: t.to_local().numpy() for n, t in _named(params)}
    cfg, _ = _config("llama")
    sharded = LlamaModel(cfg, mesh=mesh).init(3, param_dtype=torch.float32)
    plain = LlamaModel(cfg, device="cpu").init(3, param_dtype=torch.float32)
    out["init_equal"] = all(
        torch.equal(a.full_tensor(), b)
        for a, b in zip(param_leaves(sharded), param_leaves(plain)))
    out["init_dtensor"] = all(isinstance(a, DTensor)
                              for a in param_leaves(sharded))
    return out


def matmul_and_embedding(table: np.ndarray, tokens: np.ndarray):
    """A sharded matmul against the plain one (fsdp 2 x tp 2), and the
    vocab-parallel lookup on dp 2 x tp 2 and fsdp 2 x tp 2 with its
    collective counts."""
    from torch.distributed.tensor.debug import CommDebugMode
    out = {}
    mesh = build_mesh(MeshSpec(fsdp=2, tp=2), device="cpu")
    x = torch.arange(16 * 32, dtype=torch.float32).reshape(16, 32) / 100
    w = torch.ones((32, 64), dtype=torch.float32) * 0.01
    xd = distribute(x, mesh, named_sharding(mesh, "batch", None))
    wd = distribute(w, mesh, named_sharding(mesh, None, "mlp"))
    out["matmul"] = ((xd @ wd).full_tensor().numpy(), (x @ w).numpy())
    t = torch.from_numpy(table)
    for spec in (dict(dp=2, tp=2), dict(fsdp=2, tp=2)):
        mesh = build_mesh(MeshSpec(**spec), device="cpu")
        td = distribute(t, mesh, named_sharding(mesh, "vocab", "embed_in"))
        with CommDebugMode() as comm:
            x = embed_lookup(td, torch.from_numpy(tokens), mesh,
                             clamp=False, dtype=torch.float32)
        counts = {str(k): v for k, v in comm.get_comm_counts().items()}
        out[str(spec)] = (x.full_tensor().numpy(), counts,
                          [type(p).__name__ for p in x.placements])
    return out


def _error(fn) -> str:
    try:
        fn()
    except Exception as e:  # noqa: BLE001 — the test reads the type
        return f"{type(e).__name__}: {e}"
    return "no error"


def eight_ranks(trees: dict):
    """On 8 ranks: the mesh's axes and the layouts on dp 2 x fsdp 2 x
    tp 2."""
    return {"axes": mesh_axes(),
            "layouts": layouts(dict(dp=2, fsdp=2, tp=2), trees)}


def four_ranks(table: np.ndarray, tokens: np.ndarray, trees: dict,
               path: str, train_tokens: np.ndarray):
    """On 4 ranks: the layouts on dp 2 x tp 2 and fsdp 2 x tp 2, the mesh
    checks (``mesh_checks``), the refusals and a checkpoint saved on one
    mesh and restored on another."""
    out = {"layouts": {str(spec): layouts(spec, trees)
                       for spec in (dict(dp=2, tp=2), dict(fsdp=2, tp=2))},
           "refusals": refusals()}
    out.update(mesh_checks(table, tokens))
    out["saved"] = checkpoint_save(path, trees["llama"], train_tokens)
    out["restored"] = checkpoint_restore(path, train_tokens)
    return out


def mesh_checks(table: np.ndarray, tokens: np.ndarray):
    """The sharded matmul, the vocab-parallel lookup, the placement errors
    and the GQA guard of attention on a mesh (4 ranks)."""
    from ray_tpu_torch.ops.attention import flash_attention
    from ray_tpu_torch.parallel import placements
    out = matmul_and_embedding(table, tokens)
    mesh = build_mesh(MeshSpec(fsdp=2, tp=2), device="cpu")
    out["errors"] = {
        "twice": _error(lambda: placements(mesh, ("tp", "tp"))),
        "unknown": _error(lambda: placements(mesh, ("nope",))),
        "order": _error(lambda: placements(mesh, (("tp", "fsdp"),))),
        "divide": _error(lambda: placements(mesh, ("tp", None), (3, 4))),
        "ok": [repr(p) for p in placements(mesh, (("dp", "fsdp"), "sp",
                                                 "tp"), (4, 6, 2))]}
    mesh = build_mesh(MeshSpec(tp=4), device="cpu")
    g = torch.Generator().manual_seed(0)
    q = distribute(torch.randn(2, 16, 4, 8, generator=g), mesh, [Shard(2)])
    kv = distribute(torch.randn(2, 16, 2, 8, generator=g), mesh,
                    [Replicate()])
    out["gqa"] = _error(lambda: flash_attention(q, kv, kv, True))
    out["masked_loss"] = masked_loss(trees_tokens=tokens)
    cfg, _ = _config("llama")          # 2 kv heads over tp 4
    out["gqa_model"] = _error(lambda: LlamaModel(cfg, mesh=mesh).init(0))
    return out


def masked_loss(trees_tokens: np.ndarray):
    """Llama's masked loss on fsdp 2 x tp 2 and on one device, from the same
    init; the mask a host array."""
    mesh = build_mesh(MeshSpec(fsdp=2, tp=2), device="cpu")
    cfg, _ = _config("llama")
    tokens = torch.from_numpy(trees_tokens % cfg.vocab_size)
    mask = (torch.arange(tokens.numel()).reshape(tokens.shape) % 3 != 0) \
        .float()
    losses = []
    for m in (mesh, None):
        model = LlamaModel(cfg, device="cpu", mesh=m)
        loss = model.loss(model.init(5, param_dtype=torch.float32), tokens,
                          tokens.roll(-1, 1), mask)
        losses.append(float(_full(loss)))
    return losses


def refusals():
    """ViT/MLP take the one-device path on a mesh; on an sp>1 mesh
    ``"kernel"`` is refused and ``"blockwise"`` runs ring attention (its
    loss and ``"ring"``'s, each against one device); the expert
    all-to-all runs on a mesh (its loss against the einsum scheme's, with
    capacity for every token)."""
    from ray_tpu_torch.models import MLPConfig, MLPModel, ViTConfig, ViTModel
    out = {}
    mesh = build_mesh(MeshSpec(dp=4), device="cpu")
    for name, model in (("vit", ViTModel(ViTConfig.debug(), mesh=mesh)),
                        ("mlp", MLPModel(MLPConfig(in_dim=8, hidden=(8,),
                                                   num_classes=2),
                                         mesh=mesh))):
        ts = make_train_step(model, mesh=mesh)
        params, _ = ts.init_fn(0)
        out[name] = (ts.mesh, ts.param_shardings, ts.batch_sharding,
                     any(isinstance(p, DTensor)
                         for p in param_leaves(params)),
                     str(model.device))
    sp_mesh = build_mesh(MeshSpec(dp=2, sp=2), device="cpu")
    cfg, _ = _config("llama", attention_impl="kernel")
    out["sp-kernel"] = _error(lambda: LlamaModel(cfg, mesh=sp_mesh))
    tokens = torch.from_numpy(
        np.random.default_rng(0).integers(0, 256, (4, 16)))
    for impl in ("blockwise", "ring"):
        cfg, _ = _config("llama", attention_impl=impl)
        model = LlamaModel(cfg, mesh=sp_mesh)
        loss = model.loss(model.init(0, param_dtype=torch.float32), tokens,
                          tokens.roll(-1, 1))
        out[f"sp-{impl}"] = float(_full(loss))
    plain = LlamaModel(cfg, device="cpu")
    out["sp-one-device"] = float(plain.loss(
        plain.init(0, param_dtype=torch.float32), tokens,
        tokens.roll(-1, 1)))
    losses = []
    for dispatch in ("alltoall", "einsum"):
        cfg, _ = _config("moe", moe_dispatch=dispatch, capacity_factor=8.0)
        model = MoEModel(cfg, mesh=mesh)
        losses.append(float(_full(model.loss(
            model.init(0, param_dtype=torch.float32), tokens[:, :8],
            tokens[:, :8]))))
    out["alltoall"] = losses
    return out


def checkpoint_save(path: str, tree: dict, tokens: np.ndarray):
    """Llama debug on fsdp 2 x tp 2 from JAX's params, one AdamW step, then
    params, AdamW state and bf16 copies saved; returns every leaf whole."""
    mesh = build_mesh(MeshSpec(fsdp=2, tp=2), device="cpu")
    cfg, _ = _config("llama")
    model = LlamaModel(cfg, mesh=mesh)
    ts = make_train_step(model, mesh=mesh)
    params = params_from_numpy(tree, cfg, mesh=mesh,
                               param_dtype=torch.float32)
    opt = ts.opt_init(params)
    ts.step_fn(params, opt, shard_batch((tokens, np.roll(tokens, -1, 1)),
                                        ts))
    state = {"params": params, "opt": opt.state_dict(),
             "bf16": {"embed": params["embed"].to(torch.bfloat16),
                      "wq": params["layers"]["wq"].to(torch.bfloat16)},
             "meta": {"step": 1, "mesh": "fsdp=2,tp=2"}}
    Checkpoint.from_pytree(state, path)
    return _whole(state)


def _whole(tree):
    """Every tensor leaf of a tree whole, bf16 as its int16 bits."""
    if isinstance(tree, torch.Tensor):
        t = tree.full_tensor() if isinstance(tree, DTensor) else tree
        t = t.detach().clone()      # a replicated full_tensor() is a view
        if t.dtype == torch.bfloat16:
            return ("bfloat16", t.view(torch.int16).numpy())
        return (str(t.dtype), t.numpy())
    if isinstance(tree, dict):
        return {k: _whole(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_whole(v) for v in tree)
    return tree


def checkpoint_restore(path: str, tokens: np.ndarray):
    """Restore the checkpoint onto dp 2 x tp 2: every leaf whole, the
    placements of a few, and one more step from the restored state."""
    mesh = build_mesh(MeshSpec(dp=2, tp=2), device="cpu")
    cfg, _ = _config("llama")
    model = LlamaModel(cfg, mesh=mesh)
    ts = make_train_step(model, mesh=mesh)
    ck = Checkpoint(path)
    saved_opt = ck.to_pytree()["opt"]          # the shape of the state
    bf16_pl = {"embed": ts.param_shardings["embed"],
               "wq": ts.param_shardings["layers"]["wq"]}
    placements = {"params": ts.param_shardings,
                  "opt": mirror_shardings(saved_opt, ts.param_shardings),
                  "bf16": bf16_pl, "meta": None}
    state = ck.to_pytree(placements, mesh)
    kinds = {"wq": [repr(p) for p in state["params"]["layers"]["wq"]
                    .placements],
             # wq is the third leaf (param_leaves order)
             "exp_avg": [repr(p) for p in
                         state["opt"]["state"][2]["exp_avg"].placements],
             "bf16": str(state["bf16"]["wq"].dtype)}
    whole = _whole(state)
    opt = ts.opt_init(state["params"])
    opt.load_state_dict(state["opt"])
    _, _, m = ts.step_fn(state["params"], opt,
                         shard_batch((tokens, np.roll(tokens, -1, 1)), ts))
    return whole, kinds, float(m["loss"])


def multihost_explicit(address: str, world: int, rank: int, out_dir: str):
    """A rank brought up by ``initialize_multihost`` with an explicit
    coordinator (the TCP store path), outside ``spawn_ranks``."""
    from ray_tpu_torch.parallel import initialize_multihost, process_shard
    torch.set_num_threads(1)
    ok = initialize_multihost(address, world, rank, backend="gloo")
    again = initialize_multihost(address, world, rank, backend="gloo")
    t = torch.tensor([float(rank + 1)])
    dist.all_reduce(t)
    shard = process_shard(8)
    dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}"), "w") as f:
        f.write(f"{ok} {again} {t.item()} {shard[0]} {shard[1]}")


# ---------------------------------------------------------------------------
# tests/test_torch_spmd.py
# ---------------------------------------------------------------------------

def two_steps(cases: list):
    """For each (name, family, mesh spec, numpy params, tokens, config
    overrides): two default-AdamW steps on the mesh from the given params,
    and two on one device (none for the expert all-to-all, which needs a
    mesh); rank 0 returns the metrics and every param whole."""
    out = {}
    for name, family, spec, tree, tokens, kw in cases:
        mesh = build_mesh(MeshSpec(**spec), device="cpu")
        cfg, model_cls = _config(family, **kw)
        batch = (tokens, np.roll(tokens, -1, axis=1))
        runs = []
        # the one-device run once, on rank 0
        plain = dist.get_rank() == 0 and kw.get("moe_dispatch") != "alltoall"
        for m in (mesh, None) if plain else (mesh,):
            model = model_cls(cfg, device="cpu", mesh=m)
            ts = make_train_step(model, mesh=m)
            params = params_from_numpy(tree, cfg, device="cpu", mesh=m,
                                       param_dtype=torch.float32)
            opt = ts.opt_init(params)
            data = shard_batch(batch, ts)
            metrics = []
            for _ in range(2):
                params, opt, met = ts.step_fn(params, opt, data)
                metrics.append((float(met["loss"]),
                                float(met["grad_norm"])))
            whole = {n: _full(p) for n, p in _named(params)}
            placed = {n: [repr(q) for q in p.placements]
                      for n, p in _named(params) if isinstance(p, DTensor)}
            runs.append((metrics, whole, placed))
        if dist.get_rank() == 0:
            out[name] = runs
    return out


def raise_on_rank_one():
    if dist.get_rank() == 1:
        raise ValueError("a bad spec on one rank")
    dist.barrier()


# ---------------------------------------------------------------------------
# tests/test_torch_context.py
# ---------------------------------------------------------------------------

def _sp_attention(fn, spec: dict, q, k, v, cot=None, **kw):
    """``fn`` (ring or Ulysses, sharded) on q/k/v sharded over sp (batch
    and heads whole); the output whole, and with ``cot`` the gradients of
    ``sum(out * cot)`` with respect to q, k and v."""
    from ray_tpu_torch.parallel.mesh import placements
    mesh = build_mesh(MeshSpec(**spec), device="cpu")
    pl = placements(mesh, (None, "sp", None, None))
    args = [distribute(torch.from_numpy(t), mesh, pl) for t in (q, k, v)]
    if cot is not None:
        for a in args:
            a.requires_grad_(True)
    out = fn(*args, mesh, batch_axes=(), head_axis=None, **kw)
    if cot is None:
        return _full(out)
    (out.full_tensor() * torch.from_numpy(cot)).sum().backward()
    return _full(out), [_full(a.grad) for a in args]


def context_ops(inputs: dict):
    """Ring and Ulysses attention on sp=4 and sp=2 meshes of 4 ranks (the
    cases of tests/test_ops.py)."""
    from ray_tpu_torch.ops.ring_attention import ring_attention_sharded
    from ray_tpu_torch.ops.ulysses import ulysses_attention_sharded
    sp4, sp2 = dict(sp=4), dict(dp=2, sp=2)
    return {
        "ring": _sp_attention(ring_attention_sharded, sp4, *inputs["ring"]),
        "ring_full": _sp_attention(ring_attention_sharded, sp2,
                                   *inputs["ring_full"], causal=False),
        "ring_grad": _sp_attention(ring_attention_sharded, sp4,
                                   *inputs["ring_grad"]),
        "ulysses": _sp_attention(ulysses_attention_sharded, sp4,
                                 *inputs["ulysses"]),
        "ulysses_ring": [_sp_attention(f, sp4, *inputs["ulysses_ring"])
                         for f in (ulysses_attention_sharded,
                                   ring_attention_sharded)],
        "ulysses_grad": _sp_attention(ulysses_attention_sharded, sp4,
                                      *inputs["ulysses_grad"]),
        "ulysses_heads": _error(lambda: _sp_attention(
            ulysses_attention_sharded, sp4, *inputs["ulysses_heads"])),
    }


def context_four(inputs: dict, tree: dict, tokens: np.ndarray,
                 positions: np.ndarray):
    """On 4 ranks: the attention ops (``context_ops``); on dp 2 x sp 2
    explicit positions refused; on dp 2 x tp 2 the logits of explicit
    positions from JAX's params."""
    out = {"ops": context_ops(inputs)}
    cfg, _ = _config("llama")
    tok = torch.from_numpy(tokens)
    pos = torch.from_numpy(positions)
    sp_mesh = build_mesh(MeshSpec(dp=2, sp=2), device="cpu")
    model = LlamaModel(cfg, mesh=sp_mesh)
    out["sp_positions"] = _error(lambda: model.apply(
        model.init(0, param_dtype=torch.float32), tok, pos))
    mesh = build_mesh(MeshSpec(dp=2, tp=2), device="cpu")
    model = LlamaModel(cfg, mesh=mesh)
    params = params_from_numpy(tree, cfg, mesh=mesh,
                               param_dtype=torch.float32)
    out["positions"] = _full(model.apply(params, tok, pos))
    return out


# ---------------------------------------------------------------------------
# tests/test_torch_pipeline.py
# ---------------------------------------------------------------------------

def _tanh_stage(w, x):
    return torch.tanh(x @ w)


def _pipelined(ws: np.ndarray, batch: np.ndarray, pp: int, micro: int,
               grad: bool):
    """``pipelined`` of a tanh stage on ``MeshSpec.auto(8, pp=pp)``: its
    output whole, or the gradient of mean(out**2) with respect to the
    stacked weights."""
    from ray_tpu_torch.parallel.mesh import placements
    from ray_tpu_torch.parallel.pipeline import pipelined
    mesh = build_mesh(MeshSpec.auto(8, pp=pp), device="cpu")
    w = distribute(torch.from_numpy(ws), mesh,
                   placements(mesh, ("pp", None, None)))
    x = distribute(torch.from_numpy(batch), mesh,
                   placements(mesh, (("dp", "fsdp"), None)))
    run = pipelined(_tanh_stage, mesh, num_microbatches=micro)
    if not grad:
        return _full(run(w, x))
    w.requires_grad_(True)
    (run(w, x) ** 2).mean().backward()
    return _full(w.grad)


def _pp_loss(spec: dict, micro: int, stacked: dict, tokens: np.ndarray):
    from ray_tpu_torch.models import PipelinedLlama
    cfg = pp_config()
    mesh = build_mesh(MeshSpec(**spec), device="cpu")
    model = PipelinedLlama(cfg, mesh, num_microbatches=micro)
    params = params_from_numpy(stacked, cfg, mesh=mesh,
                               param_dtype=torch.float32)
    tok = torch.from_numpy(tokens)
    return float(_full(model.loss(params, tok, tok.roll(-1, 1))))


def pp_config() -> LlamaConfig:
    """tests/test_pipeline_llama.py's config, f32."""
    return LlamaConfig(vocab_size=128, dim=32, n_layers=4, n_heads=4,
                       n_kv_heads=2, ffn_dim=64, max_seq_len=32,
                       remat=False, dtype=torch.float32)


def _pp_sgd(stacked: dict, tokens: np.ndarray):
    """One SGD(1e-2) step of ``PipelinedLlama`` on pp 2 x dp 2 x tp 2 from
    JAX's stacked params: the loss and every param whole (stacked)."""
    from ray_tpu_torch.models import PipelinedLlama
    cfg = pp_config()
    mesh = build_mesh(MeshSpec(pp=2, dp=2, tp=2), device="cpu")
    model = PipelinedLlama(cfg, mesh, num_microbatches=2)
    ts = make_train_step(model, lambda ps: torch.optim.SGD(ps, lr=1e-2),
                         mesh=mesh)
    params = params_from_numpy(stacked, cfg, mesh=mesh,
                               param_dtype=torch.float32)
    opt = ts.opt_init(params)
    params, _, m = ts.step_fn(params, opt, shard_batch(
        (tokens, np.roll(tokens, -1, axis=1)), ts))
    return float(m["loss"]), {n: _full(p) for n, p in _named(params)}


def pp_refusals():
    """PipelinedLlama's refusals: pp < 2, layers pp does not divide, sp or
    ep above 1."""
    from ray_tpu_torch.models import PipelinedLlama
    cfg = pp_config()
    cases = {"pp1": (cfg, dict(dp=8)),
             "layers": (dataclasses.replace(cfg, n_layers=3),
                        dict(pp=2, dp=4)),
             "sp": (cfg, dict(pp=2, sp=2, dp=2))}
    return {name: _error(lambda: PipelinedLlama(
        c, build_mesh(MeshSpec(**spec), device="cpu")))
        for name, (c, spec) in cases.items()}


def pipeline_eight(inputs: dict, trees: dict, moe_cases: list):
    """On 8 ranks: ``pipelined`` (pp 4, 8 microbatches) and its gradient
    (pp 2); ``PipelinedLlama``'s loss on pp 2 x dp 2 x tp 2 and pp 4 x dp 2
    and its SGD step; its refusals; two AdamW steps of the MoE's expert
    all-to-all (``two_steps``)."""
    return {
        "forward": _pipelined(*inputs["forward"], pp=4, micro=8,
                              grad=False),
        "grad": _pipelined(*inputs["grad"], pp=2, micro=4, grad=True),
        "loss_pp2": _pp_loss(dict(pp=2, dp=2, tp=2), 2, trees["pp2"],
                             inputs["tokens"]),
        "loss_pp4": _pp_loss(dict(pp=4, dp=2), 4, trees["pp4"],
                             inputs["tokens8"]),
        "sgd": _pp_sgd(trees["pp2"], inputs["tokens"]),
        "refusals": pp_refusals(),
        "moe": two_steps(moe_cases),
    }


# ---------------------------------------------------------------------------
# tests/test_torch_rl_group.py
# ---------------------------------------------------------------------------

def rl_group(cases: dict):
    """Each case's learner (seeded with JAX's state) wrapped in a
    ``LearnerGroup`` over every rank, one ``update``: its metrics and its
    state; then the group's refusals."""
    import chip_smoke
    from torch.distributed.device_mesh import DeviceMesh

    from ray_tpu_torch import rl
    world = dist.get_world_size()
    out = {}
    for key, (name, kw, state, rollouts, ragged) in cases.items():
        learner = chip_smoke.make_learner(name, "cpu", **kw)
        rl.load_learner_state(learner, state)
        group = rl.LearnerGroup(learner, num_learners=world, ragged=ragged)
        out[key] = (group.num_learners, group.update(rollouts),
                    rl.learner_state(learner))
    learner = chip_smoke.make_learner("PPO", "cpu")
    out["refusals"] = {
        "more": _error(lambda: rl.LearnerGroup(learner,
                                               num_learners=world + 1)),
        "no-dp": _error(lambda: rl.LearnerGroup(learner, mesh=DeviceMesh(
            "cpu", list(range(world)), mesh_dim_names=("tp",)))),
        "conflict": _error(lambda: rl.LearnerGroup(
            learner, mesh=build_mesh(MeshSpec(dp=world), device="cpu"),
            num_learners=2 * world)),
    }
    return out


# ---------------------------------------------------------------------------
# tests/test_torch_device_objects.py
# ---------------------------------------------------------------------------

def device_objects_roundtrip(x: np.ndarray, spec: tuple):
    """``x`` distributed over a (2, 2) ("dp", "tp") mesh with ``spec`` (one
    entry a tensor dim: a mesh dim name or None), through the serialization
    context on every rank at once: the rebuilt DTensor's mesh names and
    placements, its whole value, the bf16 and plain-tensor cases, and the
    wire blob, which the test loads where no process group is."""
    from ray_tpu_torch._private.device_objects import wire_dumps
    from ray_tpu_torch._private.serialization import SerializationContext

    from torch.distributed.device_mesh import init_device_mesh

    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("dp", "tp"))
    placements = [Replicate(), Replicate()]
    for tensor_dim, name in enumerate(spec):
        if name is not None:
            placements[mesh.mesh_dim_names.index(name)] = Shard(tensor_dim)
    dx = distribute_tensor_local(torch.from_numpy(x), mesh, placements)
    ctx = SerializationContext()
    back = ctx.deserialize(ctx.serialize(dx))
    bf = ctx.deserialize(ctx.serialize(
        torch.ones(8, dtype=torch.bfloat16)))
    plain = ctx.deserialize(ctx.serialize(torch.arange(6)))
    return {"is_dtensor": isinstance(back, DTensor),
            "names": tuple(back.device_mesh.mesh_dim_names),
            "placements": [repr(p) for p in back.placements],
            "local_equal": bool(torch.equal(back.to_local(),
                                            dx.to_local())),
            "full": back.full_tensor().numpy(),
            "bf16": str(bf.dtype), "plain": plain.numpy(),
            "blob": wire_dumps(dx)}


def distribute_tensor_local(t, mesh, placements):
    """Every rank holds the whole ``t``: shard it locally (no scatter)."""
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(t, mesh, placements, src_data_rank=None)
