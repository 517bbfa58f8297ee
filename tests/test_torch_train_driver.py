"""The train driver on the port's runtime: the JAX package's trainer,
elastic and callback tests (``tests/test_train.py``,
``tests/test_train_elastic.py``, ``tests/test_callbacks.py``) on
``ray_tpu_torch``, and the KV election of ``initialize_multihost``
(``tests/test_parallel.py``'s rendezvous test).

The checkpoint tests of ``tests/test_train.py`` have their copies in
``tests/test_torch_parallel.py``, and ``test_callbacks_on_tune_trials`` in
``tests/test_torch_tune.py``. Left uncopied:
``test_tracking_integrations_import_gated`` (the W&B and MLflow callbacks,
ROADMAP A11e).
"""

import json
import threading
import time

import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch import train
from ray_tpu_torch.train import (Checkpoint, FailureConfig, JaxTrainer,
                                 RunConfig, ScalingConfig, session)
from ray_tpu_torch.train.callbacks import (Callback, CSVLoggerCallback,
                                           JsonLoggerCallback)
from ray_tpu_torch.train.scaling_policy import (ElasticScalingPolicy,
                                                FixedScalingPolicy,
                                                ResizeDecision,
                                                resolve_policy)


@pytest.fixture
def ray_start_regular():
    rt = ray_tpu_torch.init(num_nodes=1, resources={"CPU": 8})
    yield rt
    ray_tpu_torch.shutdown()


@pytest.fixture
def ray_start_cluster():
    rt = ray_tpu_torch.init(num_nodes=4, resources={"CPU": 4})
    yield rt
    ray_tpu_torch.shutdown()


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def train_worker_threads(timeout: float = 5.0):
    """Executor threads of ``_TrainWorker`` actors still alive after up to
    ``timeout`` seconds (a killed actor's idle threads wake and end)."""
    rt = ray_tpu_torch._private.worker.global_runtime()
    ids = {aid.hex()[:8] for aid, info in rt.gcs.actors.items()
           if info.class_name == "_TrainWorker"}
    deadline = time.monotonic() + timeout
    while True:
        left = [t for t in threading.enumerate() if t.is_alive()
                and t.name.startswith("actor-") and t.name[6:14] in ids]
        if not left or time.monotonic() > deadline:
            return left
        time.sleep(0.02)


# ---------------------------------------------------------------------------
# tests/test_train.py
# ---------------------------------------------------------------------------

def test_jax_trainer_basic(ray_start_cluster, tmp_path):
    def train_fn(config):
        ctx = train.get_context()
        assert ctx.get_world_size() == 2
        for step in range(3):
            metrics = {"step": step, "rank": ctx.get_world_rank(),
                       "loss": 1.0 / (step + 1)}
            if ctx.get_world_rank() == 0:
                ck = Checkpoint.from_pytree({"step": torch.tensor(step)})
                train.report(metrics, checkpoint=ck)
            else:
                train.report(metrics)

    trainer = JaxTrainer(
        train_fn, train_loop_config={},
        scaling_config=ScalingConfig(num_workers=2),
        run_config=RunConfig(name="basic", storage_path=str(tmp_path)))
    result = trainer.fit()
    assert result.error is None
    assert result.metrics["step"] == 2
    assert result.checkpoint is not None
    assert int(result.checkpoint.to_pytree()["step"]) == 2
    # both ranks reported 3 times
    assert len(result.metrics_history) == 6


def test_jax_trainer_trains_real_model(ray_start_regular, tmp_path,
                                       one_thread):
    """End to end: the MLP learns inside the trainer."""
    def train_fn(config):
        from ray_tpu_torch.models import MLPConfig, MLPModel
        from ray_tpu_torch.train.spmd import make_train_step
        model = MLPModel(MLPConfig(in_dim=8, hidden=(16,), num_classes=2),
                         device="cpu")
        ts = make_train_step(
            model, optimizer=lambda p: torch.optim.Adam(p, lr=1e-2))
        params, opt = ts.init_fn(0)
        rng = np.random.default_rng(0)
        x = torch.from_numpy(rng.normal(size=(32, 8)).astype(np.float32))
        y = (x[:, 0] > 0).long()
        for _ in range(40):
            params, opt, _m = ts.step_fn(params, opt, (x, y))
        acc = float(model.accuracy(params, x, y))
        train.report({"acc": acc},
                     checkpoint=Checkpoint.from_pytree(params))

    result = JaxTrainer(
        train_fn, scaling_config=ScalingConfig(num_workers=1),
        run_config=RunConfig(name="mlp", storage_path=str(tmp_path))).fit()
    assert result.error is None
    assert result.metrics["acc"] > 0.9
    assert result.checkpoint is not None


def test_jax_trainer_failure_retry(ray_start_cluster, tmp_path):
    """Worker crash -> group restarted from the latest checkpoint.

    Either rank may take the marker. When rank 1 does, rank 0 may report
    and checkpoint step 3 before the controller sees the failure, so the
    restart has nothing left to run: the result is still rank 0's step 3."""
    marker = tmp_path / "crashed_once"

    def train_fn(config):
        ctx = train.get_context()
        start = 0
        prev = train.get_checkpoint()
        if prev is not None:
            start = int(prev.to_pytree()["step"]) + 1
        for step in range(start, 4):
            if step == 2 and not marker.exists():
                marker.write_text("x")
                raise RuntimeError("injected failure at step 2")
            ck = (Checkpoint.from_pytree({"step": torch.tensor(step)})
                  if ctx.get_world_rank() == 0 else None)
            train.report({"step": step}, checkpoint=ck)

    result = JaxTrainer(
        train_fn, scaling_config=ScalingConfig(num_workers=2),
        run_config=RunConfig(
            name="retry", storage_path=str(tmp_path / "run"),
            failure_config=FailureConfig(max_failures=1))).fit()
    assert result.error is None
    assert result.metrics["step"] == 3
    # resumed from step 2, not from scratch: rank 0's history has one entry
    # for each of steps 0, 1, then 2, 3 after the restart
    rank0_steps = [e["metrics"]["step"] for e in result.metrics_history
                   if e["rank"] == 0]
    assert rank0_steps == [0, 1, 2, 3]
    assert not train_worker_threads()


def test_jax_trainer_failure_exhausted(ray_start_regular, tmp_path):
    def train_fn(config):
        raise ValueError("always fails")

    result = JaxTrainer(
        train_fn, scaling_config=ScalingConfig(num_workers=1),
        run_config=RunConfig(
            name="fail", storage_path=str(tmp_path),
            failure_config=FailureConfig(max_failures=0))).fit()
    assert result.error is not None


def test_dataset_shard_sequence_split(ray_start_regular, tmp_path):
    def train_fn(config):
        shard = train.get_dataset_shard("train")
        train.report({"n": len(list(shard))})

    result = JaxTrainer(
        train_fn, scaling_config=ScalingConfig(num_workers=2),
        run_config=RunConfig(name="ds", storage_path=str(tmp_path)),
        datasets={"train": list(range(10))}).fit()
    counts = sorted(e["metrics"]["n"] for e in result.metrics_history)
    assert counts == [5, 5]


def test_worker_group_collectives(ray_start_cluster, tmp_path):
    from ray_tpu_torch.train import collective as col

    def train_fn(config):
        ctx = train.get_context()
        rank = ctx.get_world_rank()
        col.barrier()
        got = col.broadcast_from_rank_zero(
            {"seed": 42} if rank == 0 else None)
        total = col.allreduce(rank + 1)           # 1 + 2 + 3 = 6
        ranks = col.allgather(rank)
        train.report({"bcast": got["seed"], "sum": total,
                      "ranks": ranks})

    result = JaxTrainer(
        train_fn, scaling_config=ScalingConfig(num_workers=3),
        run_config=RunConfig(name="coll",
                             storage_path=str(tmp_path))).fit()
    assert result.error is None
    for e in result.metrics_history:
        assert e["metrics"]["bcast"] == 42
        assert e["metrics"]["sum"] == 6
        assert e["metrics"]["ranks"] == [0, 1, 2]
    # the rendezvous actor went with its group
    with pytest.raises(ValueError):
        ray_tpu_torch.get_actor("train_collective_coll")


def test_async_checkpointer_overlaps_and_roundtrips(tmp_path):
    """AsyncCheckpointer: save returns before the disk write lands;
    wait_until_finished makes the files trustworthy; contents equal the
    sync path."""
    from ray_tpu_torch.train import AsyncCheckpointer

    tree = {"w": torch.arange(64, dtype=torch.float32).reshape(8, 8),
            "b16": torch.ones(16, dtype=torch.bfloat16), "step": 7}
    ck = AsyncCheckpointer()
    try:
        ckpt = ck.save(tree, str(tmp_path / "a"))
        ck.wait_until_finished(timeout=30)
        back = ckpt.to_pytree()
        np.testing.assert_array_equal(back["w"].numpy(), tree["w"].numpy())
        assert back["b16"].dtype == torch.bfloat16
        assert back["step"] == 7
        # a second pending save doesn't block the caller
        t0 = time.perf_counter()
        ck.save(tree, str(tmp_path / "b"))
        assert time.perf_counter() - t0 < 5
        ck.wait_until_finished(timeout=30)
        assert (tmp_path / "b" / "leaves.npz").exists()
    finally:
        ck.close()


def test_async_checkpointer_error_handling(tmp_path):
    """A failed write surfaces on result() and once on
    wait_until_finished, without poisoning later successful saves."""
    from ray_tpu_torch.train import AsyncCheckpointer

    ck = AsyncCheckpointer()
    try:
        blocked = tmp_path / "blocked"
        blocked.write_text("a file where a directory must go")
        bad = ck.save({"w": torch.ones(4)}, str(blocked / "sub"))
        with pytest.raises(Exception):
            bad.result(timeout=30)
        with pytest.raises(Exception):
            ck.wait_until_finished(timeout=30)
        # error cleared: a later good save is not poisoned
        good = ck.save({"w": torch.ones(4)}, str(tmp_path / "good"))
        ck.wait_until_finished(timeout=30)
        assert good.result().path
        np.testing.assert_array_equal(good.to_pytree()["w"].numpy(),
                                      np.ones(4))
    finally:
        ck.close()


def test_trainer_resumes_from_params_and_adamw_state(ray_start_regular,
                                                     tmp_path, one_thread):
    """chip_smoke.py phase 15(b) at debug widths: rank 0 checkpoints the
    params and the AdamW state after step 1, the loop fails once before
    step 2, and the re-formed group's steps 2-3 give the uninterrupted
    run's losses exactly (the state is restored bit for bit)."""
    from ray_tpu_torch.models import LlamaConfig, LlamaModel

    def loop(config):
        model = LlamaModel(LlamaConfig.debug(), device="cpu")
        ts = train.make_train_step(model)
        rng = np.random.default_rng(0)
        tokens = rng.integers(0, 256, (2, 32)).astype(np.int64)
        batch = train.shard_batch((tokens, np.roll(tokens, -1, 1)), ts)
        prev = train.get_checkpoint()
        if prev is None:
            params, opt, start = *ts.init_fn(0), 0
        else:
            state = prev.to_pytree()
            params = state["params"]
            opt = ts.opt_init(params)
            opt.load_state_dict(state["opt"])
            start = state["step"] + 1
        for step in range(start, 4):
            if step == config.get("fail_at") and \
                    not (tmp_path / "failed").exists():
                (tmp_path / "failed").write_text("x")
                raise RuntimeError("injected failure")
            params, opt, m = ts.step_fn(params, opt, batch)
            ck = None
            if step == config.get("ckpt_at"):
                ck = Checkpoint.from_pytree(
                    {"params": params, "opt": opt.state_dict(),
                     "step": step})
            train.report({"step": step, "loss": m["loss"].item()},
                         checkpoint=ck)

    losses = {}
    for name, config in (("straight", {}),
                         ("resumed", {"ckpt_at": 1, "fail_at": 2})):
        result = JaxTrainer(
            loop, train_loop_config=config,
            run_config=RunConfig(
                name=name, storage_path=str(tmp_path),
                failure_config=FailureConfig(max_failures=1))).fit()
        assert result.error is None, result.error
        hist = [e["metrics"] for e in result.metrics_history]
        assert [m["step"] for m in hist] == [0, 1, 2, 3]
        losses[name] = [m["loss"] for m in hist]
    assert losses["resumed"] == losses["straight"]
    assert losses["straight"][-1] < losses["straight"][0]


# ---------------------------------------------------------------------------
# tests/test_train_elastic.py
# ---------------------------------------------------------------------------

def test_resolve_policy_defaults():
    sc = ScalingConfig(num_workers=3)
    pol = resolve_policy(sc, None)
    assert isinstance(pol, FixedScalingPolicy)
    assert pol.initial_size() == 3
    assert pol.on_recovery(3, {"CPU": 1}, 1).num_workers == 3

    pol = resolve_policy(ScalingConfig(num_workers=4, elastic=(1, 4)), None)
    assert isinstance(pol, ElasticScalingPolicy)
    assert pol.initial_size() == 4


def test_elastic_policy_clamps(ray_start_regular):
    # 8 CPUs available, 3 per worker -> 2 placeable; clamped to [1, 4]
    pol = ElasticScalingPolicy(1, 4, wait_s=0.5)
    d = pol.on_recovery(4, {"CPU": 3.0}, 1)
    assert d.num_workers == 2
    # capacity below min: times out waiting and returns min (the retry
    # then fails placement and counts against FailureConfig)
    d = pol.on_recovery(4, {"CPU": 100.0}, 1)
    assert d.num_workers == 1


def test_unplaceable_gang_fails_not_hangs(ray_start_regular, tmp_path):
    """A gang the cluster can never place fails within the placement
    timeout and counts against FailureConfig."""
    def train_fn(config):
        train.report({"x": 1})

    res = JaxTrainer(
        train_fn,
        scaling_config=ScalingConfig(
            num_workers=2, resources_per_worker={"CPU": 9.0},
            placement_timeout_s=3.0),
        run_config=RunConfig(
            name="noplace", storage_path=str(tmp_path),
            failure_config=FailureConfig(max_failures=1))).fit()
    assert res.error is not None
    assert "unplaceable" in res.error


def test_elastic_resize_on_worker_failure(ray_start_regular, tmp_path):
    """Every rank of the first attempt fails at step 3; the policy re-forms
    the group at world 1, and training goes on from the latest checkpoint
    with a strictly falling loss. JAX's body also places ``w`` on a dp mesh
    of the world's devices; a torch mesh of dp 2 is two processes, which the
    in-process runtime's threads are not, so ``w`` stays a plain tensor."""

    class _LoseOneWorker(ElasticScalingPolicy):
        def on_recovery(self, current_size, resources_per_worker,
                        attempt):
            return ResizeDecision(max(self.min_workers, current_size - 1))

    def train_fn(config):
        ctx = train.get_context()
        ws = ctx.get_world_size()
        start = 0
        w = torch.arange(8, dtype=torch.float32) + 1.0
        prev = train.get_checkpoint()
        if prev is not None:
            state = prev.to_pytree()
            start = int(state["step"]) + 1
            w = state["w"]
        for step in range(start, 6):
            if step == 3 and prev is None:
                raise RuntimeError("worker lost")
            w = w * 0.8
            loss = float(torch.sum(w * w))
            ck = None
            if ctx.get_world_rank() == 0:
                ck = Checkpoint.from_pytree(
                    {"step": torch.tensor(step), "w": w})
            train.report({"step": step, "loss": loss, "world": ws},
                         checkpoint=ck)

    result = JaxTrainer(
        train_fn,
        scaling_config=ScalingConfig(num_workers=2),
        scaling_policy=_LoseOneWorker(1, 2),
        run_config=RunConfig(
            name="elastic", storage_path=str(tmp_path / "run"),
            failure_config=FailureConfig(max_failures=1))).fit()

    assert result.error is None
    rank0 = [e["metrics"] for e in result.metrics_history
             if e["rank"] == 0]
    steps = [m["step"] for m in rank0]
    worlds = [m["world"] for m in rank0]
    losses = [m["loss"] for m in rank0]
    assert steps == [0, 1, 2, 3, 4, 5]
    assert worlds == [2, 2, 2, 1, 1, 1]
    assert all(b < a for a, b in zip(losses, losses[1:]))
    assert result.metrics["world"] == 1


# ---------------------------------------------------------------------------
# tests/test_callbacks.py
# ---------------------------------------------------------------------------

def test_json_and_csv_loggers_on_trainer(ray_start_regular, tmp_path):
    events = []

    class Recorder(Callback):
        def on_run_start(self, run_name, config=None):
            events.append(("start", run_name))

        def on_report(self, metrics, iteration, rank=0, trial_id=""):
            events.append(("report", metrics["step"]))

        def on_run_end(self, result=None, error=None):
            events.append(("end", error))

    def loop(config):
        for step in range(3):
            session.report({"step": step, "loss": 1.0 / (step + 1)})

    result = JaxTrainer(
        loop, scaling_config=ScalingConfig(num_workers=1),
        run_config=RunConfig(
            name="cbrun", storage_path=str(tmp_path),
            callbacks=[Recorder(),
                       JsonLoggerCallback(str(tmp_path / "logs")),
                       CSVLoggerCallback(str(tmp_path / "logs"))])).fit()
    assert result.error is None
    assert events[0] == ("start", "cbrun")
    assert ("report", 0) in events and ("report", 2) in events
    assert events[-1] == ("end", None)

    lines = [json.loads(ln) for ln in
             open(tmp_path / "logs" / "result.json")]
    assert [ln["step"] for ln in lines] == [0, 1, 2]
    csv = open(tmp_path / "logs" / "progress.csv").read().splitlines()
    assert csv[0].startswith("iteration,")
    assert len(csv) == 4


def test_broken_callback_does_not_kill_run(ray_start_regular, tmp_path):
    class Broken(Callback):
        def on_report(self, *a, **k):
            raise RuntimeError("logging exploded")

    def loop(config):
        session.report({"ok": 1})

    result = JaxTrainer(
        loop, scaling_config=ScalingConfig(num_workers=1),
        run_config=RunConfig(name="b", storage_path=str(tmp_path),
                             callbacks=[Broken()])).fit()
    assert result.error is None


# ---------------------------------------------------------------------------
# the port's own
# ---------------------------------------------------------------------------

def test_failed_group_stops_its_other_ranks(ray_start_regular, tmp_path):
    """Rank 0 fails at once; rank 1 would train on for ever. Shutting the
    group down ends rank 1 at its next ``report``, before ``fit`` returns:
    no train worker thread is left."""
    def train_fn(config):
        ctx = train.get_context()
        if ctx.get_world_rank() == 0:
            raise RuntimeError("rank 0 fails")
        step = 0
        while True:
            time.sleep(0.01)
            train.report({"step": step})
            step += 1

    result = JaxTrainer(
        train_fn, scaling_config=ScalingConfig(num_workers=2),
        run_config=RunConfig(name="stop", storage_path=str(tmp_path))).fit()
    assert result.error is not None and "rank 0 fails" in result.error
    assert not train_worker_threads()


def test_result_is_rank_zeros_last_report(ray_start_regular, tmp_path):
    """The race of ``test_jax_trainer_failure_retry``, forced: rank 0
    checkpoints its last step before rank 1 reports step 1 and fails. The
    restart has nothing left to run, and the report drained last is rank
    1's; the result is rank 0's last report all the same."""
    rank0_done = tmp_path / "rank0_done"
    marker = tmp_path / "crashed_once"

    def train_fn(config):
        ctx = train.get_context()
        prev = train.get_checkpoint()
        start = 0 if prev is None else int(prev.to_pytree()["step"]) + 1
        if ctx.get_world_rank() == 0:
            for step in range(start, 4):
                train.report({"step": step}, checkpoint=Checkpoint.from_pytree(
                    {"step": torch.tensor(step)}))
            rank0_done.write_text("x")
            return
        if marker.exists():
            return
        deadline = time.monotonic() + 60
        while not rank0_done.exists() and time.monotonic() < deadline:
            time.sleep(0.01)
        train.report({"step": 0})
        train.report({"step": 1})
        marker.write_text("x")
        raise RuntimeError("injected failure at step 2")

    result = JaxTrainer(
        train_fn, scaling_config=ScalingConfig(num_workers=2),
        run_config=RunConfig(
            name="rank0", storage_path=str(tmp_path / "run"),
            failure_config=FailureConfig(max_failures=1))).fit()
    assert result.error is None
    last = result.metrics_history[-1]
    assert last["rank"] == 1 and last["metrics"] == {"step": 1}
    assert result.metrics == {"step": 3}
    assert int(result.checkpoint.to_pytree()["step"]) == 3


def test_use_gpu_asks_for_the_card():
    assert ScalingConfig().worker_resources() == {"CPU": 1.0}
    assert ScalingConfig(use_gpu=True).worker_resources() == {
        "CPU": 1.0, "GPU": 1.0}


def test_multihost_single_process_noop():
    from ray_tpu_torch.parallel import multihost

    assert multihost.initialize_multihost() is False  # no cluster env


def test_multihost_kv_rendezvous(ray_start_regular):
    from ray_tpu_torch.parallel import multihost

    rt = ray_tpu_torch._private.worker.global_runtime()
    addr, world, rank = multihost.rendezvous_via_kv(rt.gcs, 2, 0)
    assert addr.endswith(f":{multihost.COORDINATOR_PORT}") and rank == 0
    addr2, world2, rank2 = multihost.rendezvous_via_kv(rt.gcs, 2, 1)
    assert addr2 == addr and rank2 == 1


def test_initialize_multihost_elects_through_the_kv(ray_start_regular,
                                                    monkeypatch):
    """Given only the world size and its rank, a process reads the
    coordinator that rank 0 published in the runtime's KV (under the run's
    namespace) and joins the group there; without a runtime it does
    nothing, as JAX's does."""
    from ray_tpu_torch.parallel import multihost

    joined = []
    monkeypatch.setattr(multihost, "_join_group",
                        lambda *args: joined.append(args))
    rt = ray_tpu_torch._private.worker.global_runtime()
    addr, _, _ = multihost.rendezvous_via_kv(rt.gcs, 2, 0,
                                             run_id=rt.namespace)
    assert multihost.initialize_multihost(num_processes=2, process_id=1)
    assert joined == [(addr, 2, 1, None)]
    ray_tpu_torch.shutdown()
    assert multihost.initialize_multihost(num_processes=2,
                                          process_id=1) is False
    assert len(joined) == 1


def test_trainer_llama_losses_match_jax(monkeypatch, tmp_path, one_thread):
    """``JaxTrainer`` with one worker trains ``LlamaConfig.debug()`` for 3
    AdamW steps through ``make_train_step`` in both packages, from JAX's
    initial params (``params_from_numpy``); the reported losses agree at
    ``tests/test_torch_train.py``'s bar for train steps (f32, rtol 1e-4).
    JAX's runtime runs with process workers off."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    import ray_tpu
    import ray_tpu.train as jtrain
    from ray_tpu.models.llama import LlamaConfig as JConfig
    from ray_tpu.models.llama import LlamaModel as JModel
    from ray_tpu_torch.models import LlamaConfig, LlamaModel
    from ray_tpu_torch.models import params_from_numpy

    monkeypatch.setenv("RAY_TPU_PROCESS_WORKERS", "0")
    kw = dict(vocab_size=256, max_seq_len=64)
    jcfg = dataclasses.replace(JConfig.debug(**kw), attention_impl="flash",
                               remat=True, dtype=jnp.float32)
    tcfg = dataclasses.replace(LlamaConfig.debug(**kw),
                               attention_impl="kernel", remat=True,
                               dtype=torch.float32)
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, 256, (2, 64)).astype(np.int32)
    targets = np.roll(tokens, -1, axis=1)
    start = jax.tree.map(
        np.array, jtrain.make_train_step(JModel(jcfg)).init_fn(
            jax.random.key(0))[0])

    def jax_loop(config):
        ts = jtrain.make_train_step(JModel(jcfg))
        params, opt = ts.init_fn(jax.random.key(0))
        batch = (jnp.asarray(tokens), jnp.asarray(targets))
        for step in range(3):
            params, opt, m = ts.step_fn(params, opt, batch)
            jtrain.report({"step": step, "loss": float(m["loss"])})

    def port_loop(config):
        ts = train.make_train_step(LlamaModel(tcfg, device="cpu"))
        params = params_from_numpy(config["params"], tcfg, device="cpu",
                                   param_dtype=torch.float32)
        opt = ts.opt_init(params)
        batch = train.shard_batch((tokens, targets), ts)
        for step in range(3):
            params, opt, m = ts.step_fn(params, opt, batch)
            train.report({"step": step, "loss": m["loss"].item()})

    losses = {}
    for pkg, tr, loop, config in (
            (ray_tpu, jtrain, jax_loop, None),
            (ray_tpu_torch, train, port_loop, {"params": start})):
        pkg.init(num_nodes=1, resources={"CPU": 4})
        try:
            result = tr.JaxTrainer(
                loop, train_loop_config=config,
                scaling_config=tr.ScalingConfig(num_workers=1),
                run_config=tr.RunConfig(
                    name="llama", storage_path=str(tmp_path / pkg.__name__))
            ).fit()
        finally:
            pkg.shutdown()
        assert result.error is None, result.error
        losses[pkg.__name__] = [e["metrics"]["loss"]
                                for e in result.metrics_history]
    assert len(losses["ray_tpu_torch"]) == 3
    np.testing.assert_allclose(losses["ray_tpu_torch"], losses["ray_tpu"],
                               rtol=1e-4)
    assert losses["ray_tpu_torch"][-1] < losses["ray_tpu_torch"][0]
