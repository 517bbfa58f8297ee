"""Tune on the port's runtime: the JAX package's tune tests
(``tests/test_tune.py``) and ``test_callbacks_on_tune_trials``
(``tests/test_callbacks.py``) on ``ray_tpu_torch``; the pure modules
(search spaces, searchers, schedulers) held exactly to the JAX package's on
the same seeds and result sequences; one Tuner over a debug Llama run in
each package, with equal losses, statuses and best config; and a stopped
trial's model freed while its results live (ROADMAP C11).
"""

import dataclasses
import gc
import random
import threading
import time
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import ray_tpu
import ray_tpu_torch
from ray_tpu import tune as jtune
from ray_tpu.models.llama import LlamaConfig as JConfig
from ray_tpu.models.llama import LlamaModel as JModel
from ray_tpu.train.spmd import make_train_step as j_make_train_step
from ray_tpu.tune import schedulers as jsched
from ray_tpu.tune import search as jsearch
from ray_tpu.tune import search_space as jspace
from ray_tpu_torch import tune
from ray_tpu_torch.models import LlamaConfig, LlamaModel, params_from_numpy
from ray_tpu_torch.train import (JaxTrainer, RunConfig, ScalingConfig,
                                 make_train_step, shard_batch)
from ray_tpu_torch.train.callbacks import Callback
from ray_tpu_torch.tune import (AsyncHyperBandScheduler,
                                PopulationBasedTraining, TuneConfig, Tuner)
from ray_tpu_torch.tune import schedulers as tsched
from ray_tpu_torch.tune import search as tsearch
from ray_tpu_torch.tune import search_space as tspace
from ray_tpu_torch.tune.search_space import generate_variants


@pytest.fixture
def ray_start_regular():
    rt = ray_tpu_torch.init(num_nodes=1, resources={"CPU": 8})
    yield rt
    ray_tpu_torch.shutdown()


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def jax_in_process(monkeypatch):
    monkeypatch.setenv("RAY_TPU_PROCESS_WORKERS", "0")
    yield
    ray_tpu.shutdown()


# ---------------------------------------------------------------------------
# tests/test_tune.py
# ---------------------------------------------------------------------------

def test_generate_variants_grid_and_random():
    space = {"lr": tune.grid_search([0.1, 0.01]),
             "wd": tune.uniform(0, 1), "fixed": 7}
    variants = generate_variants(space, num_samples=3, seed=0)
    assert len(variants) == 6
    assert {v["lr"] for v in variants} == {0.1, 0.01}
    assert all(0 <= v["wd"] <= 1 and v["fixed"] == 7 for v in variants)


def test_tuner_finds_minimum(ray_start_regular):
    def objective(config):
        x = config["x"]
        return {"loss": (x - 3.0) ** 2}

    grid = Tuner(objective,
                 param_space={"x": tune.grid_search(
                     [0.0, 1.0, 2.0, 3.0, 4.0])},
                 tune_config=TuneConfig(metric="loss", mode="min"))
    results = grid.fit()
    best = results.get_best_result()
    assert best.config["x"] == 3.0
    assert best.metrics["loss"] == 0.0
    assert len(results) == 5


def test_tuner_intermediate_reports(ray_start_regular):
    def trainable(config):
        for i in range(1, 4):
            tune.report({"training_iteration": i, "score": i * config["m"]})

    results = Tuner(trainable,
                    param_space={"m": tune.grid_search([1, 2])},
                    tune_config=TuneConfig(metric="score",
                                           mode="max")).fit()
    best = results.get_best_result()
    assert best.config["m"] == 2
    assert best.metrics["score"] == 6


def test_asha_early_stops_bad_trials(ray_start_regular):
    def trainable(config):
        for i in range(1, 17):
            tune.report({"training_iteration": i,
                         "loss": config["q"] + 1.0 / i})
            time.sleep(0.02)  # give the controller a chance to intervene

    sched = AsyncHyperBandScheduler(metric="loss", mode="min", max_t=16,
                                    grace_period=2, reduction_factor=2)
    results = Tuner(
        trainable,
        param_space={"q": tune.grid_search([0.0, 5.0, 10.0, 20.0])},
        tune_config=TuneConfig(metric="loss", mode="min",
                               scheduler=sched,
                               max_concurrent_trials=1)).fit()
    best = results.get_best_result()
    assert best.config["q"] == 0.0
    trials = {r.config["q"]: r.trial for r in results}
    # the worst trial must have been stopped before finishing 16 iters
    assert len(trials[20.0].results) < 16
    assert results.errors == []


def test_pbt_exploits(ray_start_regular):
    def trainable(config):
        for i in range(1, 9):
            tune.report({"training_iteration": i,
                         "score": config["lr"] * i})

    sched = PopulationBasedTraining(
        metric="score", mode="max", perturbation_interval=2,
        hyperparam_mutations={"lr": [0.1, 1.0, 10.0]})
    results = Tuner(
        trainable, param_space={"lr": tune.grid_search([0.1, 10.0])},
        tune_config=TuneConfig(metric="score", mode="max",
                               scheduler=sched)).fit()
    assert len(results) == 2
    assert results.errors == []


def test_trial_error_captured(ray_start_regular):
    def bad(config):
        raise RuntimeError("boom")

    results = Tuner(bad, param_space={},
                    tune_config=TuneConfig(num_samples=1)).fit()
    assert len(results.errors) == 1


def test_tuner_over_jax_trainer(ray_start_regular, tmp_path):
    """Train-on-Tune: HPO over a JaxTrainer's train_loop_config."""
    from ray_tpu_torch import train

    def train_fn(config):
        # pretend loss depends on lr quadratically
        loss = (config["lr"] - 0.3) ** 2
        train.report({"loss": loss})

    trainer = JaxTrainer(
        train_fn, train_loop_config={"lr": 0.1},
        scaling_config=ScalingConfig(num_workers=1),
        run_config=RunConfig(name="hpo", storage_path=str(tmp_path)))
    results = Tuner(
        trainer,
        param_space={"train_loop_config": {
            "lr": tune.grid_search([0.1, 0.3, 0.9])}},
        tune_config=TuneConfig(metric="loss", mode="min")).fit()
    best = results.get_best_result()
    assert best.config["lr"] == 0.3
    assert best.metrics["loss"] == 0.0


def test_tpe_searcher_converges(ray_start_regular):
    """TPE beats pure exploration on a smooth 1-d objective: after the
    startup phase, suggestions concentrate near the optimum."""
    from ray_tpu_torch.tune.search import TPESearcher

    def objective(config):
        tune.report({"loss": (config["x"] - 0.7) ** 2})

    results = Tuner(
        objective,
        param_space={"x": tune.uniform(0.0, 1.0)},
        tune_config=TuneConfig(metric="loss", mode="min", num_samples=24,
                               max_concurrent_trials=2,
                               search_alg=TPESearcher(n_startup=6,
                                                      seed=0))).fit()
    best = results.get_best_result()
    assert abs(best.config["x"] - 0.7) < 0.15
    # later trials should cluster nearer the optimum than startup ones
    xs = [t.config["x"] for t in results.trials]
    startup_err = sum(abs(x - 0.7) for x in xs[:6]) / 6
    later_err = sum(abs(x - 0.7) for x in xs[-6:]) / 6
    assert later_err <= startup_err + 0.05


def test_halton_searcher_covers_space(ray_start_regular):
    from ray_tpu_torch.tune.search import HaltonSearcher

    def objective(config):
        tune.report({"loss": config["x"]})

    results = Tuner(
        objective, param_space={"x": tune.uniform(0.0, 1.0)},
        tune_config=TuneConfig(num_samples=8, max_concurrent_trials=1,
                               search_alg=HaltonSearcher())).fit()
    # low-discrepancy: all four quartiles visited within 8 points
    quartiles = {min(int(t.config["x"] * 4), 3) for t in results.trials}
    assert {0, 1, 2, 3} <= quartiles


def test_tuner_experiment_restore(tmp_path):
    """Kill an experiment mid-flight; Tuner.restore resumes it with the
    trial count conserved and finished results preserved (reference:
    Tuner.restore + experiment state snapshots). The killed process runs
    the port alone: its trainable comes from a module without JAX, and the
    snapshot is a stdlib pickle."""
    import os
    import pickle
    import signal
    import subprocess
    import sys

    from torch_tune_trainables import _restorable_trainable

    here = os.path.dirname(os.path.abspath(__file__))
    repo = os.path.dirname(here)
    exp_base = str(tmp_path)
    state_file = os.path.join(exp_base, "exp", "tuner_state.pkl")
    script = f"""
import sys
sys.path[:0] = [{repo!r}, {here!r}]
import ray_tpu_torch
from ray_tpu_torch import tune
from ray_tpu_torch.tune import TuneConfig, Tuner
from ray_tpu_torch.train.config import RunConfig
from torch_tune_trainables import _restorable_trainable
assert "jax" not in sys.modules and "ray_tpu" not in sys.modules
ray_tpu_torch.init(num_nodes=1, resources={{"CPU": 4}})
Tuner(_restorable_trainable,
      param_space={{"x": tune.grid_search([1, 2, 3, 4])}},
      tune_config=TuneConfig(metric="score", mode="max",
                             max_concurrent_trials=1),
      run_config=RunConfig(name="exp", storage_path={exp_base!r})).fit()
"""
    env = dict(os.environ)
    env["PYTHONPATH"] = repo + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    proc = subprocess.Popen([sys.executable, "-c", script], env=env,
                            start_new_session=True)

    # wait until >=1 trial TERMINATED but the experiment is not done
    def load_state():
        try:
            with open(state_file, "rb") as f:
                return pickle.loads(f.read())
        except Exception:
            return None

    deadline = time.monotonic() + 90
    while time.monotonic() < deadline:
        state = load_state()
        if state is not None:
            done = [t for t in state["trials"]
                    if t["status"] == "TERMINATED"]
            if 1 <= len(done) < 4:
                break
        if proc.poll() is not None:
            break
        time.sleep(0.05)
    assert proc.poll() is None, "experiment finished before the kill"
    os.killpg(proc.pid, signal.SIGKILL)
    proc.wait(timeout=10)

    state = load_state()
    finished_before = {t["id"] for t in state["trials"]
                       if t["status"] == "TERMINATED"}
    assert finished_before, "no finished trial before the kill"

    # restore in THIS process and finish the experiment
    exp_path = os.path.join(exp_base, "exp")
    assert Tuner.can_restore(exp_path)
    ray_tpu_torch.init(num_nodes=1, resources={"CPU": 4},
                       ignore_reinit_error=True)
    try:
        results = Tuner.restore(exp_path, _restorable_trainable).fit()
        # trial count conserved: 4 grid points, no duplicates
        assert len(results) == 4
        scores = sorted(r.metrics["score"] for r in results)
        assert scores == [1, 2, 3, 4]
        assert not results.errors
        # trials finished before the kill kept their ORIGINAL results
        # (run in the killed subprocess, not re-run here)
        by_id = {r.trial.id: r for r in results}
        for tid in finished_before:
            assert by_id[tid].metrics["run_pid"] != os.getpid()
    finally:
        ray_tpu_torch.shutdown()


def test_bohb_multi_fidelity_model(ray_start_regular):
    """BOHB = ASHA culling + a TPE whose Parzen model fits per-rung
    (multi-fidelity) observations; intermediate reports alone must be
    enough to steer suggestions toward the optimum (reference:
    tune/search/bohb + schedulers/hb_bohb pairing)."""
    from ray_tpu_torch.tune.schedulers import AsyncHyperBandScheduler
    from ray_tpu_torch.tune.search import BOHBSearcher

    def objective(config):
        # multi-fidelity surrogate: the loss ordering is visible from
        # iteration 1, so rung-level observations carry real signal
        for it in range(1, 5):
            loss = (config["x"] - 0.6) ** 2 + 0.5 / it
            tune.report({"loss": loss, "training_iteration": it})

    searcher = BOHBSearcher(n_startup=6, seed=0)
    results = Tuner(
        objective,
        param_space={"x": tune.uniform(0.0, 1.0)},
        tune_config=TuneConfig(
            metric="loss", mode="min", num_samples=20,
            max_concurrent_trials=2,
            search_alg=searcher,
            scheduler=AsyncHyperBandScheduler(
                metric="loss", mode="min", max_t=4, grace_period=1,
                reduction_factor=2))).fit()
    best = results.get_best_result()
    assert abs(best.config["x"] - 0.6) < 0.3
    # the mechanical multi-fidelity contract: rung-level observations
    # reached per-budget pools at more than one fidelity, and the model
    # phase consumed them
    assert len(searcher._by_budget) >= 2, searcher._by_budget.keys()
    assert any(len(pool) >= searcher.n_startup
               for pool in searcher._by_budget.values())


# ---------------------------------------------------------------------------
# tests/test_callbacks.py
# ---------------------------------------------------------------------------

def test_callbacks_on_tune_trials(ray_start_regular, tmp_path):
    reports = []

    class Rec(Callback):
        def on_report(self, metrics, iteration, rank=0, trial_id=""):
            reports.append((trial_id, metrics["v"]))

    def obj(config):
        return {"v": config["x"]}

    Tuner(obj, param_space={"x": tune.grid_search([1, 2, 3])},
          tune_config=TuneConfig(metric="v", mode="max"),
          run_config=RunConfig(name="t", storage_path=str(tmp_path),
                               callbacks=[Rec()])).fit()
    assert sorted(v for _, v in reports) == [1, 2, 3]
    assert len({tid for tid, _ in reports}) == 3   # distinct trial ids


# ---------------------------------------------------------------------------
# the pure modules against the JAX package's, exactly
# ---------------------------------------------------------------------------

def _space(m, with_grid=True):
    """One search space in package ``m``'s vocabulary: every domain kind,
    a constant and (for variants) a grid axis."""
    space = {"lr": m.loguniform(1e-5, 1e-1), "wd": m.uniform(0.0, 0.3),
             "layers": m.randint(1, 9),
             "act": m.choice(["relu", "gelu", "silu"]), "fixed": 7}
    if with_grid:
        space["bs"] = m.grid_search([16, 32, 64])
        space["tag"] = m.sample_from(lambda _: "drawn")
    return space


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_generate_variants_equal_jax(seed):
    for n in (1, 3):
        assert generate_variants(_space(tspace), n, seed) == \
            jspace.generate_variants(_space(jspace), n, seed)


def _objective(config) -> float:
    """A deterministic score of a config (lower is better)."""
    return ((np.log10(config["lr"]) + 3.0) ** 2 + config["wd"]
            + abs(config["layers"] - 4) * 0.1
            + {"relu": 0.3, "gelu": 0.0, "silu": 0.2}[config["act"]])


def _suggestions(searcher, m, n: int, budgets: bool = False) -> list:
    """Drive one searcher: each suggestion is scored and fed back (at
    three budgets first when ``budgets``) before the next."""
    searcher.set_search_space(_space(m, with_grid=False))
    out = []
    for i in range(n):
        tid = f"trial-{i}"
        config = searcher.suggest(tid)
        out.append(config)
        score = _objective(config)
        if budgets:
            for b in (1, 2, 4):
                searcher.on_trial_result(tid, b, score + 1.0 / b)
        searcher.on_trial_complete(tid, score)
    return out


def test_halton_suggestions_equal_jax():
    assert _suggestions(tsearch.HaltonSearcher(), tspace, 24) == \
        _suggestions(jsearch.HaltonSearcher(), jspace, 24)


@pytest.mark.parametrize("seed", [0, 3])
def test_basic_and_tpe_suggestions_equal_jax(seed):
    assert _suggestions(tsearch.BasicVariantGenerator(seed), tspace, 8) \
        == _suggestions(jsearch.BasicVariantGenerator(seed), jspace, 8)
    port = _suggestions(tsearch.TPESearcher(n_startup=6, seed=seed),
                        tspace, 30)
    jax_ = _suggestions(jsearch.TPESearcher(n_startup=6, seed=seed),
                        jspace, 30)
    assert port == jax_


@pytest.mark.parametrize("seed", [0, 3])
def test_bohb_suggestions_equal_jax(seed):
    port = tsearch.BOHBSearcher(n_startup=5, seed=seed)
    jax_ = jsearch.BOHBSearcher(n_startup=5, seed=seed)
    assert _suggestions(port, tspace, 24, budgets=True) == \
        _suggestions(jax_, jspace, 24, budgets=True)
    assert port._by_budget == jax_._by_budget


class _FakeTrial:
    """What a scheduler reads of a trial: its config."""

    def __init__(self, config):
        self.config = dict(config)
        self.pbt_exploited = False


def _result_stream(seed: int, n_trials: int, n_iters: int):
    """Interleaved (trial index, iteration, value) results, as trials
    running side by side report them."""
    rng = random.Random(seed)
    nxt = [1] * n_trials
    quality = [rng.random() for _ in range(n_trials)]
    while any(t <= n_iters for t in nxt):
        i = rng.choice([k for k in range(n_trials) if nxt[k] <= n_iters])
        yield i, nxt[i], quality[i] * 10 + 1.0 / nxt[i] + rng.random() * 0.1
        nxt[i] += 1


@pytest.mark.parametrize("seed", [0, 5])
@pytest.mark.parametrize("mode", ["min", "max"])
def test_asha_decisions_equal_jax(seed, mode):
    decisions = {}
    for name, m in (("port", tsched), ("jax", jsched)):
        sched = m.AsyncHyperBandScheduler(metric="loss", mode=mode,
                                          max_t=27, grace_period=1,
                                          reduction_factor=3)
        trials = [_FakeTrial({"i": i}) for i in range(9)]
        decisions[name] = (
            [sched.on_result(trials[i], {"training_iteration": t,
                                         "loss": v})
             for i, t, v in _result_stream(seed, 9, 27)],
            sched.rungs)
    assert decisions["port"] == decisions["jax"]
    assert decisions["port"][0].count(tsched.STOP) > 0


@pytest.mark.parametrize("seed", [0, 5])
def test_pbt_decisions_equal_jax(seed):
    out = {}
    for name, m, sp in (("port", tsched, tspace), ("jax", jsched, jspace)):
        sched = m.PopulationBasedTraining(
            metric="score", mode="max", perturbation_interval=2,
            hyperparam_mutations={"lr": [1e-3, 1e-2, 1e-1],
                                  "wd": sp.uniform(0.0, 0.1),
                                  "mom": None},
            quantile_fraction=0.25, seed=seed)
        trials = [_FakeTrial({"lr": 1e-2, "wd": 0.05, "mom": 0.9 + i / 100,
                              "i": i}) for i in range(6)]
        seen = []
        for i, t, v in _result_stream(seed, 6, 12):
            sched.on_result(trials[i], {"training_iteration": t,
                                        "score": v})
            seen.append([(tr.config, tr.pbt_exploited) for tr in trials])
        out[name] = seen
    assert out["port"] == out["jax"]
    assert any(e for _, e in out["port"][-1])


# ---------------------------------------------------------------------------
# the slice: one Tuner over a debug Llama in each package
# ---------------------------------------------------------------------------

VOCAB, SEQ, STEPS = 256, 32, 4
LRS = [1e-2, 0.0, 3e-3]


def _recording_asha(base):
    """``base`` (either package's ASHA) recording what the controller fed
    it, for the trainable to wait on: each report is decided, and a STOP
    delivered, before the trial's next step, so both packages' runs take
    the same decisions whatever the threads' timing."""

    class Recording(base):
        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            self.seen = []
            self.cond = threading.Condition()

        def on_result(self, trial, result):
            decision = super().on_result(trial, result)
            with self.cond:
                self.seen.append((trial.config["lr"],
                                  result["training_iteration"], decision))
                self.cond.notify_all()
            return decision

        def decision(self, lr, t):
            with self.cond:
                assert self.cond.wait_for(lambda: any(
                    s[:2] == (lr, t) for s in self.seen), timeout=60)
                return next(s[2] for s in self.seen if s[:2] == (lr, t))

    return Recording(metric="loss", mode="min", grace_period=2,
                     reduction_factor=3, max_t=STEPS + 1)


def _debug_configs():
    kw = dict(vocab_size=VOCAB, max_seq_len=SEQ)
    jcfg = dataclasses.replace(JConfig.debug(**kw), attention_impl="xla",
                               dtype=jnp.float32)
    tcfg = dataclasses.replace(LlamaConfig.debug(**kw),
                               attention_impl="blockwise",
                               dtype=torch.float32)
    return jcfg, tcfg


def _slice_batch():
    tokens = np.random.default_rng(0).integers(
        0, VOCAB, (2, SEQ)).astype(np.int32)
    return tokens, np.roll(tokens, -1, axis=1)


def _after_report(pkg, sched, lr, t):
    """Wait for the controller's decision on this report; after a STOP,
    for the stop to reach the trial (its next report then raises)."""
    if sched.decision(lr, t) == "STOP":
        ctx = pkg.train.session.get_context()
        assert ctx._stop_event.wait(60)


def _jax_trainable(config, tree=None, sched=None):
    jcfg, _ = _debug_configs()
    jts = j_make_train_step(JModel(jcfg),
                            optax.adamw(config["lr"], weight_decay=0.1))
    params = jax.tree.map(jnp.array, tree)
    opt = optax.adamw(config["lr"], weight_decay=0.1).init(params)
    tokens, targets = _slice_batch()
    batch = (jnp.asarray(tokens), jnp.asarray(targets))
    for i in range(1, STEPS + 1):
        params, opt, m = jts.step_fn(params, opt, batch)
        jtune.report({"training_iteration": i, "loss": float(m["loss"])})
        _after_report(ray_tpu, sched, config["lr"], i)


def _port_trainable(config, tree=None, sched=None):
    _, tcfg = _debug_configs()
    lr = config["lr"]
    ts = make_train_step(
        LlamaModel(tcfg, device="cpu"),
        optimizer=lambda ps: torch.optim.AdamW(
            ps, lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.1))
    params = params_from_numpy(tree, tcfg, device="cpu",
                               param_dtype=torch.float32)
    opt = ts.opt_init(params)
    batch = shard_batch(_slice_batch(), ts)
    for i in range(1, STEPS + 1):
        params, opt, m = ts.step_fn(params, opt, batch)
        tune.report({"training_iteration": i, "loss": m["loss"].item()})
        _after_report(ray_tpu_torch, sched, lr, i)


def _until_stopped(seen) -> list:
    """The decisions up to each trial's STOP: the report that raises
    after it reaches the scheduler or not, as the threads' timing falls."""
    stopped, out = set(), []
    for lr, t, decision in seen:
        if lr not in stopped:
            out.append((lr, t, decision))
            if decision == "STOP":
                stopped.add(lr)
    return out


def _slice_run(pkg, tune_mod, trainable, sched_base, tree) -> dict:
    import importlib
    importlib.import_module(pkg.__name__ + ".train.session")
    sched = _recording_asha(sched_base)
    grid = tune_mod.Tuner(
        tune_mod.with_parameters(trainable, tree=tree, sched=sched),
        param_space={"lr": tune_mod.grid_search(LRS)},
        tune_config=tune_mod.TuneConfig(metric="loss", mode="min",
                                        max_concurrent_trials=1,
                                        scheduler=sched)).fit()
    return {"status": [t.status for t in grid.trials],
            "losses": [[r["loss"] for r in t.results] for t in grid.trials],
            "best": grid.get_best_result().config,
            "decided": _until_stopped(sched.seen),
            "errors": grid.errors}


def test_one_tuner_over_a_debug_llama_in_both_packages(jax_in_process,
                                                       one_thread):
    """ASHA (grace 2, reduction 3: one rung, at iteration 2) over three
    learning rates of a debug Llama trained in f32, one trial at a time, in
    each package from JAX's initial params: the lr 0.0 trial is stopped at
    the rung and the others finish; losses at the train step's bar (rtol
    1e-4, tests/test_torch_train.py), statuses, decisions and the best
    config equal."""
    jcfg, _ = _debug_configs()
    tree = jax.tree.map(np.asarray, JModel(jcfg).init(jax.random.key(0)))
    ray_tpu.init(num_nodes=1, resources={"CPU": 8})
    try:
        jax_out = _slice_run(ray_tpu, jtune, _jax_trainable,
                             jsched.AsyncHyperBandScheduler, tree)
    finally:
        ray_tpu.shutdown()
    ray_tpu_torch.init(num_nodes=1, resources={"CPU": 8})
    try:
        port_out = _slice_run(ray_tpu_torch, tune, _port_trainable,
                              tsched.AsyncHyperBandScheduler, tree)
    finally:
        ray_tpu_torch.shutdown()
    assert port_out["errors"] == jax_out["errors"] == []
    assert port_out["status"] == jax_out["status"] == \
        ["TERMINATED", "STOPPED", "STOPPED"]
    assert port_out["decided"] == jax_out["decided"] == [
        (1e-2, 1, "CONTINUE"), (1e-2, 2, "CONTINUE"), (1e-2, 3, "CONTINUE"),
        (1e-2, 4, "CONTINUE"), (0.0, 1, "CONTINUE"), (0.0, 2, "STOP"),
        (3e-3, 1, "CONTINUE"), (3e-3, 2, "STOP")]
    assert port_out["best"] == jax_out["best"] == {"lr": 1e-2}
    for p, j in zip(port_out["losses"], jax_out["losses"]):
        assert len(p) == len(j)
        np.testing.assert_allclose(p, j, rtol=1e-4)
    # lr 0.0: the loss never moves; stopped at the rung, it reported once
    # more (the report that raised)
    assert len(set(port_out["losses"][1])) == 1
    assert [len(x) for x in port_out["losses"]] == [STEPS, 3, 3]


# ---------------------------------------------------------------------------
# ROADMAP C11: a stopped trial's model is freed while its results live
# ---------------------------------------------------------------------------

def test_stopped_trials_free_their_models(ray_start_regular):
    """Each trial holds a tensor in its frame and is stopped by ASHA (the
    last at max_t). A stopped trial's error holds the trainable's frames;
    JAX's ``Trial.run_ref`` keeps that error for the experiment's life.
    Here every tensor is gone when the next trial starts (by reference
    counting alone) and while the ``ResultGrid`` lives."""
    held, alive_at_start = [], []

    def trainable(config):
        alive_at_start.append([r() is not None for r in held])
        model = torch.zeros(1 << 16)
        held.append(weakref.ref(model))
        for i in range(1, 20):
            tune.report({"training_iteration": i,
                         "loss": config["q"] + 1.0 / i})
            time.sleep(0.02)

    was_enabled = gc.isenabled()
    gc.disable()
    try:
        grid = Tuner(trainable,
                     param_space={"q": tune.grid_search([0.0, 5.0, 7.0])},
                     tune_config=TuneConfig(
                         max_concurrent_trials=1,
                         scheduler=AsyncHyperBandScheduler(
                             max_t=8, grace_period=2,
                             reduction_factor=2))).fit()
        assert [t.status for t in grid.trials] == ["STOPPED"] * 3
        assert alive_at_start == [[], [False], [False, False]]
        assert [r() for r in held] == [None, None, None]
    finally:
        if was_enabled:
            gc.enable()
    assert len(grid) == 3
