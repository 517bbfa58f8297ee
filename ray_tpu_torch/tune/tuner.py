"""Tuner + trial controller (counterpart of ``ray_tpu/tune/tuner.py``;
reference: `tune/tuner.py`, `tune/tune.py`,
`tune/execution/tune_controller.py:68,666`).

Trials run as gang of actors polled by the controller event loop; the
scheduler (FIFO/ASHA/PBT) acts on every intermediate `tune.report`.

Experiment persistence / restore (reference: ``Tuner.restore`` +
experiment-state snapshots): with a ``run_config`` the controller
snapshots every trial's (config, status, results, checkpoint) to
``<storage>/<name>/tuner_state.pkl`` after each event-loop step;
``Tuner.restore(path, trainable)`` rebuilds the experiment — finished
trials keep their results, unfinished ones re-run from their last
reported checkpoint — so a killed experiment resumes with the trial
count conserved.

Two departures from the JAX package (ROADMAP C):

- the snapshot is written with the stdlib ``pickle`` where JAX's uses
  ``cloudpickle`` (the port's wire format, ``_private/serialization.py``):
  functions pickle by reference, and a searcher that ``pickle`` cannot
  carry (one that holds a lambda) is written as ``None`` and restores as
  ``None``, JAX's path for a searcher that will not pickle;
- a finished trial lets go of its run's result (``Trial.run_ref``): a
  stopped or failed trial's error holds the trainable's frames, and with
  them its model and optimizer state, for as long as the reference lives.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
import os
import pickle
import time
from typing import Any, Callable, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.train.checkpoint import Checkpoint
from ray_tpu_torch.train.session import TrainContext, _set_context
from ray_tpu_torch.tune.schedulers import (STOP, FIFOScheduler,
                                           TrialScheduler)
from ray_tpu_torch.tune.search_space import generate_variants


@dataclasses.dataclass
class TuneConfig:
    metric: str = "loss"
    mode: str = "min"
    num_samples: int = 1
    max_concurrent_trials: Optional[int] = None
    scheduler: Optional[TrialScheduler] = None
    # Searcher (tune/search.py: BasicVariantGenerator, HaltonSearcher,
    # TPESearcher); None = grid/random variant generation.
    search_alg: Optional[Any] = None
    seed: int = 0


class Trial:
    _ids = itertools.count()

    def __init__(self, config: Dict[str, Any]):
        self.id = f"trial_{next(Trial._ids):05d}"
        self.config = config
        self.status = "PENDING"
        self.results: List[Dict[str, Any]] = []
        self.error: Optional[str] = None
        self.actor = None
        self.run_ref = None
        self.pbt_exploited = False
        self.checkpoint: Optional[Checkpoint] = None

    @property
    def last_result(self) -> Dict[str, Any]:
        return self.results[-1] if self.results else {}

    def snapshot(self) -> Dict[str, Any]:
        return {"id": self.id, "config": self.config,
                "status": self.status, "results": list(self.results),
                "error": self.error, "checkpoint": self.checkpoint,
                "search_id": getattr(self, "search_id", None)}

    @staticmethod
    def from_snapshot(d: Dict[str, Any]) -> "Trial":
        t = Trial(d["config"])
        t.id = d["id"]
        t.error = d["error"]
        t.checkpoint = d.get("checkpoint")
        if d.get("search_id") is not None:
            t.search_id = d["search_id"]
        # Anything not finished re-runs (a RUNNING trial died with the
        # experiment process).
        if d["status"] in ("TERMINATED", "STOPPED", "ERROR"):
            t.status = d["status"]
            t.results = list(d["results"])
        else:
            # Re-running from the last checkpoint re-reports those steps:
            # keep the checkpoint, drop the partial results so they are
            # not double-counted in the resumed run.
            t.status = "PENDING"
            t.results = []
        return t


class _TrialActor:
    """Runs one trial's trainable; buffers intermediate reports."""

    def __init__(self):
        self._buffer: List[Dict] = []
        self._stop = None

    def run(self, fn: Callable, config: Dict[str, Any],
            checkpoint: Optional[Checkpoint] = None) -> Optional[Dict]:
        ctx = TrainContext(world_rank=0, world_size=1,
                           experiment_name="tune",
                           latest_checkpoint=checkpoint)
        ctx._report_cb = lambda e: self._buffer.append(e)
        self._stop = ctx._stop_event
        _set_context(ctx)
        try:
            out = fn(config)
            if isinstance(out, dict):
                self._buffer.append({"metrics": out, "checkpoint": None,
                                     "rank": 0})
            return out
        finally:
            _set_context(None)

    def poll(self) -> List[Dict]:
        drained, self._buffer = self._buffer, []
        return drained

    def stop(self) -> None:
        if self._stop is not None:
            self._stop.set()

    def ping(self) -> bool:
        return True


@dataclasses.dataclass
class ResultGrid:
    trials: List[Trial]
    metric: str
    mode: str

    def get_best_result(self) -> "TrialResult":
        def score(t: Trial) -> float:
            v = t.last_result.get(self.metric)
            if v is None:
                return -math.inf
            return float(v) if self.mode == "max" else -float(v)
        best = max(self.trials, key=score)
        return TrialResult(best)

    def __iter__(self):
        return (TrialResult(t) for t in self.trials)

    def __len__(self):
        return len(self.trials)

    @property
    def errors(self) -> List[str]:
        return [t.error for t in self.trials if t.error]


@dataclasses.dataclass
class TrialResult:
    trial: Trial

    @property
    def metrics(self) -> Dict[str, Any]:
        return self.trial.last_result

    @property
    def config(self) -> Dict[str, Any]:
        return self.trial.config

    @property
    def error(self) -> Optional[str]:
        return self.trial.error


class Tuner:
    def __init__(self, trainable: Callable, *,
                 param_space: Optional[Dict[str, Any]] = None,
                 tune_config: Optional[TuneConfig] = None,
                 run_config=None):
        # Train-on-Tune (reference: base_trainer.py:692 wraps a Trainer as
        # a one-trial Tune trainable): a JaxTrainer becomes a trainable
        # whose config overrides train_loop_config per trial.
        from ray_tpu_torch._private.worker_process import needs_driver
        from ray_tpu_torch.train.trainer import JaxTrainer
        is_trainer = isinstance(trainable, JaxTrainer)
        if is_trainer:
            trainable = _trainer_as_trainable(trainable)
            if param_space and "train_loop_config" in param_space:
                param_space = dict(param_space["train_loop_config"])
        self.trainable = trainable
        # The trial actors run in the driver when the trainable cannot go
        # to a worker process (it holds the card's tensors, names a CUDA
        # device or does not pickle), or is a trainer: its ranks are the
        # driver's threads, and fit() orders their reports and runs its
        # callbacks in the process that calls it.
        self._trials_in_driver = is_trainer or needs_driver(trainable)
        self.param_space = param_space or {}
        self.cfg = tune_config or TuneConfig()
        self.run_config = run_config
        self._restored_trials: Optional[List[Trial]] = None

    # -- experiment persistence (reference: Tuner.restore) --------------
    @property
    def experiment_path(self) -> Optional[str]:
        if self.run_config is None:
            return None
        return self.run_config.resolved_storage_path()

    def _state_file(self) -> Optional[str]:
        path = self.experiment_path
        return os.path.join(path, "tuner_state.pkl") if path else None

    def _save_state(self, trials: List[Trial]) -> None:
        state_file = self._state_file()
        if state_file is None:
            return
        # only snapshot when something actually changed (a long event
        # loop otherwise rewrites identical state every ~0.1s tick)
        sig = tuple((t.id, t.status, len(t.results)) for t in trials)
        if sig == getattr(self, "_last_sig", None):
            return
        self._last_sig = sig
        os.makedirs(os.path.dirname(state_file), exist_ok=True)
        try:
            searcher_blob = pickle.dumps(self.cfg.search_alg)
        except Exception:
            searcher_blob = None
        blob = pickle.dumps({
            "metric": self.cfg.metric, "mode": self.cfg.mode,
            "num_samples": self.cfg.num_samples,
            "searcher": searcher_blob,
            "trials": [t.snapshot() for t in trials]})
        tmp = state_file + ".tmp"
        with open(tmp, "wb") as f:   # atomic: a crash never half-writes
            f.write(blob)
        os.replace(tmp, state_file)

    @classmethod
    def restore(cls, path: str, trainable: Callable) -> "Tuner":
        """Rebuild a killed experiment from its state snapshots. Finished
        trials keep their results; unfinished ones re-run from their last
        reported checkpoint. ``trainable`` must be the same callable the
        experiment was built with (functions don't round-trip through the
        snapshot, same as the reference's restore contract)."""
        from ray_tpu_torch.train.config import RunConfig

        state_file = os.path.join(path, "tuner_state.pkl")
        with open(state_file, "rb") as f:
            state = pickle.loads(f.read())
        searcher = None
        if state.get("searcher"):
            try:
                # the pickled searcher carries its observations, so an
                # adaptive search (TPE) resumes where it left off
                searcher = pickle.loads(state["searcher"])
            except Exception:
                searcher = None
        base, name = os.path.dirname(path), os.path.basename(path)
        tuner = cls(trainable,
                    tune_config=TuneConfig(metric=state["metric"],
                                           mode=state["mode"],
                                           num_samples=state["num_samples"],
                                           search_alg=searcher),
                    run_config=RunConfig(name=name, storage_path=base))
        tuner._restored_trials = [Trial.from_snapshot(s)
                                  for s in state["trials"]]
        return tuner

    @staticmethod
    def can_restore(path: str) -> bool:
        return os.path.exists(os.path.join(path, "tuner_state.pkl"))

    def fit(self) -> ResultGrid:
        from ray_tpu_torch.train.callbacks import invoke as _cb
        cbs = (self.run_config.callbacks
               if self.run_config is not None else [])
        _cb(cbs, "on_run_start",
            (self.run_config.name if self.run_config else None)
            or "tune_run", dict(self.param_space))
        scheduler = self.cfg.scheduler or FIFOScheduler()
        searcher = self.cfg.search_alg
        if self._restored_trials is not None:
            trials = self._restored_trials
            # searcher experiments: trials that were never created before
            # the kill still owe their samples (trial count conserved)
            to_create = (max(0, self.cfg.num_samples - len(trials))
                         if searcher is not None else 0)
        elif searcher is not None:
            searcher.set_search_space(self.param_space)
            trials: List[Trial] = []
            to_create = self.cfg.num_samples
        else:
            variants = generate_variants(
                self.param_space, self.cfg.num_samples, self.cfg.seed)
            trials = [Trial(v) for v in variants]
            to_create = 0
        limit = self.cfg.max_concurrent_trials or max(
            1, int(ray_tpu_torch.cluster_resources().get("CPU", 4)))
        actor_cls = ray_tpu_torch.remote(_TrialActor)

        pending = [t for t in trials if t.status == "PENDING"]
        running: List[Trial] = []
        while pending or running or to_create > 0:
            # searcher-driven trials are created lazily as slots free, so
            # adaptive searchers (TPE) see completed results first
            while to_create > 0 and len(running) + len(pending) < limit:
                trial_id = f"trial-{self.cfg.num_samples - to_create}"
                trial = Trial(searcher.suggest(trial_id))
                trial.search_id = trial_id
                trials.append(trial)
                pending.append(trial)
                to_create -= 1
            while pending and len(running) < limit:
                trial = pending.pop(0)
                trial.actor = actor_cls.options(
                    max_concurrency=2,
                    _in_process=self._trials_in_driver).remote()
                trial.run_ref = trial.actor.run.remote(
                    self.trainable, trial.config, trial.checkpoint)
                trial.status = "RUNNING"
                running.append(trial)

            # Drain intermediate reports; let the scheduler stop trials.
            for trial in list(running):
                try:
                    entries = ray_tpu_torch.get(trial.actor.poll.remote(),
                                          timeout=30)
                except Exception:
                    entries = []
                for entry in entries:
                    self._consume_entry(trial, entry, cbs)
                    # multi-fidelity searchers (BOHB) ingest every
                    # intermediate report at its budget (= the
                    # scheduler's time_attr value)
                    on_res = getattr(searcher, "on_trial_result", None)
                    if on_res is not None:
                        metrics = entry["metrics"]
                        value = metrics.get(self.cfg.metric)
                        if value is not None:
                            if self.cfg.mode == "max":
                                value = -float(value)
                            on_res(getattr(trial, "search_id", ""),
                                   metrics.get(
                                       getattr(scheduler, "time_attr",
                                               "training_iteration")),
                                   value)
                    if scheduler.on_result(trial, entry["metrics"]) == STOP:
                        trial.actor.stop.remote()
                        trial.status = "STOPPED"

            done_set = set(ray_tpu_torch.wait(
                [t.run_ref for t in running], num_returns=len(running),
                timeout=0.1)[0])
            for trial in list(running):
                if trial.run_ref in done_set:
                    # hold no finished run's ref into the next step, which
                    # may start a trial before this set is made again
                    done_set.discard(trial.run_ref)
                    self._finalize(trial, scheduler, cbs)
                    running.remove(trial)
                    if searcher is not None:
                        value = trial.last_result.get(self.cfg.metric)
                        if value is not None and self.cfg.mode == "max":
                            value = -float(value)
                        searcher.on_trial_complete(
                            getattr(trial, "search_id", ""), value)
            self._save_state(trials)  # crash-resume snapshot per step
        self._save_state(trials)
        grid = ResultGrid(trials=trials, metric=self.cfg.metric,
                          mode=self.cfg.mode)
        _cb(cbs, "on_run_end", grid)
        return grid

    @staticmethod
    def _consume_entry(trial: Trial, entry: dict, cbs) -> None:
        """Per-report handling shared by the live event loop and the
        finalize drain: record metrics, fire logger callbacks, advance
        the trial's checkpoint pointer to the latest reported one."""
        from ray_tpu_torch.train.callbacks import invoke as _cb

        trial.results.append(entry["metrics"])
        _cb(cbs, "on_report", entry["metrics"],
            len(trial.results), trial_id=trial.id)
        if entry.get("checkpoint") is not None:
            trial.checkpoint = entry["checkpoint"]

    def _finalize(self, trial: Trial, scheduler: TrialScheduler,
                  cbs=()) -> None:
        try:
            ray_tpu_torch.get(trial.run_ref)
            if trial.status != "STOPPED":
                trial.status = "TERMINATED"
        except Exception as e:
            msg = repr(e)
            if "StopIteration" in msg or trial.status == "STOPPED":
                trial.status = "STOPPED"
            else:
                trial.status = "ERROR"
                trial.error = msg
        # the error of a stopped or failed run holds the trainable's frames,
        # and with them its model: keep only its text (ROADMAP C11)
        trial.run_ref = None
        # drain any last reports; a timed-out get under host load must
        # not silently lose the trial's final metrics — retry the SAME
        # poll ref (a fresh poll.remote() would find an already-drained
        # buffer: the first poll still executes server-side)
        try:
            poll_ref = trial.actor.poll.remote()
        except Exception:
            poll_ref = None
        if poll_ref is not None:
            for attempt in range(2):
                try:
                    for entry in ray_tpu_torch.get(poll_ref, timeout=30):
                        self._consume_entry(trial, entry, cbs)
                    break
                except Exception:
                    if attempt == 1:
                        break
                    time.sleep(0.5)
        scheduler.on_trial_complete(trial)
        try:
            ray_tpu_torch.kill(trial.actor)
        except Exception:
            pass


def report(metrics: Dict[str, Any],
           checkpoint: Optional[Checkpoint] = None) -> None:
    """`tune.report` — alias of the train session report."""
    from ray_tpu_torch.train.session import report as _report
    _report(metrics, checkpoint)


def _trainer_as_trainable(trainer) -> Callable:
    import copy

    def trainable(config: Dict[str, Any]):
        t = copy.copy(trainer)
        merged = dict(trainer.train_loop_config or {})
        merged.update(config)
        t.train_loop_config = merged
        result = t.fit()
        if result.error:
            raise RuntimeError(result.error)
        return dict(result.metrics)

    return trainable


def with_parameters(fn: Callable, **params) -> Callable:
    def wrapped(config):
        return fn(config, **params)
    return wrapped
