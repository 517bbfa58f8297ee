"""Trial schedulers (counterpart of ``ray_tpu/tune/schedulers.py``, the
port's own copy of that JAX-free module; reference: `tune/schedulers/` —
FIFO, ASHA `async_hyperband.py`, PBT `pbt.py`)."""

from __future__ import annotations

import math
import random
from typing import Any, Dict, List, Optional

CONTINUE = "CONTINUE"
STOP = "STOP"


class TrialScheduler:
    def on_result(self, trial, result: Dict[str, Any]) -> str:
        return CONTINUE

    def on_trial_complete(self, trial) -> None:
        pass


class FIFOScheduler(TrialScheduler):
    pass


class AsyncHyperBandScheduler(TrialScheduler):
    """ASHA: asynchronous successive halving. At each rung (time_attr
    hitting a milestone), a trial is stopped unless it's in the top 1/rf of
    completed results at that rung (reference:
    `tune/schedulers/async_hyperband.py` — the async variant never waits
    for a full rung)."""

    def __init__(self, *, metric: str = "loss", mode: str = "min",
                 time_attr: str = "training_iteration",
                 max_t: int = 100, grace_period: int = 1,
                 reduction_factor: int = 4):
        assert mode in ("min", "max")
        self.metric = metric
        self.mode = mode
        self.time_attr = time_attr
        self.max_t = max_t
        self.grace = grace_period
        self.rf = reduction_factor
        # rung milestone -> list of recorded metric values
        self.rungs: Dict[int, List[float]] = {}
        milestones = []
        t = grace_period
        while t < max_t:
            milestones.append(t)
            t *= reduction_factor
        self.milestones = milestones

    def on_result(self, trial, result: Dict[str, Any]) -> str:
        t = result.get(self.time_attr)
        val = result.get(self.metric)
        if t is None or val is None:
            return CONTINUE
        val = float(val) if self.mode == "min" else -float(val)
        for m in self.milestones:
            if t == m:
                recorded = self.rungs.setdefault(m, [])
                recorded.append(val)
                k = max(1, len(recorded) // self.rf)
                cutoff = sorted(recorded)[k - 1]
                if val > cutoff:
                    return STOP
        if t >= self.max_t:
            return STOP
        return CONTINUE


class PopulationBasedTraining(TrialScheduler):
    """PBT: at each perturbation interval, bottom-quantile trials copy the
    config (+ checkpoint state, via re-seeding config) of a top-quantile
    trial and perturb hyperparams (reference: `tune/schedulers/pbt.py`)."""

    def __init__(self, *, metric: str = "score", mode: str = "max",
                 time_attr: str = "training_iteration",
                 perturbation_interval: int = 4,
                 hyperparam_mutations: Optional[Dict[str, Any]] = None,
                 quantile_fraction: float = 0.25, seed: int = 0):
        self.metric = metric
        self.mode = mode
        self.time_attr = time_attr
        self.interval = perturbation_interval
        self.mutations = hyperparam_mutations or {}
        self.quantile = quantile_fraction
        self.rng = random.Random(seed)
        self.latest: Dict[Any, Dict] = {}   # trial -> last result

    def on_result(self, trial, result: Dict[str, Any]) -> str:
        self.latest[trial] = result
        t = result.get(self.time_attr, 0)
        if t and t % self.interval == 0:
            self._maybe_exploit(trial, result)
        return CONTINUE

    def _score(self, r):
        v = float(r.get(self.metric, -math.inf))
        return v if self.mode == "max" else -v

    def _maybe_exploit(self, trial, result) -> None:
        if len(self.latest) < 2:
            return
        ranked = sorted(self.latest.items(),
                        key=lambda kv: self._score(kv[1]), reverse=True)
        n = len(ranked)
        k = max(1, int(n * self.quantile))
        bottom = [t for t, _ in ranked[-k:]]
        top = [t for t, _ in ranked[:k]]
        if trial in bottom and top:
            donor = self.rng.choice(top)
            trial.config = dict(donor.config)
            self._perturb(trial.config)
            trial.pbt_exploited = True

    def _perturb(self, config: Dict[str, Any]) -> None:
        from ray_tpu_torch.tune.search_space import Domain
        for key, spec in self.mutations.items():
            if key not in config:
                continue
            if isinstance(spec, list):
                config[key] = self.rng.choice(spec)
            elif isinstance(spec, Domain):
                config[key] = spec.sample(self.rng)
            elif callable(spec):
                config[key] = spec()
            else:
                factor = self.rng.choice([0.8, 1.2])
                config[key] = config[key] * factor
