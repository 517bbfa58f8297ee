"""Search algorithms: random/grid variants, quasi-random, and TPE
(counterpart of ``ray_tpu/tune/search.py``, the port's own copy of that
JAX-free module: the same observations give the same suggestions).

Reference: ``python/ray/tune/search/`` — the Searcher interface
(`suggest`/`on_trial_complete`) with pluggable backends (optuna,
hyperopt, bohb…). None of those libraries exist in this image, so the
backends are NATIVE implementations of the same algorithms:

- :class:`BasicVariantGenerator` — grid/random (the default path).
- :class:`HaltonSearcher` — deterministic low-discrepancy (quasi-random)
  sweeps; better space coverage than iid sampling at small budgets.
- :class:`TPESearcher` — Tree-structured Parzen Estimator (the algorithm
  behind hyperopt): after a random startup phase, observations split
  into good/bad by quantile; candidates are drawn from a KDE over the
  good set and ranked by the density ratio l(x)/g(x).

All searchers speak the Domain vocabulary of
:mod:`ray_tpu_torch.tune.search_space` (Uniform/LogUniform/RandInt/Choice).
"""

from __future__ import annotations

import math
import random
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch.tune.search_space import (Choice, Domain, GridSearch,
                                             LogUniform, RandInt, Uniform)


class Searcher:
    """suggest() yields configs; on_trial_complete() feeds results back."""

    def set_search_space(self, space: Dict[str, Any]) -> None:
        self.space = space

    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        raise NotImplementedError

    def on_trial_complete(self, trial_id: str,
                          metric_value: Optional[float]) -> None:
        pass


class BasicVariantGenerator(Searcher):
    """iid random sampling (grid handled by the default variant path)."""

    def __init__(self, seed: int = 0):
        self._rng = random.Random(seed)

    def suggest(self, trial_id: str) -> Dict[str, Any]:
        out = {}
        for key, dom in self.space.items():
            if isinstance(dom, Domain):
                out[key] = dom.sample(self._rng)
            elif isinstance(dom, GridSearch):
                out[key] = self._rng.choice(dom.values)
            else:
                out[key] = dom
        return out


def _halton(index: int, base: int) -> float:
    """Halton low-discrepancy point in (0, 1)."""
    f, r = 1.0, 0.0
    i = index + 1
    while i > 0:
        f /= base
        r += f * (i % base)
        i //= base
    return r


_PRIMES = [2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37, 41, 43]


class HaltonSearcher(Searcher):
    """Deterministic quasi-random sweep: dimension d uses the Halton
    sequence in base prime[d]."""

    def __init__(self):
        self._count = 0

    def _from_unit(self, dom, u: float, index: int):
        if isinstance(dom, Uniform):
            return dom.lo + u * (dom.hi - dom.lo)
        if isinstance(dom, LogUniform):
            return math.exp(math.log(dom.lo)
                            + u * (math.log(dom.hi) - math.log(dom.lo)))
        if isinstance(dom, RandInt):
            return min(dom.lo + int(u * (dom.hi - dom.lo)), dom.hi - 1)
        if isinstance(dom, Choice):
            return dom.options[index % len(dom.options)]
        if isinstance(dom, GridSearch):
            return dom.values[index % len(dom.values)]
        return dom

    def suggest(self, trial_id: str) -> Dict[str, Any]:
        i = self._count
        self._count += 1
        out = {}
        for d, (key, dom) in enumerate(sorted(self.space.items())):
            u = _halton(i, _PRIMES[d % len(_PRIMES)])
            out[key] = self._from_unit(dom, u, i)
        return out


class TPESearcher(Searcher):
    """Tree-structured Parzen Estimator (hyperopt's algorithm), native.

    minimize mode is handled by the caller passing scores where LOWER is
    better (the Tuner normalizes max-mode by negating)."""

    def __init__(self, n_startup: int = 8, gamma: float = 0.25,
                 n_candidates: int = 24, seed: int = 0):
        self.n_startup = n_startup
        self.gamma = gamma
        self.n_candidates = n_candidates
        self._rng = random.Random(seed)
        self._observed: List[Tuple[Dict[str, Any], float]] = []
        self._pending: Dict[str, Dict[str, Any]] = {}

    # -- observation -------------------------------------------------------
    def on_trial_complete(self, trial_id: str,
                          metric_value: Optional[float]) -> None:
        config = self._pending.pop(trial_id, None)
        if config is not None and metric_value is not None \
                and math.isfinite(metric_value):
            self._observed.append((config, float(metric_value)))

    def _model_observations(self) -> List[Tuple[Dict[str, Any], float]]:
        """The observation pool the Parzen model fits; BOHB narrows this
        to the most-informative fidelity."""
        return self._observed

    # -- numeric helpers ---------------------------------------------------
    @staticmethod
    def _to_unit(dom, value) -> Optional[float]:
        try:
            if isinstance(dom, Uniform):
                return (value - dom.lo) / max(dom.hi - dom.lo, 1e-12)
            if isinstance(dom, LogUniform):
                return ((math.log(value) - math.log(dom.lo))
                        / max(math.log(dom.hi) - math.log(dom.lo), 1e-12))
            if isinstance(dom, RandInt):
                return (value - dom.lo) / max(dom.hi - dom.lo, 1e-12)
        except (TypeError, ValueError):
            return None
        return None

    def _from_unit(self, dom, u: float):
        u = min(max(u, 0.0), 1.0)
        if isinstance(dom, Uniform):
            return dom.lo + u * (dom.hi - dom.lo)
        if isinstance(dom, LogUniform):
            return math.exp(math.log(dom.lo)
                            + u * (math.log(dom.hi) - math.log(dom.lo)))
        if isinstance(dom, RandInt):
            return min(dom.lo + int(round(u * (dom.hi - dom.lo))),
                       dom.hi - 1)
        return None

    @staticmethod
    def _kde_logpdf(x: float, points: List[float], bw: float) -> float:
        if not points:
            return 0.0
        acc = 0.0
        for p in points:
            acc += math.exp(-0.5 * ((x - p) / bw) ** 2)
        return math.log(max(acc / (len(points) * bw), 1e-12))

    # -- suggestion --------------------------------------------------------
    def _random_config(self) -> Dict[str, Any]:
        return {key: (dom.sample(self._rng)
                      if isinstance(dom, Domain)
                      else (self._rng.choice(dom.values)
                            if isinstance(dom, GridSearch) else dom))
                for key, dom in self.space.items()}

    def suggest(self, trial_id: str) -> Dict[str, Any]:
        observed = self._model_observations()
        if len(observed) < self.n_startup:
            config = self._random_config()
            self._pending[trial_id] = config
            return config

        ranked = sorted(observed, key=lambda cv: cv[1])
        n_good = max(1, int(self.gamma * len(ranked)))
        good, bad = ranked[:n_good], ranked[n_good:]

        config: Dict[str, Any] = {}
        for key, dom in self.space.items():
            if isinstance(dom, (Uniform, LogUniform, RandInt)):
                g_pts = [u for cfg, _ in good
                         if (u := self._to_unit(dom, cfg.get(key)))
                         is not None]
                b_pts = [u for cfg, _ in bad
                         if (u := self._to_unit(dom, cfg.get(key)))
                         is not None]
                bw = max(1.0 / max(len(g_pts), 1) ** 0.5 * 0.4, 0.05)
                best_u, best_score = self._rng.random(), -1e18
                for _ in range(self.n_candidates):
                    src = self._rng.choice(g_pts) if g_pts \
                        else self._rng.random()
                    u = min(max(self._rng.gauss(src, bw), 0.0), 1.0)
                    score = (self._kde_logpdf(u, g_pts, bw)
                             - self._kde_logpdf(u, b_pts, bw))
                    if score > best_score:
                        best_u, best_score = u, score
                config[key] = self._from_unit(dom, best_u)
            elif isinstance(dom, (Choice, GridSearch)):
                options = (dom.options if isinstance(dom, Choice)
                           else dom.values)
                weights = []
                for opt in options:
                    g_n = sum(1 for cfg, _ in good if cfg.get(key) == opt)
                    b_n = sum(1 for cfg, _ in bad if cfg.get(key) == opt)
                    weights.append((g_n + 0.5) / (b_n + 0.5))
                total = sum(weights)
                r = self._rng.random() * total
                for opt, w in zip(options, weights):
                    r -= w
                    if r <= 0:
                        config[key] = opt
                        break
                else:
                    config[key] = options[-1]
            elif isinstance(dom, Domain):
                config[key] = dom.sample(self._rng)
            else:
                config[key] = dom
        self._pending[trial_id] = config
        return config


class BOHBSearcher(TPESearcher):
    """BOHB's model-based component (reference:
    ``python/ray/tune/search/bohb/bohb_search.py`` wrapping HpBandSter):
    a TPE whose observation pool is MULTI-FIDELITY — intermediate
    results at each rung budget feed per-budget pools, and the Parzen
    model fits the largest budget that has enough observations. Pair it
    with the ASHA scheduler (the async-hyperband role) for full BOHB
    behavior: the scheduler culls, this searcher proposes.

    The trial controller calls :meth:`on_trial_result` for every
    ``tune.report`` (budget = the scheduler's time_attr value).
    """

    def __init__(self, n_startup: int = 8, gamma: float = 0.25,
                 n_candidates: int = 24, seed: int = 0):
        super().__init__(n_startup=n_startup, gamma=gamma,
                         n_candidates=n_candidates, seed=seed)
        # budget -> {trial_id: (config, latest value at that budget)}
        self._by_budget: Dict[int, Dict[str, Tuple[Dict[str, Any],
                                                   float]]] = {}
        # trial_id -> config, kept past completion: the controller can
        # drain a trial's intermediate reports AFTER its final result
        # (poll/finalize ordering), and those rung observations must
        # still land in the per-budget pools
        self._configs: Dict[str, Dict[str, Any]] = {}

    def suggest(self, trial_id: str) -> Dict[str, Any]:
        config = super().suggest(trial_id)
        self._configs[trial_id] = config
        return config

    def on_trial_result(self, trial_id: str, budget: Any,
                        metric_value: Optional[float]) -> None:
        config = (self._pending.get(trial_id)
                  or self._configs.get(trial_id))
        if (config is None or metric_value is None
                or not math.isfinite(metric_value)):
            return
        try:
            b = int(budget)
        except (TypeError, ValueError):
            return
        self._by_budget.setdefault(b, {})[trial_id] = (
            config, float(metric_value))

    def on_trial_complete(self, trial_id: str,
                          metric_value: Optional[float]) -> None:
        config = self._pending.pop(trial_id, None)
        if config is not None and metric_value is not None \
                and math.isfinite(metric_value):
            self._observed.append((config, float(metric_value)))

    def _model_observations(self) -> List[Tuple[Dict[str, Any], float]]:
        # BOHB rule: fit on the LARGEST budget with enough points —
        # high-fidelity signal dominates when available, low-fidelity
        # rungs bootstrap the model early
        for b in sorted(self._by_budget, reverse=True):
            pool = self._by_budget[b]
            if len(pool) >= self.n_startup:
                return list(pool.values())
        if self._observed:
            return self._observed
        # fall back to the richest partial pool to leave startup ASAP
        best: List[Tuple[Dict[str, Any], float]] = []
        for pool in self._by_budget.values():
            if len(pool) > len(best):
                best = list(pool.values())
        return best
