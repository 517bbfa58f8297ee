"""Search space primitives (counterpart of ``ray_tpu/tune/search_space.py``,
the port's own copy of that JAX-free module; reference:
`python/ray/tune/search/sample.py` + `tune/search/variant_generator.py`
grid/resolved-vars machinery). ``generate_variants`` gives the JAX package's
configs in its order for the same seed: both draw from ``random.Random``."""

from __future__ import annotations

import math
import random
from typing import Any, Callable, Dict, List, Sequence


class Domain:
    def sample(self, rng: random.Random) -> Any:
        raise NotImplementedError


class Uniform(Domain):
    def __init__(self, lo: float, hi: float):
        self.lo, self.hi = lo, hi

    def sample(self, rng):
        return rng.uniform(self.lo, self.hi)


class LogUniform(Domain):
    def __init__(self, lo: float, hi: float):
        self.lo, self.hi = lo, hi

    def sample(self, rng):
        return math.exp(rng.uniform(math.log(self.lo), math.log(self.hi)))


class RandInt(Domain):
    def __init__(self, lo: int, hi: int):
        self.lo, self.hi = lo, hi

    def sample(self, rng):
        return rng.randrange(self.lo, self.hi)


class Choice(Domain):
    def __init__(self, options: Sequence[Any]):
        self.options = list(options)

    def sample(self, rng):
        return rng.choice(self.options)


class GridSearch:
    def __init__(self, values: Sequence[Any]):
        self.values = list(values)


class SampleFrom(Domain):
    def __init__(self, fn: Callable[[Dict], Any]):
        self.fn = fn

    def sample(self, rng):
        return self.fn({})


def uniform(lo: float, hi: float) -> Uniform:
    return Uniform(lo, hi)


def loguniform(lo: float, hi: float) -> LogUniform:
    return LogUniform(lo, hi)


def randint(lo: int, hi: int) -> RandInt:
    return RandInt(lo, hi)


def choice(options: Sequence[Any]) -> Choice:
    return Choice(options)


def grid_search(values: Sequence[Any]) -> GridSearch:
    return GridSearch(values)


def sample_from(fn: Callable) -> SampleFrom:
    return SampleFrom(fn)


def generate_variants(space: Dict[str, Any], num_samples: int,
                      seed: int = 0) -> List[Dict[str, Any]]:
    """Expand grid axes (cross product) × num_samples random draws of the
    stochastic axes (reference: BasicVariantGenerator semantics)."""
    rng = random.Random(seed)
    grids = {k: v.values for k, v in space.items()
             if isinstance(v, GridSearch)}
    grid_combos: List[Dict[str, Any]] = [{}]
    for key, values in grids.items():
        grid_combos = [dict(c, **{key: v}) for c in grid_combos
                       for v in values]
    out = []
    for _ in range(num_samples):
        for combo in grid_combos:
            cfg = {}
            for k, v in space.items():
                if isinstance(v, GridSearch):
                    cfg[k] = combo[k]
                elif isinstance(v, Domain):
                    cfg[k] = v.sample(rng)
                else:
                    cfg[k] = v
            out.append(cfg)
    return out
