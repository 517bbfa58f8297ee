"""Arrival schedules and length distributions for open-loop load
(counterpart of ``ray_tpu/loadgen/arrival.py``, a copy of the JAX package's
module: the same seed gives the same arrival times and lengths in both).

Open loop means the arrival times are drawn up front from a rate process
and do not depend on completions: a slow server does not slow the offered
load down, it builds queueing delay, which is what serving is judged by
(requests/s at a fixed offered rate, with TTFT and TPOT percentiles).
Closed-loop harnesses, which send the next request when the previous one
returns, hide queueing collapse. Everything here is seeded, so two runs of
one spec offer the same traffic.
"""

from __future__ import annotations

import random
from typing import List, Union

ARRIVAL_KINDS = ("poisson", "constant")


def arrival_times(kind: str, rate: float, duration_s: float,
                  seed: int = 0) -> List[float]:
    """Absolute arrival offsets (seconds from t0) over ``duration_s``.

    ``poisson``: exponential inter-arrivals with mean ``1/rate`` (the
    classic many-independent-users process — bursty, memoryless).
    ``constant``: uniform ``1/rate`` spacing (worst-case steady load).
    Deterministic for a fixed ``seed``.
    """
    if rate <= 0:
        raise ValueError(f"rate must be > 0, got {rate}")
    if duration_s <= 0:
        raise ValueError(f"duration_s must be > 0, got {duration_s}")
    if kind == "constant":
        return [i / rate for i in range(int(rate * duration_s))]
    if kind == "poisson":
        rng = random.Random(seed)
        out: List[float] = []
        t = 0.0
        while True:
            t += rng.expovariate(rate)
            if t >= duration_s:
                return out
            out.append(t)
    raise ValueError(
        f"unknown arrival kind {kind!r} (one of {ARRIVAL_KINDS})")


class LengthSampler:
    """Token-length distribution parsed from a compact spec string.

    Accepted forms (all values in tokens):
      ``32``                  constant
      ``"uniform:16:64"``     uniform integer in [16, 64] inclusive
      ``"lognormal:64:0.5"``  lognormal with median 64, sigma 0.5
                              (realistic long-tailed prompt lengths)

    Sampling takes the caller's ``random.Random`` so independent
    streams (prompt vs output lengths) stay independently seeded.
    """

    def __init__(self, kind: str, a: float, b: float = 0.0):
        self.kind = kind
        self.a = a
        self.b = b

    @classmethod
    def parse(cls, spec: Union[int, str]) -> "LengthSampler":
        if isinstance(spec, int):
            return cls("constant", spec)
        text = str(spec).strip()
        if ":" not in text:
            return cls("constant", int(text))
        parts = text.split(":")
        kind = parts[0]
        if kind == "uniform" and len(parts) == 3:
            lo, hi = int(parts[1]), int(parts[2])
            if lo < 1 or hi < lo:
                raise ValueError(f"bad uniform bounds in {spec!r}")
            return cls("uniform", lo, hi)
        if kind == "lognormal" and len(parts) == 3:
            median, sigma = float(parts[1]), float(parts[2])
            if median < 1 or sigma < 0:
                raise ValueError(f"bad lognormal params in {spec!r}")
            return cls("lognormal", median, sigma)
        raise ValueError(
            f"bad length spec {spec!r} (int, 'uniform:lo:hi', or "
            f"'lognormal:median:sigma')")

    def sample(self, rng: random.Random) -> int:
        if self.kind == "constant":
            return max(1, int(self.a))
        if self.kind == "uniform":
            return rng.randint(int(self.a), int(self.b))
        # lognormal: exp(N(ln median, sigma)), floored at 1 token
        import math

        return max(1, int(round(
            math.exp(rng.gauss(math.log(self.a), self.b)))))

    def __repr__(self):
        if self.kind == "constant":
            return str(int(self.a))
        return f"{self.kind}:{self.a:g}:{self.b:g}"
