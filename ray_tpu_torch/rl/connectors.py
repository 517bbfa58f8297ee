"""Connector pipelines: composable transforms between env and module
(the port's own copy of the numpy-only ``ray_tpu/rl/connectors.py``).

Reference: ``rllib/connectors/`` — env→module connectors preprocess
observations before the policy sees them; module→env connectors
postprocess actions before the env executes them. Pipelines are
stateful, serializable objects shipped to every EnvRunner so the exact
preprocessing travels with the policy.

Connectors run host-side in rollout workers (numpy); the policy sees
already-normalized fixed-shape arrays.
"""

from __future__ import annotations

from collections import deque
from typing import Any, Dict, List, Optional

import numpy as np


class Connector:
    """One transform. ``__call__(data)`` maps an observation (env→module)
    or an action (module→env)."""

    def __call__(self, data):
        raise NotImplementedError

    def reset(self) -> None:
        """Episode boundary (stateful connectors clear here)."""


class ConnectorPipeline(Connector):
    def __init__(self, connectors: Optional[List[Connector]] = None):
        self.connectors = list(connectors or [])

    def append(self, connector: Connector) -> "ConnectorPipeline":
        self.connectors.append(connector)
        return self

    def __call__(self, data):
        for c in self.connectors:
            data = c(data)
        return data

    def reset(self) -> None:
        for c in self.connectors:
            c.reset()

    @property
    def output_multiplier(self) -> int:
        """Observation-width multiplier (FrameStack widens the input)."""
        mult = 1
        for c in self.connectors:
            mult *= getattr(c, "obs_multiplier", 1)
        return mult


# -- env -> module ----------------------------------------------------------

class MeanStdObservationNormalizer(Connector):
    """Running mean/std normalization (the MeanStdFilter connector)."""

    def __init__(self, clip: float = 10.0):
        self.clip = clip
        self._count = 1e-4
        self._mean: Optional[np.ndarray] = None
        self._m2: Optional[np.ndarray] = None

    def __call__(self, obs):
        obs = np.asarray(obs, np.float32)
        if self._mean is None:
            self._mean = np.zeros_like(obs)
            self._m2 = np.ones_like(obs)
        # Welford update
        self._count += 1
        delta = obs - self._mean
        self._mean = self._mean + delta / self._count
        self._m2 = self._m2 + delta * (obs - self._mean)
        std = np.sqrt(self._m2 / self._count) + 1e-8
        return np.clip((obs - self._mean) / std, -self.clip, self.clip)


class FrameStack(Connector):
    """Concatenate the last N observations (partial observability)."""

    def __init__(self, n: int = 4):
        self.n = n
        self.obs_multiplier = n
        self._frames: deque = deque(maxlen=n)

    def __call__(self, obs):
        obs = np.asarray(obs, np.float32)
        while len(self._frames) < self.n - 1:
            self._frames.append(np.zeros_like(obs))
        self._frames.append(obs)
        return np.concatenate(list(self._frames), axis=-1)

    def reset(self) -> None:
        self._frames.clear()


class ObservationClipper(Connector):
    def __init__(self, lo: float = -10.0, hi: float = 10.0):
        self.lo, self.hi = lo, hi

    def __call__(self, obs):
        return np.clip(np.asarray(obs, np.float32), self.lo, self.hi)


# -- module -> env ----------------------------------------------------------

class ClipActions(Connector):
    def __init__(self, lo: float, hi: float):
        self.lo, self.hi = lo, hi

    def __call__(self, action):
        return np.clip(action, self.lo, self.hi)


class UnsquashActions(Connector):
    """Map tanh-squashed (-1,1) module outputs to the env's bounds."""

    def __init__(self, lo: float, hi: float):
        self.lo, self.hi = lo, hi

    def __call__(self, action):
        a = np.asarray(action, np.float32)
        return self.lo + (a + 1.0) * 0.5 * (self.hi - self.lo)
