"""Scaling policies: how the trainer sizes each start of the worker group
(counterpart of ``ray_tpu/train/scaling_policy.py``).

A decision is a target world size: re-forming the group at size W re-forms
the mesh at W workers, and the train function restores its checkpointed
state onto that mesh. ``FixedScalingPolicy`` is the default;
``ElasticScalingPolicy`` re-forms at the capacity that survives a failure.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict, Optional


@dataclasses.dataclass
class ResizeDecision:
    """Re-form the group at ``num_workers`` (== NoopDecision when it
    matches the current size)."""

    num_workers: int


class ScalingPolicy:
    """Decides the world size for every (re)start of the worker group."""

    def initial_size(self) -> int:
        raise NotImplementedError

    def on_recovery(self, current_size: int,
                    resources_per_worker: Dict[str, float],
                    attempt: int) -> ResizeDecision:
        """Called after a worker-group failure, before the retry."""
        raise NotImplementedError


class FixedScalingPolicy(ScalingPolicy):
    """Always the configured size — a retry waits for the full gang to
    be placeable again (the Train v1 behavior)."""

    def __init__(self, num_workers: int):
        self.num_workers = num_workers

    def initial_size(self) -> int:
        return self.num_workers

    def on_recovery(self, current_size, resources_per_worker, attempt):
        return ResizeDecision(self.num_workers)


class ElasticScalingPolicy(ScalingPolicy):
    """Re-form at the surviving capacity: after a failure, size the next
    group to what the cluster can actually place NOW, clamped to
    [min_workers, max_workers]. Training continues on the survivors from
    the latest checkpoint instead of waiting for replacement hardware.

    ``wait_s``: how long to wait for capacity >= min_workers before
    handing the trainer a group it may still not place. The trainer
    bounds group placement with ScalingConfig.placement_timeout_s
    (elastic default 120s) so an unplaceable group FAILS and counts
    against FailureConfig instead of hanging forever.
    """

    def __init__(self, min_workers: int, max_workers: int,
                 wait_s: float = 10.0, poll_interval_s: float = 0.25,
                 initial_workers: Optional[int] = None):
        if not 1 <= min_workers <= max_workers:
            raise ValueError(
                f"need 1 <= min_workers <= max_workers, got "
                f"[{min_workers}, {max_workers}]")
        if initial_workers is not None and not (
                min_workers <= initial_workers <= max_workers):
            raise ValueError(
                f"initial_workers={initial_workers} outside "
                f"[{min_workers}, {max_workers}]")
        self.min_workers = min_workers
        self.max_workers = max_workers
        self.initial_workers = initial_workers
        self.wait_s = wait_s
        self.poll_interval_s = poll_interval_s

    def initial_size(self) -> int:
        return self.initial_workers or self.max_workers

    def _placeable_workers(self, resources_per_worker) -> int:
        import ray_tpu_torch

        avail = ray_tpu_torch.available_resources()
        fits = math.inf
        for key, per in resources_per_worker.items():
            if per <= 0:
                continue
            fits = min(fits, avail.get(key, 0.0) // per)
        return int(fits) if fits is not math.inf else self.max_workers

    def on_recovery(self, current_size, resources_per_worker, attempt):
        deadline = time.monotonic() + self.wait_s
        while True:
            n = self._placeable_workers(resources_per_worker)
            if n >= self.min_workers or time.monotonic() >= deadline:
                break
            time.sleep(self.poll_interval_s)
        n = max(self.min_workers, min(self.max_workers, n))
        return ResizeDecision(n)


def resolve_policy(scaling_config,
                   policy: Optional[ScalingPolicy]) -> ScalingPolicy:
    """Explicit policy wins; ``ScalingConfig(elastic=(min, max))``
    builds an elastic one (starting at num_workers when it falls in the
    range, else at max); otherwise fixed at num_workers."""
    if policy is not None:
        return policy
    elastic = getattr(scaling_config, "elastic", None)
    if elastic:
        lo, hi = elastic
        n = scaling_config.num_workers
        # num_workers=1 is the dataclass default, i.e. "unset" — an
        # elastic run then starts at max. An explicit initial size of 1
        # is still expressible via ElasticScalingPolicy(initial_workers=1).
        explicit = n != 1 and lo <= n <= hi
        return ElasticScalingPolicy(
            lo, hi, initial_workers=n if explicit else None)
    return FixedScalingPolicy(scaling_config.num_workers)
