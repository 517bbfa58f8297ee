"""Train and run configuration (counterpart of ``ray_tpu/train/config.py``):
scaling is workers times mesh axes, not a worker count alone.

Where JAX's ``ScalingConfig.use_tpu`` adds a TPU chip to each worker's
resources, ``use_gpu`` adds the card: ``{"GPU": 1}``, the resource that
``init()`` detects.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional

from ray_tpu_torch.parallel.mesh import MeshSpec


@dataclasses.dataclass
class ScalingConfig:
    """How much hardware, and how it is meshed.

    ``num_workers`` orchestration workers (one a host in a real cluster);
    ``mesh`` describes the device mesh the train step runs over.
    """

    num_workers: int = 1
    resources_per_worker: Optional[Dict[str, float]] = None
    use_gpu: bool = False
    mesh: Optional[MeshSpec] = None
    placement_strategy: str = "PACK"
    # (min, max): after a worker failure, re-form the group at the
    # capacity that survives, within this range (train/scaling_policy.py)
    elastic: Optional[tuple] = None
    # a gang that cannot be placed within this window fails the attempt
    # (it counts against FailureConfig) instead of waiting. None = wait
    # forever (the fixed-size default); elastic runs default to 120 s.
    placement_timeout_s: Optional[float] = None

    def worker_resources(self) -> Dict[str, float]:
        if self.resources_per_worker:
            return dict(self.resources_per_worker)
        res = {"CPU": 1.0}
        if self.use_gpu:
            res["GPU"] = 1.0
        return res


@dataclasses.dataclass
class FailureConfig:
    """``max_failures`` < 0: retry without end."""

    max_failures: int = 0


@dataclasses.dataclass
class CheckpointConfig:
    num_to_keep: Optional[int] = None
    checkpoint_score_attribute: Optional[str] = None
    checkpoint_score_order: str = "max"


@dataclasses.dataclass
class RunConfig:
    name: Optional[str] = None
    storage_path: Optional[str] = None
    failure_config: FailureConfig = dataclasses.field(
        default_factory=FailureConfig)
    checkpoint_config: CheckpointConfig = dataclasses.field(
        default_factory=CheckpointConfig)
    # logger callbacks (train/callbacks.py)
    callbacks: list = dataclasses.field(default_factory=list)

    def resolved_storage_path(self) -> str:
        base = self.storage_path or os.path.join(
            os.path.expanduser("~"), "ray_tpu_results")
        name = self.name or "train_run"
        return os.path.join(base, name)
