"""Scheduling strategies (counterpart of
``ray_tpu/util/scheduling_strategies.py``): the reference's import path,
re-exporting the classes of the task-spec module, where the scheduler
consumes them."""

from ray_tpu_torch._private.task_spec import (NodeAffinitySchedulingStrategy,
                                              NodeLabelSchedulingStrategy,
                                              PlacementGroupSchedulingStrategy)

__all__ = ["NodeAffinitySchedulingStrategy",
           "NodeLabelSchedulingStrategy",
           "PlacementGroupSchedulingStrategy"]
