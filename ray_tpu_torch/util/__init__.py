"""Utilities of the port (counterpart of ``ray_tpu/util``): placement
groups, the scheduling strategies and the in-process metrics registry,
``util.metrics``. ``ActorPool`` and ``Queue`` come with ROADMAP A11f."""

from ray_tpu_torch.util.placement_group import (PlacementGroup,
                                                placement_group,
                                                placement_group_table,
                                                remove_placement_group)

__all__ = ["PlacementGroup", "placement_group", "remove_placement_group",
           "placement_group_table"]
