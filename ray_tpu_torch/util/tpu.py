"""Pod helpers under the reference's import path (counterpart of
``ray_tpu/util/tpu.py``): pod identity, the host's worker index, chip
detection and visibility, re-exported from ``_private/accelerators.py``,
and the torus model of ``parallel/topology.py``."""

from ray_tpu_torch._private.accelerators import (detect_tpu_chips,
                                                 get_accelerator_type,
                                                 get_pod_name, get_worker_id,
                                                 set_visible_chips)
from ray_tpu_torch.parallel.topology import TpuTopology

__all__ = ["detect_tpu_chips", "get_accelerator_type", "get_pod_name",
           "get_worker_id", "set_visible_chips", "TpuTopology"]
