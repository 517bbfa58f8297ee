"""Accelerator detection and visibility (counterpart of
``ray_tpu/_private/accelerators.py``, with its names).

The pod's variables (``TPU_VISIBLE_CHIPS``, ``TPU_ACCELERATOR_TYPE``,
``TPU_WORKER_ID``, ``TPU_NAME``) are read as JAX reads them. Where JAX
falls back to its TPU devices, the port falls back to the CUDA cards: their
count (0 in a worker process, whose card is hidden, ``_private/platform.py``)
and the first card's name. The chip resource is ``GPU``, the key onto which
the port aliases every chip demand (``_private/task_spec.py``). As in JAX,
nothing calls ``accelerator_resources`` at node registration.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

TPU_VISIBLE_CHIPS_ENV = "TPU_VISIBLE_CHIPS"
TPU_ACCELERATOR_TYPE_ENV = "TPU_ACCELERATOR_TYPE"   # e.g. "v5p-64"
TPU_WORKER_ID_ENV = "TPU_WORKER_ID"
TPU_NAME_ENV = "TPU_NAME"


def detect_tpu_chips() -> int:
    """Number of chips visible to this process: the pod's list, else the
    CUDA cards."""
    visible = os.environ.get(TPU_VISIBLE_CHIPS_ENV)
    if visible:
        return len([c for c in visible.split(",") if c.strip()])
    try:
        import torch
        return torch.cuda.device_count()
    except Exception:
        return 0


def get_accelerator_type() -> Optional[str]:
    """"v5p-64"-style accelerator type: the pod's variable, else JAX's rule
    on the first card's name (lower case, spaces dropped, then
    ``-{count}``)."""
    env = os.environ.get(TPU_ACCELERATOR_TYPE_ENV)
    if env:
        return env
    try:
        import torch
        count = torch.cuda.device_count()
        if count:
            kind = torch.cuda.get_device_name(0).lower().replace(" ", "")
            return f"{kind}-{count}"
    except Exception:
        pass
    return None


def get_pod_name() -> Optional[str]:
    return os.environ.get(TPU_NAME_ENV)


def get_worker_id() -> Optional[int]:
    wid = os.environ.get(TPU_WORKER_ID_ENV)
    return int(wid) if wid is not None else None


def set_visible_chips(chip_ids: List[int]) -> None:
    """Scope this process to a subset of the pod's chips (the reference's
    set_current_process_visible_accelerator_ids)."""
    os.environ[TPU_VISIBLE_CHIPS_ENV] = ",".join(str(c) for c in chip_ids)


def accelerator_resources() -> Dict[str, float]:
    """This host's chips as a resource dict: ``GPU`` and the
    ``accelerator_type:`` label."""
    chips = detect_tpu_chips()
    if chips == 0:
        return {}
    res: Dict[str, float] = {"GPU": float(chips)}
    acc_type = get_accelerator_type()
    if acc_type:
        res[f"accelerator_type:{acc_type}"] = 1.0
    return res
