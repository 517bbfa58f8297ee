"""DataContext (counterpart of ``ray_tpu/data/context.py``, the same code;
reference: `python/ray/data/context.py` — thread-inherited
execution configuration propagated into tasks) + execution stats
(reference: `data/_internal/stats.py`)."""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Dict, List, Optional


@dataclasses.dataclass
class DataContext:
    target_max_block_size: int = 128 * 1024 * 1024
    max_in_flight_tasks_per_operator: int = 8
    max_operator_output_queue: int = 16
    default_batch_size: int = 256
    enable_progress_bars: bool = False
    eager_free: bool = True
    # store-usage fraction above which upstream operators are throttled
    # (backpressure_policy.ObjectStoreMemoryBackpressurePolicy)
    object_store_backpressure_threshold: float = 0.8

    _local = threading.local()

    @classmethod
    def get_current(cls) -> "DataContext":
        ctx = getattr(cls._local, "ctx", None)
        if ctx is None:
            ctx = cls()
            cls._local.ctx = ctx
        return ctx

    @classmethod
    def _set_current(cls, ctx: "DataContext") -> None:
        cls._local.ctx = ctx


class DatasetStats:
    """Per-dataset execution statistics (operator timings, block counts).

    Every instance also registers in a process-global ring so the
    dashboard can surface live per-dataset operator metrics (reference:
    `data/_internal/stats.py` StatsManager -> dashboard data module)."""

    _RECENT: "List[DatasetStats]" = []
    _RECENT_CAP = 50

    def __init__(self):
        self._lock = threading.Lock()
        self.operators: Dict[str, Dict[str, float]] = {}
        self.created_at = time.time()
        self._registered = False

    # Datasets travel inside Trainers (Tune trials pickle the whole
    # trainer, datasets included — reference: train+tune integration);
    # stats are per-process observability, so the lock/ring membership
    # stay out of the pickle and a fresh lock is minted on arrival.
    def __getstate__(self):
        state = dict(self.__dict__)
        state.pop("_lock", None)
        state["_registered"] = False
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._lock = threading.Lock()

    def _register(self) -> None:
        # ring membership starts at the FIRST record(): every lazy
        # transform builds a Dataset (and stats) that never executes —
        # registering at __init__ would evict the executed ones
        if not self._registered:
            self._registered = True
            DatasetStats._RECENT.append(self)
            del DatasetStats._RECENT[:-DatasetStats._RECENT_CAP]

    @classmethod
    def recent(cls) -> List[Dict[str, Any]]:
        out = []
        for s in list(cls._RECENT):
            with s._lock:                       # snapshot: record() may
                ops = {k: dict(v)               # be mutating mid-dump
                       for k, v in s.operators.items()}
            if ops:
                out.append({"created_at": s.created_at,
                            "operators": ops})
        return out

    def record(self, op_name: str, *, blocks: int = 0, rows: int = 0,
               seconds: float = 0.0) -> None:
        self._register()
        with self._lock:
            entry = self.operators.setdefault(
                op_name, {"blocks": 0, "rows": 0, "seconds": 0.0})
            entry["blocks"] += blocks
            entry["rows"] += rows
            entry["seconds"] += seconds

    def summary(self) -> str:
        with self._lock:
            lines = ["Dataset execution stats:"]
            for name, e in self.operators.items():
                lines.append(
                    f"  {name}: {int(e['blocks'])} blocks, "
                    f"{int(e['rows'])} rows, {e['seconds']:.3f}s")
            return "\n".join(lines)
