"""Node memory-pressure controller: fused degradation levels
(counterpart of ``ray_tpu/_private/pressure.py``).

Reference Ray treats host-memory pressure as a first-class failure
domain (``common/memory_monitor.h:52`` drives worker-killing policies,
``raylet/local_object_manager.h:101`` spills the plasma store). The runtime
splits the same duty across three signals that previously never talked
to each other — host RSS (:class:`MemoryMonitor`), arena occupancy
(``ObjectTable``), and the spill-dir budget. The
:class:`PressureController` fuses them into ONE per-node level:

- ``ok``   — nothing to do;
- ``soft`` — degrade proactively: spill cold arena entries down to the
  soft watermark, throttle push-prefetch admission (worker.py);
- ``hard`` — shed load: reject NEW client reservations/puts with the
  typed retriable :class:`MemoryPressureError` (drivers ride
  ``RetryPolicy`` until relief), let the memory monitor preempt
  over-quota tenants first (``TenantAwarePolicy``), and advertise the
  level through the syncer so ``pick_node`` soft-excludes the node.

Levels only ever degrade service, never correctness: reads (and the
chunk pulls that repair placement) always pass, and a killed worker
surfaces as a typed retriable ``OutOfMemoryError`` — never silent
death. The whole subsystem is gated on ``cfg().memory_pressure``
(default off) and costs nothing when disarmed
(the port's ``memory_pressure`` flag).
"""

from __future__ import annotations

import threading
from typing import Callable, Optional, Tuple

from ray_tpu_torch._private import failpoints as _fp

LEVEL_OK = "ok"
LEVEL_SOFT = "soft"
LEVEL_HARD = "hard"
LEVELS = (LEVEL_OK, LEVEL_SOFT, LEVEL_HARD)

#: host-RSS headroom below the kill threshold where we call it "soft":
#: start degrading BEFORE the monitor starts shooting workers.
HOST_SOFT_MARGIN = 0.10


def parse_watermarks(raw: str) -> Tuple[float, float]:
    """``"0.70,0.85"`` -> ``(0.70, 0.85)``; malformed input falls back
    to the defaults rather than disabling pressure response."""
    try:
        parts = [float(p) for p in str(raw).split(",")]
        soft, hard = parts[0], parts[1]
        if 0.0 < soft <= hard <= 1.0:
            return soft, hard
    except (ValueError, IndexError):
        pass
    return 0.70, 0.85


def compute_level(host_frac: float, arena_frac: float, spill_frac: float,
                  wm_soft: float, wm_hard: float,
                  host_threshold: float) -> str:
    """Pure fusion rule (unit-tested in tests/test_torch_pressure.py):

    - hard: host RSS at/over the monitor's kill threshold, the arena at
      its hard watermark, or the arena soft-full while the spill-dir
      budget is exhausted (nowhere left to degrade to);
    - soft: host RSS inside :data:`HOST_SOFT_MARGIN` of the threshold,
      or the arena over its soft watermark;
    - ok otherwise.
    """
    if host_frac >= host_threshold or arena_frac >= wm_hard \
            or (arena_frac >= wm_soft and spill_frac >= 1.0):
        return LEVEL_HARD
    if host_frac >= host_threshold - HOST_SOFT_MARGIN \
            or arena_frac >= wm_soft:
        return LEVEL_SOFT
    return LEVEL_OK


def publish_pressure_level(level: str) -> None:
    """``ray_tpu_node_memory_pressure{level}`` enum gauge: 1 on the
    active level's series, 0 on the others (the federation-friendly
    prometheus enum idiom)."""
    try:
        from ray_tpu_torch.util.metrics import Gauge
        g = Gauge("ray_tpu_node_memory_pressure",
                  "node memory-pressure level (1 on the active series)",
                  tag_keys=("level",))
        for name in LEVELS:
            g.set(1.0 if name == level else 0.0, tags={"level": name})
    except Exception:
        pass    # metrics must never fail the control path


def count_oom_preemption(reason: str) -> None:
    """The memory monitor preempted one worker — ``reason`` is
    ``tenant_quota`` when the tenant-aware policy picked an over-quota
    job's worker, ``host`` for a plain threshold breach."""
    try:
        from ray_tpu_torch.util.metrics import Counter
        Counter("ray_tpu_oom_preemptions_total",
                "workers preempted by the memory monitor under host "
                "memory pressure",
                tag_keys=("reason",)).inc(1, tags={"reason": reason})
    except Exception:
        pass    # metrics must never fail the control path


class PressureController:
    """Periodically fuses the node's memory signals into a level and
    acts on transitions. Owned by the daemon service (one per node);
    built only when ``cfg().memory_pressure`` is on."""

    def __init__(self, objects, monitor=None,
                 tick_s: Optional[float] = None,
                 watermarks: Optional[str] = None,
                 host_threshold: Optional[float] = None,
                 on_level: Optional[Callable[[str, str], None]] = None):
        from ray_tpu_torch._private.config import cfg
        self.objects = objects
        self.monitor = monitor
        self.tick_s = float(tick_s if tick_s is not None
                            else cfg().pressure_tick_s)
        self.wm_soft, self.wm_hard = parse_watermarks(
            watermarks if watermarks is not None
            else cfg().arena_spill_watermarks)
        self.host_threshold = float(
            host_threshold if host_threshold is not None
            else cfg().memory_usage_threshold)
        self.on_level = on_level
        self.level = LEVEL_OK
        self.ticks = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="pressure-controller")

    # -- lifecycle --------------------------------------------------------
    def start(self) -> None:
        publish_pressure_level(self.level)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()

    # -- sampling ---------------------------------------------------------
    def fractions(self) -> Tuple[float, float, float]:
        """(host, arena, spill) occupancy fractions, each 0.0 when its
        signal is absent (no monitor / no arena / unbounded budget)."""
        host = 0.0
        if self.monitor is not None:
            try:
                limit = max(int(self.monitor.limit), 1)
                host = self.monitor.usage_bytes() / limit
            except Exception:
                host = 0.0
        arena = 0.0
        shm = getattr(self.objects, "_shm", None)
        if shm is not None:
            try:
                arena = shm.used_bytes() / max(self.objects.capacity, 1)
            except Exception:
                arena = 0.0
        spill = 0.0
        budget = int(getattr(self.objects, "spill_budget", 0) or 0)
        if budget:
            spill = self.objects.spilled_bytes() / budget
        return host, arena, spill

    # -- control loop -----------------------------------------------------
    def _loop(self) -> None:
        while not self._stop.wait(self.tick_s):
            try:
                self.tick()
            except Exception:
                pass

    def tick(self) -> str:
        """One fuse-and-act pass; returns the (possibly new) level.
        Failpoint ``pressure.level``: drop = skip this tick, return(X) =
        override the computed level with X — chaos scripts force
        hard-then-relief without real ballast."""
        self.ticks += 1
        level = None
        if _fp.ENABLED:
            fired = _fp.fire("pressure.level", current=self.level)
            if fired is _fp.DROP:
                return self.level
            if isinstance(fired, _fp.Return):
                fired = fired.value
            if isinstance(fired, str) and fired in LEVELS:
                level = fired
        if level is None:
            host, arena, spill = self.fractions()
            level = compute_level(host, arena, spill,
                                  self.wm_soft, self.wm_hard,
                                  self.host_threshold)
        if level != self.level:
            old, self.level = self.level, level
            publish_pressure_level(level)
            if self.on_level is not None:
                try:
                    self.on_level(old, level)
                except Exception:
                    pass
        if level != LEVEL_OK:
            # proactive degradation: walk the arena back under its soft
            # watermark off cold, unpinned entries (pins always win)
            try:
                self.objects.spill_to_fraction(self.wm_soft)
            except Exception:
                pass
        return self.level
