"""Lock-order sanitizer and contention meter for the runtime's locks
(counterpart of ``ray_tpu/_private/lock_sanitizer.py``).

An opt-in sanitizer (``RAY_TPU_LOCK_SANITIZER=1`` or
``_system_config={"lock_sanitizer": True}``) wraps the runtime's named
locks, records the set of locks each thread holds at every acquisition,
builds the global acquired-before graph between lock names, and reports
the first cycle (a potential deadlock) with both acquisition stacks. The
same flag arms ``eventloop.assert_loop``. Disabled, ``tracked_lock``
returns a plain lock: no overhead.

A second opt-in mode (``RAY_TPU_LOCK_METRICS=1`` /
``_system_config={"lock_metrics": True}``) swaps in :class:`MeteredLock`:
wait-time and hold-time histograms and a contended counter per lock name,
exported as ``ray_tpu_lock_wait_seconds{lock}`` /
``ray_tpu_lock_hold_seconds{lock}`` / ``ray_tpu_lock_contended_total{lock}``
through ``metrics.export_snapshot`` (so a daemon's lock figures federate
to the head like every other metric). The sanitizer wins when both are
set: the two wrappers answer different questions, and stacking them would
tax the very paths being measured.

Used by the runtime's central locks (the object store, the reference
count, the scheduler, the event buffer).
"""

from __future__ import annotations

import os
import threading
import time
import traceback
from typing import Dict, List, Optional, Set, Tuple


def enabled() -> bool:
    if os.environ.get("RAY_TPU_LOCK_SANITIZER") == "1":
        return True
    try:
        from ray_tpu_torch._private.config import cfg
        return bool(cfg().lock_sanitizer)
    except Exception:
        return False


class LockOrderViolation(RuntimeWarning):
    pass


class _Graph:
    """acquired-before edges between lock CLASSES (names) + first-seen
    stacks. Class-level like Linux lockdep: an inversion between any
    two instances of two classes is a discipline violation even if
    those exact instances never deadlock. Same-class nested acquisition
    of DISTINCT instances is skipped (would need lockdep-style nesting
    annotations to express)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._edges: Dict[str, Set[str]] = {}
        self._stacks: Dict[Tuple[str, str], str] = {}
        self._reported: Set[Tuple[str, str]] = set()
        self.violations: List[str] = []

    def add(self, held: List[Tuple[str, int]], acquiring: str,
            acquiring_id: int) -> Optional[str]:
        with self._lock:
            for h_name, h_id in held:
                if h_id == acquiring_id:
                    continue            # true re-entrancy: same instance
                if h_name == acquiring:
                    continue            # same class, distinct instance
                edge = (h_name, acquiring)
                if acquiring not in self._edges.setdefault(h_name, set()):
                    self._edges[h_name].add(acquiring)
                    self._stacks[edge] = "".join(
                        traceback.format_stack(limit=8)[:-2])
                # cycle check: does a path acquiring -> ... -> h exist?
                if self._reaches(acquiring, h_name):
                    if edge in self._reported:
                        continue        # dedupe: one report per edge
                    self._reported.add(edge)
                    report = self._report(h_name, acquiring)
                    self.violations.append(report)
                    return report
        return None

    def _reaches(self, src: str, dst: str) -> bool:
        seen = set()
        stack = [src]
        while stack:
            cur = stack.pop()
            if cur == dst:
                return True
            if cur in seen:
                continue
            seen.add(cur)
            stack.extend(self._edges.get(cur, ()))
        return False

    def _report(self, held: str, acquiring: str) -> str:
        fwd = self._stacks.get((held, acquiring), "<first sighting>")
        rev = self._stacks.get((acquiring, held), "<reverse edge on a path>")
        return (f"lock-order inversion: {held!r} -> {acquiring!r} "
                f"conflicts with an existing {acquiring!r} ->...-> "
                f"{held!r} path\n--- this acquisition ---\n{fwd}"
                f"--- conflicting order first seen ---\n{rev}")

    def reset(self) -> None:
        with self._lock:
            self._edges.clear()
            self._stacks.clear()
            self._reported.clear()
            self.violations.clear()


GRAPH = _Graph()
_tls = threading.local()


def _held() -> List[str]:
    held = getattr(_tls, "held", None)
    if held is None:
        held = _tls.held = []
    return held


class TrackedLock:
    """Lock wrapper feeding the acquired-before graph. Violations are
    recorded (and warned) rather than raised — the sanitizer must never
    turn a latent hazard into a live crash."""

    def __init__(self, name: str, reentrant: bool = True):
        self.name = name
        self._lock = (threading.RLock() if reentrant
                      else threading.Lock())

    def acquire(self, blocking: bool = True, timeout: float = -1):
        report = GRAPH.add(_held(), self.name, id(self))
        if report is not None:
            import warnings
            warnings.warn(report, LockOrderViolation, stacklevel=2)
        ok = self._lock.acquire(blocking, timeout)
        if ok:
            _held().append((self.name, id(self)))
        return ok

    def release(self) -> None:
        held = _held()
        key = (self.name, id(self))
        for i in range(len(held) - 1, -1, -1):   # last occurrence
            if held[i] == key:
                del held[i]
                break
        self._lock.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False


# ---------------------------------------------------------------------------
# contention meter (the observability twin of the sanitizer)
# ---------------------------------------------------------------------------

def metering_enabled() -> bool:
    if os.environ.get("RAY_TPU_LOCK_METRICS") == "1":
        return True
    try:
        from ray_tpu_torch._private.config import cfg
        return bool(cfg().lock_metrics)
    except Exception:
        return False


# Shared wait/hold bucket boundaries (seconds). 100µs..1s covers the
# control plane's spectrum: uncontended acquires land in the first
# bucket, a convoying ledger lock shows up in the 1-100ms ones.
METER_BOUNDS = (0.0001, 0.001, 0.01, 0.1, 1.0)

_METER_REG_LOCK = threading.Lock()
#: guarded by _METER_REG_LOCK (name -> live MeteredLock instances)
_METERED: Dict[str, List["MeteredLock"]] = {}


class MeteredLock:
    """Lock wrapper measuring wait (time blocked acquiring) and hold
    (time held, outermost acquire→release for RLocks) into per-instance
    histogram buckets, aggregated per NAME by
    :func:`lock_metric_entries`.

    Contention is detected with a non-blocking probe, so the
    uncontended fast path pays one extra C call and no clock read for
    wait. Bucket counters are mutated only while the measured lock is
    HELD — self-serialized, no second lock. Reads (the exporter) are
    lockless and may observe a torn in-progress update; a snapshot
    being off by one observation is acceptable for monitoring."""

    __slots__ = ("name", "_lock", "_reentrant", "_tls", "_hold_t0",
                 "wait_counts", "wait_sum", "wait_total",
                 "hold_counts", "hold_sum", "hold_total", "contended")

    def __init__(self, name: str, reentrant: bool = True):
        self.name = name
        self._lock = (threading.RLock() if reentrant
                      else threading.Lock())
        self._reentrant = reentrant
        self._tls = threading.local()
        self._hold_t0 = 0.0             # non-reentrant holder's t0
        n = len(METER_BOUNDS) + 1
        #: guarded by self._lock (mutated only while holding it)
        self.wait_counts = [0] * n
        self.wait_sum = 0.0
        self.wait_total = 0
        self.hold_counts = [0] * n
        self.hold_sum = 0.0
        self.hold_total = 0
        self.contended = 0
        with _METER_REG_LOCK:
            _METERED.setdefault(name, []).append(self)

    @staticmethod
    def _bucket(counts: List[int], value: float) -> None:
        i = 0
        while i < len(METER_BOUNDS) and value > METER_BOUNDS[i]:
            i += 1
        counts[i] += 1

    def acquire(self, blocking: bool = True, timeout: float = -1):
        if self._reentrant and getattr(self._tls, "depth", 0):
            ok = self._lock.acquire(blocking, timeout)
            if ok:
                self._tls.depth += 1
            return ok
        if self._lock.acquire(False):       # uncontended fast path
            wait = 0.0
            was_contended = False
        else:
            if not blocking:
                return False
            t0 = time.perf_counter()
            if not self._lock.acquire(True, timeout):
                return False
            wait = time.perf_counter() - t0
            was_contended = True
        now = time.perf_counter()
        if self._reentrant:
            self._tls.depth = 1
            self._tls.hold_t0 = now
        else:
            self._hold_t0 = now
        # the lock is held here (taken by the acquire calls above)
        self._bucket(self.wait_counts, wait)  # raylint: disable=guarded-by
        self.wait_sum += wait
        self.wait_total += 1
        if was_contended:
            self.contended += 1
        return True

    def release(self) -> None:
        if self._reentrant:
            depth = getattr(self._tls, "depth", 1)
            if depth > 1:
                self._tls.depth = depth - 1
                self._lock.release()
                return
            t0 = getattr(self._tls, "hold_t0", 0.0)
            self._tls.depth = 0
        else:
            t0 = self._hold_t0
        hold = time.perf_counter() - t0 if t0 else 0.0
        self._bucket(self.hold_counts, hold)
        self.hold_sum += hold
        self.hold_total += 1
        self._lock.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False


def lock_metric_entries() -> List[Dict]:
    """Per-name aggregates of every live MeteredLock, in the
    ``metrics.export_snapshot`` wire-entry format (hooked in there, so
    daemon lock metrics federate to the head automatically). Empty when
    metering never engaged."""
    with _METER_REG_LOCK:
        by_name = {name: list(insts) for name, insts in _METERED.items()}
    wait_rows, hold_rows, contended = [], [], []
    n = len(METER_BOUNDS) + 1
    for name in sorted(by_name):
        wc, ws, wt = [0] * n, 0.0, 0
        hc, hs, ht = [0] * n, 0.0, 0
        cont = 0
        for inst in by_name[name]:
            for i, c in enumerate(inst.wait_counts):
                wc[i] += c
            ws += inst.wait_sum
            wt += inst.wait_total
            for i, c in enumerate(inst.hold_counts):
                hc[i] += c
            hs += inst.hold_sum
            ht += inst.hold_total
            cont += inst.contended
        if not wt and not ht:
            continue                    # constructed but never acquired
        label = [["lock", name]]
        wait_rows.append([label, wc, ws, wt])
        hold_rows.append([label, hc, hs, ht])
        contended.append([label, cont])
    out: List[Dict] = []
    if wait_rows:
        out.append({"name": "ray_tpu_lock_wait_seconds",
                    "kind": "histogram",
                    "description": "time blocked acquiring a tracked "
                                   "runtime lock (lock_metrics mode)",
                    "boundaries": list(METER_BOUNDS),
                    "hist": wait_rows})
        out.append({"name": "ray_tpu_lock_hold_seconds",
                    "kind": "histogram",
                    "description": "time a tracked runtime lock was "
                                   "held (outermost acquire->release)",
                    "boundaries": list(METER_BOUNDS),
                    "hist": hold_rows})
        out.append({"name": "ray_tpu_lock_contended_total",
                    "kind": "counter",
                    "description": "acquisitions that blocked on a "
                                   "tracked runtime lock",
                    "samples": contended})
    return out


def tracked_lock(name: str, reentrant: bool = True):
    """A named runtime lock: sanitized when the sanitizer is enabled,
    metered when lock_metrics is, plain otherwise. ``reentrant=False``
    preserves plain-Lock semantics on every path."""
    if enabled():
        return TrackedLock(name, reentrant=reentrant)
    if metering_enabled():
        return MeteredLock(name, reentrant=reentrant)
    return threading.RLock() if reentrant else threading.Lock()
