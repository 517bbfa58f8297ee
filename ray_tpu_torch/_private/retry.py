"""Unified retry/backoff policy for control-plane reconnect loops
(counterpart of ``ray_tpu/_private/retry.py``).

Reference capability: the single retryable-gRPC policy of the reference
(``src/ray/rpc/retryable_grpc_client.h`` — every GCS/raylet client
shares one backoff/timeout discipline) instead of per-call-site sleep
constants. Every loop that re-dials a peer (head redial, daemon
head-reconnect, fast-lane reconnect, task retry) goes through a
:class:`RetryPolicy`, so backoff behavior is uniform, bounded, and
observable:

- exponential backoff with FULL JITTER (sleep ~ U(0, min(cap,
  base*mult^attempt)) — the AWS-style decorrelated herd breaker);
- an attempt budget (``max_attempts``) and/or an overall deadline
  (``deadline_s``); per-attempt work can bound itself with
  ``attempt_timeout_s`` (carried on the policy for the call site);
- counters exported through the existing Prometheus registry
  (``ray_tpu_retries_total`` / ``ray_tpu_retry_backoff_seconds_total``
  / ``ray_tpu_retry_exhausted_total``, labeled by loop name).

Usage::

    policy = RetryPolicy.default(deadline_s=grace)
    client = policy.run(lambda: HeadClient(addr),
                        loop="daemon.head_reconnect",
                        retry_on=(OSError, RpcError))

On exhaustion the LAST exception re-raises, so call sites keep their
existing error contracts (``RpcError`` from a head call, ``OSError``
from a connect).
"""

from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass
from typing import Callable, Optional, Tuple, Type

_rng = random.Random()
_rng_lock = threading.Lock()


def _counter(name: str, desc: str):
    # get-or-create by name on every use: the metrics registry may be
    # cleared between sessions and a cached instance would go dark
    from ray_tpu_torch.util.metrics import Counter
    return Counter(name, desc, tag_keys=("loop",))


def record_retry(loop: str, backoff_s: float = 0.0) -> None:
    """Count one retry (and its backoff) for ``loop`` in the Prometheus
    registry. Used by :meth:`RetryPolicy.run` and by retry paths that
    manage their own resubmission (the task-retry path)."""
    tags = {"loop": loop}
    _counter("ray_tpu_retries_total",
             "control-plane retry attempts by loop").inc(tags=tags)
    if backoff_s > 0:
        _counter("ray_tpu_retry_backoff_seconds_total",
                 "total seconds slept in retry backoff by loop").inc(
                     backoff_s, tags=tags)


def record_exhausted(loop: str) -> None:
    _counter("ray_tpu_retry_exhausted_total",
             "retry loops that gave up (budget/deadline hit)").inc(
                 tags={"loop": loop})


@dataclass(frozen=True)
class RetryPolicy:
    """Immutable backoff schedule; share instances freely across threads."""

    max_attempts: int = 0          # total fn invocations; 0 = unbounded
    base_s: float = 0.05           # first backoff cap
    max_backoff_s: float = 2.0     # backoff cap ceiling
    multiplier: float = 2.0
    deadline_s: float = 0.0        # overall budget; 0 = none
    attempt_timeout_s: float = 0.0 # advisory per-attempt bound (0 = none)
    jitter: bool = True            # full jitter; False = deterministic cap

    @classmethod
    def default(cls, **overrides) -> "RetryPolicy":
        """Policy seeded from the central flag table (config.py)."""
        from ray_tpu_torch._private.config import cfg
        base = {"base_s": cfg().retry_base_backoff_s,
                "max_backoff_s": cfg().retry_max_backoff_s}
        base.update(overrides)
        return cls(**base)

    def backoff_s(self, attempt: int,
                  rng: Optional[random.Random] = None) -> float:
        """Sleep for the given 0-based failed-attempt index."""
        # exponent clamp: an unlimited-retry task's attempt number can
        # grow past float range; by 64 doublings the cap governs anyway
        cap = min(self.max_backoff_s,
                  self.base_s * (self.multiplier ** min(attempt, 64)))
        if not self.jitter:
            return cap
        if rng is not None:
            return rng.uniform(0.0, cap)
        with _rng_lock:
            return _rng.uniform(0.0, cap)

    def run(self, fn: Callable[[], "object"], *, loop: str,
            retry_on: Tuple[Type[BaseException], ...] = (Exception,),
            rng: Optional[random.Random] = None,
            sleep: Callable[[float], None] = time.sleep,
            abort: Optional[Callable[[], bool]] = None,
            on_retry: Optional[Callable[[BaseException, int], None]]
            = None):
        """Invoke ``fn`` until it returns, an exception outside
        ``retry_on`` escapes, or the budget/deadline runs out (the last
        exception then re-raises). ``abort()`` is polled before each
        backoff so shutdown paths exit promptly; ``on_retry(exc, n)``
        runs before each re-invocation (redial hooks)."""
        deadline = (time.monotonic() + self.deadline_s
                    if self.deadline_s > 0 else None)
        attempt = 0
        while True:
            try:
                return fn()
            except retry_on as e:  # noqa: PERF203 — this IS the loop
                attempt += 1
                now = time.monotonic()
                out_of_budget = (
                    (self.max_attempts and attempt >= self.max_attempts)
                    or (deadline is not None and now >= deadline)
                    or (abort is not None and abort()))
                if out_of_budget:
                    record_exhausted(loop)
                    raise
                delay = self.backoff_s(attempt - 1, rng)
                if deadline is not None:
                    delay = min(delay, max(0.0, deadline - now))
                record_retry(loop, delay)
                if delay > 0:
                    sleep(delay)
                if abort is not None and abort():
                    record_exhausted(loop)
                    raise
                if on_retry is not None:
                    on_retry(e, attempt)


# The task-retry path resubmits through the scheduler rather than
# re-invoking a closure, so it consumes the schedule directly:
# backoff_s(attempt) + record_retry. Short caps — a crash-looping task
# must not wedge a dispatch thread for seconds.
TASK_RETRY = RetryPolicy(base_s=0.01, max_backoff_s=0.25)


# ---------------------------------------------------------------------------
# shared deferral wheel: ONE daemon thread services every delayed
# callback (per-retry threading.Timer threads explode under a
# node-death fan-out over a large backlog)
# ---------------------------------------------------------------------------

class _TimerWheel:
    def __init__(self):
        import heapq
        self._heapq = heapq
        self._heap: list = []
        self._seq = 0
        self._cv = threading.Condition()
        self._thread: Optional[threading.Thread] = None

    def defer(self, delay_s: float, fn: Callable[[], None]) -> None:
        due = time.monotonic() + max(0.0, delay_s)
        with self._cv:
            self._seq += 1
            self._heapq.heappush(self._heap, (due, self._seq, fn))
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(
                    target=self._loop, daemon=True, name="retry-timer")
                self._thread.start()
            self._cv.notify()

    def _loop(self) -> None:
        while True:
            with self._cv:
                while not self._heap:
                    self._cv.wait()
                due, _, fn = self._heap[0]
                now = time.monotonic()
                if due > now:
                    self._cv.wait(due - now)
                    continue
                self._heapq.heappop(self._heap)
            try:
                fn()
            except Exception:   # a resubmit must not kill the wheel
                pass


_wheel = _TimerWheel()


def defer(delay_s: float, fn: Callable[[], None]) -> None:
    """Run ``fn`` after ``delay_s`` on the shared timer thread."""
    _wheel.defer(delay_s, fn)
