"""Per-process asyncio event loop of the control plane (counterpart of
``ray_tpu/_private/eventloop.py``).

One lazily-started loop thread per process (``get_loop``), shared by the
RPC wire (``aio.py``), the daemon's reply pump and each node's dispatch
pass when ``cfg().async_core`` is on (the default, as in JAX). Handlers
run inline on the loop only when marked ``@rpc.loop_safe``; anything that
may block is handed to a thread.

Instrumentation (the port's ``util/metrics.py``):

- ``ray_tpu_event_loop_lag_seconds{proc}``: a repeating ``call_later``
  probe measures how late the loop ran it. Sustained lag means a callback
  blocks the loop or the loop is saturated.
- ``ray_tpu_event_loop_slow_callbacks_total{proc}``: the slow-callback
  watchdog. With ``cfg().async_debug`` the loop runs in asyncio debug mode
  with ``slow_callback_duration = cfg().loop_slow_callback_s`` and a
  logging filter counts asyncio's warning for each offender; the lag probe
  also counts each probe that arrived later than that threshold.

Thread affinity: callbacks scheduled on the loop are loop-only; a thread
reaches them through ``call_soon_threadsafe``. ``assert_loop()`` raises,
under ``cfg().lock_sanitizer``, when loop-only code runs off the loop.
"""

from __future__ import annotations

import asyncio
import logging
import os
import threading
from typing import Any, Callable, Optional

logger = logging.getLogger(__name__)

_LOCK = threading.Lock()
_LOOP: Optional[asyncio.AbstractEventLoop] = None
_LOOP_IDENT: Optional[int] = None   # the loop thread's threading.get_ident()
_PROC = ""                          # {proc} label of the loop's metrics


def set_proc_label(proc: str) -> None:
    """Name this process's loop in metrics ("driver", "head",
    "daemon:<hex8>"). Callable before or after the loop starts: the probe
    reads it at each sample."""
    global _PROC
    _PROC = proc


def proc_label() -> str:
    return _PROC or f"pid:{os.getpid()}"


def running() -> bool:
    return _LOOP is not None and not _LOOP.is_closed()


def on_loop() -> bool:
    """True when the calling thread is the loop thread."""
    return _LOOP_IDENT is not None and threading.get_ident() == _LOOP_IDENT


def assert_loop(what: str = "loop-only code") -> None:
    """Loop-affinity sanitizer: raise when loop-only code runs on another
    thread. Armed by ``cfg().lock_sanitizer``; disarmed it costs one flag
    read."""
    from ray_tpu_torch._private.config import cfg
    if not cfg().lock_sanitizer:
        return
    if _LOOP_IDENT is not None and threading.get_ident() != _LOOP_IDENT:
        raise RuntimeError(
            f"{what} ran on thread {threading.current_thread().name!r}, "
            f"not the event loop — hand it to the loop via "
            f"call_soon_threadsafe")


class _SlowCallbackCounter(logging.Filter):
    """Counts asyncio's debug-mode slow-callback warnings ("Executing
    <Handle ...> took 0.123 seconds") into the watchdog counter; the
    record itself still reaches the log."""

    def filter(self, record: logging.LogRecord) -> bool:
        try:
            msg = record.getMessage()
            if "Executing" in msg and " took " in msg:
                _slow_callback_counter().inc(1.0,
                                             tags={"proc": proc_label()})
        except Exception:
            pass    # observability must never break logging
        return True


def _lag_gauge():
    from ray_tpu_torch.util.metrics import Gauge
    return Gauge("ray_tpu_event_loop_lag_seconds",
                 "scheduled-vs-ran lag of the control-plane event loop "
                 "(a repeating call_later probe; sustained lag = a "
                 "blocking callback or a saturated loop)", ("proc",))


def _slow_callback_counter():
    from ray_tpu_torch.util.metrics import Counter
    return Counter("ray_tpu_event_loop_slow_callbacks_total",
                   "event-loop callbacks that overran the "
                   "loop_slow_callback_s threshold (asyncio debug-mode "
                   "timing plus the lag-probe watchdog)", ("proc",))


def _arm_probe(loop: asyncio.AbstractEventLoop) -> None:  #: loop-only
    from ray_tpu_torch._private.config import cfg
    interval = float(cfg().loop_lag_probe_s)
    if interval <= 0:
        return
    threshold = float(cfg().loop_slow_callback_s)
    gauge = _lag_gauge()
    counter = _slow_callback_counter()
    expected = [loop.time() + interval]

    def probe() -> None:
        lag = max(0.0, loop.time() - expected[0])
        gauge.set(lag, tags={"proc": proc_label()})
        if threshold > 0 and lag > threshold:
            # the probe itself ran late: a callback (or a GIL hold)
            # blocked the loop past the threshold; counted outside debug
            # mode too, where asyncio's own timer is off
            counter.inc(1.0, tags={"proc": proc_label()})
        expected[0] = loop.time() + interval
        loop.call_later(interval, probe)

    loop.call_later(interval, probe)


def get_loop() -> asyncio.AbstractEventLoop:
    """The process-wide control-plane loop, started on first use."""
    global _LOOP
    with _LOCK:
        if _LOOP is not None and not _LOOP.is_closed():
            return _LOOP
        loop = asyncio.new_event_loop()
        from ray_tpu_torch._private.config import cfg
        if cfg().async_debug:
            loop.set_debug(True)
            loop.slow_callback_duration = max(
                1e-4, float(cfg().loop_slow_callback_s))
            aio_logger = logging.getLogger("asyncio")
            if not any(isinstance(f, _SlowCallbackCounter)
                       for f in aio_logger.filters):
                aio_logger.addFilter(_SlowCallbackCounter())

        def run() -> None:
            global _LOOP_IDENT
            _LOOP_IDENT = threading.get_ident()
            asyncio.set_event_loop(loop)
            try:
                loop.run_forever()
            finally:
                _reset_ident()

        threading.Thread(target=run, daemon=True,
                         name="ray-tpu-loop").start()
        loop.call_soon_threadsafe(_arm_probe, loop)
        _LOOP = loop
        return _LOOP


def _reset_ident() -> None:
    global _LOOP_IDENT
    _LOOP_IDENT = None


def call_threadsafe(fn: Callable[..., Any], *args: Any) -> None:
    """Schedule ``fn(*args)`` on the loop from any thread."""
    get_loop().call_soon_threadsafe(fn, *args)


def run_coro(coro, timeout: Optional[float] = None) -> Any:
    """Run a coroutine on the loop and block for its result (thread
    context only: on the loop this would deadlock)."""
    if on_loop():
        coro.close()
        raise RuntimeError("run_coro called on the event loop thread")
    return asyncio.run_coroutine_threadsafe(coro, get_loop()).result(timeout)


def shutdown_for_tests() -> None:
    """Stop and drop the singleton loop (test isolation only: the
    production loop is a daemon thread that ends with the process)."""
    global _LOOP
    with _LOCK:
        loop = _LOOP
        _LOOP = None
    if loop is None or loop.is_closed():
        return
    try:
        loop.call_soon_threadsafe(loop.stop)
    except RuntimeError:
        pass


if hasattr(os, "register_at_fork"):
    # a forked child inherits the loop's data structures but not its
    # thread: drop the singleton so the child starts a fresh loop instead
    # of scheduling onto a loop nobody runs
    os.register_at_fork(after_in_child=lambda: (
        globals().__setitem__("_LOOP", None),
        globals().__setitem__("_LOOP_IDENT", None)))
