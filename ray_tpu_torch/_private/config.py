"""Central config/flag table (counterpart of ``ray_tpu/_private/config.py``).

Every tunable the port's runtime reads lives in one declared table.
Resolution order per flag (highest wins):

1. ``_system_config={...}`` passed to ``ray_tpu_torch.init``
2. ``RAY_TPU_<NAME>`` environment variable
3. the declared default

An unknown ``_system_config`` key raises, as in the reference. The table
holds only the flags the port's runtime reads (the core, its process
workers, the daemon cluster, the asyncio control plane and graceful
drain), each with JAX's name, type, default and variable. The reference's
other flags belong to parts of its runtime the port does not have yet.
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

_PREFIX = "RAY_TPU_"


def _parse_bool(raw: str) -> bool:
    return raw.strip().lower() not in ("0", "false", "no", "off", "")


@dataclass(frozen=True)
class Flag:
    name: str               # lower_snake; env var is RAY_TPU_<UPPER>
    type: Callable
    default: Any
    doc: str

    @property
    def env_var(self) -> str:
        return _PREFIX + self.name.upper()


FLAG_DEFS = [
    Flag("exec_pool_size", int, 0, "worker threads in each node's task "
         "execution pool (the dispatch loop feeds admitted tasks to "
         "this sized pool instead of spawning per task); 0 = the "
         "node's max_worker_threads (256)"),
    Flag("process_workers", bool, True, "run tasks and actors that do not "
         "want the card in worker processes (0 = every task and actor "
         "runs on the driver's threads)"),
    Flag("process_pool_size", int, 0, "idle worker processes kept ready "
         "(0 = auto: min(4, max(2, cpus//2)))"),
    Flag("process_pool_max", int, 32, "most idle worker processes a "
         "finished task leaves for reuse"),
    Flag("fast_lane", bool, True, "plain tasks go through the native core's "
         "lane (csrc/daemon_core.cc, hosted in the driver) to dedicated "
         "worker processes (0 = every process task takes the pipe)"),
    Flag("native_store", bool, True, "each node's object store parks "
         "contiguous numpy arrays of 64 KiB or more in a shared-memory "
         "arena (csrc/shm_store.cc) and hands out zero-copy views"),
    # -- the daemon cluster (_private/head.py, daemon.py, cluster.py) --
    Flag("cluster", str, "", "execution topology: '' = in-process virtual "
         "nodes, 'daemons' = head + node-daemon OS processes"),
    Flag("head_grace_s", float, 20.0, "how long daemons and drivers "
         "re-dial a crashed head before giving up"),
    Flag("heartbeat_interval_s", float, 0.2, "daemon->head heartbeat "
         "period"),
    Flag("node_dead_after_s", float, 1.5, "missed-heartbeat window before "
         "the head declares a node dead"),
    Flag("pull_chunk", int, 4 << 20, "inter-daemon object transfer chunk "
         "size in bytes (push and pull share it)"),
    Flag("objectplane_attach", bool, True, "workers (and the same-host "
         "driver) map the node daemon's shm arena and resolve host-tier "
         "objects zero-copy with shared-slot ref/release; False = the "
         "per-RPC object path"),
    Flag("direct_put_min_bytes", int, 256 * 1024, "puts at or above this "
         "size reserve, write and seal arena space directly (the payload "
         "never rides an RPC or pipe frame); smaller puts stay classic"),
    Flag("raw_tier_min_bytes", int, 64 * 1024, "contiguous numpy arrays "
         "at or above this size store as raw arena bytes that same-node "
         "consumers read as read-only views; the raw path rides direct "
         "puts, so the gate is max(raw_tier_min_bytes, "
         "direct_put_min_bytes)"),
    Flag("push_prefetch", bool, True, "push a task's dependencies to the "
         "consumer's daemon when the task is queued there (PushManager); "
         "False = pull-only transfer"),
    Flag("memory_pressure", bool, False, "arm arena spilling in each "
         "daemon's object table (the pressure controller itself is not "
         "ported); off keeps every put/get path a None-check"),
    Flag("arena_spill_dir", str, "", "directory for spilled arena entries; "
         "empty = spill_<node> in the driver's session dir, removed with "
         "the daemon"),
    Flag("arena_spill_budget_bytes", int, 0, "cap on total bytes parked "
         "in the spill dir (0 = unbounded)"),
    Flag("submit_batch_max", int, 64, "most tasks a push_task_batch "
         "frame"),
    Flag("submit_linger_us", int, 200, "how long (microseconds) the submit "
         "coalescer waits for more tasks before flushing a non-full "
         "batch"),
    Flag("free_batch_max", int, 256, "most object ids a free_objects RPC"),
    Flag("free_flush_ms", float, 5.0, "most milliseconds a queued zero-ref "
         "free waits before its buffer is flushed to the daemon"),
    Flag("result_batch_max", int, 256, "most task completions a "
         "task_batch_done push frame"),
    Flag("result_linger_us", int, 500, "how long (microseconds) the "
         "daemon's reply pump lingers for more completions before "
         "flushing a non-full frame"),
    Flag("control_call_timeout_s", float, 60.0, "deadline of control-plane "
         "round trips whose reply is an ack (batch-submit and free "
         "flushes): a silent partition surfaces as an RpcError"),
    # -- graceful drain / preemption --
    Flag("drain_deadline_s", float, 30.0, "default graceful-drain window: "
         "planned departures (preemption notice, downscale, maintenance) "
         "migrate objects and actors and finish running work for up to "
         "this long before escalating to the hard node-death path"),
    Flag("drain_notice_file", str, "", "path the daemon's preemption "
         "watcher polls; the file appearing (content = reason) triggers a "
         "self-announced graceful drain"),
    # -- the asyncio control plane (_private/eventloop.py, aio.py) --
    Flag("lock_sanitizer", bool, False, "arm the loop-affinity check "
         "(eventloop.assert_loop raises when loop-only code runs off the "
         "event loop); JAX's lock-order half is not ported"),
    Flag("async_core", bool, True, "single-threaded asyncio control "
         "plane: one event loop per process owns every peer socket (wire, "
         "reply pump, dispatch pass); off falls back to the "
         "thread-per-connection core (mixed clusters interoperate via the "
         "async_core hello bit)"),
    Flag("loop_lag_probe_s", float, 0.25, "interval of the event-loop lag "
         "probe behind ray_tpu_event_loop_lag_seconds; 0 disarms"),
    Flag("loop_slow_callback_s", float, 0.05, "slow-callback watchdog "
         "threshold: loop callbacks (asyncio debug timing) or probe lag "
         "past this many seconds count into "
         "ray_tpu_event_loop_slow_callbacks_total"),
    Flag("async_debug", bool, False, "run the control-plane loop in "
         "asyncio debug mode: per-callback timing feeds the slow-callback "
         "watchdog and logs each offender (debug mode taxes every "
         "callback)"),
]

FLAGS: Dict[str, Flag] = {f.name: f for f in FLAG_DEFS}


class Config:
    """Resolved flag values; refreshed when _system_config changes."""

    def __init__(self, system_config: Optional[Dict[str, Any]] = None):
        self._system = dict(system_config or {})
        unknown = set(self._system) - set(FLAGS)
        if unknown:
            raise ValueError(
                f"unknown _system_config keys: {sorted(unknown)}; "
                f"known flags: {sorted(FLAGS)}")
        self._values: Dict[str, Any] = {}
        self._provenance: Dict[str, str] = {}
        for flag in FLAG_DEFS:
            if flag.name in self._system:
                raw: Any = self._system[flag.name]
                source = "_system_config"
            elif flag.env_var in os.environ:
                raw = os.environ[flag.env_var]
                source = f"env:{flag.env_var}"
            else:
                raw = flag.default
                source = "default"
            if flag.type is bool and isinstance(raw, str):
                value: Any = _parse_bool(raw)
            else:
                value = flag.type(raw)
            self._values[flag.name] = value
            self._provenance[flag.name] = source
        if self._values["cluster"] not in ("", "daemons"):
            raise ValueError(f"cluster={self._values['cluster']!r}: "
                             f"expected '' or 'daemons'")

    def __getattr__(self, name: str) -> Any:
        try:
            return self._values[name]
        except KeyError:
            raise AttributeError(f"no flag named {name!r}") from None

    def describe(self) -> Dict[str, Dict[str, Any]]:
        return {name: {"value": self._values[name],
                       "source": self._provenance[name],
                       "doc": FLAGS[name].doc}
                for name in self._values}


_lock = threading.Lock()
_config: Optional[Config] = None


def cfg() -> Config:
    global _config
    with _lock:
        if _config is None:
            _config = Config()
        return _config


def apply_system_config(system_config: Optional[Dict[str, Any]]) -> Config:
    """Install the per-init overrides (called from ray_tpu_torch.init)."""
    global _config
    with _lock:
        _config = Config(system_config)
        return _config


def reset() -> None:
    """Drop cached values (shutdown path; env changes re-resolve)."""
    global _config
    with _lock:
        _config = None
