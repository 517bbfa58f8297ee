"""Central config/flag table (counterpart of ``ray_tpu/_private/config.py``).

Every tunable the port's runtime reads lives in one declared table.
Resolution order per flag (highest wins):

1. ``_system_config={...}`` passed to ``ray_tpu_torch.init``
2. ``RAY_TPU_<NAME>`` environment variable
3. the declared default

An unknown ``_system_config`` key raises, as in the reference. The table
is JAX's whole table, each flag with JAX's name, type, default and
variable.
``process_workers`` and ``fast_lane`` are the variables JAX's worker
plane reads straight from the environment; here they are declared.
``inline_object_size`` and ``bench_total_deadline`` are declared and read
nowhere, as in JAX.
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
    Flag("memory_pressure", bool, False, "arm each daemon's "
         "PressureController (_private/pressure.py): it fuses host RSS, "
         "arena occupancy and the spill-dir budget into an ok/soft/hard "
         "level; soft spills cold arena entries and throttles "
         "push-prefetch, hard rejects new reservations and puts with a "
         "retriable MemoryPressureError and steers placement away; off "
         "keeps every put/get path a None-check"),
    Flag("arena_spill_watermarks", str, "0.70,0.85", "soft,hard arena "
         "occupancy fractions: past soft the controller spills cold "
         "sealed unpinned entries back down to the soft line; past hard "
         "(or when the host monitor is at its own threshold) new "
         "reservations and puts are rejected with MemoryPressureError"),
    Flag("arena_spill_dir", str, "", "directory for spilled arena entries; "
         "empty = spill_<node> in the driver's session dir, removed with "
         "the daemon"),
    Flag("arena_spill_budget_bytes", int, 0, "cap on total bytes parked "
         "in the spill dir (0 = unbounded)"),
    Flag("pressure_tick_s", float, 0.5, "PressureController evaluation "
         "period (seconds); 0 disarms the controller even when "
         "memory_pressure is on"),
    # -- accelerator topology (parallel/topology.py) --
    Flag("tpu_topology", str, "", "TPU slice topology for ICI-aware gang "
         "scheduling, '<gen>:<AxBxC>' (e.g. 'v5p:4x4x4'); '' = no "
         "topology (resource-count placement only)"),
    Flag("submit_batch", bool, True, "coalesce driver->daemon task "
         "submissions into push_task_batch frames (False = one "
         "submit_task RPC per task; completions still ride the result "
         "pump)"),
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
    Flag("retry_base_backoff_s", float, 0.05, "RetryPolicy.default "
         "first-backoff cap (exponential, full jitter)"),
    Flag("retry_max_backoff_s", float, 2.0, "RetryPolicy.default "
         "backoff cap ceiling"),
    # -- chaos (_private/failpoints.py, netchaos.py) --
    Flag("failpoints", str, "", "failpoint spec activating deterministic "
         "fault injection, e.g. 'rpc.client.send=drop:every=3'; exported "
         "as RAY_TPU_FAILPOINTS so spawned daemon, head and worker "
         "processes arm the same seams"),
    Flag("failpoints_seed", int, 0, "RNG seed for probabilistic "
         "failpoint arms (0 = unseeded); same seed => same schedule"),
    Flag("net_chaos", str, "", "network-chaos link-policy spec degrading "
         "control-plane links deterministically, e.g. "
         "'driver>daemon=drop=0.3;daemon>head=partition:start=500"
         ":dur=2000'; exported as RAY_TPU_NET_CHAOS so spawned daemon, "
         "head and worker processes degrade the same links"),
    Flag("net_chaos_seed", int, 0, "RNG seed for probabilistic "
         "link-policy draws (0 = unseeded); same seed => same "
         "drop/dup/jitter schedule"),
    # -- graceful drain / preemption --
    Flag("drain_deadline_s", float, 30.0, "default graceful-drain window: "
         "planned departures (preemption notice, downscale, maintenance) "
         "migrate objects and actors and finish running work for up to "
         "this long before escalating to the hard node-death path"),
    Flag("drain_notice_file", str, "", "path the daemon's preemption "
         "watcher polls; the file appearing (content = reason) triggers a "
         "self-announced graceful drain"),
    # -- the asyncio control plane (_private/eventloop.py, aio.py) --
    Flag("lock_sanitizer", bool, False, "track the runtime's named locks' "
         "acquisition order and report the first lock-order inversion "
         "(_private/lock_sanitizer.py), and arm the loop-affinity check "
         "(eventloop.assert_loop raises when loop-only code runs off the "
         "event loop)"),
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
    # -- memory monitor / OOM defense (_private/memory_monitor.py) --
    Flag("memory_monitor", bool, True, "enable the host-memory monitor and "
         "its worker-killing policies (the driver's, and each daemon's)"),
    Flag("memory_monitor_interval", float, 1.0,
         "memory monitor check period (seconds)"),
    Flag("memory_usage_threshold", float, 0.95,
         "fraction of the limit at which the killer engages"),
    Flag("memory_limit_bytes", int, 0, "explicit memory limit "
         "(0 = detect from the cgroup or the system)"),
    Flag("worker_killing_policy", str, "retriable_fifo",
         "'retriable_fifo' or 'group_by_owner'"),
    # -- logs (_private/log_monitor.py) --
    Flag("log_to_driver", bool, True, "capture worker stdout/stderr to "
         "per-pid files and tail them to the driver"),
    Flag("log_dir", str, "", "worker log directory override"),
    # -- observability (_private/events.py, export_events.py,
    # util/profiling.py, _private/lock_sanitizer.py) --
    Flag("export_events", bool, False, "write structured task/actor/node/"
         "job/train/placement-group lifecycle events as JSONL under the "
         "session dir"),
    Flag("task_trace", bool, True, "stamp a trace context into every "
         "task and record per-phase latency spans (submit/linger/queue/"
         "dispatch/exec/result_flush/result_ingest/result) on every "
         "process; spans feed the timeline, util.state.task_breakdown and "
         "the ray_tpu_task_phase_seconds histogram"),
    Flag("trace_sample", float, 1.0, "fraction of tasks traced when "
         "task_trace is on; sampling is deterministic in the task id so "
         "driver, daemon and worker agree per task (1.0 = every task)"),
    Flag("profiling_hz", float, 0.0, "continuous stack-sampler rate "
         "(samples/second) in every process: driver, head, daemons, "
         "workers; 0 = off (on-demand bursts through the CLI's profile "
         "or util.state.cluster_profile work either way). Profiles "
         "federate to the head on heartbeats"),
    Flag("lock_metrics", bool, False, "meter the runtime's named locks: "
         "wait/hold-time histograms (ray_tpu_lock_wait_seconds / "
         "ray_tpu_lock_hold_seconds{lock}) and a contended counter on "
         "every named lock; the sanitizer wins when both are set"),
    Flag("async_debug", bool, False, "run the control-plane loop in "
         "asyncio debug mode: per-callback timing feeds the slow-callback "
         "watchdog and logs each offender (debug mode taxes every "
         "callback)"),
    Flag("inline_object_size", int, 100 * 1024, "values <= this inline in "
         "the owner memory store (max_direct_call_object_size role)"),
    Flag("bench_total_deadline", int, 540, "bench.py total wall-clock "
         "budget (seconds)"),
    # -- tenancy (tenancy/) --
    Flag("fairshare", bool, False, "multi-tenant fair share: DRF "
         "admission verdicts at submit, per-job quota gates and "
         "deficit-ordered batch admission in node dispatch; off keeps "
         "the dispatch hot path byte-identical (Node.tenancy is None)"),
    Flag("job_default_weight", float, 1.0, "fair-share weight assigned "
         "to jobs that never declared one; deficit quanta are split "
         "proportionally to weight among jobs with pending work"),
    Flag("admission_queue_max", int, 4096, "bounded per-job pending "
         "queue: tasks over quota beyond this many outstanding get a "
         "REJECTED verdict (AdmissionRejectedError) instead of QUEUED"),
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
