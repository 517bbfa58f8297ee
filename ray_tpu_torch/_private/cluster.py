"""Driver-side cluster backend: real head and node-daemon processes
(counterpart of ``ray_tpu/_private/cluster.py``).

The deployment shape where the control plane leaves the driver process: a
head (``_private/head.py``, the GCS equivalent) and N node daemons
(``_private/daemon.py``, the raylet equivalent) run as spawned OS
processes, and every interaction is a typed RPC of ``_private/rpc.py``.
The driver stays the single controller and the owner of every object, and
the one process that holds the card: the head and the daemons are spawned
with ``CUDA_VISIBLE_DEVICES=""``, and every task that wants the card runs
in the driver (``Runtime._execute_inline``).

What rides the wire:
- fused lease + push of tasks, singly or coalesced (``push_task_batch``),
  completions coalesced back (``task_batch_done``); plain tasks go to the
  daemon's native core (the fast lane) instead
- the placement group's two-phase bundle commit (prepare / commit /
  cancel)
- object get/put/free/pull/push, with a same-host zero-copy path through
  the daemon's shm arena (``ArenaCache``)
- worker-initiated core ops (the daemons call the driver's owner server,
  ``OwnerService``)
- health (daemon -> head heartbeats; the head's long-poll pubsub pushes a
  node's death to the driver, which runs ``Runtime.remove_node``)

Payloads (functions, arguments, results) ride as blobs of the port's
process wire (``fast_lane.join_parts`` of ``worker_process._pack``): only
the driver and the workers load them.

Joining a running cluster (``ClusterBackend.attach``, ``init(address=)``):
a second driver dials the head of a cluster that ``ray-tpu start`` stood
up, joins its daemons, and leaves them running at ``shutdown``.

The targeted actor lane: a daemon's serialized actor carries a tag
(``RemoteActorInstance.fast_tag``), and its plain method calls go straight
to the actor's worker through the daemon's native core, strictly FIFO;
streaming calls keep the classic path.

Observability: the backend ships the driver's task events to the head's
store once a second (``start_task_event_flusher``; ``_flush_task_events``
flushes at once), records the driver's linger and result_ingest spans of
batched tasks, prints the lines the daemons forward from their workers'
logs (``worker_log``), and fans a profile burst out to a daemon
(``DaemonHandle.profile_burst``).

Tenancy: the resource reporter's tick also runs the tenancy manager's
federation (``maybe_sync``): dirty quota records to the head, the job
table to the daemons that advertised the ``tenancy`` bit, the throttled
per-job usage report.
"""

from __future__ import annotations

import os
import pickle
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch._private import daemon as _daemon_schemas  # noqa: F401 - declares the daemon RPC schemas
from ray_tpu_torch._private import failpoints as _fp
from ray_tpu_torch._private import rpc
from ray_tpu_torch._private.head import HeadClient
from ray_tpu_torch._private.ids import NodeID
from ray_tpu_torch._private.rpc import HOLD

def _dump_blob(value: Any) -> bytes:
    """A value as one blob of the process wire (what workers load)."""
    from ray_tpu_torch._private.fast_lane import join_parts
    from ray_tpu_torch._private.worker_process import _pack
    return bytes(join_parts(_pack(value)))


def _load_blob(blob) -> Any:
    from ray_tpu_torch._private.fast_lane import loads_joined
    return loads_joined(blob)


def _load_error(blob) -> BaseException:
    e, tb = _load_blob(blob)
    setattr(e, "_remote_traceback", tb)
    return e


def _spawn(module: str, args: List[str],
           output_path: Optional[str] = None
           ) -> Tuple[subprocess.Popen, int]:
    """Spawn a ``python -m <module>`` child; returns (proc, announced port).
    ``output_path`` sends the child's stdout/stderr to a file."""
    r, w = os.pipe()
    env = dict(os.environ)
    repo_root = os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    env["PYTHONPATH"] = repo_root + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    # Control-plane processes never own the card (JAX sets
    # JAX_PLATFORMS=cpu here).
    env["CUDA_VISIBLE_DEVICES"] = ""
    out = None
    if output_path is not None:
        out = open(output_path, "ab")
    try:
        proc = subprocess.Popen(
            [sys.executable, "-m", module, *args, "--announce-fd", str(w)],
            pass_fds=(w,), env=env, start_new_session=True,
            stdout=out, stderr=out)
    finally:
        if out is not None:
            out.close()
    os.close(w)
    with os.fdopen(r) as f:
        line = f.readline().strip()
    if not line:
        proc.wait()
        raise RuntimeError(f"{module} failed to start "
                           f"(exit code {proc.returncode})")
    return proc, int(line)


class ArenaCache:
    """Same-host attach to daemon arenas by name (zero-copy reads,
    direct-put writes and shared-slot ref releases). A segment that cannot
    be mapped (another host, no native build) caches as failed and every
    object falls back to the RPC byte path."""

    def __init__(self):
        self._arenas: Dict[str, Any] = {}  #: guarded by self._lock
        self._failed: set = set()          #: guarded by self._lock
        self._lock = threading.Lock()

    def handle(self, arena: str):
        """The attached ShmObjectStore of ``arena``, or None."""
        with self._lock:
            store = self._arenas.get(arena)
            if store is not None:
                return store
            if arena in self._failed:
                return None
            try:
                from ray_tpu_torch.native_store import ShmObjectStore
                store = ShmObjectStore.attach(arena)
            except Exception:
                self._failed.add(arena)
                return None
            self._arenas[arena] = store
            return store

    def read(self, arena: str, capacity: int, off: int,
             size: int) -> Optional[memoryview]:
        store = self.handle(arena)
        if store is None:
            return None
        return store.read_range(off, size)

    def write(self, arena: str, off: int, payload) -> bool:
        """Fill a daemon-reserved (unsealed) range in place: the direct
        put's write; the bytes never ride an RPC frame."""
        store = self.handle(arena)
        if store is None:
            return False
        try:
            store.write_range(off, payload)
            return True
        except Exception:
            return False

    def ext_release(self, arena: str, slot: int) -> bool:
        """Drop a shared-slot ref through the local mapping (the zero-RPC
        release of the ref/release protocol)."""
        store = self.handle(arena)
        if store is None:
            return False
        try:
            store.ext_release(slot)
            return True
        except Exception:
            return False

    def close(self) -> None:
        # a deliberate leak, not munmap: zero-copy views handed to user
        # code may outlive this session, and their finalizers must find a
        # mapping (ShmObjectStore.detach_leak). The daemon owns the
        # segment's name; nothing here keeps /dev/shm entries alive.
        with self._lock:
            for store in self._arenas.values():
                try:
                    store.detach_leak()
                except Exception:
                    pass
            self._arenas.clear()


class DaemonCrashed(Exception):
    """The daemon PROCESS died (transport failure): node-level failure."""


class RemoteWorkerCrashed(Exception):
    """A worker process inside a (healthy) daemon died under a task."""


class _Stream:
    def __init__(self):
        import queue

        self.q: "queue.Queue" = queue.Queue()


_STREAM_DEAD = object()


class _SubmitCoalescer:
    """Per-daemon driver -> daemon submit batching: task submissions
    enqueue here; one flusher thread a daemon drains the queue into
    ``push_task_batch`` frames of up to ``submit_batch_max`` tasks,
    lingering ``submit_linger_us`` for stragglers. Completions come back
    coalesced on ``task_batch_done`` push frames
    (``DaemonHandle._on_push``). The daemon dedupes by (task, attempt),
    so a resent frame never executes a task twice."""

    # resends of one batch whose flush failed in transit (an injected
    # drop or error) before the handle is treated as dead
    _MAX_SEND_ATTEMPTS = 8

    def __init__(self, handle: "DaemonHandle"):
        from ray_tpu_torch._private.config import cfg
        self.handle = handle
        self.batch_max = max(1, int(cfg().submit_batch_max))
        self.linger_s = max(0.0, float(cfg().submit_linger_us) / 1e6)
        self._cv = threading.Condition()
        self._q: deque = deque()           #: guarded by self._cv
        self._stopped = False              #: guarded by self._cv
        self._thread = threading.Thread(
            target=self._loop, daemon=True,
            name=f"submit-batch-{handle.node_id.hex()[:8]}")
        self._thread.start()

    def enqueue(self, entry: Dict[str, Any]) -> None:
        with self._cv:
            if self._stopped:
                raise DaemonCrashed("daemon handle closed")
            self._q.append(entry)
            # wake the flusher only out of its idle wait (first entry) or
            # for a full batch: waking it out of the linger on every
            # append would flush two-task frames
            if len(self._q) == 1 or len(self._q) >= self.batch_max:
                self._cv.notify()

    def stop(self) -> None:
        with self._cv:
            self._stopped = True
            self._cv.notify_all()

    def _loop(self) -> None:
        while True:
            with self._cv:
                while not self._q and not self._stopped:
                    self._cv.wait()
                if self._stopped:
                    return      # waiters are failed by mark_dead
                if self.linger_s > 0 and len(self._q) < self.batch_max:
                    # one bounded linger for the rest of a burst
                    self._cv.wait(self.linger_s)
                n = min(len(self._q), self.batch_max)
                batch = [self._q.popleft() for _ in range(n)]
            if batch:
                self._flush(batch)

    def _record_linger(self, batch: List[Dict[str, Any]],
                       now: float) -> None:
        """The linger phase: coalescer enqueue -> the batch frame leaving
        on the wire, per traced task (driver lane). ``now`` is read once a
        batch."""
        from ray_tpu_torch._private import events
        from ray_tpu_torch._private import worker as _worker
        rt = _worker.global_runtime()
        buf = getattr(rt, "task_events", None)
        node_hex = self.handle.node_id.hex()
        for entry in batch:
            t_enq = entry.pop("t_enq", None)
            if t_enq is None:
                continue
            events.record_phase(
                buf, task_id=entry["task"], name=entry.get("name", ""),
                phase="linger", dur_s=max(now - t_enq, 0.0),
                node_id=node_hex, proc="driver",
                trace_id=entry.get("trace", ""),
                start_wall=events.wall_at(t_enq), end_mono=now)

    def _flush(self, batch: List[Dict[str, Any]]) -> None:
        handle = self.handle
        # ship each function blob once per (daemon, fid)
        fns: Dict[str, bytes] = {}
        for entry in batch:
            fid = entry["fid"]
            if fid not in handle._fns_shipped and fid not in fns:
                try:
                    from ray_tpu_torch._private.worker_process import \
                        fetch_function_blob
                    fns[fid] = fetch_function_blob(fid)
                except KeyError:
                    pass    # workers fall back to the fetch core op
        from ray_tpu_torch._private.config import cfg
        from ray_tpu_torch._private.retry import record_retry
        for attempt in range(self._MAX_SEND_ATTEMPTS):
            if handle.dead:
                return      # mark_dead already failed the waiters
            if attempt:
                record_retry("batch.submit_flush")  # a resend of the batch
            if _fp.ENABLED:
                try:
                    act = _fp.fire("batch.submit_flush", n=len(batch),
                                   attempt=attempt)
                except Exception:   # noqa: BLE001 — injected error arm:
                    # the attempt "failed in transit"; resend the same
                    # batch (idempotent at the daemon)
                    continue
                if act is _fp.DROP:
                    continue        # frame lost before the send; resend
            # the linger ends as the frame leaves, before the round trip
            self._record_linger(batch, time.perf_counter())
            try:
                # the reply is an enqueue ack (results ride the pump), so
                # a deadline is safe: an unacked flush past it means a
                # wedged link, which the RpcError path treats as node
                # death
                handle.client.call("push_task_batch", tasks=batch, fns=fns,
                                   timeout=cfg().control_call_timeout_s)
            except rpc.RemoteError as e:
                handle._ingest_batch([{"task": entry["task"], "e": str(e)}
                                      for entry in batch])
                return
            except rpc.RpcError:
                handle.mark_dead()      # transport death: node failure
                return
            if fns:
                handle._fns_shipped.update(fns)
            return
        # attempts exhausted (a persistent injected failure): surface as a
        # daemon-level failure so task retry accounting engages
        handle.mark_dead()


class _FreeCoalescer:
    """Buffers zero-ref ``free_objects`` ids a daemon and flushes them
    bounded by ``free_batch_max`` and ``free_flush_ms`` (frees are
    idempotent at the daemon)."""

    def __init__(self, handle: "DaemonHandle"):
        from ray_tpu_torch._private.config import cfg
        self.handle = handle
        self.batch_max = max(1, int(cfg().free_batch_max))
        self.flush_s = max(0.0, float(cfg().free_flush_ms) / 1e3)
        self._cv = threading.Condition()
        self._oids: List[bytes] = []       #: guarded by self._cv
        self._stopped = False              #: guarded by self._cv
        self._thread: Optional[threading.Thread] = None  #: guarded by self._cv

    def queue(self, oid: bytes) -> None:
        with self._cv:
            if self._stopped:
                return
            self._oids.append(oid)
            if self._thread is None:    # lazy: most handles never free
                self._thread = threading.Thread(
                    target=self._loop, daemon=True,
                    name=f"free-batch-{self.handle.node_id.hex()[:8]}")
                self._thread.start()
            if len(self._oids) == 1 or len(self._oids) >= self.batch_max:
                self._cv.notify()

    def _loop(self) -> None:
        while True:
            with self._cv:
                while not self._oids and not self._stopped:
                    self._cv.wait()
                if self._stopped:
                    return
                if len(self._oids) < self.batch_max:
                    # time-bounded: partial batches leave within flush_s
                    self._cv.wait(self.flush_s)
                if self._stopped:
                    return
                oids = self._oids[:self.batch_max]
                del self._oids[:len(oids)]
            if oids:    # a concurrent flush() may have drained the lot
                self._send(oids)

    def flush(self) -> None:
        """Synchronous drain (shutdown): no queued free may be lost."""
        while True:
            with self._cv:
                oids, self._oids = self._oids, []
            if not oids:
                return
            self._send(oids)

    def stop(self) -> None:
        with self._cv:
            self._stopped = True
            self._oids.clear()      # daemon dead: frees are moot
            self._cv.notify_all()

    def _send(self, oids: List[bytes]) -> None:
        if _fp.ENABLED:
            try:
                act = _fp.fire("batch.free_flush", n=len(oids))
            except Exception:   # noqa: BLE001 — injected error arm
                act = _fp.DROP
            if act is _fp.DROP:
                # flush failed in transit: requeue; object deletion is
                # idempotent at the daemon, so the retry is safe
                with self._cv:
                    if not self._stopped:
                        self._oids[:0] = oids
                return
        try:
            from ray_tpu_torch._private.config import cfg
            self.handle.client.call("free_objects", oids=oids,
                                    timeout=cfg().control_call_timeout_s)
        except (rpc.RpcError, rpc.RemoteError):
            pass    # daemon dead or erroring: its store dies with it


def _count_fenced(kind: str) -> None:
    """Count one result frame rejected by fencing: "epoch" (a superseded
    daemon incarnation), "attempt" (a stale task attempt), "dead" (a
    stamped frame after the handle was marked dead)."""
    try:
        from ray_tpu_torch.util.metrics import Counter
        Counter("ray_tpu_fenced_results_total",
                "result/stream frames rejected by fencing",
                tag_keys=("kind",)).inc(tags={"kind": kind})
    except Exception:
        pass    # metrics must never fail result ingest


class DaemonHandle:
    """The driver's connection to one node daemon."""

    def __init__(self, node_id: NodeID, addr: Tuple[str, int],
                 proc: Optional[subprocess.Popen], arenas: ArenaCache):
        self.node_id = node_id
        self.addr = tuple(addr)
        self.proc = proc
        self.arenas = arenas
        self._streams: Dict[str, _Stream] = {}  #: guarded by self._slock
        self._slock = threading.Lock()
        self.on_actor_worker_died = None  # set by the backend
        self.client = rpc.connect(self.addr, timeout=None,
                                  on_push=self._on_push).link(
                                      "daemon", node_id.hex())
        self.dead = False
        # fencing: the daemon's registration epoch (learned at hello); a
        # frame stamped with a LOWER epoch comes from a superseded
        # incarnation and must not resolve waiters. Only a daemon whose
        # hello advertises ``fence`` is fenced by epoch
        self.epoch = 0
        self._fence_supported = False
        # fair-share federation: only a daemon that advertised the
        # ``tenancy`` bit receives tenancy_sync job tables
        self._tenancy_supported = False
        # zero-copy object plane (set from the hello reply)
        self.objectplane = False
        self.arena_name: Optional[str] = None
        self.arena_capacity = 0
        self.client_id: Optional[str] = None
        self._async_core_remote = False     # which core the daemon runs
        # fast lane: direct submit to the daemon's native core
        self.fast_port: Optional[int] = None
        self._fast = None
        self._fast_lock = threading.Lock()
        self._fast_dial_lock = threading.Lock()
        # task hex -> (lane client, rid): the client pins the rid to its
        # generation (a reconnected lane restarts rid numbering)
        self._fast_rids: Dict[str, Tuple[Any, int]] = {}  #: guarded by self._fast_lock
        # control-plane batching (submit coalescer + free buffer)
        self._batch: Optional[_SubmitCoalescer] = None
        self._batch_lock = threading.Lock()
        self._batch_waiters: Dict[str, list] = {}  #: guarded by self._bw_lock
        self._bw_lock = threading.Lock()
        self._fns_shipped: set = set()      # fids this daemon holds
        self._free = _FreeCoalescer(self)
        self.runtime = None                 # bound by the backend
        self._job_id = None
        # node memory-pressure level (daemon node_pressure pushes, or the
        # gossip row at join), mirrored onto the runtime Node so pick_node
        # soft-excludes a hard node as it does a draining one
        self.pressure_level = "ok"
        self._batch_supported = True        # from hello (submit_batch)

    # -- push demux -------------------------------------------------------
    def _on_push(self, method: str, msg: Dict[str, Any]) -> None:
        if method == "task_batch_done":
            self._ingest_batch(msg.get("outcomes", ()),
                               time.perf_counter())
            return
        if method == "worker_log":
            # a line of a daemon worker's output, surfaced here
            out = sys.stderr if msg.get("stream") == "err" else sys.stdout
            print(f"(worker node={msg.get('node', '?')} "
                  f"pid={msg.get('pid')}) {msg.get('line')}", file=out)
            return
        if method in ("task_yield", "task_stream_end", "task_stream_crash"):
            if self._stale_epoch(msg):
                _count_fenced("epoch")
                return
            with self._slock:
                stream = self._streams.get(msg["task"])
            if stream is not None:
                stream.q.put(msg)
        elif method == "node_pressure":
            self._on_node_pressure(msg.get("level") or "ok")
        elif method == "actor_worker_died":
            cb = self.on_actor_worker_died
            if cb is not None:
                # OFF the reader thread: the death flow issues RPCs on
                # this client, whose replies this reader must deliver
                threading.Thread(target=cb,
                                 args=(msg["actor_id"], msg["cause"]),
                                 daemon=True,
                                 name="actor-death-cb").start()

    def _on_node_pressure(self, level: str) -> None:
        """A daemon's pressure transition: mirror the level onto the
        runtime Node and drop the scheduler's feasibility cache (a cached
        pick must not keep landing work on a node that just went hard)."""
        self.pressure_level = level
        rt = self.runtime
        node = rt.get_node(self.node_id) if rt is not None else None
        if node is not None \
                and getattr(node, "pressure_level", "ok") != level:
            node.pressure_level = level
            from ray_tpu_torch._private.scheduler import bump_cluster_epoch
            bump_cluster_epoch()

    def mark_dead(self) -> None:
        self.dead = True
        # fail in-flight RPCs with a typed transport error; the reader
        # stays up, so late pushes are still counted by the fence
        try:
            self.client._fail_all()
        except Exception:
            pass
        with self._slock:
            streams = list(self._streams.values())
        for stream in streams:
            stream.q.put(_STREAM_DEAD)
        batch = self._batch
        if batch is not None:
            batch.stop()
        self._free.stop()
        # fail every batch waiter: slot[1] stays None, which the submit
        # paths surface as DaemonCrashed
        with self._bw_lock:
            waiters, self._batch_waiters = self._batch_waiters, {}
        for slot in waiters.values():
            slot[0].set()
        fl = self._fast
        if fl is not None:
            fl.close()

    def _stale_epoch(self, msg: Dict[str, Any]) -> bool:
        """True when a frame's ``ep`` stamp is from a SUPERSEDED daemon
        incarnation. An unstamped frame, or any frame from a daemon whose
        hello did not advertise fencing, is never stale."""
        if not self._fence_supported:
            return False
        ep = msg.get("ep")
        return ep is not None and bool(self.epoch) and ep < self.epoch

    def _ingest_batch(self, outcomes, t0: float = 0.0) -> None:
        """Ingest one task_batch_done frame: every final outcome's waiter
        slot pops under ONE lock hold and every stream termination
        resolves its queue under one; only then are the waiters woken.
        Duplicates (a resent frame) find no slot and are dropped, so each
        task completes exactly once."""
        if self.dead:
            for out in outcomes:
                if out.get("ep") is not None or out.get("att") is not None:
                    _count_fenced("dead")
            return
        finals = []
        streams = []
        for out in outcomes:
            if self._stale_epoch(out):
                _count_fenced("epoch")
                continue
            (streams if out.get("stream") else finals).append(out)
        woke = []
        if finals:
            with self._bw_lock:
                for out in finals:
                    task_hex = out.get("task", "")
                    slot = self._batch_waiters.get(task_hex)
                    if slot is None:
                        continue
                    att = out.get("att")
                    if att is not None and att != slot[2]:
                        # an earlier attempt's outcome must not resolve
                        # the live attempt's slot
                        _count_fenced("attempt")
                        continue
                    self._batch_waiters.pop(task_hex, None)
                    slot[1] = out
                    woke.append(slot)
            for slot in woke:
                slot[0].set()
            if t0:
                self._record_ingest_spans(woke, t0)
        if streams:
            resolved = []
            with self._slock:
                for out in streams:
                    stream = self._streams.get(out.get("task", ""))
                    if stream is not None:
                        resolved.append((stream, out))
            for stream, out in resolved:
                msg = dict(out)
                msg["m"] = msg.pop("stream")
                stream.q.put(msg)

    def _record_ingest_spans(self, woke, t0: float) -> None:
        """The result_ingest phase: batch frame arrival -> waiters woken
        (driver lane, traced outcomes only)."""
        traced = [slot[1] for slot in woke if slot[1].get("tr")]
        if not traced:
            return
        from ray_tpu_torch._private import events
        from ray_tpu_torch._private import worker as _worker
        now = time.perf_counter()
        rt = _worker.global_runtime()
        buf = getattr(rt, "task_events", None)
        node_hex = self.node_id.hex()
        for out in traced:
            name, trace_id = out["tr"]
            events.record_phase(
                buf, task_id=out.get("task", ""), name=name,
                phase="result_ingest", dur_s=max(now - t0, 0.0),
                node_id=node_hex, proc="driver", trace_id=trace_id,
                start_wall=events.wall_at(t0), end_mono=now)

    def profile_burst(self, duration: float = 2.0) -> List[Dict[str, Any]]:
        """A stack-sampling burst on this daemon and its workers, one
        record a process (a leg of util.state.cluster_profile)."""
        out = self._call("profile_burst", duration=float(duration))
        return [r for r in out.get("procs", []) if isinstance(r, dict)]

    def _answers(self) -> bool:
        """Whether the daemon answers a ping; marks the handle dead when
        it does not."""
        try:
            self.client.call("daemon_ping", timeout=5.0)
            return True
        except rpc.RpcError:
            self.mark_dead()
            return False

    def _call(self, method: str, **kw) -> Dict[str, Any]:
        if self.dead:
            raise DaemonCrashed(f"daemon {self.node_id.hex()[:8]} is dead")
        try:
            return self.client.call(method, timeout=None, **kw)
        except rpc.RpcError as e:
            self.mark_dead()
            raise DaemonCrashed(str(e))

    # -- wiring -----------------------------------------------------------
    def hello(self, owner_addr: Tuple[str, int], job_id, namespace: str):
        # ship the driver's import roots: module-level functions pickle by
        # reference, so the daemon's workers must import the driver's
        # modules
        sys_path = [p for p in sys.path
                    if isinstance(p, str) and p and os.path.isdir(p)]
        out = self._call("hello_driver", owner_addr=list(owner_addr),
                         job_id=pickle.dumps(job_id, protocol=5),
                         namespace=namespace, sys_path=sys_path)
        from ray_tpu_torch._private.config import cfg
        self.fast_port = out.get("fast_port")
        self.objectplane = (bool(out.get("objectplane"))
                            and bool(cfg().objectplane_attach))
        self.arena_name = out.get("arena")
        self.arena_capacity = int(out.get("arena_capacity") or 0)
        self.client_id = out.get("client_id")
        self.epoch = int(out.get("epoch") or 0)
        self._fence_supported = bool(out.get("fence"))
        self._tenancy_supported = bool(out.get("tenancy"))
        self._async_core_remote = bool(out.get("async_core"))
        self._job_id = job_id
        # submit_batch=False: one classic submit_task a task, whose
        # completion still returns on the task_batch_done pump
        self._batch_supported = bool(cfg().submit_batch)
        return out

    def _submit_coalescer(self) -> Optional[_SubmitCoalescer]:
        if not self._batch_supported or self.dead:
            return None
        batch = self._batch
        if batch is not None:
            return batch
        with self._batch_lock:
            if self._batch is None and not self.dead:
                self._batch = _SubmitCoalescer(self)
            return self._batch

    def _fast_client(self):
        """The lazily-connected fast-lane client; None when unavailable."""
        if self.fast_port is None or self.dead:
            return None
        fl = self._fast
        if fl is not None and not fl.dead:
            return fl
        with self._fast_dial_lock:
            fl = self._fast
            if fl is not None and not fl.dead:
                return fl                    # a racer reconnected
            port = self.fast_port
            if port is None:
                return None
            from ray_tpu_torch._private.fast_lane import (
                FastLaneClient, lane_reconnect_policy)

            def connect():
                if _fp.ENABLED:
                    _fp.fire("cluster.lane_reconnect",
                             node=self.node_id.hex()[:8])
                return FastLaneClient(
                    (self.addr[0], port),
                    link_id=f"lane:{self.node_id.hex()}")

            try:
                fl = lane_reconnect_policy().run(
                    connect, loop="fast_lane.reconnect",
                    retry_on=(OSError, _fp.FailpointError))
            except (OSError, _fp.FailpointError):
                self.fast_port = None        # core gone: stop retrying
                return None
            self._fast = fl
            return fl

    def _execute_fast(self, fl, spec, fid: str, args_blob: bytes):
        """A plain task through the lane; the daemon's Python never sees
        it. Returns the (kind, value) outcome, or None when the caller
        should take the coalesced path (nothing ran)."""
        from ray_tpu_torch._private import fast_lane as _fle
        payload = _fle.build_payload(
            spec, fid, args_blob, spec.job_id or self._job_id,
            self.node_id, self.client_id)
        return self._lane_roundtrip(fl, spec, lambda: fl.submit(payload))

    def _call_actor_fast(self, fl, tag: int, spec, args_blob: bytes):
        """An actor-method call through the targeted lane (the actor's
        worker, strictly FIFO). Returns the (kind, value) outcome, or None
        when the caller should take the classic path (nothing ran)."""
        from ray_tpu_torch._private import fast_lane as _fle
        payload = _fle.build_actor_payload(
            spec, args_blob, spec.job_id or self._job_id, self.node_id,
            self.client_id)
        return self._lane_roundtrip(
            fl, spec, lambda: fl.submit_targeted(tag, payload))

    def _lane_roundtrip(self, fl, spec, submit):
        """One lane submit, wait and decode, shared by plain tasks and
        targeted actor calls: the (kind, value) outcome, or None when
        nothing was submitted."""
        from ray_tpu_torch._private import fast_lane as _fle
        try:
            rid, slot = submit()
        except _fle.FastLaneError:
            if self.dead:
                raise DaemonCrashed("daemon died (fast lane)")
            return None
        task_hex = spec.task_id.hex()
        with self._fast_lock:
            self._fast_rids[task_hex] = (fl, rid)
        try:
            kind, blob = fl.wait(slot)
        except _fle.FastLaneUnsubmitted:
            # the frame never reached the wire: nothing ran
            if self.dead:
                raise DaemonCrashed("daemon died (fast lane)")
            return None
        except _fle.FastLaneError as e:
            # submitted but the lane died before the outcome: the call may
            # have run, so a crash (retry accounting decides). Whose: the
            # lane's socket closes with the daemon too, so ask the daemon
            # before calling it a worker's (a retry must not go back to a
            # dead node before its death is seen)
            if self.dead or not self._answers():
                raise DaemonCrashed(str(e))
            crash = RemoteWorkerCrashed(f"fast lane died mid-call: {e}")
            crash.fast_lane = True
            raise crash
        finally:
            with self._fast_lock:
                self._fast_rids.pop(task_hex, None)
        if kind == _fle.KIND_OK:
            return ("ok", _load_blob(blob))
        if kind == _fle.KIND_ERR:
            from ray_tpu_torch._private import serialization
            e, tb = serialization.loads(blob)
            setattr(e, "_remote_traceback", tb)
            return ("err", e)
        if kind == _fle.KIND_GEN_LIST:
            # the body ran and returned a generator the worker drained:
            # replay the items as a stream, never re-run the body
            return ("gen", _fle.replay_gen_list(blob))
        if kind == _fle.KIND_CANCELLED:
            return ("err", KeyboardInterrupt())
        if kind == _fle.KIND_CRASHED:
            crash = RemoteWorkerCrashed(bytes(blob).decode(errors="replace"))
            # lane workers' task ids live in the native core: the OOM check
            # must use the lane's (time-window) attribution
            crash.fast_lane = True
            raise crash
        raise RuntimeError(f"unknown fast-lane outcome kind {kind}")

    # -- task submit ------------------------------------------------------
    def execute_task(self, spec, fid: str, args_blob: bytes):
        """Submit through the lane or the submit coalescer: the daemon
        leases a pooled worker, pushes the task and releases the worker
        itself. Returns the (kind, value) contract of
        ProcessRouter.execute_task, or ("stored", (key, nbytes)) for a
        result left in the daemon. Plain tasks (one return, not a
        generator function) ride the lane."""
        import inspect as _inspect

        from ray_tpu_torch._private.task_spec import TaskKind as _TK
        if (spec.kind == _TK.NORMAL and spec.num_returns == 1
                and not spec.runtime_env
                and not (spec.func is not None
                         and _inspect.isgeneratorfunction(spec.func))):
            fl = self._fast_client()
            if fl is not None:
                out = self._execute_fast(fl, spec, fid, args_blob)
                if out is not None:
                    return out
        task_hex = spec.task_id.hex()
        stream = _Stream()
        with self._slock:
            self._streams[task_hex] = stream
        out = None
        try:
            if self.dead:
                raise DaemonCrashed(
                    f"daemon {self.node_id.hex()[:8]} is dead")
            batch = self._submit_coalescer()
            if batch is not None:
                out = self._submit_batched(batch, spec, fid, args_blob)
            else:
                out = self._submit_via_pump(spec, fid, args_blob)
            return self._decode_outcome(out, spec, stream)
        finally:
            if out_is_final(out):
                with self._slock:
                    self._streams.pop(task_hex, None)

    def _task_entry(self, spec, fid: str, args_blob: bytes
                    ) -> Dict[str, Any]:
        return {
            "task": spec.task_id.hex(),
            # retries reuse the task id: the daemon's dedupe keys on
            # (task, attempt), so a retry EXECUTES instead of replaying
            "attempt": spec.attempt_number,
            "spec": _slim_spec_blob(spec),
            "fid": fid,
            "args": args_blob,
            "backpressure": spec.backpressure_num_objects,
        }

    def _submit_batched(self, batch: _SubmitCoalescer, spec, fid: str,
                        args_blob: bytes) -> Dict[str, Any]:
        """Enqueue on the coalescer and wait for the task's outcome dict
        on the task_batch_done pump."""
        task_hex = spec.task_id.hex()
        # slot = [wake event, outcome, live attempt number]
        slot = [threading.Event(), None, spec.attempt_number]
        with self._bw_lock:
            if self.dead:
                raise DaemonCrashed(
                    f"daemon {self.node_id.hex()[:8]} is dead")
            self._batch_waiters[task_hex] = slot
        entry = self._task_entry(spec, fid, args_blob)
        if spec.trace_sampled:
            # the linger span's inputs, for traced tasks only (the t_enq
            # stamp stays here: the flusher pops it before the send)
            entry["t_enq"] = time.perf_counter()
            entry["name"] = spec.name
            entry["trace"] = spec.trace_id
        try:
            batch.enqueue(entry)
        except BaseException:
            with self._bw_lock:
                self._batch_waiters.pop(task_hex, None)
            raise
        slot[0].wait()
        out = slot[1]
        if out is None:
            raise DaemonCrashed(
                f"daemon {self.node_id.hex()[:8]} died (batched submit)")
        if out.get("e"):
            raise rpc.RemoteError(out["e"])
        return out

    def _submit_via_pump(self, spec, fid: str,
                         args_blob: bytes) -> Dict[str, Any]:
        """One classic submit_task RPC a task (``submit_batch=False``):
        the reply is an immediate ack, and the completion returns on the
        task_batch_done pump, with the coalesced path's outcome dict and
        error surface."""
        task_hex = spec.task_id.hex()
        slot = [threading.Event(), None, spec.attempt_number]
        with self._bw_lock:
            if self.dead:
                raise DaemonCrashed(
                    f"daemon {self.node_id.hex()[:8]} is dead")
            self._batch_waiters[task_hex] = slot
        kw = self._task_entry(spec, fid, args_blob)
        if spec.trace_sampled:
            kw["name"] = spec.name
            kw["trace"] = spec.trace_id
        if fid not in self._fns_shipped:
            try:
                from ray_tpu_torch._private.worker_process import \
                    fetch_function_blob
                kw["fns"] = {fid: fetch_function_blob(fid)}
            except KeyError:
                pass    # workers fall back to the fetch core op
        try:
            self._call("submit_task", **kw)
        except BaseException:
            with self._bw_lock:
                self._batch_waiters.pop(task_hex, None)
            raise
        if "fns" in kw:
            self._fns_shipped.add(fid)
        slot[0].wait()
        out = slot[1]
        if out is None:
            raise DaemonCrashed(
                f"daemon {self.node_id.hex()[:8]} died (pumped submit)")
        if out.get("e"):
            raise rpc.RemoteError(out["e"])
        return out

    def _decode_outcome(self, out: Dict[str, Any], spec, stream: _Stream):
        kind = out["outcome"]
        if kind == "crashed":
            # the WORKER died; the daemon itself is healthy
            raise RemoteWorkerCrashed(out["error"])
        if kind == "ok":
            return ("ok", _load_blob(out["blob"]))
        if kind == "err":
            return ("err", _load_error(out["blob"]))
        if kind == "stored":
            return ("stored", (bytes(out["oid"]), out["nbytes"]))
        if kind == "gen":
            return ("gen", self._stream_iter(spec, stream))
        if kind == "dead":
            raise DaemonCrashed("actor worker is dead")
        raise RuntimeError(f"unknown outcome {kind!r}")

    def _stream_iter(self, spec, stream: _Stream):
        task_hex = spec.task_id.hex()
        try:
            while True:
                msg = stream.q.get()
                if msg is _STREAM_DEAD:
                    raise DaemonCrashed("daemon died mid-stream")
                op = msg["m"]
                if op == "task_yield":
                    yield _load_blob(msg["blob"])
                    try:
                        self.client.call("gen_ack", task_id=task_hex,
                                         timeout=5.0)
                    except rpc.RpcError:
                        pass
                    continue
                if op == "task_stream_crash":
                    raise RemoteWorkerCrashed(msg["error"])
                if not msg["ok"]:
                    raise _load_error(msg["blob"])
                return
        finally:
            with self._slock:
                self._streams.pop(task_hex, None)

    # -- actors -----------------------------------------------------------
    def create_actor(self, spec, fid: str, args_blob: bytes):
        out = self._call("create_actor", spec=_slim_spec_blob(spec),
                         fid=fid, args=args_blob)
        kind = out["outcome"]
        if kind == "crashed":
            raise RemoteWorkerCrashed(out["error"])
        if kind == "err":
            raise _load_error(out["blob"])
        return RemoteActorInstance(self, spec.actor_id,
                                   fast_tag=out.get("fast_tag"))

    def call_actor_method(self, spec, args_blob: bytes):
        task_hex = spec.task_id.hex()
        stream = _Stream()
        with self._slock:
            self._streams[task_hex] = stream
        out = None
        try:
            out = self._call("call_actor_method",
                             spec=_slim_spec_blob(spec), args=args_blob)
            return self._decode_outcome(out, spec, stream)
        finally:
            if out_is_final(out):
                with self._slock:
                    self._streams.pop(task_hex, None)

    def kill_actor(self, actor_id, expected: bool = True) -> None:
        try:
            self._call("kill_actor", actor_id=actor_id.hex(),
                       expected=expected)
        except DaemonCrashed:
            pass

    def cancel_task(self, task_id, force: bool) -> bool:
        task_hex = task_id.hex()
        if _fp.ENABLED:
            act = _fp.fire("cluster.cancel", task=task_hex)
            if act is _fp.DROP:
                return False        # cancel request lost in transit
        with self._fast_lock:
            entry = self._fast_rids.get(task_hex)
        if entry is not None:
            # a lane task: the core drops it if still queued; running ->
            # soft interrupt, or force -> the lane worker exits (a crash,
            # which a cancelled task maps to TaskCancelledError). The
            # cancel goes to the client the task was submitted on.
            lane_client, rid = entry
            if not lane_client.dead:
                lane_client.cancel(rid, force=force)
            return True
        try:
            return self._call("cancel_task", task_id=task_hex,
                              force=force)["found"]
        except DaemonCrashed:
            return False

    # -- placement group bundles: two-phase commit -----------------------
    def prepare_bundle(self, pg_id: str, index: int,
                       resources: Dict[str, float]) -> bool:
        try:
            return self._call("prepare_bundle", pg_id=pg_id, index=index,
                              resources=resources)["ok"]
        except DaemonCrashed:
            return False

    def commit_bundle(self, pg_id: str, index: int) -> bool:
        try:
            return self._call("commit_bundle", pg_id=pg_id,
                              index=index)["ok"]
        except DaemonCrashed:
            return False

    def cancel_bundle(self, pg_id: str, index: int) -> None:
        try:
            self._call("cancel_bundle", pg_id=pg_id, index=index)
        except DaemonCrashed:
            pass

    # -- object plane -----------------------------------------------------
    def _release_shm_grant(self, oid: bytes, out: Dict[str, Any]) -> None:
        """Drop the ref a get_object shm reply granted us: slot grants
        release through the local mapping (one atomic, zero RPC); an
        internal-ref grant, or a slot we failed to map, falls back to the
        release_object RPC."""
        slot = out.get("slot")
        if slot is not None:
            if self.arenas.ext_release(out["shm"], slot):
                return
            try:
                self.client.call("release_object", oid=oid, slot=slot,
                                 timeout=5.0)
            except (rpc.RpcError, rpc.RemoteError):
                pass
            return
        try:
            self.client.call("release_object", oid=oid, timeout=5.0)
        except (rpc.RpcError, rpc.RemoteError):
            pass

    def get_object_blob(self, oid: bytes) -> Optional[bytes]:
        out = self._call("get_object", oid=oid, prefer_shm=True,
                         slot_ok=True)
        if out.get("missing"):
            return None
        if out.get("shm"):
            view = self.arenas.read(out["shm"], out["capacity"],
                                    out["off"], out["size"])
            try:
                if view is not None:
                    return bytes(view)  # copy out, then release the pin
                # attach failed: re-request as bytes
                out2 = self._call("get_object", oid=oid, prefer_shm=False)
                return None if out2.get("missing") else out2["blob"]
            finally:
                self._release_shm_grant(oid, out)
        return out["blob"]

    def get_object_value(self, oid: bytes):
        """The loaded value of a pickled entry, its arrays zero-copy
        read-only views of the arena on the same host: the daemon grants a
        shared-slot ref, the payload is loaded over our own mapping, and a
        finalizer on the mapped base drops the ref once no view of the
        bytes survives. (JAX copies the blob out first.) Raises KeyError
        when the daemon does not hold it."""
        import weakref
        out = self._call("get_object", oid=oid, prefer_shm=True,
                         slot_ok=True)
        if out.get("missing"):
            raise KeyError(oid)
        if not out.get("shm"):
            return _load_blob(out["blob"])
        handle = (self.arenas.handle(out["shm"])
                  if out.get("slot") is not None else None)
        if handle is None:
            view = self.arenas.read(out["shm"], out["capacity"],
                                    out["off"], out["size"])
            try:
                blob = bytes(view) if view is not None else None
            finally:
                self._release_shm_grant(oid, out)
            if blob is None:
                blob = self.get_object_blob(oid)
                if blob is None:
                    raise KeyError(oid)
            return _load_blob(blob)
        try:
            base = handle.view_range(out["off"], out["size"])
        except Exception:
            self._release_shm_grant(oid, out)
            raise
        # the loaded arrays' buffers are views of `base`, which they keep
        # alive: its death proves no view of the bytes is left
        weakref.finalize(base, _ext_release_quiet, handle, out["slot"])
        return _load_blob(memoryview(base))

    def get_object_view(self, oid: bytes, dtype, shape):
        """Zero-copy read-only numpy view of a raw-tier arena entry on the
        same host: the daemon grants a shared-slot ref, we map the range,
        and a finalizer drops the ref. None -> the blob path."""
        import weakref

        import numpy as np
        out = self._call("get_object", oid=oid, prefer_shm=True,
                         slot_ok=True)
        if out.get("missing") or not out.get("shm"):
            return None
        if out.get("slot") is None:
            self._release_shm_grant(oid, out)
            return None
        handle = self.arenas.handle(out["shm"])
        if handle is None:
            self._release_shm_grant(oid, out)
            return None
        try:
            base = handle.view_range(out["off"], out["size"])
        except Exception:
            self._release_shm_grant(oid, out)   # never pin on failure
            return None
        # the finalizer on the BASE frombuffer array: numpy collapses base
        # chains, so a slice of the reshaped result bases on `base`
        weakref.finalize(base, _ext_release_quiet, handle, out["slot"])
        arr = base.view(np.dtype(dtype))
        if shape is not None:
            arr = arr.reshape(tuple(shape))
        return arr

    def arena_reserve(self, key: bytes, size: int
                      ) -> Optional[Dict[str, Any]]:
        """Reserve arena space for a direct put; {off, arena} or None (no
        arena, or full: the caller takes the blob RPC)."""
        try:
            out = self._call("create_object", oid=key, size=size)
        except (DaemonCrashed, rpc.RemoteError):
            return None
        if not out.get("ok"):
            return None
        return out

    def arena_seal(self, key: bytes, ref: bytes, raw,
                   nbytes: int) -> bool:
        try:
            out = self._call("seal_object", oid=key, ref=ref,
                             raw=list(raw) if raw else None,
                             nbytes=nbytes)
        except (DaemonCrashed, rpc.RemoteError):
            return False
        return bool(out.get("ok"))

    def push_object(self, oid: bytes, to_addr,
                    ref: bytes = b"") -> Dict[str, Any]:
        """Proactive push of a local object to a peer daemon (the sender
        runs the PushManager: chunked, deduplicated)."""
        return self._call("push_object", oid=oid, to_addr=list(to_addr),
                          ref=ref)

    def put_object_blob(self, oid: bytes, blob: bytes) -> None:
        out = self._call("put_object", oid=oid, blob=blob)
        if isinstance(out, dict) and out.get("backpressure"):
            from ray_tpu_torch.exceptions import MemoryPressureError
            raise MemoryPressureError(
                f"node {self.node_id.hex()[:8]} rejected put under "
                f"{out.get('level', 'hard')} memory pressure")

    def free_objects(self, oids: List[bytes]) -> None:
        try:
            self._call("free_objects", oids=oids)
        except DaemonCrashed:
            pass

    def queue_free(self, oid: bytes) -> None:
        """Zero-ref free, coalesced (time- and size-bounded)."""
        if not self.dead:
            self._free.queue(oid)

    def flush_frees(self) -> None:
        if not self.dead:
            self._free.flush()

    def pull_object(self, oid: bytes,
                    from_addr: Optional[Tuple[str, int]] = None,
                    priority: int = 2, ref: bytes = b"",
                    raw=None) -> bool:
        """priority: 0 = get, 1 = wait, 2 = task args. ``from_addr=None``
        resolves through the owner's object directory. ``ref`` (and the
        raw tier's ``raw``) index the copy for this daemon's workers."""
        kw: Dict[str, Any] = {}
        if ref:
            kw["ref"] = ref
            kw["raw"] = list(raw) if raw else None
        out = self._call("pull_object", oid=oid,
                         from_addr=list(from_addr) if from_addr else [],
                         priority=priority, **kw)
        return out.get("ok", False)

    # -- lifecycle --------------------------------------------------------
    def stop(self) -> None:
        self.flush_frees()      # no queued free may outlive the session
        try:
            if not self.dead:
                self.client.call("daemon_stop", timeout=2.0)
        except rpc.RpcError:
            pass
        self.mark_dead()
        self.client.close()
        if self.proc is not None:
            try:
                self.proc.wait(timeout=5.0)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait(timeout=5.0)

    def detach(self) -> None:
        """Disconnect from a daemon this driver did not spawn (a joined
        cluster): close the connection, leave the process running."""
        self.flush_frees()      # the daemon lives on: release its store
        self.mark_dead()
        self.client.close()

    def sigkill(self) -> None:
        """Chaos path: hard-kill the daemon process (node failure)."""
        if self.proc is not None:
            try:
                self.proc.kill()
            except OSError:
                pass
        self.mark_dead()


def _ext_release_quiet(handle, slot: int) -> None:
    """Finalizer of the driver's zero-copy views: drop the shared-slot ref
    through the local mapping (must never raise)."""
    try:
        handle.ext_release(slot)
    except Exception:
        pass


def out_is_final(out) -> bool:
    return out is None or out.get("outcome") != "gen"


def _slim_spec_blob(spec) -> bytes:
    """The spec's metadata without the callable and arguments (the daemon
    runs no user code; payloads travel as fid + args blob)."""
    import copy

    slim = copy.copy(spec)
    slim.func = None
    slim.args = ()
    slim.kwargs = {}
    slim.scheduling_strategy = "DEFAULT"
    return pickle.dumps(slim, protocol=5)


class RemoteActorInstance:
    """The driver's handle to an actor hosted in a daemon's worker."""

    __slots__ = ("daemon", "actor_id", "fast_tag")

    def __init__(self, daemon: DaemonHandle, actor_id,
                 fast_tag: Optional[int] = None):
        self.daemon = daemon
        self.actor_id = actor_id
        # the actor worker's tag in the daemon's native core (None: the
        # classic RPC path only)
        self.fast_tag = fast_tag

    def call_actor_method(self, spec, args_blob: bytes):
        """Plain calls ride the targeted lane (per-actor FIFO in the
        native core); streaming calls stay on the classic path."""
        if (self.fast_tag is not None
                and spec.num_returns not in ("streaming", "dynamic")
                and not spec.runtime_env):
            fl = self.daemon._fast_client()
            if fl is not None:
                out = self.daemon._call_actor_fast(fl, self.fast_tag,
                                                   spec, args_blob)
                if out is not None:
                    return out
        return self.daemon.call_actor_method(spec, args_blob)


class RemoteStore:
    """Store facade of a daemon-backed node: values live in the daemon's
    object table; the driver keeps a metadata mirror (key, size, tier, raw
    dtype/shape) and fetches on demand. Same-host paths are zero-copy:
    large puts reserve, write and seal arena space (the payload never
    rides an RPC frame), and raw-tier gets return read-only
    ``np.frombuffer`` views pinned by shared-slot refs."""

    def __init__(self, daemon: DaemonHandle):
        from ray_tpu_torch.objectplane.tiers import TierAccounting
        self.daemon = daemon
        # ObjectID -> (key, nbytes, tier, raw|None)
        self._meta: Dict[Any, tuple] = {}  #: guarded by self._lock
        self._lock = threading.Lock()
        # an UNCHAINED ledger: this store mirrors metadata; the daemon
        # publishes the arena's occupancy itself
        self.tiers = TierAccounting()
        self.stats = {"gets": 0, "puts": 0, "direct_puts": 0,
                      "zero_copy_gets": 0}

    def register_remote(self, object_id, daemon_key: bytes,
                        nbytes: int, raw=None,
                        tier: Optional[str] = None) -> None:
        from ray_tpu_torch.objectplane.tiers import TIER_HOST
        tier = tier or TIER_HOST
        raw = tuple(raw) if raw else None
        with self._lock:
            prev = self._meta.get(object_id)
            self._meta[object_id] = (daemon_key, nbytes, tier, raw)
        if prev is None:
            self.tiers.add(tier, nbytes)

    def put(self, object_id, value, nbytes: int = 0) -> None:
        key = b"put:" + object_id.binary()
        if self._direct_put_raw(object_id, key, value):
            return
        blob = _dump_blob(value)
        if self._direct_put_blob(object_id, key, blob):
            return
        from ray_tpu_torch._private.retry import RetryPolicy
        from ray_tpu_torch.exceptions import MemoryPressureError
        # hard-pressure backpressure is retriable by contract: the node is
        # spilling its way back to capacity, so ride the policy until
        # relief instead of failing the put
        RetryPolicy.default(deadline_s=30.0).run(
            lambda: self.daemon.put_object_blob(key, blob),
            loop="put.backpressure", retry_on=(MemoryPressureError,))
        self.register_remote(object_id, key, len(blob))
        self.stats["puts"] += 1

    def _direct_put_raw(self, object_id, key: bytes, value) -> bool:
        """Large contiguous numpy arrays store as raw arena bytes, written
        through the driver's own mapping; consumers view them back with no
        serialization."""
        if not self.daemon.objectplane:
            return False
        from ray_tpu_torch.objectplane.tiers import raw_put_eligible
        raw = raw_put_eligible(value)
        if raw is None:
            return False
        return self._arena_put(object_id, key,
                               memoryview(value).cast("B"), raw)

    def _direct_put_blob(self, object_id, key: bytes,
                         blob: bytes) -> bool:
        if not self.daemon.objectplane:
            return False
        from ray_tpu_torch._private.config import cfg
        if len(blob) < int(cfg().direct_put_min_bytes):
            return False
        return self._arena_put(object_id, key, blob, None)

    def _arena_put(self, object_id, key: bytes, payload, raw) -> bool:
        size = (payload.nbytes if isinstance(payload, memoryview)
                else len(payload))
        out = self.daemon.arena_reserve(key, size)
        if out is None:
            return False    # arena full / no native store: blob path
        if not self.daemon.arenas.write(out["arena"], out["off"],
                                        payload):
            # the arena cannot be mapped here: stop trying direct puts on
            # this handle and abort the reserve
            self.daemon.objectplane = False
            self.daemon.free_objects([key])
            return False
        if not self.daemon.arena_seal(key, object_id.binary(), raw,
                                      size):
            self.daemon.free_objects([key])
            return False
        self.register_remote(object_id, key, size, raw=raw)
        self.stats["puts"] += 1
        self.stats["direct_puts"] += 1
        return True

    def get(self, object_id):
        with self._lock:
            entry = self._meta.get(object_id)
        if entry is None:
            raise KeyError(object_id)
        key, _nbytes, _tier, raw = entry
        self.stats["gets"] += 1
        if raw is not None:
            attachable = (self.daemon.arena_name is not None
                          and self.daemon.arenas.handle(
                              self.daemon.arena_name) is not None)
            arr = (self.daemon.get_object_view(key, raw[0], raw[1])
                   if attachable else None)
            if arr is not None:
                self.stats["zero_copy_gets"] += 1
                from ray_tpu_torch.objectplane.tiers import \
                    count_zero_copy_get
                count_zero_copy_get()
                return arr
            # another host / attach failure: raw bytes over RPC
            import numpy as np
            blob = self.daemon.get_object_blob(key)
            if blob is None:
                raise KeyError(object_id)
            arr = np.frombuffer(blob, dtype=np.dtype(raw[0])).reshape(
                tuple(raw[1]))
            return arr
        try:
            return self.daemon.get_object_value(key)
        except KeyError:
            raise KeyError(object_id) from None

    def contains(self, object_id) -> bool:
        with self._lock:
            return object_id in self._meta

    def delete(self, object_id) -> None:
        with self._lock:
            entry = self._meta.pop(object_id, None)
        if entry is None:
            return
        self.tiers.add(entry[2], -entry[1])
        if not self.daemon.dead:
            self.daemon.queue_free(entry[0])

    def object_ids(self):
        with self._lock:
            return list(self._meta)

    def nbytes_of(self, object_id) -> int:
        with self._lock:
            entry = self._meta.get(object_id)
        return entry[1] if entry else 0

    def meta_of(self, object_id) -> Tuple[bytes, int, Any]:
        """(daemon store key, nbytes, raw dtype/shape|None): what a peer
        daemon needs to transfer this object directly."""
        with self._lock:
            key, nbytes, _tier, raw = self._meta[object_id]
        return key, nbytes, raw

    def has_daemon_key(self, daemon_key: bytes) -> bool:
        """Directory support: does this node hold the given store key?"""
        with self._lock:
            return any(e[0] == daemon_key for e in self._meta.values())

    def used_bytes(self) -> int:
        with self._lock:
            return sum(e[1] for e in self._meta.values())

    def tier_bytes(self) -> Dict[str, int]:
        return self.tiers.snapshot()

    def close(self) -> None:
        with self._lock:
            self._meta.clear()
        self.tiers.clear()


class _OwnerHolder:
    """Pins refs created on behalf of daemon workers, keyed by borrower
    ("t:<task>" / "a:<actor>"). Holds release when the borrowing task
    finishes or the actor dies: a long-lived daemon must not pin dead
    tasks' objects."""

    def __init__(self):
        self._held: Dict[Any, List[Any]] = {}  #: guarded by self._lock
        self._lock = threading.Lock()

    def _hold(self, task_rid, obj) -> None:
        with self._lock:
            self._held.setdefault(task_rid or "_", []).append(obj)

    def release(self, key: str) -> None:
        """Drop one borrower's holds (the dropped ObjectRefs' __del__
        cascades into refcounting, outside the lock)."""
        if not self._held:  # raylint: disable=guarded-by
            return  # the common per-task case pays no lock
        with self._lock:
            dropped = self._held.pop(key, None)
        del dropped

    def clear(self) -> None:
        with self._lock:
            held, self._held = self._held, {}
        del held

    def num_keys(self) -> int:
        with self._lock:
            return len(self._held)


class OwnerService:
    """The driver's RPC server for daemon-initiated core operations (the
    CoreWorkerService direction)."""

    def __init__(self, runtime):
        self.runtime = runtime
        self.holder = _OwnerHolder()

    def handle_core_op(self, conn, rid, msg):
        def run():
            from ray_tpu_torch._private.worker_process import \
                dispatch_core_op

            try:
                kw = _load_blob(msg["payload"])
                value = dispatch_core_op(self.runtime, self.holder,
                                         msg["call"], kw, msg.get("task"))
                conn.reply(rid, ok=True, value=_dump_blob(value))
            except BaseException as e:  # noqa: BLE001 - shipped back
                from ray_tpu_torch._private import serialization
                from ray_tpu_torch._private.fast_lane import join_parts
                try:
                    blob = serialization.dumps(e)
                except Exception:
                    blob = serialization.dumps(RuntimeError(repr(e)))
                conn.reply(rid, ok=False, value=bytes(join_parts([blob])))

        threading.Thread(target=run, daemon=True,
                         name="owner-core-op").start()
        return HOLD


class ClusterBackend:
    """Spawns and tracks the head and daemon processes of one driver.

    Head fault tolerance: the head persists KV and pubsub to sqlite in the
    session dir; a supervisor thread here respawns a crashed head on the
    SAME port with the same state file, the daemons re-register, and the
    driver's HeadClient re-dials: a head SIGKILL is a blip, not a lost
    cluster."""

    def __init__(self, runtime, num_daemons: int,
                 resources_per_daemon: Dict[str, float],
                 object_store_bytes: int = 256 * 1024 * 1024):
        import json

        from ray_tpu_torch._private.config import cfg
        object_store_bytes = max(object_store_bytes, 1 << 20)
        self.runtime = runtime
        self.arenas = ArenaCache()
        self.node_resources: Dict[NodeID, Dict[str, float]] = {}
        self._owns_cluster = True   # we spawned head and daemons: we stop them
        self.session_dir = tempfile.mkdtemp(prefix="ray_tpu_torch_session_")
        self._head_state = os.path.join(self.session_dir, "head_state.db")
        self._shutting_down = False
        self.daemons: Dict[NodeID, DaemonHandle] = {}  #: guarded by self._lock
        self._lock = threading.Lock()
        self.head_proc = None
        self.head = None
        self.owner_server = None
        try:
            self.head_proc, self._head_port = _spawn(
                "ray_tpu_torch._private.head",
                ["--state-path", self._head_state,
                 "--parent-pid", str(os.getpid())])
            self.head = HeadClient(("127.0.0.1", self._head_port),
                                   reconnect_window=cfg().head_grace_s)
            self._supervisor = threading.Thread(
                target=self._supervise_head, daemon=True,
                name="head-supervisor")
            self._supervisor.start()
            self.owner_service = OwnerService(runtime)
            self.owner_server = rpc.serve(self.owner_service).start()

            def spawn_daemon(node_id):
                return _spawn("ray_tpu_torch._private.daemon", [
                    "--head", f"127.0.0.1:{self._head_port}",
                    "--node-id", node_id.hex(),
                    "--resources", json.dumps(resources_per_daemon),
                    "--object-store-bytes", str(object_store_bytes),
                    "--session-dir", self.session_dir,
                ])

            # the daemons start at once (each process's start and its
            # warm worker pool take seconds on a slow host), in node order
            node_ids = [NodeID.from_random() for _ in range(num_daemons)]
            with ThreadPoolExecutor(max(1, num_daemons)) as pool:
                spawns = [pool.submit(spawn_daemon, n) for n in node_ids]
            failed = None
            for node_id, spawned in zip(node_ids, spawns):
                try:
                    proc, port = spawned.result()
                except BaseException as e:
                    failed = failed or e
                    continue
                handle = DaemonHandle(node_id, ("127.0.0.1", port), proc,
                                      self.arenas)
                with self._lock:
                    self.daemons[node_id] = handle
                handle.runtime = runtime
            if failed is not None:
                raise failed
            for node_id in node_ids:
                handle = self.daemons[node_id]  # raylint: disable=guarded-by
                handle.hello(self.owner_server.addr, runtime.job_id,
                             runtime.namespace)
                handle.on_actor_worker_died = self._make_actor_death_cb()
                self.node_resources[node_id] = dict(resources_per_daemon)
        except BaseException:
            self.shutdown()     # nothing of a half-started cluster stays
            raise
        self.head.subscribe("node", self._on_node_event)
        self.start_resource_reporter()
        self.start_task_event_flusher()

    @classmethod
    def attach(cls, runtime, address: str) -> "ClusterBackend":
        """Join an existing cluster (``ray-tpu start``) as a new driver:
        connect to its head, join its registered daemons and speak the
        same wire. Nothing is spawned, and shutdown() leaves the cluster
        running."""
        from ray_tpu_torch._private.config import cfg
        self = cls.__new__(cls)
        self.runtime = runtime
        self.arenas = ArenaCache()
        self._owns_cluster = False
        self.node_resources = {}
        self.session_dir = tempfile.mkdtemp(prefix="ray_tpu_torch_driver_")
        self._head_state = None
        host, port = address.rsplit(":", 1)
        self._head_port = int(port)
        self.head_proc = None
        self._shutting_down = False
        self.daemons = {}       # raylint: disable=guarded-by
        self._lock = threading.Lock()
        self.owner_server = None
        self.head = HeadClient((host, self._head_port),
                               reconnect_window=cfg().head_grace_s)
        try:
            self.owner_service = OwnerService(runtime)
            self.owner_server = rpc.serve(self.owner_service).start()
            for info in self.head.list_nodes():
                if info["alive"]:
                    self._join_node(info, add_runtime_node=False)
            if not self.daemons:    # raylint: disable=guarded-by
                raise RuntimeError(
                    f"cluster at {address} has no alive nodes to join")
        except BaseException:
            self.shutdown()
            raise
        self.head.subscribe("node", self._on_node_event)
        self.start_resource_reporter()
        self.start_task_event_flusher()
        return self

    def describe_peers(self) -> List[str]:
        """One line per connected daemon for debug_state: which
        control-plane core the peer advertised in hello (the async_core
        bit), and liveness. Frames are byte-identical across cores, so
        this is where a mixed cluster shows."""
        with self._lock:
            handles = list(self.daemons.values())
        return [f"daemon {h.node_id.hex()[:8]}: core="
                f"{'async' if h._async_core_remote else 'threaded'} "
                f"alive={not h.dead}" for h in handles]

    def start_resource_reporter(self, interval_s: float = 0.5) -> None:
        """The driver is the scheduling authority and owns the true
        availability view: push it to the head (only when changed, and
        again within the head's 2 s freshness window)."""
        def loop():
            last: Dict[str, Any] = {}
            last_sent = 0.0
            while not self._shutting_down:
                time.sleep(interval_s)
                loads: Dict[str, Dict[str, float]] = {}
                with self._lock:
                    node_ids = list(self.daemons)
                for node_id in node_ids:
                    node = self.runtime.get_node(node_id)
                    if node is None or not node.alive:
                        continue
                    loads[node_id.hex()] = dict(node.ledger.available())
                now = time.monotonic()
                if loads and (loads != last or now - last_sent > 1.5):
                    try:
                        self.head.report_resources(loads)
                    except rpc.RpcError:
                        continue  # a lost report: retried next tick
                    last = loads
                    last_sent = now
                # fair-share federation rides the same tick: dirty quota
                # records to the head (persisted) and the capable daemons,
                # and the throttled per-job usage report
                ten = getattr(self.runtime, "tenancy", None)
                if ten is not None and ten.enabled:
                    try:
                        ten.maybe_sync(self)
                    except Exception:
                        pass  # dirty records retry next tick

        threading.Thread(target=loop, daemon=True,
                         name="resource-reporter").start()

    def start_task_event_flusher(self, interval_s: float = 1.0) -> None:
        """Ship the driver's new task events to the head's store every
        ``interval_s``, so the state API and the timeline outlive the
        driver. ``_flush_task_events()`` flushes at once."""
        self._task_event_cursor = 0
        flush_lock = threading.Lock()

        def flush_once() -> None:
            buf = getattr(self.runtime, "task_events", None)
            if buf is None:
                return
            # one flusher at a time: the periodic thread, shutdown's final
            # flush and direct calls share the cursor, and a concurrent
            # read-push-advance would store a batch twice
            with flush_lock:
                batch = buf.events_after(self._task_event_cursor)
                if not batch:
                    return
                job_hex = self.runtime.job_id.hex()
                for ev in batch:
                    ev.setdefault("job_id", job_hex)
                if _fp.ENABLED:
                    try:
                        # drop/error arm = a flush lost in transit; the
                        # unadvanced cursor resends next interval
                        if _fp.fire("trace.flush",
                                    n=len(batch)) is _fp.DROP:
                            return
                    except Exception:
                        return
                try:
                    self.head.task_events_push(batch)
                except rpc.RpcError:
                    return   # a lost flush: the same cursor retries
                self._task_event_cursor = batch[-1]["seq"]

        self._flush_task_events = flush_once

        def loop():
            while not self._shutting_down:
                time.sleep(interval_s)
                if not self._shutting_down:
                    flush_once()

        threading.Thread(target=loop, daemon=True,
                         name="task-event-flusher").start()

    def _supervise_head(self) -> None:
        """Respawn a crashed head on the same port with the same state."""
        while not self._shutting_down:
            time.sleep(0.25)
            if self._shutting_down or self.head_proc.poll() is None:
                continue
            if _fp.ENABLED:
                try:
                    # a delay arm extends the outage; an error arm is a
                    # failed respawn attempt (the next tick retries): an
                    # escape here would kill the supervisor thread
                    _fp.fire("head.respawn")
                except Exception:  # noqa: BLE001 — injected faults
                    continue
            try:
                proc, _ = _spawn(
                    "ray_tpu_torch._private.head",
                    ["--state-path", self._head_state,
                     "--port", str(self._head_port),
                     "--parent-pid", str(os.getpid())])
            except (RuntimeError, OSError):
                continue  # the port may linger in TIME_WAIT; retry
            if self._shutting_down:
                # shutdown() won the race while we spawned: leak no head
                proc.kill()
                proc.wait()
                return
            self.head_proc = proc

    def _make_actor_death_cb(self):
        def cb(actor_id_hex: str, cause: str) -> None:
            from ray_tpu_torch._private.ids import ActorID

            try:
                self.runtime.on_actor_worker_died(
                    ActorID.from_hex(actor_id_hex), cause)
            except Exception:
                pass

        return cb

    def _join_node(self, info: Dict[str, Any],
                   add_runtime_node: bool) -> Optional[DaemonHandle]:
        """The node-join sequence of a daemon this driver did not spawn (one
        started by hand, or by a launcher, against this head): connect,
        hello, wire the callbacks, add it to the runtime. A daemon it
        already knows (a re-registration after a head restart) only has
        its new epoch adopted, so frames of the old incarnation are
        fenced."""
        try:
            node_id = NodeID.from_hex(info["node_id"])
        except (KeyError, ValueError):
            return None
        with self._lock:
            if node_id in self.daemons or self._shutting_down:
                existing = self.daemons.get(node_id)
                if existing is not None:
                    ep = int(info.get("epoch") or 0)
                    if ep > existing.epoch:
                        existing.epoch = ep
                return None
        if not info.get("alive", True):
            return None
        try:
            handle = DaemonHandle(node_id, tuple(info["addr"]), None,
                                  self.arenas)
            handle.runtime = self.runtime
            handle.hello(self.owner_server.addr, self.runtime.job_id,
                         self.runtime.namespace)
        except (OSError, rpc.RpcError, DaemonCrashed, KeyError):
            return None    # it raced its death; the death event follows
        handle.on_actor_worker_died = self._make_actor_death_cb()
        with self._lock:
            if node_id in self.daemons or self._shutting_down:
                handle.mark_dead()
                handle.client.close()
                return None
            self.daemons[node_id] = handle
        self.node_resources[node_id] = dict(info["resources"])
        if add_runtime_node:
            node = self.runtime.add_remote_node(handle,
                                                dict(info["resources"]))
            if info.get("draining"):
                # joined mid-drain (we subscribed after the drain event):
                # migrate with the remaining window
                self.runtime.begin_node_drain(
                    node, float(info.get("drain_deadline_s") or 0.0),
                    info.get("drain_reason") or "drain")
            # joined while the node was already pressured (the
            # node_pressure push was missed): the gossip row carries it
            level = (info.get("gossip_load") or {}).get("pressure")
            if level and level != "ok":
                handle._on_node_pressure(level)
        return handle

    def _on_node_event(self, event: Dict[str, Any]) -> None:
        kind = event.get("kind")
        if kind == "added":
            self._join_node(event.get("node") or {}, add_runtime_node=True)
            return
        if kind == "drain":
            # a graceful drain announced (a preemption notice, another
            # driver, the CLI): start the migration; begin_node_drain is
            # idempotent, so the initiating driver's own call coexists
            try:
                node = self.runtime.get_node(
                    NodeID.from_hex(event["node_id"]))
            except (KeyError, ValueError):
                return
            if node is not None:
                self.runtime.begin_node_drain(
                    node, float(event.get("deadline_s") or 0.0),
                    event.get("reason") or "drain")
            return
        if kind != "death":
            return
        node_id = NodeID.from_hex(event["node_id"])
        with self._lock:
            handle = self.daemons.get(node_id)
        if handle is None:
            return
        # do NOT skip when the handle is already dead: an RPC failure
        # marks it dead without the node-death flow; remove_node below is
        # a no-op if the runtime already removed the node
        handle.mark_dead()
        node = self.runtime.get_node(node_id)
        if node is not None:
            if event.get("drain_expired"):
                # the head's deadline escalation beat the driver's own
                # timer (the runtime counts it exactly once)
                self.runtime.count_drain_escalation(node)
            try:
                self.runtime.remove_node(node, _from_cluster=True)
            except Exception:
                pass

    def report_daemon_dead(self, handle: DaemonHandle, reason: str) -> None:
        handle.mark_dead()
        try:
            self.head.mark_node_dead(handle.node_id.hex(), reason)
        except rpc.RpcError:
            pass

    def shutdown(self) -> None:
        # the final flush: post-mortem reads of a shared head see the
        # driver's whole history
        flush = getattr(self, "_flush_task_events", None)
        if flush is not None:
            try:
                flush()
            except Exception:
                pass
        self._shutting_down = True
        with self._lock:
            daemons = list(self.daemons.values())
            self.daemons.clear()
        if self._owns_cluster and daemons:
            # each stop waits for its process to exit: all at once
            with ThreadPoolExecutor(len(daemons)) as pool:
                list(pool.map(lambda h: h.stop(), daemons))
        else:       # a joined cluster: disconnect, do not stop
            for handle in daemons:
                handle.detach()
        if self.head is not None:
            if self._owns_cluster:
                self.head.stop_head()
            self.head.close()
        if self.head_proc is not None:
            try:
                self.head_proc.wait(timeout=5.0)
            except subprocess.TimeoutExpired:
                self.head_proc.kill()
                self.head_proc.wait(timeout=5.0)
        if self.owner_server is not None:
            self.owner_server.stop()
        self.arenas.close()
        if self._owns_cluster:
            # a daemon that was SIGKILLed never unlinked its arena: remove
            # every node's segment name (mappings still held stay valid)
            from ray_tpu_torch.objectplane.arena import sweep_stale_segments
            for node_id in list(self.node_resources):
                sweep_stale_segments(f"rtpt_{node_id.hex()[:12]}")
        shutil.rmtree(self.session_dir, ignore_errors=True)
