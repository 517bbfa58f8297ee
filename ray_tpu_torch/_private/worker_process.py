"""Process workers: the default execution path for tasks and actors
(counterpart of ``ray_tpu/_private/worker_process.py``).

Workers are real OS processes, every task payload crosses a serialization
boundary, functions ship once through a function table, and workers reach
back into the driver's runtime for nested operations.

Placement rule (the accelerator plane): work that touches the card (a
``GPU`` demand, an ``_in_process`` actor, a payload that names a device off
the CPU: a tensor or ``torch.device`` anywhere the wire's pickler meets it,
closures included) runs in the driver, the one process that owns the card.
Everything else runs in worker processes that cannot see it
(``CUDA_VISIBLE_DEVICES=""``, ``_private/platform.py``).

Architecture (one host; the pipe is the wire):

  driver Runtime -- WorkerClient --(a socket pair, framed pickles)-- worker
    - ProcessRouter: eligibility, routing, the pool, crash handling
    - WorkerClient: one live worker process; a reader thread routes task
      results and yields and serves the worker's core ops (get, put,
      submit, wait, actor calls) against the driver's Runtime
    - worker process: a reader loop and one thread a task; a
      WorkerProxyRuntime is installed as the global runtime, so the public
      API (``get``/``put``/``remote``/actors/generators) works inside a
      task through the pipe.

A message is a header, a stdlib pickle of a plain dict, and the parts of
one payload: what it carries of user values (functions, arguments, results,
exceptions) is pickled by the port's by-value pickler
(``_private/serialization.py``), tensors by the wire format of
``_private/device_objects.py``, with protocol 5's out-of-band buffers as
parts of their own. Large arrays cross without a copy into the pickle
stream, and the receiver reads each part with one blocking ``recv``
(``MSG_WAITALL``): the driver's reader thread takes the GIL once a part,
not once a socket buffer, which matters beside a launch-bound step.

The fast lane (``_private/fast_lane.py``), on by default (``fast_lane``
flag, JAX's ``RAY_TPU_FAST_LANE``): the router hosts the native core
(``csrc/daemon_core.cc``) on a thread of the driver and sends every plain
task (one return, not a generator function) to it first; the core leases a
free lane worker (dedicated workers from the same template, never in the
idle pool) and routes the result back with no Python per task. The lane
falls back to the pipe only where JAX's does: no native build, or nothing
submitted.

Process actors: the instance lives in a dedicated worker process; in the
driver the ActorExecutor machinery (ordering, concurrency, restarts) drives
a proxy instance whose calls go over the pipe. A dead worker is a retryable
system failure for a task and actor death for an actor; the normal restart
path then replays the creation spec.

Workers fork from a forkserver template that preloads this module, numpy
and pyarrow (where it is installed) with the card hidden and never initialises CUDA: the driver has usually
initialised CUDA already, so a plain ``fork`` of the driver would be unsafe.
A worker imports torch only when a task needs it. Idle workers outlive a
runtime and serve the next one in the same process; the template lives
until the interpreter exits (or ``stop_worker_plane``).

In a daemon (``_private/daemon.py``) the same pool serves the daemon's
tasks: its WorkerClients run with ``raw_outcomes`` (results stay blobs the
daemon relays without loading), core ops forward to the owner as blobs,
and the workers attach the daemon's shared-memory arena
(``objectplane/arena.py``, handed over in the boot frame) for zero-copy
gets and direct puts (``WorkerProxyRuntime._shm_get``/``_shm_put``).

A daemon's serialized actor joins its worker to the native core as a
targeted lane (``join_fast_lane`` with a ``tag``): its method calls then
reach the worker with no daemon Python, and the pipe's calls take the
actor lock so the two never interleave.

Observability: a worker's stdout and stderr go to per-pid files in its
host's log dir (``_private/log_monitor.py``), which the host tails to the
driver; a traced task's exec span and the worker's cumulative profile ride
its result frame into the host's span buffer and profile store; user
metrics drain to the host after each task (``metrics_push``); and a
``profile_burst`` op samples the worker's stacks on demand.

Runtime environments: a task's prepared env rides its message; the worker
resolves its ``pkg://`` URIs into the node-local package cache (the blob is
fetched once from the owner with the ``fetch_runtime_pkg`` core op) and
applies the env around the body. The compiled DAG's cross-process mode
binds an actor worker's stages to shared-memory channels with one
``dag_start`` op; a loop thread then runs them each round with no message
on this pipe, until a ``dag_stop`` of the same generation.
"""

from __future__ import annotations

import hashlib
import inspect
import itertools
import os
import pickle
import queue
import socket
import struct
import sys
import threading
import time
import traceback
import weakref
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ray_tpu_torch._private import failpoints as _fp
from ray_tpu_torch._private import serialization
from ray_tpu_torch._private.device_objects import DeviceValue, wire_dumps
from ray_tpu_torch._private.ids import ActorID, ObjectID, TaskID
from ray_tpu_torch._private.task_spec import TaskKind, TaskSpec


class WorkerCrashed(Exception):
    """The worker process died while something was running on it."""


_CALLS = [0]                    # calls sent to worker processes, in all
_CALLS_LOCK = threading.Lock()


def calls_sent() -> int:
    """How many task, actor-creation and method calls this process has sent
    to worker processes, through the pipe or the fast lane."""
    return _CALLS[0]


def _count_sent() -> None:
    with _CALLS_LOCK:
        _CALLS[0] += 1


_HEAD = struct.Struct("!QI")     # header bytes, payload parts
_LEN = struct.Struct("!Q")
_SOCK_BUF = 4 << 20             # asked for; the kernel caps it


def _pack(value: Any, host_only: bool = False) -> List[Any]:
    """A value as payload parts: the in-band pickle stream, then each
    out-of-band buffer. ``host_only``: raise DeviceValue on a tensor or
    device off the CPU (the accelerator-plane rule) instead of copying it
    to host bytes."""
    buffers: List[pickle.PickleBuffer] = []
    inband = wire_dumps(value, buffer_callback=buffers.append,
                        host_only=host_only)
    return [inband] + [b.raw() for b in buffers]


def _unpack(parts: Sequence[Any]) -> Any:
    return pickle.loads(parts[0], buffers=parts[1:])


class _Channel:
    """One end of a worker's socket pair: messages of a header dict and the
    parts of one payload, sent whole under a lock."""

    def __init__(self, sock: socket.socket):
        self.sock = sock
        # a wire lock: it keeps one message's frames contiguous on the
        # socket, and nothing else is done while it is held
        self._send_lock = threading.Lock()
        for opt in (socket.SO_SNDBUF, socket.SO_RCVBUF):
            try:
                sock.setsockopt(socket.SOL_SOCKET, opt, _SOCK_BUF)
            except OSError:
                pass

    def send(self, msg: Dict[str, Any], parts: Sequence[Any] = ()) -> None:
        header = pickle.dumps(msg, protocol=5)
        views = [memoryview(p).cast("B") for p in parts]
        prefix = _HEAD.pack(len(header), len(views)) + b"".join(
            _LEN.pack(v.nbytes) for v in views)
        with self._send_lock:
            self.sock.sendall(prefix + header)
            for v in views:
                self.sock.sendall(v)

    def recv(self) -> Tuple[Dict[str, Any], List[memoryview]]:
        n_header, n_parts = _HEAD.unpack(self._exact(_HEAD.size))
        lens = self._exact(_LEN.size * n_parts)
        sizes = [_LEN.unpack_from(lens, i * _LEN.size)[0]
                 for i in range(n_parts)]
        msg = pickle.loads(self._exact(n_header))
        return msg, [self._exact(n) for n in sizes]

    def _exact(self, n: int) -> memoryview:
        # np.empty: a large part needs no zero-fill before it is read over
        buf = memoryview(np.empty(n, np.uint8) if n >= 1 << 16
                         else bytearray(n)).cast("B")
        pos = 0
        while pos < n:
            got = self.sock.recv_into(buf[pos:], n - pos, socket.MSG_WAITALL)
            if not got:
                raise EOFError("worker channel closed")
            pos += got
        return buf

    def close(self) -> None:
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self.sock.close()


# ---------------------------------------------------------------------------
# function table (code shipping)
# ---------------------------------------------------------------------------

_FN_TABLE: Dict[str, bytes] = {}
_FN_REFS: Dict[str, int] = {}
_FN_TABLE_LOCK = threading.Lock()
_FN_MEMO: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _release_fn_blob(fid: str) -> None:
    """weakref.finalize callback: the last live callable for this blob was
    collected, so nothing can submit it again."""
    with _FN_TABLE_LOCK:
        n = _FN_REFS.get(fid, 0) - 1
        if n <= 0:
            _FN_REFS.pop(fid, None)
            _FN_TABLE.pop(fid, None)
        else:
            _FN_REFS[fid] = n


def export_function(fn) -> Tuple[str, bytes]:
    """Pickle ``fn`` once and register it in the function table; returns
    (function_id, blob). Workers fetch the blob by id on first use and
    cache it. Raises DeviceValue, every time, for a function whose closure
    or globals name a device off the CPU."""
    try:
        cached = _FN_MEMO.get(fn)
    except TypeError:
        cached = None
    if isinstance(cached, str):
        raise DeviceValue(cached)
    if cached is not None:
        return cached
    try:
        blob = wire_dumps(fn, host_only=True)
    except DeviceValue as e:
        # the message only: the exception's frames hold ``fn``, which
        # would then never leave this weak-keyed memo
        try:
            _FN_MEMO[fn] = str(e)
        except TypeError:
            pass
        raise
    fid = hashlib.sha1(blob).hexdigest()
    entry = (fid, blob)
    with _FN_TABLE_LOCK:
        _FN_TABLE[fid] = blob
    try:
        _FN_MEMO[fn] = entry
        with _FN_TABLE_LOCK:
            _FN_REFS[fid] = _FN_REFS.get(fid, 0) + 1
        weakref.finalize(fn, _release_fn_blob, fid)
    except TypeError:
        pass    # unweakrefable callables just pickle again
    return entry


def register_function_blob(blob: bytes) -> str:
    """Register an already-pickled callable (a daemon receives the blobs a
    driver ships in push_task_batch), so pool workers fetch it by id here
    with no owner round trip."""
    fid = hashlib.sha1(blob).hexdigest()
    with _FN_TABLE_LOCK:
        _FN_TABLE[fid] = bytes(blob)
    return fid


def fetch_function_blob(fid: str) -> bytes:
    with _FN_TABLE_LOCK:
        blob = _FN_TABLE.get(fid)
    if blob is None:
        raise KeyError(f"function {fid} not in function table")
    return blob


# ---------------------------------------------------------------------------
# worker-process side
# ---------------------------------------------------------------------------

_current_rid = threading.local()


def _set_owner(own: Optional[str]) -> None:
    """Bind the running task's driver token (a daemon's worker: the driver
    that pushed it) to this thread. It rides every nested core op back to
    the daemon and names the driver of the thread's output lines."""
    _current_rid.own = own


def _current_owner() -> Optional[str]:
    """This thread's driver token: its task's, else the one its starter
    held (``_inherit_owner_in_threads``), else None. Never another
    thread's: with several drivers attached, the daemon refuses a nested op
    that names none."""
    own = getattr(_current_rid, "own", None)
    if own is None:
        own = getattr(threading.current_thread(), "_rt_owner", None)
    return own


def _inherit_owner_in_threads() -> None:
    """Worker boot: a thread a task starts (a ``Thread``, a pool's, a
    ``Timer``) keeps the task's driver token for its life, so its nested
    ops and lines go to that driver after the worker has moved on to
    another driver's task."""
    start = threading.Thread.start

    def start_with_owner(self):
        own = _current_owner()
        if own is not None:
            self._rt_owner = own
        start(self)

    threading.Thread.start = start_with_owner


def _borrower_key() -> Optional[str]:
    """The owner-side borrow key of refs created on this caller's behalf:
    in an actor, 'a:<actor hex>' (held for the actor's lifetime), else
    't:<task hex>' (held until the owner finishes that task). A lane
    worker's holds key by it, and so do the owner's holds for a daemon's
    workers (``cluster._OwnerHolder``)."""
    from ray_tpu_torch._private import runtime_context
    ctx = runtime_context._ctx.get()
    if ctx is None:
        return None
    if ctx.actor_id is not None:
        return "a:" + ctx.actor_id.hex()
    if ctx.task_id is None:
        return None
    return "t:" + ctx.task_id.hex()


def _dump_exc(e: BaseException) -> bytes:
    tb = traceback.format_exc()
    try:
        return serialization.dumps((e, tb))
    except Exception:
        return serialization.dumps(
            (RuntimeError(f"{type(e).__name__}: {e}"), tb))


class _GeneratorStateProxy:
    """Worker-side view of a driver GeneratorState (ObjectRefGenerator)."""

    def __init__(self, state: "_WorkerState", task_id: TaskID):
        self._state = state
        self._task_id = task_id

    def next_ref(self, index: int, timeout: Optional[float] = None):
        out = self._state.call_host("gen_next", task_id=self._task_id,
                                    index=index, timeout=timeout)
        if out is None:
            raise StopIteration
        return out

    @property
    def finished(self) -> bool:
        return self._state.call_host("gen_finished", task_id=self._task_id)


class _GcsProxy:
    def __init__(self, state: "_WorkerState"):
        self._state = state

    def get_actor_info(self, actor_id):
        return self._state.call_host("gcs_get_actor_info",
                                     actor_id=actor_id)

    def get_named_actor(self, name, namespace):
        return self._state.call_host("gcs_get_named_actor", name=name,
                                     namespace=namespace)

    @property
    def nodes(self):
        return self._state.call_host("gcs_nodes")

    def kv_put(self, key, value, overwrite=True, namespace=b""):
        return self._state.call_host("gcs_kv_put", key=key, value=value,
                                     overwrite=overwrite,
                                     namespace=namespace)

    def kv_get(self, key, namespace=b""):
        return self._state.call_host("gcs_kv_get", key=key,
                                     namespace=namespace)

    def kv_del(self, key, namespace=b""):
        return self._state.call_host("gcs_kv_del", key=key,
                                     namespace=namespace)

    def kv_keys(self, prefix=b"", namespace=b""):
        return self._state.call_host("gcs_kv_keys", prefix=prefix,
                                     namespace=namespace)


class _PgManagerProxy:
    """Worker-side pg_manager: returns picklable copies of the driver's
    PlacementGroups (handle semantics: id, bundles, state)."""

    def __init__(self, state: "_WorkerState"):
        self._state = state

    def get(self, pg_id):
        return self._state.call_host("pg_get", pg_id=pg_id)

    def create(self, bundles, strategy, name=""):
        return self._state.call_host("pg_create", bundles=bundles,
                                     strategy=strategy, name=name)

    def remove(self, pg):
        return self._state.call_host("pg_remove", pg_id=pg.id)

    def table(self):
        return self._state.call_host("pg_table")

    def ready_ref(self, pg_id):
        return self._state.call_host("pg_ready_ref", pg_id=pg_id)

    def wait(self, pg_id, timeout):
        return self._state.call_host("pg_wait", pg_id=pg_id,
                                     timeout=timeout)


class _NoopRefcounter:
    """The driver pins every ref a worker creates until the task (or the
    actor) ends, so counting in the worker is a no-op."""

    def add_local_ref(self, oid):
        pass

    def remove_local_ref(self, oid):
        pass


class WorkerProxyRuntime:
    """Installed as the global runtime inside a worker process: forwards the
    core API to the driver over the pipe. Duck-types the Runtime surface
    that ObjectRef, RemoteFunction, ActorHandle and the module-level API
    touch."""

    def __init__(self, state: "_WorkerState"):
        self._state = state
        self.refcounter = _NoopRefcounter()
        self.gcs = _GcsProxy(state)
        self.pg_manager = _PgManagerProxy(state)
        self._actor_lock = threading.RLock()
        self._actor_executors: Dict[ActorID, Any] = {}

    # Pooled workers serve different runtimes over their lifetime, so job
    # and namespace come from the runtime bound now.
    @property
    def namespace(self):
        return self._state.call_host("host_info")["namespace"]

    @property
    def job_id(self):
        return self._state.call_host("host_info")["job_id"]

    def get(self, refs, timeout: Optional[float] = None):
        refs = list(refs)
        out = self._shm_get(refs, timeout)
        if out is not None:
            return out
        return self._state.call_host("get", refs=refs, timeout=timeout)

    def _shm_get(self, refs, timeout: Optional[float]):
        """Zero-copy resolve through the attached node arena: (offset,
        nbytes) metadata from the daemon, ``np.frombuffer`` on the mapping;
        no payload crosses the pipe and raw-tier arrays skip serialization.
        Per-object slot refs (taken daemon-side on our behalf) keep every
        view safe from eviction until released. An object not in the arena
        yet (its producer still running) is waited for and looked up once
        more before it takes the owner's copy. Returns None to take the
        classic owner path (no arena: not in a daemon, or attach failed)."""
        from ray_tpu_torch.objectplane import arena as _oparena
        ar = _oparena.get_arena()
        if ar is None or not refs or ar.store() is None:
            return None
        values: List[Any] = [None] * len(refs)
        missing = self._shm_resolve(ar, refs, range(len(refs)), values)
        if missing is None:
            return None
        if missing:
            try:
                self.wait([refs[i] for i in missing],
                          num_returns=len(missing), timeout=timeout)
                again = self._shm_resolve(ar, refs, missing, values)
            except Exception:
                again = None
            if again is not None:
                missing = again
        if missing:
            fetched = self._state.call_host(
                "get", refs=[refs[i] for i in missing], timeout=timeout)
            for i, v in zip(missing, fetched):
                values[i] = v
        return values

    def _shm_resolve(self, ar, refs, indices, values) -> Optional[List[int]]:
        """Resolve ``refs[i]`` for each ``i`` in ``indices`` into
        ``values`` from the arena; returns the indices not in it, or None
        when the arena path failed (every granted slot ref released)."""
        from ray_tpu_torch._private.fast_lane import loads_joined
        indices = list(indices)
        try:
            metas = self._state.call_host(
                "shm_get_meta", oids=[refs[i].id.binary() for i in indices])
        except Exception:
            return None
        if not isinstance(metas, list) or len(metas) != len(indices):
            return None
        missing: List[int] = []
        pending = {i: m for i, m in zip(indices, metas)
                   if isinstance(m, dict)}
        try:
            for i, meta in zip(indices, metas):
                if not isinstance(meta, dict):
                    missing.append(i)
                    continue
                # ownership hand-off BEFORE resolving: from here this
                # slot's one release belongs to the code below (the view's
                # finalizer, or the finally), never to the sweep
                del pending[i]
                raw = meta.get("raw")
                if raw:
                    values[i] = ar.view(meta["off"], meta["size"],
                                        meta["slot"], dtype=raw[0],
                                        shape=raw[1])
                else:
                    view = ar.store().view_range(meta["off"], meta["size"])
                    try:
                        values[i] = loads_joined(view)
                    finally:
                        ar.release_slot(meta["slot"])
        except Exception:
            # mid-resolve failure: drop every granted-but-unconsumed slot
            # ref and fall back wholesale
            for meta in pending.values():
                ar.release_slot(meta["slot"])
            return None
        return missing

    def put(self, value):
        ref = self._shm_put(value)
        if ref is not None:
            return ref
        return self._state.call_host("put", value=value)

    def _shm_put(self, value):
        """Direct put: reserve arena space through the daemon, write the
        payload IN PLACE through our own mapping, and send only the seal;
        the payload never rides the pipe or an RPC frame. Returns the
        owner-registered ObjectRef, or None to take the classic path (a
        small value, no arena, any failure)."""
        from ray_tpu_torch.objectplane import arena as _oparena
        ar = _oparena.get_arena()
        if ar is None or ar.store() is None:
            return None
        try:
            from ray_tpu_torch._private.object_store import _is_device_value
            if _is_device_value(value):
                return None
            from ray_tpu_torch._private.config import cfg
            from ray_tpu_torch.objectplane.tiers import raw_put_eligible
            raw = raw_put_eligible(value)
            if raw is not None:
                payload = memoryview(value).cast("B")
                nbytes = payload.nbytes
            else:
                from ray_tpu_torch._private.worker import _find_nested_refs
                if _find_nested_refs(value):
                    # nested ObjectRefs need the owner's borrowed-ref
                    # registration (the classic put)
                    return None
                from ray_tpu_torch._private.fast_lane import join_parts
                payload = join_parts(_pack(value))
                nbytes = len(payload)
                if nbytes < int(cfg().direct_put_min_bytes):
                    return None
            node_hex = self._node_hex()
            if node_hex is None:
                return None     # no task context: the owner path
            oid = ObjectID.from_random()
            key = b"wput:" + oid.binary()
            out = self._state.call_host("shm_put_reserve", key=key,
                                        size=nbytes)
            if not isinstance(out, dict) or "off" not in out:
                return None     # arena full: the classic path
        except Exception:
            return None
        try:
            ar.write(out["off"], payload)
            if not self._seal_with_retry(key, oid, raw, nbytes):
                raise RuntimeError("seal refused")
            return self._state.call_host(
                "put_stored", oid=oid.binary(), key=key, nbytes=nbytes,
                raw=raw, node=node_hex)
        except Exception:
            self._shm_put_abort(key)
            return None

    def _seal_with_retry(self, key: bytes, oid, raw, nbytes: int) -> bool:
        for _ in range(3):
            if _fp.ENABLED:
                try:
                    # drop arm = the seal message is lost in transit;
                    # resend (sealing is idempotent at the daemon)
                    if _fp.fire("shm.seal", nbytes=nbytes) is _fp.DROP:
                        continue
                except Exception:
                    continue
            out = self._state.call_host(
                "shm_put_seal", key=key, ref=oid.binary(), raw=raw)
            return bool(isinstance(out, dict) and out.get("ok"))
        return False

    def _shm_put_abort(self, key: bytes) -> None:
        try:
            self._state.call_host("shm_put_abort", key=key)
        except Exception:
            pass

    @staticmethod
    def _node_hex() -> Optional[str]:
        from ray_tpu_torch._private import runtime_context
        ctx = runtime_context._ctx.get()
        nid = getattr(ctx, "node_id", None) if ctx else None
        return nid.hex() if nid is not None else None

    def wait(self, refs, num_returns: int = 1,
             timeout: Optional[float] = None, fetch_local: bool = True):
        return self._state.call_host("wait", refs=list(refs),
                                     num_returns=num_returns,
                                     timeout=timeout,
                                     fetch_local=fetch_local)

    def submit_task(self, spec: TaskSpec, record_lineage: bool = True):
        return self._state.call_host("submit_task", spec=spec)

    def create_actor(self, spec: TaskSpec, get_if_exists: bool = False):
        return self._state.call_host("create_actor", spec=spec,
                                     get_if_exists=get_if_exists)

    def kill_actor(self, actor_id, no_restart: bool = True,
                   cause: str = "ray_tpu_torch.kill() called"):
        return self._state.call_host("kill_actor", actor_id=actor_id,
                                     no_restart=no_restart, cause=cause)

    def cancel(self, ref, force: bool = False, recursive: bool = True):
        return self._state.call_host("cancel", ref=ref, force=force,
                                     recursive=recursive)

    def generator_state(self, task_id: TaskID) -> _GeneratorStateProxy:
        return _GeneratorStateProxy(self._state, task_id)

    def cluster_resources(self):
        return self._state.call_host("cluster_resources")

    def available_resources(self):
        return self._state.call_host("available_resources")


class _WorkerState:
    def __init__(self, chan: _Channel, boot: Dict[str, Any]):
        self.chan = chan
        self.boot = boot
        self._ids = itertools.count()
        self._pending: Dict[str, list] = {}  #: guarded by self._pending_lock
        self._pending_lock = threading.Lock()
        self._task_threads: Dict[str, threading.Thread] = {}
        self.actor_instance: Any = None
        # serializes method calls between the pipe and the targeted lane;
        # engaged only once the lane binds (_lane_bound), so actors off the
        # lane keep their configured concurrency
        self.actor_lock = threading.RLock()
        self._lane_bound = False
        self._fn_cache: Dict[str, Any] = {}
        self._gen_sems: Dict[str, threading.Semaphore] = {}
        self.proxy = WorkerProxyRuntime(self)
        # the compiled DAG's channel loop (dag_start/dag_stop ops)
        self._dag_stop: Any = None
        self._dag_thread: Any = None
        self._dag_channels: Dict[str, Any] = {}
        self._dag_gen: Any = None

    def send(self, msg: Dict[str, Any], parts: Sequence[Any] = ()) -> None:
        self.chan.send(msg, parts)

    def call_host(self, call: str, **kw) -> Any:
        rid = f"w{next(self._ids)}"
        ev = threading.Event()
        slot = [ev, True, None]
        with self._pending_lock:
            self._pending[rid] = slot
        self.send({"op": "core", "id": rid, "call": call,
                   "task": getattr(_current_rid, "rid", None),
                   "task_key": _borrower_key(),
                   "own": _current_owner()}, _pack(kw))
        ev.wait()
        if slot[1]:
            return slot[2]
        raise slot[2]

    def notify_host(self, call: str, **kw) -> None:
        """``call_host`` that waits for nothing: the host's reply finds no
        pending slot and is dropped."""
        self.send({"op": "core", "id": f"w{next(self._ids)}", "call": call,
                   "task": getattr(_current_rid, "rid", None),
                   "task_key": _borrower_key(),
                   "own": _current_owner()}, _pack(kw))

    # -- main loop -------------------------------------------------------
    def serve_forever(self) -> None:
        while True:
            try:
                msg, parts = self.chan.recv()
            except (EOFError, OSError):
                os._exit(0)
            msg["parts"] = parts
            op = msg.get("op")
            if op == "shutdown":
                os._exit(0)
            elif op == "reply":
                with self._pending_lock:
                    slot = self._pending.pop(msg["for"], None)
                if slot is not None:
                    slot[1] = msg["ok"]
                    slot[2] = _unpack(parts)
                    slot[0].set()
            elif op in ("execute_task", "create_actor", "call_method",
                        "reset_actor", "dag_start", "dag_stop"):
                t = threading.Thread(target=self._handle, args=(msg,),
                                     daemon=True,
                                     name=f"task-{msg['id']}")
                self._task_threads[msg["id"]] = t
                t.start()
            elif op == "gen_ack":
                sem = self._gen_sems.get(msg["target"])
                if sem is not None:
                    sem.release()
            elif op == "cancel":
                self._async_raise(msg["target"])
            elif op == "extend_sys_path":
                for p in msg.get("paths", ()):
                    if p not in sys.path:
                        sys.path.append(p)
            elif op == "profile_burst":
                # on-demand stack sampling on a thread of its own, so the
                # burst never blocks this loop
                threading.Thread(target=self._profile_burst, args=(msg,),
                                 daemon=True, name="profile-burst").start()
            elif op == "join_fast_lane":
                # dedicate this worker to the native core's task lane
                # (fast_lane.py); the channel stays open for host ops
                # (fetch_function, nested core ops). With a tag, this is
                # an actor's targeted lane.
                try:
                    from ray_tpu_torch._private.fast_lane import (
                        worker_fast_lane_start)
                    worker_fast_lane_start(tuple(msg["addr"]), self,
                                           tag=msg.get("tag"))
                    if msg.get("tag") is not None:
                        self._lane_bound = True
                    self.send({"id": msg["id"], "op": "result", "ok": True},
                              _pack(None))
                except BaseException as e:  # noqa: BLE001 - shipped back
                    self.send({"id": msg["id"], "op": "result",
                               "ok": False}, [_dump_exc(e)])

    def _profile_burst(self, msg: Dict[str, Any]) -> None:
        from ray_tpu_torch.util import profiling
        try:
            rec = profiling.burst_record(
                f"worker:{os.getpid()}",
                duration_s=float(msg.get("duration") or 2.0))
            self.send({"id": msg["id"], "op": "result", "ok": True},
                      _pack(rec))
        except BaseException as e:  # noqa: BLE001 - shipped back
            self.send({"id": msg["id"], "op": "result", "ok": False},
                      [_dump_exc(e)])

    def _flush_metrics(self) -> None:
        """User metrics made in this worker flow to its host's registry
        (the driver's exposition, or the daemon's snapshot)."""
        from ray_tpu_torch.util import metrics
        try:
            deltas = metrics.drain_deltas()
            if deltas:
                self.call_host("metrics_push", entries=deltas)
        except Exception:
            pass

    def _async_raise(self, rid: str) -> None:
        """Best-effort KeyboardInterrupt into the thread running ``rid``
        (a non-force cancel interrupts the worker)."""
        import ctypes
        t = self._task_threads.get(rid)
        if t is None or not t.is_alive():
            return
        ctypes.pythonapi.PyThreadState_SetAsyncExc(
            ctypes.c_ulong(t.ident), ctypes.py_object(KeyboardInterrupt))

    def _resolve_runtime_env(self, renv):
        """pkg:// URIs to node-local extracted dirs (fetched once from the
        owner through the host channel, then cached)."""
        if not renv:
            return renv
        from ray_tpu_torch._private import runtime_env_packaging as pkg

        def resolve(value):
            if not (isinstance(value, str)
                    and value.startswith(pkg.PKG_SCHEME)):
                return value
            local = pkg.cached_dir(value)
            if local is None:
                local = pkg.extract_blob(
                    value, self.call_host("fetch_runtime_pkg", uri=value))
            return local

        out = dict(renv)
        if out.get("working_dir"):
            out["working_dir"] = resolve(out["working_dir"])
        if out.get("py_modules"):
            out["py_modules"] = [resolve(m) for m in out["py_modules"]]
        return out

    # -- the compiled DAG's channel loop ---------------------------------
    # After one dag_start, every execute() flows only through the
    # pre-allocated shm channels: no task submission, no object store.
    def _dag_start(self, spec: Dict[str, Any]):
        from ray_tpu_torch.dag.shm_channel import ShmChannel
        if self._dag_thread is not None:
            # a superseded binding (a CompiledDAG abandoned without a
            # teardown): stop the stale loop, serve the new one
            self._dag_teardown()
        channels = {name: ShmChannel(name=name)
                    for name in spec["channels"]}
        consts = spec["consts"]
        stages = spec["stages"]
        stop = threading.Event()

        def loop():
            from ray_tpu_torch.dag.shm_channel import ChannelClosed
            while not stop.is_set():
                try:
                    for st in stages:
                        self._dag_run_stage(st, channels, consts, stop)
                except ChannelClosed:
                    return
                except Exception:
                    # e.g. ChannelFull on an oversized stage output: leave
                    # a diagnostic the driver sees (worker logs reach it)
                    # before the loop dies
                    print("[compiled-dag] worker loop died:\n"
                          + traceback.format_exc(), file=sys.stderr,
                          flush=True)
                    return

        t = threading.Thread(target=loop, daemon=True, name="dag-loop")
        self._dag_stop = stop
        self._dag_thread = t
        self._dag_channels = channels
        self._dag_gen = spec.get("gen")
        t.start()
        return None

    def _dag_run_stage(self, st, channels, consts, stop) -> None:
        def fetch(src):
            kind, key = src
            if kind == "chan":
                # idle waiting has no deadline: a compiled DAG parked for
                # hours still answers the next execute(); the stop event
                # is the only exit
                return channels[key].read(stop=stop, timeout=None)
            return ("ok", consts[key])

        inputs = [fetch(s) for s in st["args"]]
        kw_in = {k: fetch(s) for k, s in st["kwargs"].items()}
        err = next((v for s, v in inputs if s != "ok"),
                   next((v for s, v in kw_in.values() if s != "ok"),
                        None))
        if err is not None:
            out = ("err", err)       # an upstream failure propagates
        else:
            try:
                method = getattr(self.actor_instance, st["method"])
                out = ("ok", method(
                    *[v for _, v in inputs],
                    **{k: v for k, (_, v) in kw_in.items()}))
            except BaseException as e:  # noqa: BLE001 - via the channel
                out = ("err", e)
        for name in st["out"]:
            channels[name].write(out[0], out[1], stop=stop,
                                 timeout=3600.0)

    def _dag_teardown(self):
        if self._dag_stop is not None:
            self._dag_stop.set()
        if self._dag_thread is not None:
            self._dag_thread.join(timeout=5)
        for ch in self._dag_channels.values():
            ch.close()
        self._dag_stop = None
        self._dag_thread = None
        self._dag_channels = {}
        self._dag_gen = None
        return None

    def _fn(self, msg: Dict[str, Any]):
        fid = msg["fn_id"]
        fn = self._fn_cache.get(fid)
        if fn is None:
            fn = pickle.loads(self.call_host("fetch_function", fid=fid))
            self._fn_cache[fid] = fn
        return fn

    def _handle(self, msg: Dict[str, Any]) -> None:
        from ray_tpu_torch._private import runtime_context

        rid = msg["id"]
        _current_rid.rid = rid
        _set_owner(msg.get("own"))
        # a lane-bound actor's pipe call holds the actor lock through a
        # streaming drain too: it must not interleave with a lane call
        locked = msg["op"] == "call_method" and self._lane_bound
        ctx = dict(msg.get("ctx") or {})
        # the exec-phase span of a task or method call: the body timed in
        # the worker (the only process that sees it), shipped on the
        # result frame
        trace = ctx.pop("trace", None)
        if msg["op"] not in ("execute_task", "call_method"):
            trace = None
        t_exec0 = time.perf_counter() if trace else 0.0

        def exec_span():
            if not trace:
                return None
            from ray_tpu_torch._private.events import wall_at
            nid, tid = ctx.get("node_id"), ctx.get("task_id")
            end = time.perf_counter()
            return {"task_id": tid.hex() if tid is not None else "",
                    "name": ctx.get("task_name", ""), "event": "SPAN",
                    "phase": "exec",
                    "node_id": nid.hex() if nid is not None else "",
                    "proc": f"worker:{os.getpid()}", "trace_id": trace,
                    "wall_ts": wall_at(end), "start_wall": wall_at(t_exec0),
                    "dur_s": end - t_exec0}

        try:
            token = runtime_context._set_context(**ctx)
            if locked:
                self.actor_lock.acquire()
            try:
                from ray_tpu_torch.runtime_env import apply_runtime_env
                renv = self._resolve_runtime_env(msg.get("runtime_env"))
                with apply_runtime_env(renv), _post_mortem_on_error():
                    op = msg["op"]
                    if op == "create_actor":
                        cls = self._fn(msg)
                        args, kwargs = _unpack(msg["parts"])
                        self.actor_instance = cls(*args, **kwargs)
                        result = None
                    elif op == "call_method":
                        method = getattr(self.actor_instance, msg["method"])
                        args, kwargs = _unpack(msg["parts"])
                        result = method(*args, **kwargs)
                    elif op == "dag_start":
                        result = self._dag_start(_unpack(msg["parts"]))
                    elif op == "dag_stop":
                        gen = _unpack(msg["parts"])
                        # generation-scoped: a stale CompiledDAG being
                        # collected must not stop a newer binding's loop
                        result = (self._dag_teardown()
                                  if gen is None or gen == self._dag_gen
                                  else None)
                    elif op == "reset_actor":
                        self._dag_teardown()    # a recycle leaves no loop
                        # Clean actor teardown: drop the instance so the
                        # process can go back to the idle pool. If anything
                        # still holds the instance after gc (a thread the actor
                        # started, a module global) the worker is dirty and
                        # must be killed, not recycled.
                        inst, self.actor_instance = self.actor_instance, None
                        wr = weakref.ref(inst) if inst is not None else None
                        del inst
                        import gc
                        gc.collect()
                        if wr is not None and wr() is not None:
                            raise RuntimeError("actor instance still "
                                               "referenced; worker dirty")
                        result = None
                    else:
                        fn = self._fn(msg)
                        args, kwargs = _unpack(msg["parts"])
                        result = fn(*args, **kwargs)
                    if inspect.isgenerator(result):
                        # producer-side flow control: at most `backpressure`
                        # unacked items cross the pipe; the driver acks as the
                        # consumer pulls them
                        bp = msg.get("backpressure") or -1
                        sem = None
                        if bp > 0:
                            sem = threading.Semaphore(bp)
                            self._gen_sems[rid] = sem
                        try:
                            # the actor lock spans a whole method call, a
                            # streaming one's sends included; the host's
                            # reader never takes it, so a send that blocks
                            # cannot deadlock
                            self.send({"id": rid, "op": "gen_start"})  # raylint: disable=blocking-under-lock
                            for item in result:
                                if sem is not None:
                                    sem.acquire()
                                self.send({"id": rid, "op": "yield"},  # raylint: disable=blocking-under-lock
                                          _pack(item))
                            self._flush_metrics()   # before the release
                            self.send({"id": rid, "op": "result", "ok": True,  # raylint: disable=blocking-under-lock
                                       "span": exec_span()}, _pack(None))
                        finally:
                            self._gen_sems.pop(rid, None)
                        return
            finally:
                if locked:
                    self.actor_lock.release()
                runtime_context._reset_context(token)
            # flush before the result: once the host sees it, it may
            # release or kill this worker
            self._flush_metrics()
            self.send({"id": rid, "op": "result", "ok": True,
                       "span": exec_span(), "profile": _result_profile()},
                      _pack(result))
        except BaseException as e:  # noqa: BLE001 - shipped to the driver
            try:
                self._flush_metrics()
                self.send({"id": rid, "op": "result", "ok": False,
                           "span": exec_span(),
                           "profile": _result_profile()},
                          [_dump_exc(e)])
            except (BrokenPipeError, OSError):
                os._exit(1)
        finally:
            self._task_threads.pop(rid, None)


# The worker's cumulative profile rides at most one result frame a second;
# the host ingests it and a daemon's heartbeat ships it to the head. None
# (the common case, profiling off) costs one key on the frame.
_PROFILE_RESULT_S = 1.0
_last_profile_sent = [0.0]


def _post_mortem_on_error():
    """The remote debugger's hook (one definition, in ``util/rpdb.py``,
    shared with the in-process path), guarded so a debugger-side import
    failure never masks the user's exception."""
    import contextlib
    try:
        from ray_tpu_torch.util.rpdb import post_mortem_on_error
        return post_mortem_on_error()
    except Exception:
        return contextlib.nullcontext()


def _result_profile():
    from ray_tpu_torch.util import profiling
    rec = profiling.process_profile()
    if rec is None:
        return None
    now = time.monotonic()
    if now - _last_profile_sent[0] < _PROFILE_RESULT_S:
        return None
    _last_profile_sent[0] = now
    return rec


def _child_main(sock: socket.socket) -> None:
    """Worker bootstrap, forked from the forkserver template (not a
    ``spawn``, which would re-run the driver's ``__main__``, and not a fresh
    interpreter, which pays its start and the port's imports per worker).
    The first message on the socket is the boot config."""
    import signal

    # Ctrl+C goes to the whole foreground process group; workers must not
    # die with it (the driver decides shutdown).
    signal.signal(signal.SIGINT, signal.SIG_IGN)
    # network-chaos role: any control-plane socket this worker opens (the
    # lane's result delivery) matches worker>* link policies
    from ray_tpu_torch._private import netchaos as _nc
    _nc.set_local_role("worker")
    chan = _Channel(sock)
    boot, _ = chan.recv()
    os.environ.update(boot.get("env", {}))
    for p in boot.get("extra_sys_path", []):
        if p not in sys.path:
            sys.path.append(p)
    if boot.get("log_dir"):
        # per-worker log files, tailed to the driver by the host's monitor
        from ray_tpu_torch._private.log_monitor import \
            redirect_process_output
        try:
            redirect_process_output(boot["log_dir"], _current_owner)
        except OSError:
            pass
    _inherit_owner_in_threads()
    if boot.get("force_cpu_platform"):
        from ray_tpu_torch._private.platform import force_cpu_platform
        force_cpu_platform()
    if boot.get("profiling_hz"):
        from ray_tpu_torch.util import profiling
        profiling.start_process_sampler(f"worker:{os.getpid()}",
                                        hz=boot["profiling_hz"])
    if boot.get("arena"):
        # the hosting daemon's arena: attached lazily on first use
        from ray_tpu_torch.objectplane import arena as _oparena
        _oparena.configure(*boot["arena"])
    from ray_tpu_torch._private import worker as worker_mod

    state = _WorkerState(chan, boot)
    worker_mod._global_runtime = state.proxy  # type: ignore[assignment]
    state.serve_forever()


# ---------------------------------------------------------------------------
# driver side
# ---------------------------------------------------------------------------

class _Pending:
    __slots__ = ("q",)

    def __init__(self):
        self.q: "queue.Queue" = queue.Queue()


_DEAD = object()  # pushed into pending queues on worker death

_MP_CTX = None
_MP_CTX_LOCK = threading.Lock()
_START_LOCK = threading.Lock()
_OUR_FORKSERVER = None


def _mp_context():
    """The forkserver context every worker forks from. The forkserver is the
    template process: it preloads this module, numpy, pyarrow and, where
    this process has imported it, torch once (a preload that is not
    installed is skipped), with the card
    hidden (``CUDA_VISIBLE_DEVICES=""`` in its environment), and never
    initialises CUDA."""
    global _MP_CTX, _OUR_FORKSERVER
    with _MP_CTX_LOCK:
        if _MP_CTX is not None:
            return _MP_CTX
        import multiprocessing as mp
        from multiprocessing import forkserver as _fs

        ctx = mp.get_context("forkserver")
        repo_root = os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))))
        # The template inherits this process's environment when it starts:
        # set its two variables for the moment of the start only. CUDA
        # reads CUDA_VISIBLE_DEVICES at its first initialisation, so pin
        # this process's own view of the card first (a no-op once torch
        # has touched CUDA).
        torch = sys.modules.get("torch")
        if torch is not None:
            torch.cuda.device_count()
        saved = {k: os.environ.get(k)
                 for k in ("CUDA_VISIBLE_DEVICES", "PYTHONPATH")}
        os.environ["CUDA_VISIBLE_DEVICES"] = ""
        os.environ["PYTHONPATH"] = repo_root + (
            os.pathsep + saved["PYTHONPATH"] if saved["PYTHONPATH"] else "")
        try:
            # a PRIVATE ForkServer: multiprocessing's module-level one may
            # already run for user code, with the card visible and no
            # preloads, and ours must never serve user forks
            _OUR_FORKSERVER = _fs.ForkServer()
            # pyarrow as JAX's template does: its first import in a task's
            # thread, then its use from another thread after that one
            # exits, segfaults (a plain-process repro, no fork needed)
            # torch too where this process has it: a worker's first use of
            # it (a policy, a probe, a tensor argument) then costs no
            # import, seconds on a slow host; importing it initialises no
            # CUDA, and a process without torch (a daemon) keeps its
            # templates light
            _OUR_FORKSERVER.set_forkserver_preload(
                ["ray_tpu_torch._private.worker_process",
                 "ray_tpu_torch._private.worker", "numpy", "pyarrow"]
                + (["torch"] if torch is not None else []))
            _OUR_FORKSERVER.ensure_running()
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        import atexit

        atexit.register(stop_worker_plane)
        _MP_CTX = ctx
        return ctx


def forkserver_pid() -> Optional[int]:
    """The template's pid while it runs (tests and the chip check read
    it)."""
    fs = _OUR_FORKSERVER
    return getattr(fs, "_forkserver_pid", None) if fs is not None else None


def _stop_forkserver() -> None:
    """Stop the template process (closing its alive pipe ends its loop) and
    wait for it; a later worker start makes a new one."""
    global _MP_CTX, _OUR_FORKSERVER
    with _MP_CTX_LOCK:
        fs, _OUR_FORKSERVER = _OUR_FORKSERVER, None
        _MP_CTX = None
    if fs is None:
        return
    fd = getattr(fs, "_forkserver_alive_fd", None)
    pid = getattr(fs, "_forkserver_pid", None)
    if fd is not None:
        try:
            os.close(fd)
        except OSError:
            pass
        fs._forkserver_alive_fd = None
    if pid is not None:
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline:
            try:
                done, _ = os.waitpid(pid, os.WNOHANG)
            except ChildProcessError:
                break
            if done:
                break
            time.sleep(0.02)
        else:
            try:
                os.kill(pid, 9)
                os.waitpid(pid, 0)
            except (ProcessLookupError, ChildProcessError):
                pass


def _start_sans_main(p) -> None:
    """Start a worker Process on OUR forkserver, without multiprocessing's
    main-module fixup: a worker must never re-run the driver's
    ``__main__`` (a user script, ``chip_smoke.py``); driver-side functions
    reach workers through the function table instead. Both patches are
    scoped: the lock serialises our starts, the spawn patch checks the
    starting thread, and the forkserver alias is restored before
    release."""
    from multiprocessing import forkserver as _fs
    from multiprocessing import spawn as _spawn

    with _START_LOCK:
        orig = _spawn.get_preparation_data
        me = threading.get_ident()

        def sans_main(name):
            d = orig(name)
            if threading.get_ident() == me:
                d.pop("init_main_from_path", None)
                d.pop("init_main_from_name", None)
            return d

        # popen_forkserver calls the module-level alias (a bound method of
        # the import-time singleton), so that alias is what we swap
        saved_connect = _fs.connect_to_new_process
        _spawn.get_preparation_data = sans_main
        if _OUR_FORKSERVER is not None:
            _fs.connect_to_new_process = _OUR_FORKSERVER.connect_to_new_process
        try:
            p.start()
        finally:
            _fs.connect_to_new_process = saved_connect
            _spawn.get_preparation_data = orig


def rebind_pg(rt, spec):
    """Specs built inside a worker carry a pickled copy of their
    PlacementGroup; bind the strategy to the driver's live group by id."""
    strat = getattr(spec, "scheduling_strategy", None)
    pg = getattr(strat, "placement_group", None)
    if pg is not None:
        live = rt.pg_manager.get(pg.id)
        if live is not None:
            strat.placement_group = live
    return spec


def _actor_info_for_worker(info):
    """The actor's GCS record without its creation spec: the spec holds the
    actor's constructor arguments, which need not cross the pipe (and may
    be state of the driver's)."""
    if info is None:
        return None
    import copy
    out = copy.copy(info)
    out.creation_spec = None
    return out


def dispatch_core_op(rt, holder, call: str, kw: Dict[str, Any],
                     task_rid: Optional[str]) -> Any:
    """Driver-side dispatch of a worker-initiated core operation.
    ``holder`` pins refs created on behalf of the worker via
    ``_hold(task_rid, obj)``."""
    if call == "get":
        return rt.get(kw["refs"], timeout=kw.get("timeout"))
    if call == "put":
        ref = rt.put(kw["value"])
        holder._hold(task_rid, ref)
        return ref
    if call == "wait":
        return rt.wait(kw["refs"], num_returns=kw["num_returns"],
                       timeout=kw["timeout"], fetch_local=kw["fetch_local"])
    if call == "submit_task":
        refs = rt.submit_task(rebind_pg(rt, kw["spec"]))
        holder._hold(task_rid, refs)
        return refs
    if call == "create_actor":
        return rt.create_actor(rebind_pg(rt, kw["spec"]),
                               get_if_exists=kw["get_if_exists"])
    if call == "kill_actor":
        return rt.kill_actor(kw["actor_id"], no_restart=kw["no_restart"],
                             cause=kw["cause"])
    if call == "cancel":
        return rt.cancel(kw["ref"], force=kw["force"],
                         recursive=kw["recursive"])
    if call == "gen_next":
        state = rt.generator_state(kw["task_id"])
        try:
            ref = state.next_ref(kw["index"], timeout=kw.get("timeout"))
        except StopIteration:
            return None
        holder._hold(task_rid, ref)
        return ref
    if call == "gen_finished":
        return rt.generator_state(kw["task_id"]).finished
    if call == "gcs_get_actor_info":
        return _actor_info_for_worker(rt.gcs.get_actor_info(kw["actor_id"]))
    if call == "gcs_get_named_actor":
        return rt.gcs.get_named_actor(kw["name"], kw["namespace"])
    if call == "gcs_nodes":
        return dict(rt.gcs.nodes)
    if call.startswith("gcs_kv_"):
        # the store util.rpdb._kv prefers: the head's KV when there is one
        # (discoverable from other processes, as `cli debug` needs), else
        # the driver's gcs
        backend = getattr(rt, "cluster_backend", None)
        store = getattr(backend, "head", None) or rt.gcs
        ns = kw.get("namespace", b"")
        if call == "gcs_kv_put":
            return store.kv_put(kw["key"], kw["value"],
                                overwrite=kw.get("overwrite", True),
                                namespace=ns)
        if call == "gcs_kv_get":
            return store.kv_get(kw["key"], namespace=ns)
        if call == "gcs_kv_del":
            return store.kv_del(kw["key"], namespace=ns)
        if call == "gcs_kv_keys":
            return store.kv_keys(kw["prefix"], namespace=ns)
    if call == "fetch_function":
        return fetch_function_blob(kw["fid"])
    if call == "fetch_runtime_pkg":
        from ray_tpu_torch._private.runtime_env_packaging import \
            fetch_pkg_blob
        return fetch_pkg_blob(kw["uri"])
    if call == "put_stored":
        # a daemon worker's direct put: the payload is already written and
        # sealed in its node's arena; the owner records ownership,
        # location and the raw tier's dtype/shape
        ref = rt.put_stored(kw["oid"], kw["key"], kw["nbytes"],
                            kw.get("raw"), kw["node"])
        holder._hold(task_rid, ref)
        return ref
    if call == "locate_object":
        # the owner's object directory: which daemons hold a copy (by
        # their store key)
        return rt.locate_object(kw["oid"])
    if call == "pg_get":
        return rt.pg_manager.get(kw["pg_id"])
    if call == "pg_create":
        return rt.pg_manager.create(kw["bundles"], kw["strategy"],
                                    kw["name"])
    if call == "pg_remove":
        pg = rt.pg_manager.get(kw["pg_id"])
        if pg is not None:
            rt.pg_manager.remove(pg)
        return None
    if call == "pg_table":
        return rt.pg_manager.table()
    if call == "pg_ready_ref":
        ref = rt.pg_manager.ready_ref(kw["pg_id"])
        holder._hold(task_rid, ref)
        return ref
    if call == "pg_wait":
        return rt.pg_manager.wait(kw["pg_id"], kw["timeout"])
    if call == "host_info":
        return {"namespace": rt.namespace, "job_id": rt.job_id}
    if call == "export_event":
        from ray_tpu_torch._private.export_events import emit_export
        emit_export(kw["event_type"], **kw["payload"])
        return None
    if call == "cluster_resources":
        return rt.cluster_resources()
    if call == "available_resources":
        return rt.available_resources()
    raise ValueError(f"unknown core op {call!r}")


class WorkerClient:
    """Driver handle to one worker process."""

    def __init__(self, boot: Dict[str, Any]):
        ctx = _mp_context()
        parent, child = socket.socketpair()
        self.proc = ctx.Process(target=_child_main, args=(child,),
                                daemon=True, name="ray-tpu-torch-worker")
        _start_sans_main(self.proc)
        child.close()
        self.pid = self.proc.pid
        self.chan = _Channel(parent)
        # first message: the boot config (platform pinning etc.)
        self.chan.send(boot)
        self._ids = itertools.count()
        #: guarded by self._pending_lock
        self._pending: Dict[str, _Pending] = {}
        self._pending_lock = threading.Lock()
        # Objects created on the worker's behalf (refs from put/submit),
        # pinned until the creating task -- or the whole actor -- ends.
        self._holds: Dict[str, List[Any]] = {}
        self.runtime = None          # bound by the router on assignment
        self.node = None
        self.actor_id: Optional[ActorID] = None
        self.fast_lane = False       # dedicated to the native core's lane
        self.lane_tag = None         # an actor's targeted-lane tag
        # in a daemon: results stay blobs, relayed without loading
        self.raw_outcomes = False
        self.expected_death = False
        self.dead = False
        self.calls = 0
        self._on_death: List[Any] = []
        self._reader = threading.Thread(target=self._read_loop, daemon=True,
                                        name=f"wkr-read-{self.pid}")
        self._reader.start()

    # -- plumbing --------------------------------------------------------
    def _send(self, msg: Dict[str, Any], parts: Sequence[Any] = ()) -> None:
        try:
            self.chan.send(msg, parts)
        except OSError:
            raise WorkerCrashed(
                f"worker {self.pid} pipe closed "
                f"(exitcode={self.proc.exitcode})")

    def _read_loop(self) -> None:
        while True:
            try:
                msg, parts = self.chan.recv()
            except Exception:
                self._on_dead()
                return
            msg["parts"] = parts
            op = msg.get("op")
            if op in ("result", "gen_start", "yield"):
                if op == "result":
                    self._ingest_observability(msg)
                with self._pending_lock:
                    pend = self._pending.get(msg["id"])
                if pend is not None:
                    pend.q.put(msg)
            elif op == "core":
                threading.Thread(target=self._serve_core, args=(msg,),
                                 daemon=True, name="wkr-core").start()

    def _ingest_observability(self, msg: Dict[str, Any]) -> None:
        """The exec span and the profile record a result frame carries,
        into this host's span buffer (the driver's, or the daemon's, which
        its heartbeat ships to the head) and profile store."""
        try:
            if msg.get("span") is not None:
                from ray_tpu_torch._private import events
                events.ingest_span_events(
                    getattr(self.runtime, "task_events", None),
                    [msg["span"]])
            if msg.get("profile") is not None:
                from ray_tpu_torch.util import profiling
                profiling.ingest_profile(msg["profile"])
        except Exception:
            pass    # observability never fails a result

    def _on_dead(self) -> None:
        if self.dead:
            return
        self.dead = True
        # reap the child so it leaves no zombie behind
        try:
            self.proc.join(timeout=1.0)
        except Exception:
            pass
        with self._pending_lock:
            pending = list(self._pending.values())
        for p in pending:
            p.q.put(_DEAD)
        self._holds.clear()
        callbacks, self._on_death = self._on_death, []
        for cb in callbacks + list(DEATH_HOOKS):
            try:
                cb(self)
            except Exception:
                pass

    def add_death_callback(self, cb) -> None:
        if self.dead:
            cb(self)
        else:
            self._on_death.append(cb)

    def alive(self) -> bool:
        return not self.dead and self.proc.is_alive()

    def notify_extend_sys_path(self, paths: List[str]) -> None:
        """Fire-and-forget: a live worker learns new import roots of the
        driver (a daemon's hello reaches the prestarted pool too)."""
        self._send({"op": "extend_sys_path", "paths": list(paths)})

    def kill(self, expected: bool = True) -> None:
        self.expected_death = self.expected_death or expected
        try:
            self._send({"op": "shutdown"})
        except WorkerCrashed:
            pass
        self.proc.join(timeout=0.5)
        if self.proc.is_alive():
            self.proc.kill()
            self.proc.join(timeout=1.0)
        try:
            self.chan.close()
        except OSError:
            pass

    # -- worker-initiated core ops ---------------------------------------
    def _serve_core(self, msg: Dict[str, Any]) -> None:
        try:
            rt = self.runtime
            if msg["call"] == "metrics_push":
                # the process-wide registry, no runtime needed: the
                # post-task flush races release_worker's unbinding
                from ray_tpu_torch.util import metrics
                metrics.merge_deltas(_unpack(msg["parts"])["entries"])
                self._send({"op": "reply", "for": msg["id"], "ok": True},
                           _pack(True))
                return
            if rt is None:
                raise RuntimeError("worker not bound to a runtime")
            call = msg["call"]
            forward = getattr(rt, "forward_core_op", None)
            local_fn = None
            if forward is not None and call == "fetch_function":
                # content-addressed blobs the daemon already holds
                local_fn = _FN_TABLE.get(_unpack(msg["parts"])["fid"])
            if forward is not None and call in _SHM_LOCAL_OPS:
                # object-plane metadata ops are daemon-LOCAL: neither the
                # metadata nor the payload round-trips through the owner.
                # This client rides along so grants are charged to it.
                value = rt.shm_ops(call, _unpack(msg["parts"]), self)
                parts = _pack(value)
                ok = True
            elif local_fn is not None:
                parts, ok = _pack(local_fn), True
            elif forward is not None:
                # in a daemon: a blob round trip to the owner (the driver
                # the task's token names), loaded only at its edge
                from ray_tpu_torch._private.fast_lane import (join_parts,
                                                              split_joined)
                ok, blob = forward(call, join_parts(msg["parts"]),
                                   msg.get("task_key") or msg.get("task"),
                                   msg.get("own"))
                parts = split_joined(blob)
            else:
                kw = _unpack(msg["parts"])
                value = dispatch_core_op(rt, self, call, kw,
                                         self._hold_key_for(msg))
                parts, ok = _pack(value), True
            reply = {"op": "reply", "for": msg["id"], "ok": ok}
        except BaseException as e:  # noqa: BLE001 - shipped back
            try:
                parts = [serialization.dumps(e)]
            except Exception:
                parts = [serialization.dumps(RuntimeError(repr(e)))]
            reply = {"op": "reply", "for": msg["id"], "ok": False}
        try:
            self._send(reply, parts)
        except WorkerCrashed:
            pass

    def _hold(self, task_rid: Optional[str], obj: Any) -> None:
        key = task_rid or "__actor__"
        if self.actor_id is not None:
            key = "__actor__"   # actor-held refs live as long as the actor
        self._holds.setdefault(key, []).append(obj)

    def _hold_key_for(self, msg: Dict[str, Any]) -> Optional[str]:
        """Classic workers key holds by worker rid (released in _finish);
        dedicated lane workers have no per-call _finish, so their holds key
        by the global borrower id ('t:<task>') and are released by
        ProcessRouter.release_borrows when the task ends."""
        if self.fast_lane and msg.get("task_key"):
            return msg["task_key"]
        return msg.get("task")

    def _request(self, msg: Dict[str, Any],
                 parts: Sequence[Any] = ()) -> Tuple[str, _Pending]:
        rid = f"h{next(self._ids)}"
        msg["id"] = rid
        pend = _Pending()
        with self._pending_lock:
            self._pending[rid] = pend
        if self.dead:
            pend.q.put(_DEAD)
            return rid, pend
        self._send(msg, parts)
        return rid, pend

    def _finish(self, rid: str) -> None:
        with self._pending_lock:
            self._pending.pop(rid, None)
        self._holds.pop(rid, None)

    def _crashed(self, what: str) -> WorkerCrashed:
        if self.proc.is_alive():
            self.proc.join(timeout=1.0)
        return WorkerCrashed(f"worker process {self.pid} died {what}"
                             f"(exitcode={self.proc.exitcode})")

    def _wait_outcome(self, rid: str, pend: _Pending):
        """The first message decides: value, error, or generator."""
        msg = pend.q.get()
        if msg is _DEAD:
            self._finish(rid)
            raise self._crashed("")
        if msg["op"] == "gen_start":
            return ("gen", self._gen_iter(rid, pend))
        if self.raw_outcomes:
            from ray_tpu_torch._private.fast_lane import join_parts
            self._finish(rid)
            return ("ok_raw" if msg["ok"] else "err_raw",
                    join_parts(msg["parts"]))
        payload = _unpack(msg["parts"])
        self._finish(rid)
        if msg["ok"]:
            return ("ok", payload)
        e, tb = payload
        setattr(e, "_remote_traceback", tb)
        return ("err", e)

    def _gen_iter(self, rid: str, pend: _Pending):
        try:
            while True:
                msg = pend.q.get()
                if msg is _DEAD:
                    raise self._crashed("mid-stream ")
                if msg["op"] == "yield":
                    if self.raw_outcomes:
                        # no ack here: in a daemon the ack comes from the
                        # driver's consumer (the gen_ack RPC), so flow
                        # control tracks consumption, not the relay
                        from ray_tpu_torch._private.fast_lane import (
                            join_parts)
                        yield ("yield_raw", join_parts(msg["parts"]))
                        continue
                    yield _unpack(msg["parts"])
                    try:
                        # the consumer pulled the item: grant the producer
                        # another flow-control token
                        self._send({"op": "gen_ack", "target": rid})
                    except WorkerCrashed:
                        pass
                    continue
                if self.raw_outcomes:
                    if not msg["ok"]:
                        from ray_tpu_torch._private.fast_lane import (
                            join_parts)
                        yield ("err_raw", join_parts(msg["parts"]))
                    return
                if not msg["ok"]:
                    e, tb = _unpack(msg["parts"])
                    setattr(e, "_remote_traceback", tb)
                    raise e
                return
        finally:
            self._finish(rid)

    @staticmethod
    def _ctx_fields(spec: TaskSpec, node, runtime) -> Dict[str, Any]:
        ctx = {
            "job_id": spec.job_id or runtime.job_id,
            "task_id": spec.task_id,
            "node_id": node.node_id if node is not None else None,
            "actor_id": spec.actor_id,
            "resources": dict(spec.resources),
            "task_name": spec.name,
            "placement_group_id": spec.placement_group_id,
            "pg_capture": spec.pg_capture,
        }
        if spec.trace_sampled:
            ctx["trace"] = spec.trace_id
        return ctx

    def execute_task(self, spec: TaskSpec, node, fid: str,
                     args_parts: Sequence[Any]):
        self._count_call()
        rid, pend = self._request({
            "op": "execute_task", "fn_id": fid,
            "ctx": self._ctx_fields(spec, node, self.runtime),
            "runtime_env": spec.runtime_env,
            "backpressure": spec.backpressure_num_objects,
        }, args_parts)
        router = self.runtime.process_router
        router.track_task(spec.task_id, self, rid)
        try:
            outcome = self._wait_outcome(rid, pend)
        except BaseException:
            router.untrack_task(spec.task_id)
            raise
        if outcome[0] == "gen":
            # stay tracked while the worker streams: cancel and crash
            # handling must reach a producing generator task
            return ("gen", _untrack_after(router, spec.task_id, outcome[1]))
        router.untrack_task(spec.task_id)
        return outcome

    def create_actor_instance(self, spec: TaskSpec, node, fid: str,
                              args_parts: Sequence[Any],
                              own: Optional[str] = None):
        self._count_call()
        rid, pend = self._request({
            "op": "create_actor", "fn_id": fid,
            "ctx": self._ctx_fields(spec, node, self.runtime),
            "runtime_env": spec.runtime_env,
            "own": own,
        }, args_parts)
        return self._wait_outcome(rid, pend)

    def call_method(self, spec: TaskSpec, node,
                    args_parts: Sequence[Any]):
        self._count_call()
        rid, pend = self._request({
            "op": "call_method", "method": spec.method_name,
            "ctx": self._ctx_fields(spec, node, self.runtime),
            "runtime_env": spec.runtime_env,
        }, args_parts)
        return self._wait_outcome(rid, pend)

    def dag_op(self, op: str, value: Any):
        """A compiled-DAG binding op (``dag_start`` with the stages' spec,
        ``dag_stop`` with the generation), answered like a task."""
        rid, pend = self._request({"op": op, "ctx": {}}, _pack(value))
        return self._wait_outcome(rid, pend)

    def _count_call(self) -> None:
        self.calls += 1
        _count_sent()

    def profile_burst(self, duration: float = 2.0):
        """A stack-sampling burst in the worker: its profile record, or
        None if the worker died mid-burst."""
        try:
            rid, pend = self._request({"op": "profile_burst",
                                       "duration": float(duration)})
            msg = pend.q.get(timeout=duration + 10.0)
        except Exception:
            return None
        self._finish(rid)
        if msg is _DEAD or not msg.get("ok"):
            return None
        return _unpack(msg["parts"])

    def reset_actor(self):
        """Tear down the actor instance in the worker (the clean death path)
        so the worker can be recycled."""
        rid, pend = self._request({"op": "reset_actor", "ctx": {}})
        return self._wait_outcome(rid, pend)

    def cancel_request(self, rid: str) -> None:
        try:
            self._send({"op": "cancel", "target": rid})
        except WorkerCrashed:
            pass


def _untrack_after(router, task_id, it):
    """Yield through a worker stream, untracking the task at its end."""
    try:
        yield from it
    finally:
        router.untrack_task(task_id)


# ---------------------------------------------------------------------------
# the pool (module-level: idle workers outlive a runtime and serve the next
# one in this process)
# ---------------------------------------------------------------------------

_POOL_LOCK = threading.Lock()
_IDLE: List[WorkerClient] = []
_ALL_WORKERS: "weakref.WeakSet" = weakref.WeakSet()
# called with every worker of this process that dies, after its own
# callbacks (a daemon's log monitor forgets the worker's driver)
DEATH_HOOKS: List[Any] = []
_PRESTARTING = [0]
_FILL_RUNNING = [False]
_POOL_CLOSED = threading.Event()   # interpreter exiting: no new spawns


def live_workers() -> List[WorkerClient]:
    return [w for w in list(_ALL_WORKERS) if w.alive()]


def _pool_floor() -> int:
    """How many idle workers the prestarter keeps ready."""
    from ray_tpu_torch._private.config import cfg
    n = cfg().process_pool_size
    return n if n > 0 else min(4, max(2, (os.cpu_count() or 4) // 2))


def _pool_max() -> int:
    """How many idle workers a release keeps for reuse."""
    from ray_tpu_torch._private.config import cfg
    return max(_pool_floor(), cfg().process_pool_max)


def _async_kill(w: WorkerClient) -> None:
    """Kill off the caller's thread: kill() blocks up to 1.5 s on join."""
    threading.Thread(target=w.kill, daemon=True,
                     name="worker-reaper").start()


# The driver's import roots, shipped to a daemon at hello: by-reference
# pickles of the driver's modules must resolve in the daemon's workers.
_EXTRA_SYS_PATH: List[str] = []
_SYS_PATH_VERSION = [0]

# The hosting daemon's shm arena (name, capacity): handed to every worker
# in the boot frame so it can attach the segment and run the zero-copy
# object protocol. Unset outside daemon processes.
_ARENA_INFO: List[Optional[tuple]] = [None]

_SHM_LOCAL_OPS = frozenset({"shm_get_meta", "shm_release",
                            "shm_put_reserve", "shm_put_seal",
                            "shm_put_abort"})


def set_extra_sys_path(paths: List[str]) -> None:
    changed = False
    for p in paths:
        if p not in _EXTRA_SYS_PATH:
            _EXTRA_SYS_PATH.append(p)
            changed = True
    if changed:
        _SYS_PATH_VERSION[0] += 1


def set_arena_info(name: str, capacity: int) -> None:
    _ARENA_INFO[0] = (name, int(capacity))


def _make_boot() -> Dict[str, Any]:
    # workers never own the card: hide it before anything touches CUDA
    boot: Dict[str, Any] = {"env": {}, "force_cpu_platform": True}
    from ray_tpu_torch._private import log_monitor
    from ray_tpu_torch._private.config import cfg
    if log_monitor.log_to_driver_enabled():
        boot["log_dir"] = log_monitor.session_log_dir()
    # shipped, not inherited: the template may predate the setting
    boot["profiling_hz"] = float(cfg().profiling_hz)
    if _EXTRA_SYS_PATH:
        boot["extra_sys_path"] = list(_EXTRA_SYS_PATH)
    if _ARENA_INFO[0] is not None:
        boot["arena"] = _ARENA_INFO[0]
    return boot


def _spawn_worker() -> WorkerClient:
    # the version BEFORE the boot is built: a set_extra_sys_path racing
    # this spawn leaves the worker stale, and ensure_sys_path re-sends
    version = _SYS_PATH_VERSION[0]
    w = WorkerClient(_make_boot())
    w._sys_path_version = version
    _ALL_WORKERS.add(w)
    return w


def ensure_sys_path(w: WorkerClient) -> None:
    """Re-send the driver's import roots to a worker that predates the
    latest set_extra_sys_path."""
    if getattr(w, "_sys_path_version", -1) != _SYS_PATH_VERSION[0]:
        try:
            w.notify_extend_sys_path(_EXTRA_SYS_PATH)
            w._sys_path_version = _SYS_PATH_VERSION[0]
        except Exception:
            pass


def acquire_worker() -> WorkerClient:
    got: Optional[WorkerClient] = None
    stale: List[WorkerClient] = []
    with _POOL_LOCK:
        while _IDLE:
            w = _IDLE.pop()
            if w.alive():
                got = w
                break
            stale.append(w)
    for w in stale:
        _async_kill(w)
    if got is None:
        got = _spawn_worker()
    _maybe_prestart_async()
    return got


def release_worker(w: WorkerClient) -> None:
    """Back to the idle pool, up to ``process_pool_max`` idle workers; an
    actor's worker or a dead one is killed, never recycled."""
    keep = False
    if w.actor_id is None and w.alive():
        w.runtime = None
        w.node = None
        w.raw_outcomes = False
        with _POOL_LOCK:
            keep = len(_IDLE) < _pool_max() and not _POOL_CLOSED.is_set()
            if keep:
                _IDLE.append(w)
    if not keep:
        _async_kill(w)


def _maybe_prestart_async() -> None:
    """Keep ``process_pool_size`` idle workers ready, in the background."""
    if _POOL_CLOSED.is_set():
        return
    with _POOL_LOCK:
        if (_FILL_RUNNING[0]
                or len(_IDLE) + _PRESTARTING[0] >= _pool_floor()):
            return
        _FILL_RUNNING[0] = True

    def fill():
        try:
            while not _POOL_CLOSED.is_set():
                with _POOL_LOCK:
                    if len(_IDLE) + _PRESTARTING[0] >= _pool_floor():
                        return
                    _PRESTARTING[0] += 1
                try:
                    w = _spawn_worker()
                finally:
                    with _POOL_LOCK:
                        _PRESTARTING[0] -= 1
                with _POOL_LOCK:
                    keep = not _POOL_CLOSED.is_set()
                    if keep:
                        _IDLE.append(w)
                if not keep:
                    _async_kill(w)
                    return
        except Exception:
            pass
        finally:
            with _POOL_LOCK:
                _FILL_RUNNING[0] = False
    threading.Thread(target=fill, daemon=True,
                     name="worker-prestart").start()


def drain_pool() -> None:
    """Kill every idle pooled worker."""
    with _POOL_LOCK:
        idle, _IDLE[:] = list(_IDLE), []
    for w in idle:
        w.kill()


def stop_worker_plane(timeout: float = 10.0) -> None:
    """Kill every worker this process started and stop the template: after
    it returns no worker process and no forkserver of this process is
    left. The next worker start makes a new template. It also runs at
    interpreter exit."""
    _POOL_CLOSED.set()
    try:
        deadline = time.monotonic() + timeout
        while _PRESTARTING[0] > 0 and time.monotonic() < deadline:
            time.sleep(0.02)   # let racing spawns land so the kill sees them
        drain_pool()
        for w in list(_ALL_WORKERS):
            if w.proc.is_alive() or not w.dead:
                w.kill(expected=True)
        _stop_forkserver()
    finally:
        _POOL_CLOSED.clear()


# ---------------------------------------------------------------------------
# the router (owned by the Runtime)
# ---------------------------------------------------------------------------

def _wants_accelerator(resources: Dict[str, float]) -> bool:
    return any(k == "GPU" for k, v in (resources or {}).items() if v)


def needs_driver(value: Any) -> bool:
    """True when ``value`` cannot go to a worker process: it names a device
    off the CPU (a tensor, a module's parameters, a ``torch.device``) or
    the wire cannot pickle it. A library that hands such a value to an
    actor's methods creates that actor with ``_in_process`` on this
    answer."""
    try:
        wire_dumps(value, host_only=True)
    except Exception:
        return True
    return False


class _ProcessActorInstance:
    """Driver-side proxy for an actor living in a worker process. The
    Runtime's actor-task executor detects this type and routes calls
    through ProcessRouter.call_actor_method; the ActorExecutor machinery
    (ordering, concurrency, restarts) drives it like a live instance."""

    __slots__ = ("_client", "_class_name")

    def __init__(self, client: WorkerClient, class_name: str):
        self._client = client
        self._class_name = class_name


class ProcessRouter:
    def __init__(self, runtime):
        from ray_tpu_torch._private.config import cfg

        self.runtime = runtime
        self.enabled = bool(cfg().process_workers)
        self._actor_workers: Dict[ActorID, WorkerClient] = {}
        self._lock = threading.Lock()
        # task_id -> (client, rid) while a normal task runs in a process
        self._running: Dict[TaskID, Tuple[WorkerClient, str]] = {}
        # driver-local fast lane (the native core, csrc/daemon_core.cc,
        # hosted in this process): plain tasks skip the per-task pipe round
        # trip and checkout. Started lazily on the first eligible task.
        self._fast = None                 # FastLaneClient
        self._fast_core = None            # CoreHandle
        self._fast_lock = threading.Lock()
        self._fast_workers: List[WorkerClient] = []
        # task hex -> (lane client, rid): the client pins the rid to its
        # generation (see cancel_task)
        self._fast_rids: Dict[str, Tuple[Any, int]] = {}
        self._fast_disabled = not cfg().fast_lane
        self._fast_max = max(2, min(8, (os.cpu_count() or 4)))
        if self.enabled:
            # start the template now (in init, not under a task's thread),
            # then warm the pool in the background so the first task does
            # not pay the spawn
            _mp_context()
            _maybe_prestart_async()

    # -- eligibility -----------------------------------------------------
    def _serialize_payload(self, spec: TaskSpec, args, kwargs
                           ) -> Optional[Tuple[str, bytes]]:
        """The function's id and the arguments' parts, or None where the
        work stays in the driver: the payload names a device off the CPU
        (DeviceValue, the accelerator plane) or the wire cannot pickle it
        (JAX's path for what cloudpickle refuses)."""
        try:
            fid, _ = export_function(spec.func)
            args_parts = _pack((args, kwargs), host_only=True)
        except Exception:
            return None
        return fid, args_parts

    def eligible_task(self, spec: TaskSpec, args, kwargs):
        # pg_demand is the demand before a placement group renamed it to
        # bundle-scoped keys, which a plain name check would miss
        demand = spec.pg_demand or spec.resources
        if (not self.enabled or spec.kind != TaskKind.NORMAL
                or spec.in_process or _wants_accelerator(demand)):
            return None
        return self._serialize_payload(spec, args, kwargs)

    def eligible_actor(self, spec: TaskSpec, args, kwargs):
        demand = spec.pg_demand or spec.resources
        if (not self.enabled or spec.kind != TaskKind.ACTOR_CREATION
                or spec.in_process or _wants_accelerator(demand)):
            return None
        cls = spec.func
        if not inspect.isclass(cls):
            return None
        from ray_tpu_torch._private.worker import _class_is_async
        if _class_is_async(cls):
            return None     # asyncio actors run on the driver's loop
        return self._serialize_payload(spec, args, kwargs)

    # -- normal tasks ----------------------------------------------------
    def track_task(self, task_id: TaskID, client: WorkerClient,
                   rid: str) -> None:
        with self._lock:
            self._running[task_id] = (client, rid)

    def untrack_task(self, task_id: TaskID) -> None:
        with self._lock:
            self._running.pop(task_id, None)

    def execute_task(self, spec: TaskSpec, node, payload):
        fid, args_parts = payload
        if self._fast_eligible(spec):
            out = self._execute_fast(spec, node, fid, args_parts)
            if out is not None:
                return out
            # the lane declined (no build, or nothing submitted): the pipe
        client = acquire_worker()
        client.runtime = self.runtime
        client.node = node
        try:
            outcome = client.execute_task(spec, node, fid, args_parts)
        except WorkerCrashed:
            client.kill(expected=False)
            raise
        if outcome[0] == "gen":
            # the worker keeps producing after this returns: release it
            # only once the stream is drained
            return ("gen", self._release_after(client, outcome[1]))
        release_worker(client)
        return outcome

    # -- driver-local fast lane ------------------------------------------
    def _fast_eligible(self, spec: TaskSpec) -> bool:
        return (not self._fast_disabled
                and spec.num_returns == 1
                and not spec.runtime_env
                and not (spec.func is not None
                         and inspect.isgeneratorfunction(spec.func)))

    def _fast_client(self):
        if self._fast is not None and not self._fast.dead:
            return self._fast
        from ray_tpu_torch._private.fast_lane import (CoreHandle,
                                                      FastLaneClient,
                                                      lane_reconnect_policy)
        try:
            with self._fast_lock:
                if self._fast is not None and not self._fast.dead:
                    return self._fast
                if self._fast_core is None:
                    core = CoreHandle()
                    if core.start("127.0.0.1", 0) is None:
                        self._fast_disabled = True   # no native build
                        return None
                    self._fast_core = core
                    threading.Thread(target=self._fast_pool_loop,
                                     daemon=True,
                                     name="router-fastlane").start()
                port = self._fast_core.port
            # connect outside the lock: the retry window's backoff sleeps
            # must not stall cancel_task's bookkeeping
            def connect():
                if _fp.ENABLED:
                    _fp.fire("fast_lane.reconnect")
                return FastLaneClient(("127.0.0.1", port))

            fl = lane_reconnect_policy().run(
                connect, loop="fast_lane.reconnect",
                retry_on=(OSError, _fp.FailpointError))
            with self._fast_lock:
                if self._fast is None or self._fast.dead:
                    self._fast = fl
                else:
                    fl.close()      # lost the reconnect race
                return self._fast
        except Exception:
            self._fast_disabled = True
            return None

    def _fast_dedicate(self) -> WorkerClient:
        core = self._fast_core
        if core is None:
            raise RuntimeError("fast lane stopped")
        # from the template, the card hidden, never in the idle pool
        w = _spawn_worker()
        w.fast_lane = True
        w.runtime = self.runtime
        try:
            rid, pend = w._request({"op": "join_fast_lane",
                                    "addr": ["127.0.0.1", core.port]})
            out = w._wait_outcome(rid, pend)
            if out[0] != "ok":
                raise RuntimeError(f"fast-lane join failed: {out!r}")
        except BaseException:
            w.kill(expected=True)
            raise
        return w

    def _fast_pool_loop(self) -> None:
        """Queue-depth-driven sizing, like the daemon's lane pool. The
        whole maintenance step holds _fast_lock so shutdown()'s swap can
        never interleave with a dedicate (which would leak the just-spawned
        worker process)."""
        while not self.runtime._shutdown:
            try:
                with self._fast_lock:
                    if self._fast_core is None:
                        return        # shut down
                    alive = [w for w in self._fast_workers if w.alive()]
                    self._fast_workers = alive
                    stats = self._fast_core.stats()
                    if (not alive
                            or (stats.get("queued", 0) > 0
                                and len(alive) < self._fast_max)):
                        self._fast_workers.append(self._fast_dedicate())
                        continue
            except Exception:
                time.sleep(1.0)
            time.sleep(0.25)

    def fast_stats(self) -> Dict[str, int]:
        """The lane core's counters (queued, inflight, free_workers,
        submitted); empty while no core runs."""
        core = self._fast_core
        return core.stats() if core is not None else {}

    def _execute_fast(self, spec: TaskSpec, node, fid: str,
                      args_parts: Sequence[Any]):
        from ray_tpu_torch._private import fast_lane as _fle
        fl = self._fast_client()
        if fl is None:
            return None
        payload = _fle.build_payload(
            spec, fid, _fle.join_parts(args_parts),
            spec.job_id or self.runtime.job_id,
            node.node_id if node is not None else None)
        try:
            rid, slot = fl.submit(payload)
        except _fle.FastLaneError:
            return None                  # nothing submitted: the pipe
        _count_sent()
        task_hex = spec.task_id.hex()
        with self._fast_lock:
            # store the CLIENT with the rid: after a lane death + reconnect
            # the new client's rid counter restarts at 1, so a bare rid
            # could cancel an unrelated task on the new lane
            self._fast_rids[task_hex] = (fl, rid)
        try:
            kind, blob = fl.wait(slot)
        except _fle.FastLaneUnsubmitted:
            # the frame never reached the wire (another submitter's flush
            # failed first): nothing ran — the pipe, retry-free
            return None
        except _fle.FastLaneError as e:
            # submitted but the lane died: a worker crash, so retry
            # accounting applies (never a silent re-run)
            crash = WorkerCrashed(f"fast lane died mid-task: {e}")
            crash.fast_lane = True
            raise crash
        finally:
            with self._fast_lock:
                self._fast_rids.pop(task_hex, None)
        if kind == _fle.KIND_OK:
            return ("ok", _fle.loads_joined(blob))
        if kind == _fle.KIND_ERR:
            e, tb = serialization.loads(blob)
            setattr(e, "_remote_traceback", tb)
            return ("err", e)
        if kind == _fle.KIND_GEN_LIST:
            # the function body already ran and the worker drained its
            # returned generator: replay it as a real generator, so the
            # streaming machinery engages without re-running the body
            return ("gen", _fle.replay_gen_list(blob))
        if kind == _fle.KIND_CANCELLED:
            return ("err", KeyboardInterrupt())
        if kind == _fle.KIND_CRASHED:
            crash = WorkerCrashed(bytes(blob).decode(errors="replace"))
            crash.fast_lane = True
            raise crash
        raise RuntimeError(f"unknown fast-lane outcome kind {kind}")

    def release_borrows(self, key: str) -> None:
        """Drop lane workers' holds for a finished borrower ('t:<task>'):
        per-task borrow release for the driver-local lane."""
        if not self._fast_workers:
            return
        for w in list(self._fast_workers):
            w._holds.pop(key, None)

    @staticmethod
    def _release_after(client: WorkerClient, it):
        try:
            yield from it
        finally:
            release_worker(client)

    def cancel_task(self, task_id: TaskID, force: bool) -> bool:
        task_hex = task_id.hex()
        with self._fast_lock:
            entry = self._fast_rids.get(task_hex)
        if entry is not None:
            # cancel on the client GENERATION the task was submitted on —
            # a reconnected lane restarts its rid counter, and a stale rid
            # sent there would kill an unrelated task
            lane_client, rid = entry
            if not lane_client.dead:
                lane_client.cancel(rid, force=force)
            return True
        with self._lock:
            entry = self._running.get(task_id)
        if entry is None:
            return False
        client, rid = entry
        if force:
            client.expected_death = False
            client.proc.terminate()   # surfaces as WorkerCrashed
        else:
            client.cancel_request(rid)
        return True

    # -- actors ----------------------------------------------------------
    def create_actor(self, spec: TaskSpec, node, payload):
        """Returns a _ProcessActorInstance, or raises the user's __init__
        exception or WorkerCrashed."""
        fid, args_parts = payload
        client = acquire_worker()
        client.runtime = self.runtime
        client.node = node
        client.actor_id = spec.actor_id
        try:
            kind, value = client.create_actor_instance(spec, node, fid,
                                                       args_parts)
        except WorkerCrashed:
            client.kill(expected=False)
            raise
        if kind == "err":
            client.actor_id = None
            release_worker(client)  # __init__ failed cleanly: reusable
            raise value
        with self._lock:
            self._actor_workers[spec.actor_id] = client
        actor_id = spec.actor_id
        client.add_death_callback(
            lambda c, aid=actor_id: self._actor_worker_died(aid, c))
        return _ProcessActorInstance(client,
                                     getattr(spec.func, "__name__", "Actor"))

    def call_actor_method(self, instance: _ProcessActorInstance,
                          spec: TaskSpec, node, args, kwargs):
        from ray_tpu_torch import exceptions as exc

        client: WorkerClient = instance._client
        if client.dead:
            raise exc.ActorDiedError(spec.actor_id,
                                     "actor worker process died")
        try:
            args_parts = _pack((args, kwargs), host_only=True)
        except DeviceValue as e:
            refused = str(e)
        else:
            refused = None
        if refused is not None:
            # raised outside the handler: the DeviceValue's frames hold
            # the arguments, which must not live on in the error
            raise ValueError(
                f"an argument holds a {refused}: an actor in a worker "
                f"process sees only the CPU, so one that takes the card's "
                f"values is created with num_gpus or _in_process=True")
        try:
            return client.call_method(spec, node, args_parts)
        except WorkerCrashed as e:
            raise exc.ActorDiedError(spec.actor_id, str(e))

    def _actor_worker_died(self, actor_id: ActorID,
                           client: WorkerClient) -> None:
        with self._lock:
            if self._actor_workers.get(actor_id) is client:
                self._actor_workers.pop(actor_id, None)
        if client.expected_death:
            return
        rt = self.runtime
        if rt is None or rt._shutdown:
            return
        # an unexpected process death is actor death, with restarts
        try:
            rt.on_actor_worker_died(
                actor_id, f"actor worker process died (pid {client.pid})")
        except Exception:
            pass

    def discard_actor(self, actor_id: ActorID,
                      expected: bool = True) -> None:
        with self._lock:
            client = self._actor_workers.pop(actor_id, None)
        if client is None:
            return
        with client._pending_lock:
            busy = bool(client._pending)
        if (not expected or busy or not client.alive()
                or client.lane_tag is not None):
            # a killed actor's process dies with its running calls; a
            # lane-bound worker keeps its tagged lane and lock, so it never
            # goes back to the pool
            client.kill(expected=expected)
            return
        # clean death: reset the instance and recycle the worker
        try:
            kind, _ = client.reset_actor()
        except Exception:
            kind = "err"
        if kind not in ("ok", "ok_raw"):
            client.kill(expected=True)
            return
        client._on_death.clear()    # stale actor-death callbacks
        client._holds.pop("__actor__", None)
        client.actor_id = None
        release_worker(client)

    # -- lifecycle -------------------------------------------------------
    def shutdown(self) -> None:
        # the lane first: the core is process-global (one a process), so
        # the next runtime in this process needs it freed
        with self._fast_lock:
            fl, self._fast = self._fast, None
            core, self._fast_core = self._fast_core, None
            lane_workers, self._fast_workers = self._fast_workers, []
        if fl is not None:
            fl.close()
        for w in lane_workers:
            w.kill(expected=True)
        if core is not None:
            core.stop()
        with self._lock:
            actors = dict(self._actor_workers)
        for actor_id in actors:
            # recycle cleanly shut-down actor workers into the pool (the
            # pool outlives runtimes; respawns cost)
            self.discard_actor(actor_id, expected=True)
