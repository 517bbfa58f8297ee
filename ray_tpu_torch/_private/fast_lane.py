"""Fast lane: driver -> C++ core -> worker task path (counterpart of
``ray_tpu/_private/fast_lane.py``).

The native core (``csrc/daemon_core.cc``, the port's copy of JAX's) is the
raylet-style C++ engine for the per-task hot loop — lease a free worker,
forward the payload, pump the outcome back. In the one-process topology
the driver hosts it on its own thread (``ProcessRouter``); the daemons will
host it the same way. This module is everything that speaks its wire
protocol from Python:

- :class:`CoreHandle` — start/stop the in-process C++ event loop via ctypes.
- :class:`FastLaneClient` — driver side: submit plain tasks straight to the
  core (one frame out, one frame in), and actor-method calls to a tagged
  worker (:meth:`FastLaneClient.submit_targeted`).
- :func:`worker_fast_lane_start` — worker side: a lane thread reading EXEC
  frames plus ONE persistent exec thread (no per-task thread spawn),
  replying RESULT frames. With a ``tag`` the worker is an actor's: the
  core routes it only the submits addressed to that tag, strictly FIFO
  (the targeted actor lane, ops 0x09-0x0b).

Encoding. A task payload is JAX's map (ids as raw bytes) as a stdlib pickle
of a plain dict; JAX's is msgpack, which the card's machine lacks. Arguments,
results and drained generator items are what the pipe carries
(``worker_process._pack``: the by-value pickler, tensors by the wire of
``device_objects.py``, protocol 5's out-of-band buffers as parts of their
own), joined into ONE blob, because a lane frame is one body
(``u32 len | u8 op | u64 id | payload``): ``u32 n | n x u64 size | the n
parts`` (:func:`join_parts`). The receiver reads each out-of-band buffer as
a view into that blob, uncopied (:func:`loads_joined`).

Plain NORMAL tasks ride the pool lane, and a daemon's serialized actors
(``max_concurrency == 1``, no concurrency groups) the targeted lane;
generator functions, multi-return tasks and streaming calls keep the pipe.

Chaos: ``fast_lane.submit`` and ``fast_lane.ping`` are failpoint seams (a
drop surfaces as lane death, never a half-written frame), netchaos sits
below the lane's framing on both sides (a whole frame is dropped or
duplicated), and reconnects ride :func:`lane_reconnect_policy`.
"""

from __future__ import annotations

import ctypes
import itertools
import os
import pickle
import socket
import struct
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ray_tpu_torch._private import failpoints as _fp
from ray_tpu_torch._private import netchaos as _nc

from ray_tpu_torch._private.rpc import SEND_CONCAT_MAX as _SEND_CONCAT_MAX

# ops (mirror daemon_core.cc)
OP_HELLO_WORKER = 0x01
OP_SUBMIT = 0x02
OP_RESULT = 0x03
OP_CANCEL = 0x04
OP_PING = 0x05
OP_EXEC = 0x06
OP_REPLY = 0x07
OP_CANCEL_EXEC = 0x08
# targeted lane (actors): a tagged worker serves exactly the submits
# addressed to its tag, strictly FIFO; the core acks the tagged hello once
# the tag is routable
OP_HELLO_TAGGED = 0x09
OP_SUBMIT_TARGETED = 0x0a
OP_HELLO_ACK = 0x0b

KIND_OK = 0x00
KIND_ERR = 0x01
KIND_CRASHED = 0x63
KIND_CANCELLED = 0x64
KIND_PONG = 0x65
# the callable returned a generator: the body already ran (plain-function
# side effects done), so no re-run — the worker drains it and ships the
# item LIST; the driver replays it as a stream
KIND_GEN_LIST = 0x67

_U32 = struct.Struct("<I")
_U64 = struct.Struct("<Q")
_NPARTS = struct.Struct("!I")
_PART = struct.Struct("!Q")


def join_parts(parts: Sequence[Any]) -> bytearray:
    """One blob of a payload's parts (in-band pickle, then each out-of-band
    buffer): ``u32 n | n x u64 size | the parts``. A bytearray, so the
    buffers a receiver rebuilds over it stay writable, as the pipe's do."""
    views = [memoryview(p).cast("B") for p in parts]
    head = _NPARTS.pack(len(views)) + b"".join(
        _PART.pack(v.nbytes) for v in views)
    return bytearray().join([head, *views])


def split_joined(blob) -> List[memoryview]:
    """Inverse of :func:`join_parts`: the parts, as views into ``blob``
    (a daemon relays a payload to its worker without loading it)."""
    view = memoryview(blob).cast("B")
    (n,) = _NPARTS.unpack_from(view, 0)
    pos = _NPARTS.size + n * _PART.size
    parts: List[memoryview] = []
    for i in range(n):
        (size,) = _PART.unpack_from(view, _NPARTS.size + i * _PART.size)
        parts.append(view[pos:pos + size])
        pos += size
    return parts


def loads_joined(blob) -> Any:
    """Inverse of :func:`join_parts` + ``worker_process._pack``: every
    out-of-band buffer is a view into ``blob``."""
    parts = split_joined(blob)
    return pickle.loads(parts[0], buffers=parts[1:])


def _frame_stream(sock: socket.socket):
    """Yield complete frames from a buffered reader: ONE recv may deliver
    many small frames (a drain storm's replies, a burst of EXEC frames),
    where per-frame recv_exact paid two syscalls per frame. Raises
    ConnectionError on EOF like recv_exact."""
    buf = bytearray()
    while True:
        off = 0
        n = len(buf)
        while n - off >= 4:
            (blen,) = _U32.unpack_from(buf, off)
            end = off + 4 + blen
            if end > n:
                break
            if (_nc.ENABLED
                    and _nc.on_recv(sock, blen + 4) is _nc.DROP_FRAME):
                off = end       # frame lost on the simulated link
                continue
            yield buf[off + 4:end]
            off = end
        if off:
            del buf[:off]
        chunk = sock.recv(1 << 18)
        if not chunk:
            raise ConnectionError("lane socket closed")
        buf += chunk


def _send_lane_frame(sock: socket.socket, wlock: threading.Lock, op: int,
                     head: bytes, payload=b"") -> None:
    """Lane frame write shared by client and worker sides: header and small
    payloads concatenate (one syscall); large payloads go as a second
    sendall under the same lock — no multi-MB concat copy."""
    prefix = _U32.pack(1 + len(head) + len(payload)) + bytes([op]) + head
    copies = 1
    if _nc.ENABLED:
        verdict = _nc.on_send(sock, len(prefix) + len(payload))
        if verdict is _nc.DROP_FRAME:
            return      # whole frame suppressed; lane framing intact
        if verdict is _nc.DUP_FRAME:
            copies = 2
    with wlock:
        for _ in range(copies):
            if len(payload) <= _SEND_CONCAT_MAX:
                sock.sendall(prefix + payload)
            else:
                sock.sendall(prefix)
                sock.sendall(payload)


# ---------------------------------------------------------------------------
# the core's host: own the C++ event loop
# ---------------------------------------------------------------------------

class CoreHandle:
    """Loads the native core and runs it inside this process (one core a
    process: the C side keeps it in a global)."""

    def __init__(self) -> None:
        from ray_tpu_torch._build import load_host_library

        self._lib = load_host_library("daemon_core")
        self.port: Optional[int] = None
        if self._lib is not None:
            self._lib.rtdc_start.restype = ctypes.c_int
            self._lib.rtdc_start.argtypes = [ctypes.c_char_p, ctypes.c_int]
            self._lib.rtdc_stats.argtypes = [ctypes.POINTER(ctypes.c_uint64)]
            self._lib.rtdc_stats.restype = None
            self._lib.rtdc_stop.argtypes = []
            self._lib.rtdc_stop.restype = None

    def start(self, host: str = "0.0.0.0", port: int = 0) -> Optional[int]:
        if self._lib is None:
            return None
        got = self._lib.rtdc_start(host.encode(), port)
        self.port = got if got > 0 else None
        return self.port

    def stats(self) -> Dict[str, int]:
        if self._lib is None or self.port is None:
            return {}
        out = (ctypes.c_uint64 * 4)()
        self._lib.rtdc_stats(out)
        return {"queued": out[0], "inflight": out[1],
                "free_workers": out[2], "submitted": out[3]}

    def stop(self) -> None:
        if self._lib is not None and self.port is not None:
            self._lib.rtdc_stop()
            self.port = None


# ---------------------------------------------------------------------------
# driver side
# ---------------------------------------------------------------------------

class FastLaneError(Exception):
    """Transport failure on the fast lane (the core died)."""


class FastLaneUnsubmitted(FastLaneError):
    """The frame provably never reached the wire (it was still staged when
    another thread's flush failed): nothing ran, so callers fall back to the
    classic path without consuming a retry."""


# wait() sentinel for a slot whose frame was never written (distinct from
# None = lane died after the frame may have been delivered)
_UNSUBMITTED = object()


def replay_gen_list(blob):
    """Decode a KIND_GEN_LIST payload into a live generator replaying the
    worker-drained items. The body already ran worker-side; the driver's
    streaming machinery consumes the replay exactly like a classic stream
    without re-running anything."""
    items = loads_joined(blob)

    def replay():
        yield from items

    return replay()


def lane_reconnect_policy():
    """The shared reconnect schedule of lane clients: a brief backoff
    window (the core may be mid-restart); persistent failure is the
    caller's cue to disable the lane."""
    from ray_tpu_torch._private.retry import RetryPolicy
    return RetryPolicy(max_attempts=3, base_s=0.02, max_backoff_s=0.2)


class FastLaneClient:
    """One connection to a C++ core; thread-safe submit."""

    def __init__(self, addr: Tuple[str, int], link_id: str = "lane"):
        self._sock = socket.create_connection(addr, timeout=10.0)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._sock.settimeout(None)
        # default identity is the bare "lane"; the driver passes a
        # node-scoped id ("lane:<node_hex>") so a chaos spec can partition
        # ONE node's lane without touching its siblings
        _nc.register_link(self._sock, "daemon", link_id=link_id)
        from ray_tpu_torch._private.lock_sanitizer import tracked_lock
        self._wlock = tracked_lock("fast_lane.wire", reentrant=False)
        self._rids = itertools.count(1)
        # rid -> [Event, kind, payload]
        self._pending: Dict[int, list] = {}  #: guarded by self._plock
        self._plock = tracked_lock("fast_lane.pending", reentrant=False)
        # Flat-combining send stage: under concurrent submission the lock
        # holder drains everyone's frames with ONE sendall (a drain storm
        # paid a syscall + wire wakeup per task); an uncontended send stays
        # synchronous — same latency and error surface.
        self._send_stage: list = []     #: guarded by self._stage_lock
        self._send_flushing = False     #: guarded by self._stage_lock
        self._stage_lock = tracked_lock("fast_lane.send_stage",
                                        reentrant=False)
        self.dead = False
        self._reader = threading.Thread(target=self._read_loop,
                                        daemon=True, name="fastlane-read")
        self._reader.start()

    # -- wire -------------------------------------------------------------
    def _send(self, op: int, head: bytes, payload=b"",
              rid: Optional[int] = None) -> None:
        prefix = (_U32.pack(1 + len(head) + len(payload))
                  + bytes([op]) + head)
        if len(payload) > _SEND_CONCAT_MAX:
            # large frame: rides the stage as a TWO-PART entry so the
            # flusher writes it in FIFO position without a multi-MB concat
            # copy (a direct write could overtake this thread's own earlier
            # staged frame)
            frame = (prefix, payload)
        else:
            frame = prefix + payload
        with self._stage_lock:
            self._send_stage.append((frame, rid))
            if self._send_flushing:
                # a flusher is active: it picks this frame up in its next
                # pass. A flush failure there resolves this slot by
                # delivery state: still-staged frames come back
                # FastLaneUnsubmitted (classic fallback, no retry),
                # written-or-partial ones as lane death (retry accounting)
                return
            self._send_flushing = True
        self._drain_send_stage(frame)

    def _drain_send_stage(self, own_frame=None) -> None:
        # A send failure raises to the caller ONLY while own_frame was
        # provably never delivered: it was the sole frame of the failed
        # write (sendall raising then guarantees the core can't hold a
        # complete frame). Any other failure splits by delivery state:
        # frames still staged (never written) resolve their slots
        # FastLaneUnsubmitted — their submitters take the classic path
        # retry-free — while frames in the failed or an earlier write may
        # have reached the core, so their slots fail as lane death (wait()
        # raises "died mid-call" -> retry accounting). Raising for a
        # possibly-delivered frame would make the classic fallback re-run a
        # task the core may already be executing.
        while True:
            with self._stage_lock:
                batch = self._send_stage
                if not batch:
                    self._send_flushing = False
                    return
                self._send_stage = []
            try:
                with self._wlock:
                    self._write_batch(batch)
            except BaseException:
                with self._stage_lock:
                    unwritten = self._send_stage
                    self._send_stage = []
                    self._send_flushing = False
                self._resolve_unsubmitted(unwritten)
                self._fail_pending()
                if len(batch) == 1 and batch[0][0] is own_frame:
                    raise
                return
            if own_frame is not None and any(
                    f is own_frame for f, _ in batch):
                own_frame = None

    def _write_batch(self, batch) -> None:
        """Write staged entries in FIFO order (caller holds _wlock):
        consecutive small frames join into one sendall; a large two-part
        entry flushes the run, then writes prefix + payload without ever
        concatenating the big payload."""
        run: list = []
        for f, _ in batch:
            if _nc.ENABLED:
                nb = (len(f[0]) + len(f[1])) if isinstance(f, tuple) \
                    else len(f)
                verdict = _nc.on_send(self._sock, nb)
                if verdict is _nc.DROP_FRAME:
                    continue    # staged frame lost on the simulated link
                if verdict is _nc.DUP_FRAME:
                    if isinstance(f, tuple):
                        run.extend(f)
                    else:
                        run.append(f)
            if isinstance(f, tuple):
                if run:
                    self._sock.sendall(
                        run[0] if len(run) == 1 else b"".join(run))
                    run = []
                self._sock.sendall(f[0])
                self._sock.sendall(f[1])
            else:
                run.append(f)
        if run:
            self._sock.sendall(run[0] if len(run) == 1 else b"".join(run))

    def _resolve_unsubmitted(self, entries) -> None:
        """Slots of never-written frames: resolve as UNSUBMITTED before
        _fail_pending sweeps the rest as died-mid-call."""
        for _, rid in entries:
            if rid is None:
                continue
            with self._plock:
                slot = self._pending.pop(rid, None)
            if slot is not None:
                slot[1] = _UNSUBMITTED
                slot[0].set()

    def _fail_pending(self) -> None:
        self.dead = True
        with self._plock:
            pending, self._pending = self._pending, {}
        for slot in pending.values():
            slot[1] = None
            slot[0].set()

    def _read_loop(self) -> None:
        try:
            for body in _frame_stream(self._sock):
                if not body or body[0] != OP_REPLY or len(body) < 10:
                    continue
                (rid,) = _U64.unpack_from(body, 1)
                kind = body[9]
                blob = memoryview(body)[10:]
                with self._plock:
                    slot = self._pending.pop(rid, None)
                if slot is not None:
                    slot[1] = kind
                    slot[2] = blob
                    slot[0].set()
        except (ConnectionError, OSError):
            pass
        self._fail_pending()

    # -- API --------------------------------------------------------------
    def submit(self, payload) -> Tuple[int, list]:
        """Send a task payload; returns (rid, slot) to wait on."""
        return self._submit_op(OP_SUBMIT, b"", payload)

    def submit_targeted(self, tag: int, payload) -> Tuple[int, list]:
        """Send to the tagged worker (per-actor FIFO ordering)."""
        return self._submit_op(OP_SUBMIT_TARGETED, _U64.pack(tag), payload)

    def _submit_op(self, op: int, extra: bytes,
                   payload) -> Tuple[int, list]:
        if self.dead:
            raise FastLaneError("fast lane is down")
        rid = next(self._rids)
        slot = [threading.Event(), None, None]
        with self._plock:
            self._pending[rid] = slot
        try:
            # DROP surfaces as a send failure: the lane is a stream
            # socket, so a lost frame desyncs framing; peers treat it as
            # connection loss, and the caller's classic fallback stays
            # safe (nothing was submitted)
            if _fp.ENABLED and _fp.fire("fast_lane.submit",
                                        op=op) is _fp.DROP:
                raise OSError("frame dropped by failpoint")
            self._send(op, _U64.pack(rid) + extra, payload, rid=rid)
        except Exception as e:  # noqa: BLE001 — any send-path failure
            # (socket death OR an injected error of any class) must pop
            # the slot and mark the lane dead; a narrower catch leaked one
            # pending slot per escape
            self.dead = True
            with self._plock:
                self._pending.pop(rid, None)
            raise FastLaneError(str(e))
        return rid, slot

    def wait(self, slot: list,
             timeout: Optional[float] = None) -> Tuple[int, Any]:
        # the loop-affinity contract of AsyncClient.call: blocking the
        # process event loop here would stall every peer it serves
        from ray_tpu_torch._private import eventloop
        if eventloop.on_loop():
            raise RuntimeError(
                "FastLaneClient.wait would block the event loop; fast-lane "
                "round trips belong on worker or caller threads")
        if not slot[0].wait(timeout):
            raise TimeoutError("fast lane reply timed out")
        if slot[1] is _UNSUBMITTED:
            raise FastLaneUnsubmitted(
                "frame never reached the wire (flush failed first)")
        if slot[1] is None:
            raise FastLaneError("fast lane died mid-call")
        return slot[1], slot[2]

    def cancel(self, rid: int, force: bool = False) -> None:
        try:
            self._send(OP_CANCEL, _U64.pack(rid) + bytes([1 if force else 0]))
        except OSError:
            pass

    def ping(self, timeout: float = 5.0) -> Dict[str, int]:
        # through _submit_op: a send failure pops the pending slot and
        # marks the lane dead, never a leaked slot or a raw OSError
        if _fp.ENABLED:
            try:
                if _fp.fire("fast_lane.ping") is _fp.DROP:
                    raise OSError("ping dropped by failpoint")
            except Exception as e:  # noqa: BLE001 — any injected class
                # marks the lane dead and surfaces as the typed error
                self.dead = True
                raise FastLaneError(str(e))
        rid, slot = self._submit_op(OP_PING, b"", b"")
        kind, blob = self.wait(slot, timeout)
        if kind != KIND_PONG or len(blob) < 32:
            raise FastLaneError("bad pong")
        q, inf, w, done = struct.unpack("<QQQQ", blob[:32])
        return {"queued": q, "inflight": inf, "workers": w,
                "completed": done}

    def close(self) -> None:
        self.dead = True
        try:
            self._sock.close()
        except OSError:
            pass


def build_payload(spec, fid: str, args_blob, job_id, node_id,
                  own: Optional[str] = None) -> bytes:
    """Driver-side: the task payload the worker lane decodes. Everything the
    worker's execution context needs travels here (classic path:
    ``WorkerClient._ctx_fields``), and ``own``, the driver's token at the
    daemon, which its nested core ops and output lines go back to."""
    return pickle.dumps({
        "fid": fid,
        "own": own,
        "args": args_blob,
        "job": job_id.binary() if job_id is not None else b"",
        "task": spec.task_id.binary(),
        "node": node_id.binary() if node_id is not None else b"",
        "name": spec.name or "",
        "res": {k: float(v) for k, v in (spec.resources or {}).items()},
        "pg": (spec.placement_group_id.binary()
               if spec.placement_group_id is not None else b""),
        "pgc": bool(spec.pg_capture),
    }, protocol=5)


def build_actor_payload(spec, args_blob, job_id, node_id,
                        own: Optional[str] = None) -> bytes:
    """Driver-side: the payload of a targeted actor-method call."""
    return pickle.dumps({
        "method": spec.method_name,
        "own": own,
        "args": args_blob,
        "job": job_id.binary() if job_id is not None else b"",
        "task": spec.task_id.binary(),
        "node": node_id.binary() if node_id is not None else b"",
        "aid": spec.actor_id.binary() if spec.actor_id is not None else b"",
        "name": spec.name or "",
        "res": {k: float(v) for k, v in (spec.resources or {}).items()},
        "pg": (spec.placement_group_id.binary()
               if spec.placement_group_id is not None else b""),
        "pgc": bool(spec.pg_capture),
    }, protocol=5)


# ---------------------------------------------------------------------------
# worker side
# ---------------------------------------------------------------------------

# worker-side drain bound for generator-returning callables: the lane ships
# the drained items as ONE reply frame, so an unbounded (or infinite)
# generator must error out instead of wedging the lane worker — true
# streaming belongs to the classic path (num_returns="streaming" or a
# generator function)
GEN_DRAIN_MAX_ITEMS = 100_000


def _drain_capped(gen) -> list:
    items: list = []
    for item in gen:
        items.append(item)
        if len(items) > GEN_DRAIN_MAX_ITEMS:
            gen.close()
            raise RuntimeError(
                f"fast-lane task returned a generator exceeding "
                f"{GEN_DRAIN_MAX_ITEMS} items; use "
                f"num_returns='streaming' (or a generator function) "
                f"for unbounded streams")
    return items


def worker_fast_lane_start(addr: Tuple[str, int], state,
                           tag: Optional[int] = None) -> None:
    """Connect this worker process to the core and serve EXEC frames.

    One lane thread reads frames; one persistent exec thread runs tasks (no
    per-task thread creation). CANCEL_EXEC async-raises KeyboardInterrupt
    into the exec thread, the classic path's soft-cancel contract; a forced
    one exits the process, which the core reports as CRASHED.

    With ``tag`` the worker registers targeted (an actor's lane): the core
    routes it only the submits addressed to the tag, strictly FIFO, and the
    exec thread runs them as method calls on ``state.actor_instance`` under
    ``state.actor_lock``, so classic calls on the pipe stay serialized with
    lane calls."""
    sock = socket.create_connection(addr, timeout=10.0)
    sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    sock.settimeout(None)
    _nc.register_link(sock, "daemon", link_id="lane")
    wlock = threading.Lock()
    frames = _frame_stream(sock)

    def send(op: int, head: bytes, payload=b"") -> None:
        _send_lane_frame(sock, wlock, op, head, payload)

    if tag is not None:
        send(OP_HELLO_TAGGED, _U64.pack(tag))
        # only once the core acks is the tag routable: the daemon's
        # create-actor reply (and so the driver's first targeted submit)
        # cannot outrun the registration
        body = next(frames)
        if not body or body[0] != OP_HELLO_ACK:
            raise RuntimeError("targeted lane hello not acknowledged")
    else:
        send(OP_HELLO_WORKER, b"")

    import queue as _q
    tasks: "_q.Queue[Optional[Tuple[int, dict]]]" = _q.Queue()
    current = {"tid": 0}
    exec_thread_holder = {}

    # hot-path imports resolved ONCE per worker, not per task
    import inspect

    from ray_tpu_torch._private import runtime_context
    from ray_tpu_torch._private.ids import (ActorID, JobID, NodeID,
                                            PlacementGroupID, TaskID)
    from ray_tpu_torch._private.worker_process import (
        _current_rid, _dump_exc, _pack, _post_mortem_on_error, _set_owner)

    def run_one(tid: int, msg: dict) -> None:
        current["tid"] = tid
        _current_rid.rid = f"fl{tid}"
        # the submitting driver's token (the daemon never sees lane tasks)
        _set_owner(msg.get("own"))
        try:
            ctx = {
                "job_id": JobID(msg["job"]) if msg["job"] else None,
                "task_id": TaskID(msg["task"]),
                "node_id": NodeID(msg["node"]) if msg["node"] else None,
                "actor_id": ActorID(msg["aid"]) if msg.get("aid") else None,
                "resources": msg["res"],
                "task_name": msg["name"],
                "placement_group_id": (PlacementGroupID(msg["pg"])
                                       if msg["pg"] else None),
                "pg_capture": msg["pgc"],
            }
            gen_items = None
            token = runtime_context._set_context(**ctx)
            try:
                # the remote debugger holds a crashed frame open when
                # RAY_TPU_POST_MORTEM=1, as on the pipe path
                with _post_mortem_on_error():
                    args, kwargs = loads_joined(msg["args"])
                    if "method" in msg:
                        # an actor call: on the live instance, serialized with
                        # the pipe's calls by the actor lock (the order is the
                        # core's per-tag FIFO). A generator drains here, inside
                        # the context and the lock, so no other method
                        # interleaves with its body.
                        with state.actor_lock:
                            method = getattr(state.actor_instance,
                                             msg["method"])
                            result = method(*args, **kwargs)
                            if inspect.isgenerator(result):
                                gen_items = _drain_capped(result)
                    else:
                        fn = state._fn({"fn_id": msg["fid"]})
                        result = fn(*args, **kwargs)
                    if gen_items is None and inspect.isgenerator(result):
                        # a PLAIN function returned a live generator: its body
                        # already ran (side effects included), so the lane must
                        # not hand the task back for a re-run. Drain here —
                        # inside the runtime context — and ship the item list;
                        # the driver replays it as a stream. Generator
                        # FUNCTIONS never ride the lane (driver eligibility).
                        gen_items = _drain_capped(result)
            finally:
                runtime_context._reset_context(token)
            kind, value = ((KIND_GEN_LIST, gen_items)
                           if gen_items is not None else (KIND_OK, result))
            blob = join_parts(_pack(value))
            # user metrics reach the host before the result does
            state._flush_metrics()
            # clear BEFORE the send: once the driver sees the result a late
            # CANCEL_EXEC must become a no-op, not an async interrupt
            # landing on the next task
            current["tid"] = 0
            try:
                send(OP_RESULT, _U64.pack(tid) + bytes([kind]), blob)
            except BaseException:  # noqa: BLE001 — see below
                # ANY failure mid-send (socket error, late async cancel)
                # may leave a partial frame on the wire; the stream is
                # unrecoverable — exit so the core crashes the task
                raise SystemExit from None
        except SystemExit:
            raise
        except BaseException as e:  # noqa: BLE001 — shipped back
            try:
                state._flush_metrics()
                current["tid"] = 0
                send(OP_RESULT, _U64.pack(tid) + bytes([KIND_ERR]),
                     _dump_exc(e))
            except BaseException:  # noqa: BLE001 — same partial-frame risk
                raise SystemExit from None
        finally:
            current["tid"] = 0
            _current_rid.rid = None
            _current_rid.own = None

    def exec_loop() -> None:
        while True:
            try:
                item = tasks.get()
                if item is None:
                    return
                run_one(*item)
            except SystemExit:
                os._exit(1)     # the core crashes the task; the router
                #                 replaces the worker
            except KeyboardInterrupt:
                # a cancel's async-raise landed outside the task body (late
                # delivery): swallow it — the lane worker must survive, not
                # die holding the core's free slot
                continue

    def lane_loop() -> None:
        try:
            for body in frames:
                if not body:
                    continue
                op = body[0]
                if op == OP_EXEC and len(body) >= 9:
                    (tid,) = _U64.unpack_from(body, 1)
                    msg = pickle.loads(memoryview(body)[9:])
                    tasks.put((tid, msg))
                elif op == OP_CANCEL_EXEC and len(body) >= 9:
                    (tid,) = _U64.unpack_from(body, 1)
                    force = len(body) >= 10 and body[9] == 1
                    if current["tid"] == tid:
                        if force:
                            # the classic force-cancel contract: kill the
                            # worker; the core reports CRASHED and the
                            # driver maps a cancelled crash to
                            # TaskCancelledError
                            os._exit(1)
                        t = exec_thread_holder.get("t")
                        if t is not None and t.is_alive():
                            ctypes.pythonapi.PyThreadState_SetAsyncExc(
                                ctypes.c_ulong(t.ident),
                                ctypes.py_object(KeyboardInterrupt))
        except (ConnectionError, OSError):
            pass
        # the core is gone: this worker can serve nothing more
        os._exit(0)

    et = threading.Thread(target=exec_loop, daemon=True,
                          name="fastlane-exec")
    exec_thread_holder["t"] = et
    et.start()
    lt = threading.Thread(target=lane_loop, daemon=True,
                          name="fastlane-read")
    lt.start()
