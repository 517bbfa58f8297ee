"""Typed RPC layer: length-prefixed frames of plain data over TCP
(counterpart of ``ray_tpu/_private/rpc.py``).

The control-plane wire of the daemon cluster (``_private/head.py``,
``_private/daemon.py``, ``_private/cluster.py``) and the framing helpers
the fast lane (``_private/fast_lane.py``) shares.

- The card's data never rides this wire: tensors stay in the driver, the
  one process that owns the card; host arrays move between processes of
  one host through the shared-memory arenas. RPC carries control messages
  and pickled host-plane payloads (as ``bytes`` fields) only.
- Typed messages: every method has a declared field schema (``SCHEMAS``);
  ``call`` validates the required fields at the caller, and a call to an
  undeclared method fails there.
- Framing: ``u32 length | frame``. A frame is a plain dict of ``None``,
  bool, int, float, str, bytes, bytearray, list, tuple, set and dict,
  encoded as a stdlib pickle (protocol 5) and decoded by an unpickler
  that refuses every global: data only, as JAX's msgpack is, and at C
  speed. A frame that names a global (a class, a function, a numpy
  scalar) is refused by the sender and by the receiver with
  ``RpcError``. Payloads that hold user objects ride inside frames as
  ``bytes``; daemons never load them.

Two cores speak these frames, chosen per process by ``cfg().async_core``
in ``serve()`` and ``connect()``: the asyncio core (``aio.py``, the
default, as in JAX) and the threaded core below. Threaded server model:
one decode thread per connection feeding a shared handler pool, so
requests pipeline. Per-connection arrival order is kept for
ordinary handlers by a FIFO lane; handlers that may block are marked
``@concurrent`` and run outside the lane. Dispatch is by method name to a
service object (``handle_<method>``). A handler may return ``HOLD`` to
park the request (long-poll) and complete it later with
``Connection.reply``.
"""

from __future__ import annotations

import io
import pickle
import socket
import struct
import threading
from collections import deque
from typing import Any, Callable, Dict, Optional, Tuple

from ray_tpu_torch._private import failpoints as _fp
from ray_tpu_torch._private import netchaos as _nc

_LEN = struct.Struct("!I")
MAX_FRAME = 1 << 31


class RpcError(Exception):
    """Transport-level failure (peer died, protocol violation)."""


class RemoteError(Exception):
    """The remote handler raised; message carries the remote repr."""


class _Hold:
    """Sentinel: handler parked the request for a deferred reply."""


HOLD = _Hold()


def concurrent(handler):
    """Mark a handler as safe to run OUTSIDE its connection's FIFO lane.

    Use for handlers that may block (e.g. a 120 s object pull): they run
    on a thread of their own so they cannot head-of-line-block other
    requests from the same peer. Everything unmarked keeps strict
    per-connection arrival order (actor-call ordering relies on it)."""
    handler._rpc_concurrent = True
    return handler


def loop_safe(handler):
    """Mark a handler as non-blocking. The asyncio core runs such
    handlers inline on its event loop; the threaded core
    ignores the marker (lane semantics)."""
    handler._rpc_loop_safe = True
    return handler


# ---------------------------------------------------------------------------
# message schemas (the "proto file"): method -> required field names
# ---------------------------------------------------------------------------

SCHEMAS: Dict[str, Tuple[str, ...]] = {}


def declare(method: str, *fields: str) -> None:
    SCHEMAS[method] = fields


def _validate(method: str, kw: Dict[str, Any]) -> None:
    fields = SCHEMAS.get(method)
    if fields is None:
        raise RpcError(f"undeclared rpc method {method!r}")
    missing = [f for f in fields if f not in kw]
    if missing:
        raise RpcError(f"{method}: missing fields {missing}")


# ---------------------------------------------------------------------------
# the wire's encoding: plain data only
# ---------------------------------------------------------------------------

class _FramePickler(pickle.Pickler):
    """Pickles a frame of plain data. ``reducer_override`` is called for
    every object but None, bools and exact ints, floats, bytes, str,
    dicts, sets, frozensets, lists and tuples; of the rest only bytearray
    is plain data."""

    def reducer_override(self, obj):
        if type(obj) is bytearray:
            return NotImplemented
        raise RpcError(f"a frame carries plain data only, not "
                       f"{type(obj).__name__}")


class _FrameUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        raise RpcError(f"a frame may not name a global ({module}.{name})")


def dumps_frame(obj: Dict[str, Any]) -> bytes:
    buf = io.BytesIO()
    _FramePickler(buf, protocol=5).dump(obj)
    return buf.getvalue()


def loads_frame(blob) -> Any:
    try:
        return _FrameUnpickler(io.BytesIO(blob)).load()
    except RpcError:
        raise
    except Exception as e:   # truncated or corrupt stream
        raise RpcError(f"undecodable frame: {e}") from None


# ---------------------------------------------------------------------------
# wire instrumentation: hot-path updates are plain dict/int ops (a rare lost
# increment under a race is acceptable for byte/frame counters); the
# per-method request counters and the inflight gauge take the small lock.
# ---------------------------------------------------------------------------

_WIRE_LOCK = threading.Lock()
_WIRE = {"bytes_sent": 0, "bytes_recv": 0,
         "frames_sent": 0, "frames_recv": 0, "inflight": 0}
_WIRE_CLIENT_REQS: Dict[str, int] = {}
_WIRE_SERVER_REQS: Dict[str, int] = {}


def wire_metric_entries() -> list:
    """This process's wire counters as metric-snapshot entries (label keys
    as [[k, v], ...])."""
    with _WIRE_LOCK:
        client = dict(_WIRE_CLIENT_REQS)
        server = dict(_WIRE_SERVER_REQS)
        inflight = _WIRE["inflight"]
    out = [
        {"name": "ray_tpu_rpc_inflight", "kind": "gauge",
         "description": "RPC requests awaiting a reply in this process",
         "samples": [[[], inflight]]},
        {"name": "ray_tpu_wire_bytes_total", "kind": "counter",
         "description": "bytes moved on the control-plane wire",
         "samples": [[[["direction", "sent"]], _WIRE["bytes_sent"]],
                     [[["direction", "recv"]], _WIRE["bytes_recv"]]]},
        {"name": "ray_tpu_wire_frames_total", "kind": "counter",
         "description": "frames moved on the control-plane wire",
         "samples": [[[["direction", "sent"]], _WIRE["frames_sent"]],
                     [[["direction", "recv"]], _WIRE["frames_recv"]]]},
    ]
    if client:
        out.append({
            "name": "ray_tpu_rpc_client_requests_total", "kind": "counter",
            "description": "outbound RPC requests by method",
            "samples": [[[["method", m]], v]
                        for m, v in sorted(client.items())]})
    if server:
        out.append({
            "name": "ray_tpu_rpc_server_requests_total", "kind": "counter",
            "description": "inbound RPC requests by method",
            "samples": [[[["method", m]], v]
                        for m, v in sorted(server.items())]})
    out.extend(_nc.chaos_metric_entries())
    return out


# Above this size the `len + blob` concatenation copy costs more than a
# second syscall: send header and payload as two sendalls under the lock
# (zero extra copy); below it, one small concat + one syscall wins.
SEND_CONCAT_MAX = 64 * 1024


def send_frame_bytes(sock: socket.socket, blob, wlock) -> None:
    """Length-prefixed frame write, shared by rpc and the fast lane.
    ``blob`` is any bytes-like; large payloads are never copied into a
    `len + blob` concatenation. ``wlock`` is the connection's
    write-serialization lock: holding it across the sendall is the
    contract (frames must not interleave)."""
    n = len(blob)
    if n > MAX_FRAME:
        raise RpcError(f"frame too large: {n}")
    if _nc.ENABLED:
        # chaos sits BELOW the frame layer: a drop suppresses the WHOLE
        # frame (never a byte prefix, so framing stays intact); a dup
        # delivers the same complete frame twice back-to-back
        verdict = _nc.on_send(sock, n + 4)
        if verdict is _nc.DROP_FRAME:
            return
        if verdict is _nc.DUP_FRAME:
            _write_frame(sock, blob, n, wlock)
    _write_frame(sock, blob, n, wlock)


def _write_frame(sock: socket.socket, blob, n: int, wlock) -> None:
    _WIRE["bytes_sent"] += n + 4    # lossy-tolerant plain add (hot path)
    _WIRE["frames_sent"] += 1
    if n <= SEND_CONCAT_MAX:
        with wlock:
            sock.sendall(_LEN.pack(n) + blob)
        return
    with wlock:
        # two-phase write under the same lock hold: the header and its
        # payload must stay adjacent on the stream
        sock.sendall(_LEN.pack(n))
        sock.sendall(blob)


def _send_frame(sock: socket.socket, obj: Dict[str, Any],
                wlock: threading.Lock) -> None:
    send_frame_bytes(sock, dumps_frame(obj), wlock)


def recv_exact(sock: socket.socket, n: int) -> bytearray:
    """Read exactly ``n`` bytes via recv_into on one preallocated buffer —
    no per-chunk bytes allocation + copy. Raises ConnectionError on EOF (an
    OSError subclass, so transport-failure handling catches it
    unchanged)."""
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        r = sock.recv_into(view[got:])
        if not r:
            raise ConnectionError("connection closed")
        got += r
    return buf


def _recv_frame(sock: socket.socket) -> Dict[str, Any]:
    while True:
        (n,) = _LEN.unpack(recv_exact(sock, 4))
        if n > MAX_FRAME:
            raise RpcError(f"frame too large: {n}")
        _WIRE["bytes_recv"] += n + 4    # lossy-tolerant plain add
        _WIRE["frames_recv"] += 1
        blob = recv_exact(sock, n)
        if _nc.ENABLED and _nc.on_recv(sock, n + 4) is _nc.DROP_FRAME:
            continue        # inbound frame lost on the simulated link
        break
    msg = loads_frame(blob)
    if not isinstance(msg, dict):
        raise RpcError(f"a frame is a dict, not {type(msg).__name__}")
    return msg


# ---------------------------------------------------------------------------
# client
# ---------------------------------------------------------------------------

class Client:
    """One TCP connection to a Server; thread-safe request/reply."""

    def __init__(self, addr: Tuple[str, int], timeout: float = 30.0,
                 on_push: Optional[Callable[[str, Dict[str, Any]], None]]
                 = None):
        self.addr = tuple(addr)
        self._sock = socket.create_connection(self.addr, timeout=10.0)
        self._sock.settimeout(None)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._wlock = threading.Lock()
        self._id = 0                        #: guarded by self._id_lock
        self._id_lock = threading.Lock()
        self._pending: Dict[int, list] = {}  #: guarded by self._plock
        self._plock = threading.Lock()
        self._timeout = timeout
        self._on_push = on_push
        self.dead = False
        self._reader = threading.Thread(target=self._read_loop, daemon=True,
                                        name=f"rpc-client-{self.addr[1]}")
        self._reader.start()

    def link(self, peer_role: str, link_id: str = "") -> "Client":
        """Tag this connection's socket with the peer's chaos-link
        identity (cold path; chainable: ``Client(addr).link("head")``)."""
        _nc.register_link(self._sock, peer_role, link_id)
        return self

    def _read_loop(self) -> None:
        try:
            while True:
                msg = _recv_frame(self._sock)
                if _fp.ENABLED and _fp.fire(
                        "rpc.client.recv",
                        method=msg.get("m", "")) is _fp.DROP:
                    continue    # reply/push lost in transit
                rid = msg.get("i")
                if rid is None:
                    # server push (no correlation id)
                    if self._on_push is not None:
                        try:
                            self._on_push(msg.get("m", ""), msg)
                        except Exception:
                            pass
                    continue
                with self._plock:
                    slot = self._pending.pop(rid, None)
                if slot is not None:
                    slot[1] = msg
                    slot[0].set()
        except Exception:   # transport death AND injected faults: any
            # reader exit must fail pending slots, or timeout=None callers
            # hang for ever on a dead connection
            self._fail_all()

    def _fail_all(self) -> None:
        self.dead = True
        with self._plock:
            pending, self._pending = self._pending, {}
        for slot in pending.values():
            slot[1] = None
            slot[0].set()

    def call(self, method: str, timeout: Optional[float] = None,
             **kw) -> Dict[str, Any]:
        """Blocking request/reply. Raises RemoteError on handler error,
        RpcError on transport failure."""
        _validate(method, kw)
        if self.dead:
            raise RpcError(f"connection to {self.addr} is dead")
        with _WIRE_LOCK:
            _WIRE_CLIENT_REQS[method] = \
                _WIRE_CLIENT_REQS.get(method, 0) + 1
            _WIRE["inflight"] += 1
        try:
            return self._call_counted(method, timeout, kw)
        finally:
            with _WIRE_LOCK:
                _WIRE["inflight"] -= 1

    def _call_counted(self, method: str, timeout: Optional[float],
                      kw: Dict[str, Any]) -> Dict[str, Any]:
        # failpoint BEFORE the pending slot exists: an error arm must not
        # leak a slot; a DROP arm skips the send so the caller times out
        # exactly like real frame loss
        dropped = (_fp.ENABLED and _fp.fire(
            "rpc.client.send", method=method) is _fp.DROP)
        if dropped and (timeout if timeout is not None
                        else self._timeout) is None:
            # a deadline-less caller (long-poll subscribers) can never
            # observe a lost frame as a timeout: surface the drop as
            # transport failure instead of wedging the waiter for ever
            self._fail_all()
            raise RpcError(f"send to {self.addr} dropped by failpoint")
        msg = dict(kw)
        msg["m"] = method
        with self._id_lock:
            self._id += 1
            rid = self._id
        msg["i"] = rid
        blob = dumps_frame(msg)     # a frame that is not plain data
        slot = [threading.Event(), None]   # fails here, before any slot
        with self._plock:
            self._pending[rid] = slot
        try:
            if not dropped:
                send_frame_bytes(self._sock, blob, self._wlock)
        except (OSError, RpcError):
            self._fail_all()
            raise RpcError(f"send to {self.addr} failed")
        if not slot[0].wait(timeout if timeout is not None
                            else self._timeout):
            with self._plock:
                self._pending.pop(rid, None)
            raise RpcError(f"{method} to {self.addr} timed out")
        reply = slot[1]
        if reply is None:
            raise RpcError(f"connection to {self.addr} died during "
                           f"{method}")
        if reply.get("e"):
            raise RemoteError(reply["e"])
        return reply

    def notify(self, method: str, **kw) -> None:
        """Fire-and-forget (no reply expected)."""
        _validate(method, kw)
        if (_fp.ENABLED and _fp.fire("rpc.client.send",
                                     method=method) is _fp.DROP):
            return              # notification lost in transit
        msg = dict(kw)
        msg["m"] = method
        blob = dumps_frame(msg)
        try:
            send_frame_bytes(self._sock, blob, self._wlock)
        except (OSError, RpcError):
            self._fail_all()
            raise RpcError(f"send to {self.addr} failed")

    def close(self) -> None:
        self.dead = True
        try:
            # a bare close() does NOT wake a reader blocked in recv() (the
            # fd may even be reused); shutdown() delivers EOF so the reader
            # exits and deadline-less callers unblock
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass
        self._fail_all()    # idempotent: close() means dead for callers


# ---------------------------------------------------------------------------
# server
# ---------------------------------------------------------------------------

class Connection:
    """Server-side handle to one client connection."""

    def __init__(self, sock: socket.socket, peer):
        self.sock = sock
        self.peer = peer
        self.wlock = threading.Lock()
        self.meta: Dict[str, Any] = {}   # services stash identity here
        self.closed = False
        # FIFO lane: ordered handlers from this peer execute one at a
        # time in arrival order, but OFF the read thread, so decoding
        # (and @concurrent handlers) pipeline ahead of a slow handler.
        self._lane: deque = deque()
        self._lane_lock = threading.Lock()
        self._lane_busy = False

    def link(self, peer_role: str, link_id: str = "") -> "Connection":
        """Tag the accepted socket's chaos-link identity: services call
        this once the peer identifies itself (hello/register)."""
        _nc.register_link(self.sock, peer_role, link_id)
        return self

    def reply(self, rid: int, **kw) -> None:
        msg = dict(kw)
        msg["i"] = rid
        try:
            blob = dumps_frame(msg)
        except RpcError as e:
            # an unplain reply becomes the caller's RemoteError
            blob = dumps_frame({"i": rid, "e": f"RpcError: {e}"})
        try:
            send_frame_bytes(self.sock, blob, self.wlock)
        except (OSError, RpcError):
            self.closed = True

    def reply_error(self, rid: int, err: str) -> None:
        self.reply(rid, e=err)

    def push(self, method: str, **kw) -> None:
        """Server-initiated message (no correlation id)."""
        msg = dict(kw)
        msg["m"] = method
        try:
            _send_frame(self.sock, msg, self.wlock)
        except (OSError, RpcError):
            self.closed = True


class Server:
    """Threaded RPC server. ``service`` exposes ``handle_<method>``
    callables with signature (conn, rid, msg) -> reply dict | HOLD.
    Optional ``on_disconnect(conn)`` on the service is called when a
    client connection drops (daemon death detection hook)."""

    def __init__(self, service: Any, host: str = "127.0.0.1",
                 port: int = 0):
        self.service = service
        self._srv = socket.create_server((host, port))
        self.addr = self._srv.getsockname()
        self._stop = False
        self._conns: list = []
        from ray_tpu_torch._private.thread_pool import DaemonThreadPool
        self._pool = DaemonThreadPool(128, name=f"rpc-{self.addr[1]}")
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True,
            name=f"rpc-server-{self.addr[1]}")

    def _run_handler(self, conn: Connection, handler, rid, msg) -> None:
        try:
            out = handler(conn, rid, msg)
            if out is HOLD or rid is None:
                return
            conn.reply(rid, **(out or {}))
        except Exception as e:  # noqa: BLE001 - shipped back
            if rid is not None:
                conn.reply_error(rid, f"{type(e).__name__}: {e}")

    def _drain_lane(self, conn: Connection) -> None:
        while True:
            with conn._lane_lock:
                if not conn._lane:
                    conn._lane_busy = False
                    return
                handler, rid, msg = conn._lane.popleft()
            try:
                self._run_handler(conn, handler, rid, msg)
            except BaseException:   # never wedge the lane
                with conn._lane_lock:
                    conn._lane_busy = False
                raise

    def start(self) -> "Server":
        self._accept_thread.start()
        return self

    def _accept_loop(self) -> None:
        while not self._stop:
            try:
                sock, peer = self._srv.accept()
            except OSError:
                return
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            conn = Connection(sock, peer)
            self._conns.append(conn)
            threading.Thread(target=self._serve_conn, args=(conn,),
                             daemon=True,
                             name=f"rpc-conn-{peer[1]}").start()

    def _serve_conn(self, conn: Connection) -> None:
        try:
            while not self._stop:
                msg = _recv_frame(conn.sock)
                method = msg.get("m", "")
                if _fp.ENABLED and _fp.fire(
                        "rpc.server.recv", method=method) is _fp.DROP:
                    continue    # request lost before dispatch
                rid = msg.get("i")
                with _WIRE_LOCK:
                    _WIRE_SERVER_REQS[method] = \
                        _WIRE_SERVER_REQS.get(method, 0) + 1
                handler = getattr(self.service, f"handle_{method}", None)
                if handler is None:
                    if rid is not None:
                        conn.reply_error(rid, f"no such method {method!r}")
                    continue
                if getattr(handler, "_rpc_concurrent", False):
                    # a thread of its own, NOT the shared pool: concurrent
                    # handlers may block for minutes (object pulls), and
                    # enough of them would exhaust the pool and stall
                    # every connection's lane drain
                    threading.Thread(
                        target=self._run_handler,
                        args=(conn, handler, rid, msg), daemon=True,
                        name=f"rpc-conc-{method}").start()
                    continue
                with conn._lane_lock:
                    conn._lane.append((handler, rid, msg))
                    if conn._lane_busy:
                        continue
                    conn._lane_busy = True
                self._pool.submit(lambda: self._drain_lane(conn))
        except (RpcError, OSError):
            pass
        finally:
            conn.closed = True
            try:
                conn.sock.close()
            except OSError:
                pass
            cb = getattr(self.service, "on_disconnect", None)
            if cb is not None and not self._stop:
                try:
                    cb(conn)
                except Exception:
                    pass

    def stop(self) -> None:
        self._stop = True
        try:
            self._srv.close()
        except OSError:
            pass
        for conn in self._conns:
            try:
                conn.sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                conn.sock.close()
            except OSError:
                pass


# ---------------------------------------------------------------------------
# core selection: both cores speak identical frames, so a threaded peer and
# an asyncio peer interoperate on one socket; cfg().async_core is a choice
# of each process (advertised in the async_core hello bit), not a version
# of the wire
# ---------------------------------------------------------------------------

def serve(service: Any, host: str = "127.0.0.1", port: int = 0):
    """Build the configured server core (NOT started: call .start())."""
    from ray_tpu_torch._private.config import cfg
    if cfg().async_core:
        from ray_tpu_torch._private.aio import AsyncServer
        return AsyncServer(service, host=host, port=port)
    return Server(service, host=host, port=port)


def connect(addr: Tuple[str, int], timeout: float = 30.0,
            on_push: Optional[Callable[[str, Dict[str, Any]], None]]
            = None):
    """Dial with the configured client core."""
    from ray_tpu_torch._private.config import cfg
    if cfg().async_core:
        from ray_tpu_torch._private.aio import AsyncClient
        return AsyncClient(addr, timeout=timeout, on_push=on_push)
    return Client(addr, timeout=timeout, on_push=on_push)


def wait_for_server(addr: Tuple[str, int], timeout: float = 15.0) -> None:
    """Probe ``addr`` until it accepts a connection (``RetryPolicy``,
    backoff capped at 50 ms doubling to 0.5 s), or raise RpcError after
    ``timeout`` seconds."""
    from ray_tpu_torch._private.retry import RetryPolicy

    if timeout <= 0:
        # an exhausted budget means fail NOW (RetryPolicy reads
        # deadline_s=0 as "no deadline" and would probe for ever)
        raise RpcError(f"server at {addr} did not come up in {timeout}s")

    def probe() -> None:
        with socket.create_connection(tuple(addr), timeout=1.0):
            return

    try:
        RetryPolicy(base_s=0.05, max_backoff_s=0.5,
                    deadline_s=timeout).run(
            probe, loop="rpc.wait_for_server", retry_on=(OSError,))
    except OSError:
        raise RpcError(f"server at {addr} did not come up in {timeout}s")
