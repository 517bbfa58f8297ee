"""Asyncio control-plane wire: protocols on the per-process event loop
(counterpart of ``ray_tpu/_private/aio.py``).

The async twin of ``rpc.py``, chosen by ``cfg().async_core`` through
``rpc.serve()`` and ``rpc.connect()``. One event loop per process
(``eventloop.get_loop``) owns every peer socket: frame parse, handler and
reply run pipelined on the loop, and writes are deferred and coalesced per
peer per loop iteration. The threaded core's reader thread per connection
and its cross-thread wakeup per frame go; handlers that may block still
leave the loop (``@concurrent`` on a thread of their own, the FIFO lane on
the shared pool) exactly as there.

Wire parity is the contract:

- Frames are byte-identical (``u32 len | frame``, the frame encoded by
  ``rpc.dumps_frame``): async and threaded peers interoperate on one
  socket; the ``async_core`` hello bit only advertises the local core.
- The same ``_WIRE`` counters, schemas (``_validate``) and limits
  (``MAX_FRAME``) serve both cores: they are imported from ``rpc``.
- A frame that is not plain data is refused by the sender and by the
  receiver, as in the threaded core.

Chaos: the threaded core's failpoint seams (``rpc.client.send``,
``rpc.client.recv``, ``rpc.server.recv``) fire here under the same names,
so one schedule hits whichever core a process runs; netchaos sits below
the frame layer in the write batcher and the frame protocol, and its
delays ride ``call_later`` (the loop never sleeps) in per-link FIFO.

Thread affinity: everything the loop calls is loop-only. Handlers run on
pool or dedicated threads unless marked ``@rpc.loop_safe``; their replies
re-enter the loop through ``call_soon_threadsafe`` and join the peer's
next write batch.
"""

from __future__ import annotations

import asyncio
import socket
import threading
from collections import deque
from typing import Any, Callable, Dict, Optional, Tuple

from ray_tpu_torch._private import eventloop
from ray_tpu_torch._private import failpoints as _fp
from ray_tpu_torch._private import netchaos as _nc
from ray_tpu_torch._private.rpc import (  # one set of counters, schemas
    # and limits for both cores: exposition and validation cannot drift
    _LEN, _WIRE, _WIRE_LOCK, _WIRE_CLIENT_REQS, _WIRE_SERVER_REQS, HOLD,
    MAX_FRAME, SEND_CONCAT_MAX, RemoteError, RpcError, _validate,
    dumps_frame, loads_frame)


def _raw_sock(transport) -> Any:
    """The real ``socket.socket`` behind a transport. asyncio hands out a
    ``TransportSocket`` facade with ``__slots__`` (not weakref-able), but
    netchaos keys link identity in a WeakKeyDictionary: unwrap to the
    underlying socket object, stable for the connection's lifetime."""
    ts = transport.get_extra_info("socket")
    return getattr(ts, "_sock", ts)


class _WriteBatcher:
    """Per-peer deferred, coalesced outbound frames.

    ``send`` never writes: it stages the frame and arms one ``call_soon``
    flush, so every frame staged by the current burst of loop callbacks
    leaves in a single ``transport.write``. Payloads above
    ``SEND_CONCAT_MAX`` skip the join copy and ride writes of their own;
    order holds because only the loop thread writes."""

    def __init__(self, loop: asyncio.AbstractEventLoop, transport,
                 sock) -> None:
        self._loop = loop
        self._transport = transport
        self._sock = sock               # chaos-link identity
        self._stage: deque = deque()
        self._armed = False
        self._delayed: deque = deque()  # (blob, due): chaos-delayed FIFO
        self._timer: Optional[asyncio.TimerHandle] = None
        self.frames = 0                 # staged frames (test hook)
        self.writes = 0                 # flush batches (test hook)

    def send(self, blob) -> None:  #: loop-only
        n = len(blob)
        if n > MAX_FRAME:
            raise RpcError(f"frame too large: {n}")
        if _nc.ENABLED:
            # chaos below the frame layer: drop suppresses the WHOLE frame,
            # dup stages the same complete frame twice, delay queues it
            # FIFO behind earlier delayed frames on this link
            verdict, delay_s = _nc.on_send_decide(self._sock, n + 4)
            if verdict is _nc.DROP_FRAME:
                return
            copies = 2 if verdict is _nc.DUP_FRAME else 1
            if delay_s > 0 or self._delayed:
                due = self._loop.time() + delay_s
                for _ in range(copies):
                    self._delayed.append((blob, due))
                self._arm_timer()
                return
            for _ in range(copies):
                self._stage_frame(blob)
            return
        self._stage_frame(blob)

    def _stage_frame(self, blob) -> None:  #: loop-only
        _WIRE["bytes_sent"] += len(blob) + 4    # lossy-tolerant plain add
        _WIRE["frames_sent"] += 1
        self.frames += 1
        self._stage.append(blob)
        if not self._armed:
            self._armed = True
            # call_soon, not a write now: whatever the rest of this loop
            # iteration stages joins the same flush
            self._loop.call_soon(self._flush)

    def _arm_timer(self) -> None:  #: loop-only
        if self._timer is not None:
            return
        due = self._delayed[0][1]
        self._timer = self._loop.call_later(
            max(0.0, due - self._loop.time()), self._release_delayed)

    def _release_delayed(self) -> None:  #: loop-only
        self._timer = None
        now = self._loop.time()
        while self._delayed and self._delayed[0][1] <= now:
            self._stage_frame(self._delayed.popleft()[0])
        if self._delayed:
            self._arm_timer()

    def _flush(self) -> None:  #: loop-only
        self._armed = False
        if self._transport.is_closing():
            self._stage.clear()
            return
        small: list = []
        while self._stage:
            blob = self._stage.popleft()
            n = len(blob)
            if n > SEND_CONCAT_MAX:
                # the joined run first, so stream order holds; then the
                # big payload without a concatenation copy
                if small:
                    self._transport.write(b"".join(small))
                    small = []
                self._transport.write(_LEN.pack(n))
                self._transport.write(bytes(blob))
                self.writes += 1
                continue
            small.append(_LEN.pack(n))
            small.append(bytes(blob))
        if small:
            self._transport.write(b"".join(small))
            self.writes += 1


class _FrameProtocol(asyncio.Protocol):
    """Framing on the loop. ``owner`` (AsyncClient or AsyncConnection)
    supplies ``_attached``, ``_on_frame`` and ``_on_lost`` and a ``sock``
    attribute for chaos-link identity. Inbound chaos delays re-schedule
    delivery through ``call_later`` (the loop never sleeps), keeping
    per-link FIFO as the threaded reader's in-line sleep does."""

    def __init__(self, owner) -> None:
        self._owner = owner
        self._loop = eventloop.get_loop()
        self._buf = bytearray()
        self._in_delayed: deque = deque()  # (blob, due)
        self._in_timer: Optional[asyncio.TimerHandle] = None
        self.transport = None

    def connection_made(self, transport) -> None:  #: loop-only
        self.transport = transport
        self._owner._attached(transport)

    def data_received(self, data: bytes) -> None:  #: loop-only
        buf = self._buf
        buf += data
        off = 0
        while True:
            avail = len(buf) - off
            if avail < 4:
                break
            (n,) = _LEN.unpack_from(buf, off)
            if n > MAX_FRAME:
                self._violation()
                return
            if avail - 4 < n:
                break
            blob = bytes(buf[off + 4:off + 4 + n])
            off += 4 + n
            _WIRE["bytes_recv"] += n + 4    # lossy-tolerant plain add
            _WIRE["frames_recv"] += 1
            if _nc.ENABLED:
                verdict, delay_s = _nc.on_recv_decide(
                    self._owner.sock, n + 4)
                if verdict is _nc.DROP_FRAME:
                    continue    # inbound frame lost on the simulated link
                if delay_s > 0 or self._in_delayed:
                    self._in_delayed.append(
                        (blob, self._loop.time() + delay_s))
                    self._arm_in_timer()
                    continue
            if not self._deliver(blob):
                return
        if off:
            del buf[:off]

    def _arm_in_timer(self) -> None:  #: loop-only
        if self._in_timer is not None:
            return
        due = self._in_delayed[0][1]
        self._in_timer = self._loop.call_later(
            max(0.0, due - self._loop.time()), self._release_in_delayed)

    def _release_in_delayed(self) -> None:  #: loop-only
        self._in_timer = None
        now = self._loop.time()
        while self._in_delayed and self._in_delayed[0][1] <= now:
            if not self._deliver(self._in_delayed.popleft()[0]):
                return
        if self._in_delayed:
            self._arm_in_timer()

    def _deliver(self, blob: bytes) -> bool:  #: loop-only
        try:
            msg = loads_frame(blob)
        except RpcError:
            self._violation()
            return False
        if not isinstance(msg, dict):
            self._violation()
            return False
        self._owner._on_frame(msg)
        return True

    def _violation(self) -> None:  #: loop-only
        # a protocol violation is the connection's death, as the threaded
        # reader's exit is; abort tears down through connection_lost
        self._buf.clear()
        self._in_delayed.clear()
        if self.transport is not None:
            self.transport.abort()

    def connection_lost(self, exc) -> None:  #: loop-only
        if self._in_timer is not None:
            self._in_timer.cancel()
            self._in_timer = None
        self._owner._on_lost(exc)


# ---------------------------------------------------------------------------
# client
# ---------------------------------------------------------------------------

class AsyncClient:
    """Duck-types ``rpc.Client``: blocking thread-side ``call`` and
    ``notify`` over a connection the event loop owns. The socket is
    connected synchronously (the constructor fails as the threaded
    client's does), then handed to the loop."""

    def __init__(self, addr: Tuple[str, int], timeout: float = 30.0,
                 on_push: Optional[Callable[[str, Dict[str, Any]], None]]
                 = None):
        self.addr = tuple(addr)
        self._sock = socket.create_connection(self.addr, timeout=10.0)
        self._sock.settimeout(None)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self.sock = self._sock          # chaos-link identity
        self._id = 0                    #: guarded by self._id_lock
        self._id_lock = threading.Lock()
        self._pending: Dict[int, list] = {}  #: guarded by self._plock
        self._plock = threading.Lock()
        self._timeout = timeout
        self._on_push = on_push
        self.dead = False
        self._loop = eventloop.get_loop()
        self._proto = _FrameProtocol(self)
        self._batcher: Optional[_WriteBatcher] = None

        async def _attach():
            await self._loop.create_connection(lambda: self._proto,
                                               sock=self._sock)

        try:
            eventloop.run_coro(_attach(), timeout=10.0)
        except BaseException:
            self._sock.close()
            raise

    def link(self, peer_role: str, link_id: str = "") -> "AsyncClient":
        """Tag this connection's socket with the peer's chaos-link
        identity (cold path; chainable)."""
        _nc.register_link(self._sock, peer_role, link_id)
        return self

    # -- loop side ----------------------------------------------------
    def _attached(self, transport) -> None:  #: loop-only
        self._batcher = _WriteBatcher(self._loop, transport, self._sock)

    def _on_frame(self, msg: Dict[str, Any]) -> None:  #: loop-only
        # the threaded core's seam name: one seam, two cores
        if _fp.ENABLED and _fp.fire(  # raylint: disable=failpoint-registry
                "rpc.client.recv", method=msg.get("m", "")) is _fp.DROP:
            return      # reply/push lost in transit
        rid = msg.get("i")
        if rid is None:
            # server push (no correlation id): inline on the loop, as the
            # threaded reader runs it inline on its thread
            if self._on_push is not None:
                try:
                    self._on_push(msg.get("m", ""), msg)
                except Exception:
                    pass
            return
        with self._plock:
            slot = self._pending.pop(rid, None)
        if slot is not None:
            slot[1] = msg
            slot[0].set()

    def _on_lost(self, exc) -> None:  #: loop-only
        self._fail_all()

    def _fail_all(self) -> None:
        self.dead = True
        with self._plock:
            pending, self._pending = self._pending, {}
        for slot in pending.values():
            slot[1] = None
            slot[0].set()

    # -- thread side --------------------------------------------------
    def _send_blob(self, blob: bytes) -> None:
        if self.dead or self._batcher is None:
            raise RpcError(f"connection to {self.addr} is dead")
        if eventloop.on_loop():
            # already on the loop (a push handler sending): stage direct
            self._batcher.send(blob)  # raylint: disable=loop-affinity
        else:
            self._loop.call_soon_threadsafe(self._batcher.send, blob)

    def call(self, method: str, timeout: Optional[float] = None,
             **kw) -> Dict[str, Any]:
        """Blocking request/reply, thread context only: waiting on the
        loop thread would deadlock the wire it waits on."""
        if eventloop.on_loop():
            raise RuntimeError(
                f"blocking rpc call({method!r}) on the event loop thread "
                f"— hand blocking work to an executor")
        _validate(method, kw)
        if self.dead:
            raise RpcError(f"connection to {self.addr} is dead")
        with _WIRE_LOCK:
            _WIRE_CLIENT_REQS[method] = _WIRE_CLIENT_REQS.get(method, 0) + 1
            _WIRE["inflight"] += 1
        try:
            return self._call_counted(method, timeout, kw)
        finally:
            with _WIRE_LOCK:
                _WIRE["inflight"] -= 1

    def _call_counted(self, method: str, timeout: Optional[float],
                      kw: Dict[str, Any]) -> Dict[str, Any]:
        # the threaded client's discipline: the failpoint fires BEFORE the
        # pending slot exists, and a deadline-less caller surfaces a
        # dropped send as transport death
        dropped = (_fp.ENABLED and _fp.fire(  # raylint: disable=failpoint-registry
            "rpc.client.send", method=method) is _fp.DROP)
        if dropped and (timeout if timeout is not None
                        else self._timeout) is None:
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
                self._send_blob(blob)
        except (OSError, RuntimeError, RpcError):
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
        if (_fp.ENABLED and _fp.fire("rpc.client.send",  # raylint: disable=failpoint-registry
                                     method=method) is _fp.DROP):
            return              # notification lost in transit
        msg = dict(kw)
        msg["m"] = method
        blob = dumps_frame(msg)
        try:
            self._send_blob(blob)
        except (OSError, RuntimeError, RpcError):
            self._fail_all()
            raise RpcError(f"send to {self.addr} failed")

    def close(self) -> None:
        self.dead = True

        def _close() -> None:
            t = self._proto.transport
            if t is not None:
                t.abort()
            else:
                self._sock.close()

        try:
            self._loop.call_soon_threadsafe(_close)
        except RuntimeError:
            pass        # the loop is already gone (interpreter exit)
        self._fail_all()    # idempotent: close() means dead for callers


# ---------------------------------------------------------------------------
# server
# ---------------------------------------------------------------------------

class AsyncConnection:
    """Duck-types ``rpc.Connection`` for services: ``sock``, ``peer``,
    ``meta``, ``closed``, ``reply()``, ``reply_error()`` and ``push()``.
    Replies may come from any thread (the lane, ``@concurrent``, the
    pump); they re-enter the loop and join this peer's write batch."""

    def __init__(self, server: "AsyncServer"):
        self._server = server
        self._loop = server._loop
        self.sock = None
        self.peer = None
        self.meta: Dict[str, Any] = {}   # services stash identity here
        self.closed = False
        self._proto = _FrameProtocol(self)
        self._batcher: Optional[_WriteBatcher] = None
        # FIFO lane, as in the threaded server: from one peer, ordered
        # handlers run one at a time in arrival order on the shared pool
        self._lane: deque = deque()
        self._lane_lock = threading.Lock()
        self._lane_busy = False

    def link(self, peer_role: str, link_id: str = "") -> "AsyncConnection":
        """Tag the accepted socket's chaos-link identity (hello/register)."""
        if self.sock is not None:
            _nc.register_link(self.sock, peer_role, link_id)
        return self

    # -- loop side ----------------------------------------------------
    def _attached(self, transport) -> None:  #: loop-only
        self.sock = _raw_sock(transport)
        self.peer = transport.get_extra_info("peername")
        self._batcher = _WriteBatcher(self._loop, transport, self.sock)

    def _on_frame(self, msg: Dict[str, Any]) -> None:  #: loop-only
        self._server._dispatch(self, msg)

    def _on_lost(self, exc) -> None:  #: loop-only
        self.closed = True
        self._server._conn_lost(self)

    def _abort(self) -> None:  #: loop-only
        t = self._proto.transport
        if t is not None:
            t.abort()

    # -- the reply surface, from any thread ----------------------------
    def _send_blob(self, blob: bytes) -> None:
        if self.closed or self._batcher is None:
            return      # as threaded: a send after death is dropped
        if eventloop.on_loop():
            self._batcher.send(blob)  # raylint: disable=loop-affinity
        else:
            try:
                self._loop.call_soon_threadsafe(self._batcher.send, blob)
            except RuntimeError:
                self.closed = True      # the loop is gone

    def reply(self, rid: int, **kw) -> None:
        msg = dict(kw)
        msg["i"] = rid
        try:
            blob = dumps_frame(msg)
        except RpcError as e:
            # an unplain reply becomes the caller's RemoteError
            blob = dumps_frame({"i": rid, "e": f"RpcError: {e}"})
        self._send_blob(blob)

    def reply_error(self, rid: int, err: str) -> None:
        self.reply(rid, e=err)

    def push(self, method: str, **kw) -> None:
        """Server-initiated message (no correlation id)."""
        msg = dict(kw)
        msg["m"] = method
        try:
            blob = dumps_frame(msg)
        except RpcError:
            self.closed = True      # as the threaded Connection.push
            return
        self._send_blob(blob)


class AsyncServer:
    """Duck-types ``rpc.Server``. The listening socket is bound at once
    (``addr`` is valid immediately, as in the threaded server);
    ``start()`` hands it to the loop. Dispatch runs on the loop:
    ``@loop_safe`` handlers inline, ``@concurrent`` ones on a thread of
    their own, everything else through the connection's FIFO lane on the
    shared pool."""

    def __init__(self, service: Any, host: str = "127.0.0.1",
                 port: int = 0):
        self.service = service
        self._sock = socket.create_server((host, port))
        self.addr = self._sock.getsockname()
        self._stop = False
        self._conns: list = []
        self._loop = eventloop.get_loop()
        self._aserver: Optional[asyncio.AbstractServer] = None
        from ray_tpu_torch._private.thread_pool import DaemonThreadPool
        self._pool = DaemonThreadPool(128, name=f"rpc-{self.addr[1]}")

    def start(self) -> "AsyncServer":
        async def _start():
            return await self._loop.create_server(self._make_protocol,
                                                  sock=self._sock)

        self._aserver = eventloop.run_coro(_start(), timeout=10.0)
        return self

    def _make_protocol(self):  #: loop-only
        conn = AsyncConnection(self)
        self._conns.append(conn)
        return conn._proto

    def _dispatch(self, conn: AsyncConnection,
                  msg: Dict[str, Any]) -> None:  #: loop-only
        method = msg.get("m", "")
        if _fp.ENABLED and _fp.fire(  # raylint: disable=failpoint-registry
                "rpc.server.recv", method=method) is _fp.DROP:
            return      # request lost before dispatch
        rid = msg.get("i")
        with _WIRE_LOCK:
            _WIRE_SERVER_REQS[method] = _WIRE_SERVER_REQS.get(method, 0) + 1
        handler = getattr(self.service, f"handle_{method}", None)
        if handler is None:
            if rid is not None:
                conn.reply_error(rid, f"no such method {method!r}")
            return
        if getattr(handler, "_rpc_loop_safe", False):
            # declared non-blocking: inline on the loop; an immediate
            # reply joins this peer's coalesced write batch
            self._run_handler(conn, handler, rid, msg)
            return
        if getattr(handler, "_rpc_concurrent", False):
            # a thread of its own, not the shared pool (threaded parity):
            # it may block for minutes without starving lane drains
            threading.Thread(target=self._run_handler,
                             args=(conn, handler, rid, msg), daemon=True,
                             name=f"rpc-conc-{method}").start()
            return
        with conn._lane_lock:
            conn._lane.append((handler, rid, msg))
            if conn._lane_busy:
                return
            conn._lane_busy = True
        self._pool.submit(lambda: self._drain_lane(conn))

    @staticmethod
    def _run_handler(conn: AsyncConnection, handler, rid, msg) -> None:
        try:
            out = handler(conn, rid, msg)
            if out is HOLD or rid is None:
                return
            conn.reply(rid, **(out or {}))
        except Exception as e:  # noqa: BLE001 - shipped back
            if rid is not None:
                conn.reply_error(rid, f"{type(e).__name__}: {e}")

    def _drain_lane(self, conn: AsyncConnection) -> None:
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

    def _conn_lost(self, conn: AsyncConnection) -> None:  #: loop-only
        try:
            self._conns.remove(conn)
        except ValueError:
            pass
        cb = getattr(self.service, "on_disconnect", None)
        if cb is not None and not self._stop:
            # a service's disconnect hook may block (reclaim, exit): off
            # the loop, as the dying reader thread ran it
            self._pool.submit(lambda: self._safe_disconnect(cb, conn))

    @staticmethod
    def _safe_disconnect(cb, conn) -> None:
        try:
            cb(conn)
        except Exception:
            pass

    def stop(self) -> None:
        self._stop = True
        if self._aserver is None:
            # never started: the listening socket is still ours
            try:
                self._sock.close()
            except OSError:
                pass
            return

        def _close() -> None:
            self._aserver.close()
            for conn in list(self._conns):
                conn._abort()

        try:
            self._loop.call_soon_threadsafe(_close)
        except RuntimeError:
            pass        # the loop is already gone (interpreter exit)
