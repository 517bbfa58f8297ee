"""Serve's second ingress beside HTTP (counterpart of
``ray_tpu/serve/grpc_proxy.py``), on the port's RPC wire.

JAX's is a ``grpc.Server`` with msgpack bodies; the card's machine has
neither ``grpc`` nor ``msgpack``. The port keeps its names and behaviour on
a threaded ``rpc.Server`` (``_private/rpc.py``: length-prefixed frames of
plain data, an unpickler that refuses globals), with the same four
methods:

    Predict (request) -> {"result": ...} | {"error": ..., "code": ...}
    PredictStream (request, stream) -> pushed {"chunk": ...} frames, then
        the reply
    CancelStream (stream): the client left the stream (gRPC's cancel)
    ListApplications () -> {"applications": {app: ingress}}
    Healthz () -> {"status": "ok"}

A request is {"application": str (optional: the default app), "method":
str (optional), "args": [...], "kwargs": {...}, "deadline_s": seconds
or None}. Values cross as plain data; anything else becomes its ``repr``, as
msgpack's ``default=repr`` does in JAX's proxy (tuples come back as lists).

What stays JAX's: the client's deadline bounds the replica wait server-side
with a 600 s ceiling (60 s without one); one handle per app, made again
when the app's ingress changes; a stream's chunks flow through a bounded
queue (8) between the replica's generator and the connection, so a slow
client stops the pump, a client that leaves the stream releases it, and
each chunk wait is bounded (120 s).
"""

from __future__ import annotations

import itertools
import queue
import threading
from typing import Any, Callable, Dict, Optional

from ray_tpu_torch._private import rpc

rpc.declare("Predict", "request")
rpc.declare("PredictStream", "request", "stream")
rpc.declare("CancelStream", "stream")
rpc.declare("ListApplications")
rpc.declare("Healthz")

CHUNK_TIMEOUT_S = 120.0
WAIT_CEILING_S = 600.0
DEFAULT_WAIT_S = 60.0


def _plain(obj: Any) -> Any:
    """``obj`` as frame data: containers recursively, anything that is not
    plain data as its ``repr`` (JAX's msgpack ``default=repr``)."""
    if obj is None or isinstance(obj, (bool, int, float, str, bytes)):
        return obj
    if isinstance(obj, bytearray):
        return bytes(obj)
    if isinstance(obj, (list, tuple)):
        return [_plain(x) for x in obj]
    if isinstance(obj, dict):
        return {(k if isinstance(k, (str, int, float, bool, bytes))
                 or k is None else repr(k)): _plain(v)
                for k, v in obj.items()}
    return repr(obj)


def _error(e: BaseException) -> str:
    return f"{type(e).__name__}: {e}"


class _ProxyService:
    """The proxy's handlers (``handle_<method>`` of ``rpc.Server``)."""

    def __init__(self, get_handle: Callable[[Optional[str]], Any],
                 list_apps: Callable[[], Dict[str, str]]):
        self._get_handle = get_handle
        self._list_apps = list_apps

    def _handle_for(self, req: Dict[str, Any]):
        handle = self._get_handle(req.get("application"))
        if req.get("method"):
            handle = handle.options(req["method"])
        return handle

    @rpc.concurrent
    def handle_Predict(self, conn, rid, msg):
        req = msg["request"]
        try:
            handle = self._handle_for(req)
            # the client's deadline, less a margin so this error is read
            # before the transport's own timeout; the ceiling stops an hour
            # long deadline from pinning a thread on a wedged replica
            rem = req.get("deadline_s")
            wait = (min(max(0.1, rem - 0.5), WAIT_CEILING_S)
                    if rem is not None else DEFAULT_WAIT_S)
            result = handle.remote(*req.get("args") or [],
                                   **req.get("kwargs") or {}
                                   ).result(timeout=wait)
            return {"result": _plain(result)}
        except TimeoutError as e:
            return {"error": _error(e), "code": "DEADLINE_EXCEEDED"}
        except Exception as e:  # noqa: BLE001 - shipped to the client
            return {"error": _error(e), "code": "INTERNAL"}

    @rpc.concurrent
    def handle_PredictStream(self, conn, rid, msg):
        """One pushed frame per replica chunk, flushed as produced, then
        the reply; each chunk wait is bounded, so a wedged replica ends
        the call with DEADLINE_EXCEEDED instead of pinning a thread."""
        sid, req = msg["stream"], msg["request"]
        try:
            gen = self._handle_for(req).options(stream=True).remote(
                *req.get("args") or [], **req.get("kwargs") or {})
        except Exception as e:  # noqa: BLE001 - shipped to the client
            return {"error": _error(e), "code": "INTERNAL"}
        # small bound: end-to-end flow control for a slow client
        q: "queue.Queue" = queue.Queue(maxsize=8)
        stop = threading.Event()
        streams = conn.meta.setdefault("streams", {})
        streams[sid] = stop

        def offer(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.5)
                    return True
                except queue.Full:
                    continue
            return False

        def pump():
            try:
                for chunk in gen:
                    if not offer(("chunk", chunk)):
                        return        # the client is gone: stop reading
                offer(("end", None))
            except BaseException as e:  # noqa: BLE001 - shipped
                offer(("err", e))

        threading.Thread(target=pump, daemon=True,
                         name="grpc-stream-pump").start()
        try:
            while True:
                try:
                    kind, item = q.get(timeout=CHUNK_TIMEOUT_S)
                except queue.Empty:
                    return {"error": "chunk timeout",
                            "code": "DEADLINE_EXCEEDED"}
                if kind == "end":
                    return {"done": True}
                if kind == "err":
                    return {"error": _error(item), "code": "INTERNAL"}
                conn.push("stream_item", stream=sid, chunk=_plain(item))
                if conn.closed or stop.is_set():
                    return {"cancelled": True}
        finally:
            stop.set()      # release the pump at its next offer
            streams.pop(sid, None)

    def handle_CancelStream(self, conn, rid, msg):
        stop = conn.meta.get("streams", {}).get(msg["stream"])
        if stop is not None:
            stop.set()
        return {"ok": True}

    def handle_ListApplications(self, conn, rid, msg):
        return {"applications": self._list_apps()}

    def handle_Healthz(self, conn, rid, msg):
        return {"status": "ok"}


class GrpcProxy:
    """Routes the second ingress's calls to application ingress handles."""

    def __init__(self, get_handle: Callable[[Optional[str]], Any],
                 list_apps: Callable[[], Dict[str, str]],
                 host: str = "127.0.0.1", port: int = 0):
        self._server = rpc.Server(_ProxyService(get_handle, list_apps),
                                  host=host, port=port).start()
        self.port = self._server.addr[1]

    def stop(self) -> None:
        self._server.stop()


class GrpcServeClient:
    """Client of the proxy (tests and SDK parity)."""

    def __init__(self, address: str):
        host, port = address.rsplit(":", 1)
        self._streams: Dict[int, "queue.Queue"] = {}
        self._slock = threading.Lock()
        self._sids = itertools.count(1)
        self._client = rpc.Client((host, int(port)), timeout=None,
                                  on_push=self._on_push)

    def _on_push(self, method: str, msg: Dict[str, Any]) -> None:
        if method != "stream_item":
            return
        with self._slock:
            q = self._streams.get(msg.get("stream"))
        if q is not None:
            q.put(("chunk", msg.get("chunk")))

    @staticmethod
    def _request(args, kwargs, application, method, timeout):
        return {"application": application, "method": method,
                "args": list(args), "kwargs": kwargs, "deadline_s": timeout}

    def predict(self, *args, application: Optional[str] = None,
                method: Optional[str] = None,
                timeout: Optional[float] = None, **kwargs) -> Any:
        """``timeout`` is the call's deadline; the proxy bounds the replica
        wait by it (less a margin) server-side."""
        try:
            out = self._client.call(
                "Predict", timeout=timeout, request=self._request(
                    args, kwargs, application, method, timeout))
        except rpc.RpcError as e:
            # the status stays visible for retry policies
            code = ("DEADLINE_EXCEEDED" if "timed out" in str(e)
                    else "UNAVAILABLE")
            raise RuntimeError(f"{code}: {e}") from None
        if "error" in out:
            raise RuntimeError(f"{out['code']}: {out['error']}")
        return out["result"]

    def predict_stream(self, *args, application: Optional[str] = None,
                       method: Optional[str] = None, **kwargs):
        """Yield chunks as the replica produces them (server streaming)."""
        sid = next(self._sids)
        q: "queue.Queue" = queue.Queue()
        with self._slock:
            self._streams[sid] = q

        def call():
            try:
                out = self._client.call(
                    "PredictStream", timeout=None, stream=sid,
                    request=self._request(args, kwargs, application,
                                          method, None))
                q.put(("reply", out))
            except BaseException as e:  # noqa: BLE001 - raised below
                q.put(("reply", {"error": str(e), "code": "UNAVAILABLE"}))

        # pushes and the reply arrive in order on one connection: every
        # chunk is in the queue before the reply that ends the stream
        threading.Thread(target=call, daemon=True,
                         name="grpc-stream-call").start()
        done = False
        try:
            while True:
                kind, item = q.get()
                if kind == "chunk":
                    yield item
                    continue
                done = True
                if "error" in item:
                    raise RuntimeError(f"{item['code']}: {item['error']}")
                return
        finally:
            with self._slock:
                self._streams.pop(sid, None)
            if not done:        # left early: release the proxy's pump
                try:
                    self._client.notify("CancelStream", stream=sid)
                except rpc.RpcError:
                    pass

    def list_applications(self) -> Dict[str, str]:
        return self._client.call("ListApplications")["applications"]

    def healthz(self) -> bool:
        return self._client.call("Healthz")["status"] == "ok"

    def close(self) -> None:
        self._client.close()


_proxy: Optional[GrpcProxy] = None
_lock = threading.Lock()


def start_grpc_proxy(port: int = 0) -> int:
    """Start (or return) the process-wide proxy; returns its port."""
    global _proxy
    with _lock:
        if _proxy is None:
            import atexit

            from ray_tpu_torch.serve import api as serve_api

            handles: Dict[str, Any] = {}
            hlock = threading.Lock()

            def get_handle(app_name: Optional[str]):
                # one handle (one membership listener) per app, made again
                # when the app's ingress deployment changes: a delete and
                # redeploy must not route through a stale handle
                name = app_name or "default"
                ingress = serve_api._apps.get(name)
                if ingress is None:
                    raise KeyError(name)
                with hlock:
                    entry = handles.get(name)
                    if entry is None or entry[0] != ingress:
                        entry = (ingress, serve_api.get_app_handle(name))
                        handles[name] = entry
                    return entry[1]

            def list_apps():
                return dict(serve_api._apps)

            _proxy = GrpcProxy(get_handle, list_apps, port=port)
            atexit.register(stop_grpc_proxy)
        return _proxy.port


def stop_grpc_proxy() -> None:
    global _proxy
    with _lock:
        if _proxy is not None:
            _proxy.stop()
            _proxy = None
