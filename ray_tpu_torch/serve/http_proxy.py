"""Asyncio HTTP ingress for Serve, the ASGI-proxy role (counterpart of
``ray_tpu/serve/http_proxy.py``).

Reference: ``python/ray/serve/_private/proxy.py:697`` (HTTPProxy — an
ASGI app under uvicorn) and ``:1009`` (the streaming response path).
The stdlib ``ThreadingHTTPServer`` it replaces spends a thread per
CONNECTION and has no ingress backpressure; this plane is one asyncio
event loop:

- connections scale without threads (keep-alive supported),
- an explicit in-flight cap (``max_ongoing_requests``) sheds load with
  503 + Retry-After the moment the data plane saturates — the
  reference's proxy backpressure contract,
- per-request work awaits the data plane (``ObjectRef.as_future``) so
  a slow replica never blocks the accept loop,
- SSE streaming pulls replica chunks through an executor, flushing
  each the moment it lands (TTFT = first chunk, not handler return).

HTTP/1.1 subset: request line + headers + Content-Length bodies (no
chunked request decoding — JSON ingress clients all send a length).
"""

from __future__ import annotations

import asyncio
import json
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Optional

from ray_tpu_torch.serve.router import DeploymentHandle

_MAX_HEADER = 64 * 1024
_MAX_BODY = 64 * 1024 * 1024


class AsyncHTTPProxy:
    """One event loop serving every running application."""

    def __init__(self, handles: Dict[str, DeploymentHandle],
                 host: str = "127.0.0.1", port: int = 8000,
                 max_ongoing_requests: int = 200,
                 request_timeout_s: float = 60.0):
        self.handles = handles
        self.host = host
        self.port = port
        self.max_ongoing = max_ongoing_requests
        self.request_timeout_s = request_timeout_s
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._server: Optional[asyncio.AbstractServer] = None
        self._thread: Optional[threading.Thread] = None
        self._started = threading.Event()
        # streaming generators block in ray get per chunk: bounded pool
        self._pool = ThreadPoolExecutor(max_workers=32,
                                        thread_name_prefix="proxy-stream")
        self._ongoing = 0
        self.stats = {"requests": 0, "shed": 0, "streams": 0}

    # -- lifecycle --------------------------------------------------------
    def start(self) -> int:
        """Run the loop in a daemon thread; returns the bound port."""
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="serve-http-proxy")
        self._thread.start()
        if not self._started.wait(10.0):
            raise RuntimeError("HTTP proxy failed to start")
        return self.port

    def _run(self) -> None:
        self._loop = asyncio.new_event_loop()
        asyncio.set_event_loop(self._loop)

        async def boot():
            # limit must exceed _MAX_HEADER or readuntil raises
            # LimitOverrunError before the 431 check can answer
            self._server = await asyncio.start_server(
                self._serve_conn, self.host, self.port,
                limit=_MAX_HEADER * 2)
            self.port = self._server.sockets[0].getsockname()[1]
            self._started.set()

        self._loop.run_until_complete(boot())
        try:
            self._loop.run_forever()
        finally:
            self._loop.close()

    def stop(self) -> None:
        loop = self._loop
        if loop is None:
            return

        def shutdown():  #: loop-only
            if self._server is not None:
                self._server.close()
            loop.stop()

        try:
            loop.call_soon_threadsafe(shutdown)
        except RuntimeError:
            pass
        if self._thread is not None:
            self._thread.join(timeout=5.0)
        self._pool.shutdown(wait=False)

    # -- connection loop ---------------------------------------------------
    async def _serve_conn(self, reader: asyncio.StreamReader,
                          writer: asyncio.StreamWriter) -> None:
        try:
            while True:
                keep_alive = await self._serve_one(reader, writer)
                if not keep_alive:
                    break
        except (asyncio.IncompleteReadError, ConnectionError,
                asyncio.LimitOverrunError):
            pass
        finally:
            try:
                writer.close()
            except Exception:
                pass

    async def _serve_one(self, reader, writer) -> bool:
        try:
            head = await reader.readuntil(b"\r\n\r\n")
        except asyncio.LimitOverrunError:
            await self._plain(writer, 431, {"error": "headers too large"})
            return False
        if len(head) > _MAX_HEADER:
            await self._plain(writer, 431, {"error": "headers too large"})
            return False
        lines = head.decode("latin-1").split("\r\n")
        try:
            method, path, version = lines[0].split(" ", 2)
        except ValueError:
            await self._plain(writer, 400, {"error": "bad request line"})
            return False
        headers = {}
        for ln in lines[1:]:
            if ":" in ln:
                k, v = ln.split(":", 1)
                headers[k.strip().lower()] = v.strip()
        length = int(headers.get("content-length", 0) or 0)
        if length > _MAX_BODY:
            await self._plain(writer, 413, {"error": "body too large"})
            return False
        raw = await reader.readexactly(length) if length else b""
        keep_alive = (headers.get("connection", "").lower() != "close"
                      and version != "HTTP/1.0")

        # ingress backpressure: shed BEFORE touching the data plane
        if self._ongoing >= self.max_ongoing:
            self.stats["shed"] += 1
            await self._plain(writer, 503,
                              {"error": "too many ongoing requests"},
                              extra_headers={"Retry-After": "1"})
            return keep_alive
        self._ongoing += 1
        self.stats["requests"] += 1
        try:
            streamed = await self._handle_request(writer, path, headers,
                                                  raw)
        finally:
            self._ongoing -= 1
        # SSE responses are EOF-terminated (no Content-Length): the
        # advertised 'Connection: close' must actually happen or
        # EOF-reading clients hang until timeout
        return keep_alive and not streamed

    # -- request handling --------------------------------------------------
    def _route(self, path: str) -> Optional[DeploymentHandle]:
        app = path.strip("/").split("/")[0] or "default"
        return self.handles.get(app) or self.handles.get("default")

    async def _handle_request(self, writer, path: str,
                              headers: Dict[str, str],
                              raw: bytes) -> bool:
        """Returns True when the response was a stream (conn closes)."""
        handle = self._route(path)
        if handle is None:
            await self._plain(writer, 404, {"error": "no such application"})
            return False
        try:
            payload: Any = json.loads(raw) if raw else {}
        except json.JSONDecodeError:
            payload = raw.decode(errors="replace")
        wants_stream = ("text/event-stream" in headers.get("accept", "")
                        or (isinstance(payload, dict)
                            and payload.get("stream") is True))
        if wants_stream:
            await self._stream(writer, handle, payload)
            return True
        loop = asyncio.get_running_loop()
        timeout = self.request_timeout_s

        def resolve():
            import ray_tpu_torch
            resp = handle.remote(payload)
            # bounded get: a stuck replica must release this pool slot
            return ray_tpu_torch.get(resp.ref, timeout=timeout)

        try:
            # the bounded pool is the thread budget (no thread per
            # request); asyncio.wait_for gives the client its 504 even
            # if the pool itself is saturated
            result = await asyncio.wait_for(
                loop.run_in_executor(self._pool, resolve),
                timeout=timeout + 5.0)
            await self._plain(writer, 200, result)
        except asyncio.TimeoutError:
            await self._plain(writer, 504, {"error": "request timed out"})
        except Exception as e:  # noqa: BLE001 — surfaced to the client
            if type(e).__name__ == "GetTimeoutError":
                await self._plain(writer, 504,
                                  {"error": "request timed out"})
            else:
                await self._plain(writer, 500, {"error": repr(e)})
        return False

    async def _stream(self, writer, handle, payload) -> None:
        """SSE: chunks flush as the replica yields them (proxy.py:1009)."""
        self.stats["streams"] += 1
        loop = asyncio.get_running_loop()

        def submit():
            # .remote() is a full rpc round trip (lease + push): run it
            # on the stream pool, never on the event loop
            return handle.options(stream=True).remote(payload)

        try:
            gen = await loop.run_in_executor(self._pool, submit)
        except Exception as e:  # noqa: BLE001
            await self._plain(writer, 500, {"error": repr(e)})
            return
        writer.write(b"HTTP/1.1 200 OK\r\n"
                     b"Content-Type: text/event-stream\r\n"
                     b"Cache-Control: no-cache\r\n"
                     b"Connection: close\r\n\r\n")
        await writer.drain()
        it = iter(gen)

        def next_chunk():
            try:
                return False, next(it)
            except StopIteration:
                return True, None

        try:
            while True:
                done, chunk = await loop.run_in_executor(self._pool,
                                                         next_chunk)
                if done:
                    writer.write(b"data: [DONE]\n\n")
                    await writer.drain()
                    break
                writer.write(f"data: {json.dumps(chunk)}\n\n".encode())
                await writer.drain()
        except (ConnectionError, asyncio.CancelledError):
            pass           # client went away mid-stream
        except Exception as e:  # noqa: BLE001 — last-gasp error event
            try:
                writer.write(
                    f"data: {json.dumps({'error': repr(e)})}\n\n".encode())
                await writer.drain()
            except Exception:
                pass

    async def _plain(self, writer, code: int, payload: Any,
                     extra_headers: Optional[Dict[str, str]] = None
                     ) -> None:
        body = json.dumps(payload).encode()
        reason = {200: "OK", 400: "Bad Request", 404: "Not Found",
                  413: "Payload Too Large", 431: "Headers Too Large",
                  500: "Internal Server Error",
                  503: "Service Unavailable",
                  504: "Gateway Timeout"}.get(code, "OK")
        head = [f"HTTP/1.1 {code} {reason}",
                "Content-Type: application/json",
                f"Content-Length: {len(body)}"]
        for k, v in (extra_headers or {}).items():
            head.append(f"{k}: {v}")
        writer.write(("\r\n".join(head) + "\r\n\r\n").encode() + body)
        await writer.drain()


