"""serve API: run/shutdown/status/get_deployment_handle + HTTP proxy
(counterpart of ``ray_tpu/serve/api.py``).

Reference: `serve/api.py:691` (serve.run), `serve/_private/proxy.py:697`
(HTTPProxy ASGI). The default proxy is the asyncio one of
``serve/http_proxy.py``; ``legacy_threaded=True`` keeps a threaded stdlib
HTTP server. Both JSON-decode request bodies and route to the
application's ingress handle — the data plane (handle → P2C router →
replica actor) is identical in shape to the reference.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional

import ray_tpu_torch
from ray_tpu_torch.serve.deployment import Application
from ray_tpu_torch.serve.router import DeploymentHandle

_apps: Dict[str, str] = {}       # app name -> ingress deployment name
_http_server = None
_http_thread = None


def _get_controller(create: bool = True):
    try:
        return ray_tpu_torch.get_actor("serve_controller")
    except Exception:
        if not create:
            raise
    from ray_tpu_torch.serve.controller import ServeController
    controller_cls = ray_tpu_torch.remote(ServeController)
    handle = controller_cls.options(
        name="serve_controller", lifetime="detached",
        # Control-plane actor: holds live handles/locks and brokers
        # device-owning replicas — stays in the card-owning process.
        _in_process=True,
        max_concurrency=32).remote()
    ray_tpu_torch.get(handle.ping.remote())
    return handle


def run(app: Application, *, name: str = "default",
        route_prefix: Optional[str] = None,
        blocking: bool = False,
        local_testing_mode: bool = False):
    """Deploy an application; returns the ingress handle. With
    ``local_testing_mode`` the graph runs fully in-process (reference:
    serve/_private/local_testing_mode.py)."""
    if local_testing_mode:
        from ray_tpu_torch.serve.local_testing import run_local
        return run_local(app)
    controller = _get_controller()
    ingress = ray_tpu_torch.get(controller.deploy_application.remote(app))
    _apps[name] = ingress
    return DeploymentHandle(ingress, controller)


def get_deployment_handle(deployment_name: str,
                          app_name: str = "default") -> DeploymentHandle:
    return DeploymentHandle(deployment_name, _get_controller(create=False))

def get_app_handle(app_name: str = "default") -> DeploymentHandle:
    return DeploymentHandle(_apps[app_name], _get_controller(create=False))


def status() -> Dict[str, Any]:
    controller = _get_controller(create=False)
    return ray_tpu_torch.get(controller.status.remote())


def delete(app_name: str) -> None:
    controller = _get_controller(create=False)
    ingress = _apps.pop(app_name, None)
    if ingress:
        ray_tpu_torch.get(controller.delete_deployment.remote(ingress))


def shutdown() -> None:
    global _http_server, _http_thread
    if _http_server is not None:
        if hasattr(_http_server, "shutdown"):
            _http_server.shutdown()     # legacy ThreadingHTTPServer
        else:
            _http_server.stop()         # asyncio proxy
        _http_server = None
        _http_thread = None
    try:
        controller = _get_controller(create=False)
        ray_tpu_torch.get(controller.shutdown.remote())
        ray_tpu_torch.kill(controller)
    except Exception:
        pass
    _apps.clear()


# ---------------------------------------------------------------------------
# HTTP proxy
# ---------------------------------------------------------------------------

class _ProxyHandler(BaseHTTPRequestHandler):
    handles: Dict[str, DeploymentHandle] = {}

    def log_message(self, *args):  # quiet
        pass

    def _route(self) -> Optional[DeploymentHandle]:
        app = self.path.strip("/").split("/")[0] or "default"
        return self.handles.get(app) or self.handles.get("default")

    def _respond(self, code: int, payload: Any) -> None:
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _respond_stream(self, handle, payload) -> None:
        """SSE response (reference: proxy.py:1009 streaming path): each
        replica chunk is flushed as a ``data:`` event the moment it
        arrives — the client reads chunk 1 while generation continues."""
        try:
            gen = handle.options(stream=True).remote(payload)
        except Exception as e:
            self._respond(500, {"error": repr(e)})
            return
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-cache")
        self.end_headers()
        try:
            for chunk in gen:
                self.wfile.write(
                    f"data: {json.dumps(chunk)}\n\n".encode())
                self.wfile.flush()
            self.wfile.write(b"data: [DONE]\n\n")
            self.wfile.flush()
        except (BrokenPipeError, ConnectionResetError):
            pass  # client went away mid-stream
        except Exception as e:
            try:
                self.wfile.write(
                    f"data: {json.dumps({'error': repr(e)})}\n\n".encode())
                self.wfile.flush()
            except OSError:
                pass

    def do_POST(self):
        handle = self._route()
        if handle is None:
            self._respond(404, {"error": "no such application"})
            return
        length = int(self.headers.get("Content-Length", 0))
        raw = self.rfile.read(length) if length else b"{}"
        try:
            payload = json.loads(raw) if raw else {}
        except json.JSONDecodeError:
            payload = raw.decode()
        wants_stream = ("text/event-stream"
                        in self.headers.get("Accept", "")
                        or (isinstance(payload, dict)
                            and payload.get("stream") is True))
        if wants_stream:
            self._respond_stream(handle, payload)
            return
        try:
            result = handle.remote(payload).result(timeout=60)
            self._respond(200, result)
        except Exception as e:
            self._respond(500, {"error": repr(e)})

    def do_GET(self):
        self.do_POST()


def start_http_proxy(port: int = 8000, host: str = "127.0.0.1", *,
                     max_ongoing_requests: int = 200,
                     request_timeout_s: float = 60.0,
                     legacy_threaded: bool = False) -> int:
    """Start the HTTP ingress serving all running applications; returns
    the bound port (0 picks a free one).

    Default plane: the asyncio proxy (``serve/http_proxy.py`` — one
    event loop, keep-alive, SSE streaming, and ingress backpressure
    shedding 503s past ``max_ongoing_requests``; reference:
    ``serve/_private/proxy.py:697``). ``legacy_threaded=True`` keeps the
    old thread-per-connection stdlib server."""
    global _http_server, _http_thread
    if _http_server is not None:
        return (_http_server.server_address[1]
                if hasattr(_http_server, "server_address")
                else _http_server.port)
    controller = _get_controller(create=False)
    handles = {app: DeploymentHandle(ingress, controller)
               for app, ingress in _apps.items()}
    if legacy_threaded:
        _ProxyHandler.handles = handles
        _http_server = ThreadingHTTPServer((host, port), _ProxyHandler)
        _http_thread = threading.Thread(
            target=_http_server.serve_forever, daemon=True)
        _http_thread.start()
        return _http_server.server_address[1]
    from ray_tpu_torch.serve.http_proxy import AsyncHTTPProxy
    _http_server = AsyncHTTPProxy(
        handles, host=host, port=port,
        max_ongoing_requests=max_ongoing_requests,
        request_timeout_s=request_timeout_s)
    return _http_server.start()
