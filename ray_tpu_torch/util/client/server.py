"""The client server (counterpart of ``ray_tpu/util/client/server.py``):
it runs in a driver of the cluster and executes the proxied API calls,
holding refs, functions and actors on the remote drivers' behalf.
"""

from __future__ import annotations

import socket
import threading
import traceback
import uuid
from typing import Any, Dict, Optional, Tuple

import ray_tpu_torch
from ray_tpu_torch.util.client.protocol import recv_msg, send_msg


class ClientServer:
    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(16)
        self.address: Tuple[str, int] = self._sock.getsockname()
        # server-side handle tables (the server owns refs for the client)
        self._refs: Dict[str, Any] = {}
        self._actors: Dict[str, Any] = {}
        self._funcs: Dict[str, Any] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        threading.Thread(target=self._accept_loop, daemon=True,
                         name="client-server").start()

    # -- wire loop -------------------------------------------------------
    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            threading.Thread(target=self._serve_conn, args=(conn,),
                             daemon=True).start()

    def _serve_conn(self, conn: socket.socket) -> None:
        try:
            while True:
                req = recv_msg(conn)
                try:
                    result = self._handle(req)
                    send_msg(conn, {"ok": True, "result": result})
                except Exception as e:
                    send_msg(conn, {
                        "ok": False, "error": repr(e),
                        "traceback": traceback.format_exc()})
        except (ConnectionError, OSError):
            pass
        finally:
            conn.close()

    # -- ops -------------------------------------------------------------
    def _track_ref(self, ref) -> str:
        rid = uuid.uuid4().hex
        with self._lock:
            self._refs[rid] = ref
        return rid

    def _handle(self, req: Dict) -> Any:
        op = req["op"]
        if op == "put":
            return self._track_ref(ray_tpu_torch.put(req["value"]))
        if op == "get":
            refs = [self._refs[r] for r in req["ref_ids"]]
            values = ray_tpu_torch.get(refs, timeout=req.get("timeout"))
            return values
        if op == "wait":
            refs = [self._refs[r] for r in req["ref_ids"]]
            ready, not_ready = ray_tpu_torch.wait(
                refs, num_returns=req["num_returns"],
                timeout=req.get("timeout"))
            id_of = {id(v): k for k, v in self._refs.items()}
            return ([id_of[id(r)] for r in ready],
                    [id_of[id(r)] for r in not_ready])
        if op == "register_function":
            self._funcs[req["func_id"]] = ray_tpu_torch.remote(req["func"])
            return True
        if op == "task":
            fn = self._funcs[req["func_id"]]
            if req.get("options"):
                fn = fn.options(**req["options"])
            args = self._unwrap_args(req["args"])
            ref = fn.remote(*args, **req.get("kwargs", {}))
            return self._track_ref(ref)
        if op == "create_actor":
            cls = ray_tpu_torch.remote(req["cls"])
            if req.get("options"):
                cls = cls.options(**req["options"])
            args = self._unwrap_args(req["args"])
            handle = cls.remote(*args, **req.get("kwargs", {}))
            aid = uuid.uuid4().hex
            self._actors[aid] = handle
            return aid
        if op == "actor_call":
            handle = self._actors[req["actor_id"]]
            method = getattr(handle, req["method"])
            args = self._unwrap_args(req["args"])
            return self._track_ref(method.remote(*args,
                                                 **req.get("kwargs", {})))
        if op == "kill_actor":
            ray_tpu_torch.kill(self._actors.pop(req["actor_id"]))
            return True
        if op == "release":
            with self._lock:
                for rid in req["ref_ids"]:
                    self._refs.pop(rid, None)
            return True
        if op == "cluster_resources":
            return ray_tpu_torch.cluster_resources()
        if op == "available_resources":
            return ray_tpu_torch.available_resources()
        if op == "ping":
            return "pong"
        raise ValueError(f"unknown op {op!r}")

    def _unwrap_args(self, args):
        out = []
        for a in args:
            if isinstance(a, dict) and a.get("__client_ref__"):
                out.append(self._refs[a["ref_id"]])
            else:
                out.append(a)
        return out

    def shutdown(self) -> None:
        self._stop.set()
        try:
            self._sock.close()
        except OSError:
            pass


def serve_cluster(host: str = "127.0.0.1", port: int = 0,
                  num_nodes: int = 1) -> ClientServer:
    """Boot a runtime (if needed) and serve it to remote drivers."""
    if not ray_tpu_torch.is_initialized():
        ray_tpu_torch.init(num_nodes=num_nodes)
    return ClientServer(host, port)
