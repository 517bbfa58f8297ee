"""The thin client, the remote-driver side of ``ray://`` mode
(counterpart of ``ray_tpu/util/client/client.py``): ``ClusterClient``
mirrors the core API over the wire, with ``ClientObjectRef`` and
``ClientActorHandle`` proxies for what the server holds.
"""

from __future__ import annotations

import socket
import threading
import uuid
from typing import Any, Dict, List, Optional, Sequence, Union

from ray_tpu_torch.util.client.protocol import recv_msg, send_msg


class ClientObjectRef:
    def __init__(self, client: "ClusterClient", ref_id: str):
        self._client = client
        self.ref_id = ref_id

    def __repr__(self):
        return f"ClientObjectRef({self.ref_id[:12]})"


class ClientActorMethod:
    def __init__(self, client, actor_id: str, name: str):
        self._client = client
        self._actor_id = actor_id
        self._name = name

    def remote(self, *args, **kwargs) -> ClientObjectRef:
        return self._client._actor_call(self._actor_id, self._name, args,
                                        kwargs)


class ClientActorHandle:
    def __init__(self, client, actor_id: str):
        self._client = client
        self._actor_id = actor_id

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        return ClientActorMethod(self._client, self._actor_id, name)


class ClientRemoteFunction:
    def __init__(self, client, func, options: Optional[Dict] = None):
        self._client = client
        self._func = func
        self._func_id = uuid.uuid4().hex
        self._options = options
        self._registered = False

    def options(self, **opts) -> "ClientRemoteFunction":
        out = ClientRemoteFunction(self._client, self._func, opts)
        out._func_id = self._func_id
        out._registered = self._registered
        return out

    def remote(self, *args, **kwargs) -> ClientObjectRef:
        if not self._registered:
            self._client._call("register_function",
                               func_id=self._func_id, func=self._func)
            self._registered = True
        rid = self._client._call(
            "task", func_id=self._func_id,
            args=self._client._wrap_args(args), kwargs=kwargs,
            options=self._options)
        return ClientObjectRef(self._client, rid)


class ClientActorClass:
    def __init__(self, client, cls, options: Optional[Dict] = None):
        self._client = client
        self._cls = cls
        self._options = options

    def options(self, **opts) -> "ClientActorClass":
        return ClientActorClass(self._client, self._cls, opts)

    def remote(self, *args, **kwargs) -> ClientActorHandle:
        aid = self._client._call(
            "create_actor", cls=self._cls,
            args=self._client._wrap_args(args), kwargs=kwargs,
            options=self._options)
        return ClientActorHandle(self._client, aid)


class ClusterClient:
    """Mirrors the core API over the wire."""

    def __init__(self, address: str):
        host, _, port = address.partition(":")
        self._sock = socket.create_connection((host, int(port)), timeout=60)
        self._lock = threading.Lock()
        assert self._call("ping") == "pong"

    # -- plumbing --------------------------------------------------------
    def _call(self, op: str, **kwargs) -> Any:
        with self._lock:
            send_msg(self._sock, {"op": op, **kwargs})
            resp = recv_msg(self._sock)
        if not resp["ok"]:
            raise RuntimeError(
                f"server error: {resp['error']}\n{resp['traceback']}")
        return resp["result"]

    def _wrap_args(self, args):
        out = []
        for a in args:
            if isinstance(a, ClientObjectRef):
                out.append({"__client_ref__": True, "ref_id": a.ref_id})
            else:
                out.append(a)
        return out

    def _actor_call(self, actor_id, method, args, kwargs):
        rid = self._call("actor_call", actor_id=actor_id, method=method,
                         args=self._wrap_args(args), kwargs=kwargs)
        return ClientObjectRef(self, rid)

    # -- API -------------------------------------------------------------
    def put(self, value: Any) -> ClientObjectRef:
        return ClientObjectRef(self, self._call("put", value=value))

    def get(self, refs: Union[ClientObjectRef, Sequence[ClientObjectRef]],
            *, timeout: Optional[float] = None):
        single = isinstance(refs, ClientObjectRef)
        ref_list = [refs] if single else list(refs)
        values = self._call("get", ref_ids=[r.ref_id for r in ref_list],
                            timeout=timeout)
        return values[0] if single else values

    def wait(self, refs: Sequence[ClientObjectRef], *, num_returns: int = 1,
             timeout: Optional[float] = None):
        ready_ids, rest_ids = self._call(
            "wait", ref_ids=[r.ref_id for r in refs],
            num_returns=num_returns, timeout=timeout)
        by_id = {r.ref_id: r for r in refs}
        return ([by_id[i] for i in ready_ids],
                [by_id[i] for i in rest_ids])

    def remote(self, func_or_class):
        import inspect
        if inspect.isclass(func_or_class):
            return ClientActorClass(self, func_or_class)
        return ClientRemoteFunction(self, func_or_class)

    def kill(self, actor: ClientActorHandle) -> None:
        self._call("kill_actor", actor_id=actor._actor_id)

    def cluster_resources(self) -> Dict[str, float]:
        return self._call("cluster_resources")

    def available_resources(self) -> Dict[str, float]:
        return self._call("available_resources")

    def release(self, refs: List[ClientObjectRef]) -> None:
        self._call("release", ref_ids=[r.ref_id for r in refs])

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass


def connect(address: str) -> ClusterClient:
    """`ray_tpu_torch.util.client.connect("host:port")` — remote-driver mode."""
    return ClusterClient(address)
