"""Cross-language API: export Python callables for non-Python clients
(counterpart of ``ray_tpu/xlang.py``).

Functions and actor classes are exported under stable names to the
cluster's KV; a C++ client (``csrc/cpp_client.cc``: ``rtc_submit_task``,
``rtc_create_actor``, ``rtc_call_actor``) submits by name with plain
arguments and receives plain results. Execution happens on a daemon's
pooled Python workers.

The exported callable goes to the KV as a blob of the port's by-value
pickler (``_private/serialization.py``; JAX's is ``cloudpickle``).
Arguments and results are plain values only (None, bool, int, float, str,
bytes, lists, and dicts with str keys) in the wire's frame encoding
(``_private/rpc.py``; JAX's is msgpack): no pickle of a user object
crosses the language boundary.
"""

from __future__ import annotations

from typing import Any, Callable

from ray_tpu_torch._private import serialization


def _kv_put(key: str, blob: bytes) -> None:
    from ray_tpu_torch._private import worker

    rt = worker.global_runtime()
    if rt is None:
        raise RuntimeError("ray_tpu_torch.init() first")
    head = getattr(getattr(rt, "cluster_backend", None), "head", None)
    if head is not None:          # daemons: the KV the C++ clients see
        head.kv_put(key.encode(), blob)
        return
    rt.gcs.kv_put(key.encode(), blob)


def export_task(name: str, fn: Callable) -> None:
    """Make ``fn`` invocable by name from non-Python clients
    (C++: ``rtc_submit_task(h, name, args)``)."""
    _kv_put(f"xlang:fn:{name}", serialization.dumps(fn))


def export_actor_class(name: str, cls: Any) -> None:
    """Make ``cls`` instantiable by name from non-Python clients
    (C++: ``rtc_create_actor(h, cls_name, actor_name, args)`` then
    ``rtc_call_actor(h, actor_name, method, args)``)."""
    _kv_put(f"xlang:actor:{name}", serialization.dumps(cls))
