"""Actor classes and handles (counterpart of ``ray_tpu/actor.py``)."""

from __future__ import annotations

import functools
from typing import Any, Dict, Optional

from ray_tpu_torch import exceptions as exc
from ray_tpu_torch._private import worker
from ray_tpu_torch._private.ids import ActorID, ObjectID, TaskID, next_seqno
from ray_tpu_torch._private.task_spec import (DEFAULT_ACTOR_OPTIONS, TaskKind,
                                              TaskSpec,
                                              resources_from_options,
                                              strategy_from_options,
                                              validate_options)
from ray_tpu_torch._private.runtime_env_packaging import \
    prepare_runtime_env as _prepare_runtime_env
from ray_tpu_torch.tenancy import context as _tenancy_ctx


class ActorMethod:
    """Bound remote method on an actor handle."""

    def __init__(self, handle: "ActorHandle", method_name: str,
                 options: Optional[Dict[str, Any]] = None):
        self._handle = handle
        self._method_name = method_name
        self._options = options or {}

    def options(self, **opts) -> "ActorMethod":
        merged = dict(self._options)
        merged.update(opts)
        return ActorMethod(self._handle, self._method_name, merged)

    def remote(self, *args, **kwargs):
        return self._handle._submit_method(
            self._method_name, args, kwargs, self._options)

    def bind(self, *args, **kwargs):
        """Build a DAG node (``ray_tpu_torch.dag``)."""
        from ray_tpu_torch.dag.node import ClassMethodNode
        return ClassMethodNode(self._handle, self._method_name, args,
                               kwargs)

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"actor method {self._method_name} cannot be called directly; "
            f"use .remote()")


class ActorHandle:
    """Handle to a live actor. ``handle.m.remote(...)`` calls method ``m``;
    ``handle.__call__.remote(...)`` calls the instance itself (a callable
    actor such as ``LLMServer``), where the reference's handle reaches no
    name that starts with ``_``."""

    def __init__(self, actor_id: ActorID, class_name: str = "Actor",
                 method_options: Optional[Dict[str, Dict[str, Any]]] = None):
        self._actor_id = actor_id
        self._class_name = class_name
        self._method_options = method_options or {}

    @property
    def _ray_actor_id(self) -> ActorID:
        return self._actor_id

    def __getattr__(self, name: str) -> ActorMethod:
        if name.startswith("_") and name != "__call__":
            raise AttributeError(name)
        return ActorMethod(self, name,
                           dict(self._method_options.get(name, {})))

    def __repr__(self):
        return f"ActorHandle({self._class_name}, {self._actor_id.hex()[:12]})"

    def __reduce__(self):
        return (ActorHandle,
                (self._actor_id, self._class_name, self._method_options))

    def __hash__(self):
        return hash(self._actor_id)

    def __eq__(self, other):
        return (isinstance(other, ActorHandle)
                and other._actor_id == self._actor_id)

    def _submit_method(self, method_name: str, args, kwargs,
                       options: Dict[str, Any]):
        rt = worker.global_worker()
        info = rt.gcs.get_actor_info(self._actor_id)
        if info is None:
            raise ValueError(f"unknown actor {self._actor_id}")
        # max_pending_calls backpressure
        with rt._actor_lock:
            executor = rt._actor_executors.get(self._actor_id)
        spec_limit = getattr(info.creation_spec, "max_pending_calls", -1) \
            if info.creation_spec else -1
        if (spec_limit and spec_limit > 0 and executor is not None
                and executor.num_pending >= spec_limit):
            raise exc.PendingCallsLimitExceeded(
                f"actor has {executor.num_pending} pending calls "
                f"(max_pending_calls={spec_limit})")

        num_returns = options.get("num_returns", 1)
        n_ids = 1 if not isinstance(num_returns, int) else max(num_returns, 1)
        task_id = TaskID.from_random()
        spec = TaskSpec(
            task_id=task_id,
            kind=TaskKind.ACTOR_TASK,
            name=f"{self._class_name}.{method_name}",
            func=None,
            args=tuple(args),
            kwargs=dict(kwargs),
            resources={},
            num_returns=num_returns,
            return_ids=[ObjectID.from_random() for _ in range(n_ids)],
            max_retries=info.max_task_retries,
            scheduling_strategy="DEFAULT",
            job_id=_tenancy_ctx.current_job_id(rt),
            actor_id=self._actor_id,
            method_name=method_name,
            seqno=next_seqno(),
            concurrency_group=options.get("concurrency_group", ""),
        )
        refs = rt.submit_task(spec)
        if num_returns == "streaming":
            from ray_tpu_torch.remote_function import ObjectRefGenerator
            return ObjectRefGenerator(task_id)
        if isinstance(num_returns, int) and num_returns != 1:
            return refs if num_returns > 0 else None
        return refs[0]


class ActorClass:
    def __init__(self, cls: type, default_options: Dict[str, Any]):
        self._cls = cls
        merged = dict(DEFAULT_ACTOR_OPTIONS)
        merged.update(default_options)
        self._default_options = validate_options(merged, for_actor=True)
        # Per-method defaults declared with @ray_tpu_torch.method(**opts).
        self._method_options: Dict[str, Dict[str, Any]] = {}
        for name in dir(cls):
            m = getattr(cls, name, None)
            opts = getattr(m, "__ray_tpu_method_options__", None)
            if opts:
                self._method_options[name] = dict(opts)
        functools.update_wrapper(self, cls, updated=[])

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"actor class {self._cls.__name__} cannot be instantiated "
            f"directly; use {self._cls.__name__}.remote()")

    def options(self, **options) -> "_ActorOptionsWrapper":
        merged = dict(self._default_options)
        merged.update(options)
        validate_options(merged, for_actor=True)
        return _ActorOptionsWrapper(self, merged)

    def remote(self, *args, **kwargs) -> ActorHandle:
        return self._remote(args, kwargs, self._default_options)

    def _remote(self, args, kwargs, options) -> ActorHandle:
        rt = worker.global_worker()
        name = options.get("name")
        namespace = options.get("namespace") or rt.namespace
        actor_id = ActorID.from_random()
        spec = TaskSpec(
            task_id=TaskID.from_random(),
            kind=TaskKind.ACTOR_CREATION,
            runtime_env=_prepare_runtime_env(
                options.get("runtime_env")),
            name=f"{self._cls.__name__}.__init__",
            func=self._cls,
            args=tuple(args),
            kwargs=dict(kwargs),
            resources=resources_from_options(options),
            num_returns=1,
            return_ids=[ObjectID.from_random()],
            scheduling_strategy=worker.capture_parent_pg_strategy(
                strategy_from_options(options)),
            job_id=_tenancy_ctx.current_job_id(rt),
            actor_id=actor_id,
            max_restarts=options.get("max_restarts", 0),
            max_task_retries=options.get("max_task_retries", 0),
            max_concurrency=options.get("max_concurrency", 1),
            max_pending_calls=options.get("max_pending_calls", -1),
            concurrency_groups=options.get("concurrency_groups"),
            lifetime=options.get("lifetime"),
            actor_name=name,
            namespace=namespace,
            label_selector=options.get("label_selector"),
            in_process=bool(options.get("_in_process")),
            method_options=dict(self._method_options),
        )
        real_id = rt.create_actor(
            spec, get_if_exists=bool(options.get("get_if_exists")))
        if real_id != actor_id:  # got an existing named actor
            info = rt.gcs.get_actor_info(real_id)
            return ActorHandle(real_id,
                               info.class_name if info else "Actor",
                               dict(info.method_options) if info else None)
        return ActorHandle(actor_id, self._cls.__name__,
                           dict(self._method_options))


class _ActorOptionsWrapper:
    def __init__(self, actor_cls: ActorClass, options: Dict[str, Any]):
        self._actor_cls = actor_cls
        self._options = options

    def remote(self, *args, **kwargs) -> ActorHandle:
        return self._actor_cls._remote(args, kwargs, self._options)


def get_actor(name: str, namespace: Optional[str] = None) -> ActorHandle:
    rt = worker.global_worker()
    ns = namespace or rt.namespace
    actor_id = rt.gcs.get_named_actor(name, ns)
    if actor_id is None:
        raise ValueError(
            f"failed to look up actor {name!r} in namespace {ns!r}")
    info = rt.gcs.get_actor_info(actor_id)
    return ActorHandle(actor_id, info.class_name if info else "Actor",
                       dict(info.method_options) if info else None)


def exit_actor() -> None:
    """Terminate the current actor from inside one of its methods."""
    from ray_tpu_torch._private.worker import _ExitActor
    raise _ExitActor()
