"""``@remote`` functions (counterpart of ``ray_tpu/remote_function.py``)."""

from __future__ import annotations

import functools
import inspect
import threading
from typing import Any, Dict, List, Optional, Union

from ray_tpu_torch._private import worker
from ray_tpu_torch._private.ids import ObjectID, TaskID
from ray_tpu_torch._private.object_ref import ObjectRef
from ray_tpu_torch._private.runtime_env_packaging import \
    prepare_runtime_env as _prepare_runtime_env
from ray_tpu_torch._private.task_spec import (DEFAULT_TASK_OPTIONS, TaskKind,
                                              TaskSpec,
                                              resources_from_options,
                                              strategy_from_options,
                                              validate_options)
from ray_tpu_torch.tenancy import context as _tenancy_ctx


class ObjectRefGenerator:
    """Iterator over the streamed returns of a generator task.

    Each ``next()`` yields an ObjectRef as soon as the producer reports the
    item — before the task finishes.
    """

    def __init__(self, task_id: TaskID):
        self._task_id = task_id
        self._index = 0
        # several threads may share one generator; index claims must be
        # atomic or items are delivered twice, and a claim that errors
        # (timeout) returns to the hole set so another consumer re-claims it
        self._lock = threading.Lock()
        self._holes: set = set()

    def __getstate__(self):
        return {"_task_id": self._task_id, "_index": self._index,
                "_holes": set(self._holes)}

    def __setstate__(self, d):
        self._task_id = d["_task_id"]
        self._index = d["_index"]
        self._holes = set(d.get("_holes", ()))
        self._lock = threading.Lock()

    def __iter__(self) -> "ObjectRefGenerator":
        return self

    def __next__(self) -> ObjectRef:
        return self.next()

    def next(self, timeout: Optional[float] = None) -> ObjectRef:
        """``next(gen)`` with a deadline: raises ``GetTimeoutError`` after
        ``timeout`` seconds; the claimed index returns to the hole set so a
        retry (or another consumer) re-claims it."""
        rt = worker.global_worker()
        state = rt.generator_state(self._task_id)
        with self._lock:
            if self._holes:
                index = min(self._holes)
                self._holes.discard(index)
            else:
                index = self._index
                self._index += 1
        try:
            return state.next_ref(index, timeout=timeout)
        except BaseException:
            with self._lock:
                self._holes.add(index)
            raise

    def __aiter__(self):
        return self

    async def __anext__(self):
        import asyncio
        loop = asyncio.get_event_loop()
        try:
            return await loop.run_in_executor(None, self.__next__)
        except StopIteration:
            raise StopAsyncIteration

    def completed(self) -> bool:
        rt = worker.global_worker()
        return rt.generator_state(self._task_id).finished


class RemoteFunction:
    def __init__(self, func, default_options: Dict[str, Any]):
        self._function = func
        merged = dict(DEFAULT_TASK_OPTIONS)
        merged.update(default_options)
        self._default_options = validate_options(merged, for_actor=False)
        functools.update_wrapper(self, func)

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"remote function {self._function.__name__} cannot be called "
            f"directly; use {self._function.__name__}.remote()")

    def options(self, **options) -> "_OptionsWrapper":
        merged = dict(self._default_options)
        merged.update(options)
        validate_options(merged, for_actor=False)
        return _OptionsWrapper(self, merged)

    def remote(self, *args, **kwargs):
        return self._remote(args, kwargs, self._default_options)

    def bind(self, *args, **kwargs):
        """Build a DAG node (``ray_tpu_torch.dag``)."""
        from ray_tpu_torch.dag.node import FunctionNode
        return FunctionNode(self, args, kwargs)

    @property
    def _function_name(self) -> str:
        return getattr(self._function, "__name__", "fn")

    def _remote(self, args, kwargs, options) -> Union[ObjectRef,
                                                      List[ObjectRef],
                                                      ObjectRefGenerator]:
        rt = worker.global_worker()
        num_returns = options.get("num_returns", 1)
        if (num_returns == 1
                and inspect.isgeneratorfunction(self._function)):
            num_returns = "streaming"
        n_ids = 1 if not isinstance(num_returns, int) else max(num_returns, 1)
        task_id = TaskID.from_random()
        spec = TaskSpec(
            task_id=task_id,
            kind=TaskKind.NORMAL,
            name=options.get("name") or self._function.__qualname__,
            func=self._function,
            args=tuple(args),
            kwargs=dict(kwargs),
            resources=resources_from_options(options),
            num_returns=num_returns,
            return_ids=[ObjectID.from_random() for _ in range(n_ids)],
            max_retries=options.get("max_retries", 3),
            retry_exceptions=options.get("retry_exceptions", False),
            runtime_env=_prepare_runtime_env(
                options.get("runtime_env")),
            scheduling_strategy=worker.capture_parent_pg_strategy(
                strategy_from_options(options)),
            job_id=_tenancy_ctx.current_job_id(rt),
            backpressure_num_objects=options.get(
                "_generator_backpressure_num_objects", -1),
            label_selector=options.get("label_selector"),
            in_process=bool(options.get("_in_process")),
        )
        refs = rt.submit_task(spec)
        if num_returns == "streaming":
            return ObjectRefGenerator(task_id)
        if isinstance(num_returns, int) and num_returns != 1:
            return refs if num_returns > 0 else None
        return refs[0]


class _OptionsWrapper:
    def __init__(self, remote_fn: RemoteFunction, options: Dict[str, Any]):
        self._remote_fn = remote_fn
        self._options = options

    def remote(self, *args, **kwargs):
        return self._remote_fn._remote(args, kwargs, self._options)
