"""Actor pool utility (counterpart of ``ray_tpu/util/actor_pool.py``, the
port's own copy of that JAX-free module; reference:
python/ray/util/actor_pool.py)."""

from __future__ import annotations

from typing import Any, Callable, Iterable, List, Optional

import ray_tpu_torch


class ActorPool:
    """Round-robins work over a fixed set of actors."""

    def __init__(self, actors: List[Any]):
        self._idle = list(actors)
        self._future_to_actor = {}
        self._index_to_future = {}
        self._next_task_index = 0
        self._next_return_index = 0

    def map(self, fn: Callable, values: Iterable[Any]):
        for v in values:
            self.submit(fn, v)
        while self.has_next():
            yield self.get_next()

    def map_unordered(self, fn: Callable, values: Iterable[Any]):
        for v in values:
            self.submit(fn, v)
        while self.has_next():
            yield self.get_next_unordered()

    def submit(self, fn: Callable, value: Any) -> None:
        if not self._idle:
            # Wait for any in-flight result to free an actor.
            refs = list(self._future_to_actor)
            ready, _ = ray_tpu_torch.wait(refs, num_returns=1)
            self._return_actor_of(ready[0])
        actor = self._idle.pop()
        ref = fn(actor, value)
        self._future_to_actor[ref] = actor
        self._index_to_future[self._next_task_index] = ref
        self._next_task_index += 1

    def has_next(self) -> bool:
        return bool(self._index_to_future)

    def get_next(self, timeout: Optional[float] = None) -> Any:
        if not self.has_next():
            raise StopIteration("no pending results")
        # Wait before consuming the index so a timeout is retryable.
        ref = self._index_to_future[self._next_return_index]
        if timeout is not None:
            ready, _ = ray_tpu_torch.wait([ref], num_returns=1,
                                          timeout=timeout)
            if not ready:
                raise TimeoutError("next result not ready within timeout")
        del self._index_to_future[self._next_return_index]
        self._next_return_index += 1
        value = ray_tpu_torch.get(ref)
        self._return_actor_of(ref)
        return value

    def get_next_unordered(self, timeout: Optional[float] = None) -> Any:
        if not self.has_next():
            raise StopIteration("no pending results")
        refs = list(self._index_to_future.values())
        ready, _ = ray_tpu_torch.wait(refs, num_returns=1, timeout=timeout)
        if not ready:
            raise TimeoutError("no result within timeout")
        ref = ready[0]
        for idx, r in list(self._index_to_future.items()):
            if r == ref:
                del self._index_to_future[idx]
                break
        value = ray_tpu_torch.get(ref)
        self._return_actor_of(ref)
        return value

    def _return_actor_of(self, ref) -> None:
        actor = self._future_to_actor.pop(ref, None)
        if actor is not None:
            self._idle.append(actor)

    def push(self, actor: Any) -> None:
        self._idle.append(actor)

    def pop_idle(self) -> Optional[Any]:
        return self._idle.pop() if self._idle else None
