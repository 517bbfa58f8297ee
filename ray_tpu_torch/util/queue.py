"""Actor-backed distributed queue (counterpart of ``ray_tpu/util/queue.py``,
the port's own copy of that JAX-free module; reference:
python/ray/util/queue.py). The queue is an async actor over
``asyncio.Queue``; on the in-process runtime an item is held, not copied,
so a CUDA tensor put on the queue is the same tensor when it is taken."""

from __future__ import annotations

import asyncio
from typing import Any, List, Optional

import ray_tpu_torch


class Empty(Exception):
    pass


class Full(Exception):
    pass


@ray_tpu_torch.remote(max_concurrency=64)
class _QueueActor:
    def __init__(self, maxsize: int):
        self.q = asyncio.Queue(maxsize=maxsize)

    async def put(self, item, timeout=None):
        try:
            await asyncio.wait_for(self.q.put(item), timeout)
            return True
        except asyncio.TimeoutError:
            return False

    async def get(self, timeout=None):
        try:
            return True, await asyncio.wait_for(self.q.get(), timeout)
        except asyncio.TimeoutError:
            return False, None

    def put_nowait(self, item):
        try:
            self.q.put_nowait(item)
            return True
        except asyncio.QueueFull:
            return False

    def get_nowait(self):
        try:
            return True, self.q.get_nowait()
        except asyncio.QueueEmpty:
            return False, None

    async def get_item(self):
        return await self.q.get()

    def qsize(self):
        return self.q.qsize()

    def empty(self):
        return self.q.empty()

    def full(self):
        return self.q.full()


class Queue:
    """Multi-producer multi-consumer queue shared across tasks/actors."""

    def __init__(self, maxsize: int = 0,
                 actor_options: Optional[dict] = None):
        self.maxsize = maxsize
        opts = actor_options or {}
        self.actor = (_QueueActor.options(**opts).remote(maxsize)
                      if opts else _QueueActor.remote(maxsize))

    def put(self, item: Any, block: bool = True,
            timeout: Optional[float] = None) -> None:
        if not block:
            if not ray_tpu_torch.get(self.actor.put_nowait.remote(item)):
                raise Full("queue is full")
            return
        if not ray_tpu_torch.get(self.actor.put.remote(item, timeout)):
            raise Full("queue is full (timeout)")

    def get(self, block: bool = True,
            timeout: Optional[float] = None) -> Any:
        if not block:
            ok, item = ray_tpu_torch.get(self.actor.get_nowait.remote())
            if not ok:
                raise Empty("queue is empty")
            return item
        ok, item = ray_tpu_torch.get(self.actor.get.remote(timeout))
        if not ok:
            raise Empty("queue is empty (timeout)")
        return item

    def put_nowait(self, item: Any) -> None:
        self.put(item, block=False)

    def get_nowait(self) -> Any:
        return self.get(block=False)

    def qsize(self) -> int:
        return ray_tpu_torch.get(self.actor.qsize.remote())

    def empty(self) -> bool:
        return ray_tpu_torch.get(self.actor.empty.remote())

    def full(self) -> bool:
        return ray_tpu_torch.get(self.actor.full.remote())

    def put_async(self, item: Any):
        return self.actor.put.remote(item)

    def get_async(self):
        """Ref resolving to the item itself (same contract as get())."""
        return self.actor.get_item.remote()

    def shutdown(self) -> None:
        ray_tpu_torch.kill(self.actor)
