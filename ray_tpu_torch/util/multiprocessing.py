"""multiprocessing.Pool shim over tasks (counterpart of
``ray_tpu/util/multiprocessing.py``, the port's own copy of that JAX-free
module; reference: `python/ray/util/multiprocessing/pool.py` — drop-in Pool
running on the cluster)."""

from __future__ import annotations

from typing import Any, Callable, Iterable, List, Optional

import ray_tpu_torch


class AsyncResult:
    def __init__(self, refs: List, single: bool):
        self._refs = refs
        self._single = single

    def get(self, timeout: Optional[float] = None):
        vals = ray_tpu_torch.get(self._refs, timeout=timeout)
        return vals[0] if self._single else vals

    def wait(self, timeout: Optional[float] = None) -> None:
        ray_tpu_torch.wait(self._refs, num_returns=len(self._refs),
                     timeout=timeout)

    def ready(self) -> bool:
        ready, _ = ray_tpu_torch.wait(self._refs, num_returns=len(self._refs),
                                timeout=0)
        return len(ready) == len(self._refs)


class Pool:
    """Subset of multiprocessing.Pool: map/starmap/imap/apply (+_async)."""

    def __init__(self, processes: Optional[int] = None):
        if not ray_tpu_torch.is_initialized():
            ray_tpu_torch.init()
        self._size = processes or int(
            ray_tpu_torch.cluster_resources().get("CPU", 4))
        self._closed = False

    def _task(self, func: Callable):
        return ray_tpu_torch.remote(func)

    def apply(self, func, args=(), kwds=None):
        return self.apply_async(func, args, kwds).get()

    def apply_async(self, func, args=(), kwds=None) -> AsyncResult:
        ref = self._task(func).remote(*args, **(kwds or {}))
        return AsyncResult([ref], single=True)

    def map(self, func, iterable: Iterable, chunksize: Optional[int] = None
            ) -> List[Any]:
        return self.map_async(func, iterable, chunksize).get()

    def map_async(self, func, iterable: Iterable,
                  chunksize: Optional[int] = None) -> AsyncResult:
        f = self._task(func)
        return AsyncResult([f.remote(x) for x in iterable], single=False)

    def starmap(self, func, iterable: Iterable) -> List[Any]:
        f = self._task(func)
        return ray_tpu_torch.get([f.remote(*args) for args in iterable])

    def imap(self, func, iterable: Iterable, chunksize: int = 1):
        f = self._task(func)
        refs = [f.remote(x) for x in iterable]
        for ref in refs:
            yield ray_tpu_torch.get(ref)

    def imap_unordered(self, func, iterable: Iterable, chunksize: int = 1):
        f = self._task(func)
        pending = [f.remote(x) for x in iterable]
        while pending:
            done, pending = ray_tpu_torch.wait(pending, num_returns=1)
            yield ray_tpu_torch.get(done[0])

    def close(self) -> None:
        self._closed = True

    def terminate(self) -> None:
        self._closed = True

    def join(self) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.terminate()
