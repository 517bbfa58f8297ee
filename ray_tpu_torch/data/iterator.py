"""Data iteration: batches with prefetch, and the device feed (counterpart
of ``ray_tpu/data/iterator.py``).

Reference: `python/ray/data/iterator.py:106` (iter_batches with
prefetch_batches, formats, local shuffle). ``iter_batches`` and
``iter_torch_batches`` are JAX's. ``to_jax`` keeps JAX's name and
arguments; where JAX ``device_put``s batch N+1 while batch N computes, the
port stages each batch in pinned host memory (in the prefetch thread) and
copies it to the card on a side CUDA stream, so the copy of batch N+1
overlaps the step on batch N.

One departure: JAX's prefetch thread blocks for ever on its full queue once
the consumer stops early (a train loop that breaks out of its epoch), and
holds the stream's blocks and operators with it. Here the thread stops and
closes the stream when the consumer's iterator is closed (ROADMAP C12).
"""

from __future__ import annotations

import collections
import queue
import threading
from typing import Any, Callable, Dict, Iterator, List, Optional

import numpy as np

from ray_tpu_torch.data.block import Block, BlockAccessor, concat_blocks


def _batches_from_blocks(block_iter: Iterator[Block], batch_size:
                         Optional[int], batch_format: str,
                         drop_last: bool,
                         shuffle_buffer_size: Optional[int] = None,
                         shuffle_seed: Optional[int] = None):
    """Re-chunk a stream of blocks into fixed-size batches."""
    rng = np.random.default_rng(shuffle_seed)
    buffer: List[Block] = []
    buffered = 0

    def emit(table: Block):
        return BlockAccessor(table).to_batch(batch_format)

    carry: Optional[Block] = None
    for block in block_iter:
        if block.num_rows == 0:
            continue
        if shuffle_buffer_size:
            buffer.append(block)
            buffered += block.num_rows
            if buffered < shuffle_buffer_size:
                continue
            block = concat_blocks(buffer)
            block = block.take(rng.permutation(block.num_rows))
            buffer, buffered = [], 0
        carry = block if carry is None else concat_blocks([carry, block])
        if batch_size is None:
            yield emit(carry)
            carry = None
            continue
        while carry is not None and carry.num_rows >= batch_size:
            yield emit(carry.slice(0, batch_size))
            rest = carry.slice(batch_size, carry.num_rows - batch_size)
            carry = rest if rest.num_rows else None
    if buffer:
        block = concat_blocks(buffer)
        block = block.take(rng.permutation(block.num_rows))
        carry = block if carry is None else concat_blocks([carry, block])
        while (carry is not None and batch_size is not None
               and carry.num_rows >= batch_size):
            yield emit(carry.slice(0, batch_size))
            rest = carry.slice(batch_size, carry.num_rows - batch_size)
            carry = rest if rest.num_rows else None
    if carry is not None and carry.num_rows and not drop_last:
        yield emit(carry)


def _prefetched(it: Iterator, n: int) -> Iterator:
    """Run the upstream iterator in a thread, buffering up to n items. When
    this iterator is closed before the end, the thread stops at its next
    item and closes the upstream."""
    if n <= 0:
        yield from it
        return
    q: queue.Queue = queue.Queue(maxsize=n)
    DONE = object()
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def pump():
        try:
            for item in it:
                if not put(item):
                    return
            put(DONE)
        except BaseException as e:  # propagate into consumer
            put(e)
        finally:
            close = getattr(it, "close", None)
            if close is not None:
                close()

    t = threading.Thread(target=pump, daemon=True, name="data-prefetch")
    t.start()
    try:
        while True:
            item = q.get()
            if item is DONE:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()


def _rebuild_strided_iterator(dataset, n: int, index: int
                              ) -> "DataIterator":
    """Pickle-side reconstruction of a streaming_split shard: a
    process-local pass over the blocks whose ARRIVAL index is
    ``index (mod n)``. The in-process shards share ONE execution behind
    a lock; a shard that crossed a process boundary cannot share that
    generator, so it degrades to its own pass over the same disjoint,
    covering strided subset."""
    def pull():
        for j, block in enumerate(dataset.iter_blocks()):
            if j % n == index:
                yield block

    return DataIterator(pull, pickle_recipe=(dataset, n, index))


class _CudaFeed:
    """Host-to-card copies of batches through a ring of pinned staging
    buffers (``slots`` of them, one pinned tensor a column in each, made at
    the first batch's shape).

    ``stage`` runs in the prefetch thread: it takes a free slot, waits for
    that slot's last copy to finish, then writes the batch into the slot's
    pinned buffers (casting to a numpy ``dtypes`` entry on the way).
    ``launch`` runs in the consumer: it issues the non-blocking copies (and
    the casts to torch dtypes, and the placement on a mesh) on a side
    stream, records an event, and hands the slot back with that event.
    ``hand_over`` makes the consumer's stream wait for the event and marks
    each tensor as used there. A copy that fails raises; there is no
    pageable or synchronous path."""

    def __init__(self, device, slots: int):
        import torch
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self._free: queue.Queue = queue.Queue()
        for i in range(slots):
            self._free.put((i, None))
        self._buffers: List[Dict[str, Any]] = [{} for _ in range(slots)]

    def stage(self, batch: Dict[str, np.ndarray],
              host_dtypes: Dict[str, np.dtype]):
        import torch
        slot, done = self._free.get()
        if done is not None:
            done.synchronize()
        buffers = self._buffers[slot]
        staged = {}
        for name, v in batch.items():
            dtype = host_dtypes.get(name, v.dtype)
            if dtype == object:
                raise TypeError(f"column {name!r} holds Python objects, "
                                f"which cannot be copied to the card")
            buf = buffers.get(name)
            if (buf is None or buf.shape[1:] != v.shape[1:]
                    or buf.shape[0] < len(v)
                    or buf.numpy().dtype != dtype):
                tdtype = torch.from_numpy(np.empty(0, dtype)).dtype
                buf = buffers[name] = torch.empty(v.shape, dtype=tdtype,
                                                  pin_memory=True)
            view = buf[:len(v)]
            np.copyto(view.numpy(), v, casting="unsafe")
            staged[name] = view
        return slot, staged

    def launch(self, slot: int, staged: Dict[str, Any],
               device_dtypes: Dict[str, Any], sharding):
        import torch
        out = {}
        with torch.cuda.stream(self.stream):
            for name, host in staged.items():
                t = host.to(self.device, non_blocking=True)
                if name in device_dtypes:
                    t = t.to(device_dtypes[name])
                if sharding is not None:
                    t = _place(t, sharding)
                out[name] = t
            done = torch.cuda.Event()
            done.record(self.stream)
        self._free.put((slot, done))
        return out, done

    def hand_over(self, out: Dict[str, Any], done) -> Dict[str, Any]:
        import torch
        stream = torch.cuda.current_stream(self.device)
        stream.wait_event(done)
        for t in out.values():
            local = t.to_local() if hasattr(t, "to_local") else t
            local.record_stream(stream)
        return out


def _place(t, sharding):
    """``t`` placed on a mesh: ``sharding`` is ``(mesh, placements)``, the
    train step's ``(ts.mesh, ts.batch_sharding)`` (JAX's
    ``NamedSharding``)."""
    from ray_tpu_torch.parallel.mesh import distribute
    mesh, placements = sharding
    return distribute(t, mesh, placements)


class DataIterator:
    """Iterator facade over a stream of blocks (one per consumer shard)."""

    def __init__(self, block_iter_factory: Callable[[], Iterator[Block]],
                 pickle_recipe=None):
        self._factory = block_iter_factory
        # (dataset, n, index) for shards that may travel between
        # processes (Tune trials pickle whole Trainers, datasets and
        # shard iterators included); the live shared-pass closure holds
        # a lock and cannot cross the boundary itself
        self._pickle_recipe = pickle_recipe

    def __reduce__(self):
        if self._pickle_recipe is None:
            raise TypeError(
                "this DataIterator wraps a process-local stream and "
                "cannot be pickled; build it from streaming_split for "
                "a transferable shard")
        return (_rebuild_strided_iterator, self._pickle_recipe)

    def iter_blocks(self) -> Iterator[Block]:
        return self._factory()

    def iter_rows(self) -> Iterator[Dict[str, Any]]:
        for block in self._factory():
            yield from BlockAccessor(block).to_rows()

    def iter_batches(self, *, batch_size: Optional[int] = 256,
                     batch_format: str = "numpy",
                     prefetch_batches: int = 1,
                     drop_last: bool = False,
                     local_shuffle_buffer_size: Optional[int] = None,
                     local_shuffle_seed: Optional[int] = None
                     ) -> Iterator[Any]:
        batches = _batches_from_blocks(
            self._factory(), batch_size, batch_format, drop_last,
            local_shuffle_buffer_size, local_shuffle_seed)
        return _prefetched(batches, prefetch_batches)

    def iter_torch_batches(self, *, batch_size: Optional[int] = 256,
                           dtypes=None, device: str = "cpu",
                           **kwargs) -> Iterator[Any]:
        """Batches as torch tensors (reference: iter_torch_batches). Each
        tensor starts as a host copy: the batch is a read-only view of a
        stored block, which a tensor must not alias."""
        import torch
        for batch in self.iter_batches(batch_size=batch_size,
                                       batch_format="numpy", **kwargs):
            out = {}
            for k, v in batch.items():
                t = torch.from_numpy(np.array(v))
                if dtypes and k in dtypes:
                    t = t.to(dtypes[k])
                out[k] = t.to(device) if device != "cpu" else t
            yield out

    def to_jax(self, *, batch_size: int, sharding=None,
               prefetch: int = 2, drop_last: bool = True,
               dtypes: Optional[Dict[str, Any]] = None,
               device=None) -> Iterator[Dict[str, Any]]:
        """Device-prefetching iterator of dicts of tensors: batch N+1 is
        already on its way to the card while batch N computes.

        ``device=None`` is the card (raises on a host without one);
        ``device="cpu"`` copies each batch into CPU tensors. ``dtypes``
        maps a column to a numpy dtype, cast on the host before the copy as
        in JAX, or to a ``torch.dtype``, cast on the device after it (bf16,
        which numpy lacks). ``sharding=(mesh, placements)`` places each
        column on the train step's mesh (``(ts.mesh, ts.batch_sharding)``).
        On the card, up to ``prefetch`` + 1 batches are staged in pinned
        memory and copied on a side stream ahead of the consumer."""
        import torch

        from ray_tpu_torch._device import resolve_device
        dev = resolve_device(device)
        host_dtypes = {k: np.dtype(v) for k, v in (dtypes or {}).items()
                       if not isinstance(v, torch.dtype)}
        device_dtypes = {k: v for k, v in (dtypes or {}).items()
                         if isinstance(v, torch.dtype)}
        batches = _batches_from_blocks(self._factory(), batch_size,
                                       "numpy", drop_last)
        if dev.type == "cuda":
            feed = _CudaFeed(dev, prefetch + 1)
            host = _prefetched((feed.stage(b, host_dtypes)
                                for b in batches), prefetch)
        else:
            feed = None
            host = _prefetched(batches, prefetch)

        def to_device(item):
            if feed is not None:
                return feed.launch(*item, device_dtypes, sharding)
            out = {}
            for k, v in item.items():
                t = torch.tensor(v.astype(host_dtypes[k], copy=False)
                                 if k in host_dtypes else v, device=dev)
                if k in device_dtypes:
                    t = t.to(device_dtypes[k])
                out[k] = t if sharding is None else _place(t, sharding)
            return out, None

        def ready(pair):
            out, done = pair
            return out if feed is None else feed.hand_over(out, done)

        buf: collections.deque = collections.deque()
        try:
            for item in host:
                buf.append(to_device(item))   # starts the async copy
                if len(buf) > prefetch:
                    yield ready(buf.popleft())
            while buf:
                yield ready(buf.popleft())
        finally:
            host.close()
