"""PushManager: proactive daemon-to-daemon object transfer (counterpart of
``ray_tpu/objectplane/push.py``).

The peer of the pull engine (``daemon.PullManager``). A push moves a
hot object to a node that is ABOUT to need it (dep prefetch at dispatch,
drain migration) instead of waiting for that node to pull.

Dedup rules (the tentpole contract):

- **in-flight dedupe** — a second push of the same (object, destination)
  joins the running transfer instead of re-sending bytes;
- **directory dedupe** — never push to a node that already holds a copy
  per the owner's object directory (``locate_fn``), and probe the
  receiver's table before the first chunk;
- **pull dedupe** — the receiver answers ``have`` as soon as the object
  lands (e.g. a concurrent pull completed it); the sender aborts the
  remaining chunks — a chunk a pull already transferred is never pushed.

Chunks are read straight from the sender's arena
(``ObjectTable.read_range`` — a pinned zero-copy view per chunk, no
intermediate whole-object copy) and assembled receiver-side by
:class:`PushReceiver` into one buffer, exactly like the pull path.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Any, Dict, Optional, Tuple

from ray_tpu_torch._private import failpoints as _fp



def _push_chunk_size() -> int:
    from ray_tpu_torch._private.config import cfg
    return cfg().pull_chunk     # one transfer granularity for both engines


class _Push:
    __slots__ = ("oid", "to_addr", "ref", "raw", "event", "ok",
                 "skipped", "error")

    def __init__(self, oid: bytes, to_addr: Tuple[str, int], ref: bytes):
        self.oid = oid
        self.to_addr = to_addr
        self.ref = ref          # logical ObjectID (receiver oid-index)
        self.raw = None         # raw-tier (dtype, shape), sender-filled
        self.event = threading.Event()
        self.ok = False
        self.skipped = False    # destination already held a copy
        self.error = ""


class PushManager:
    """Sender-side push engine for one daemon."""

    def __init__(self, objects, peer_fn, locate_fn=None,
                 chunk: Optional[int] = None, num_workers: int = 2):
        self.objects = objects
        self._peer = peer_fn            # addr -> rpc.Client
        self._locate = locate_fn        # oid -> [addr] holding a copy
        self.chunk = chunk if chunk is not None else _push_chunk_size()
        self._cv = threading.Condition()
        self._q: deque = deque()                    #: guarded by self._cv
        # (oid, addr) -> _Push: in-flight dedupe table
        self._inflight: Dict[Tuple[bytes, Tuple[str, int]], _Push] = {}  #: guarded by self._cv
        self.stats = {"pushes_started": 0, "pushes_deduped": 0,
                      "pushes_skipped_held": 0, "pushes_failed": 0,
                      "pushes_aborted_by_pull": 0,
                      "chunks_pushed": 0, "bytes_pushed": 0}
        for i in range(num_workers):
            threading.Thread(target=self._loop, daemon=True,
                             name=f"push-worker-{i}").start()

    def inflight_count(self) -> int:
        """Pushes queued or transferring right now."""
        with self._cv:
            return len(self._inflight)

    def request(self, oid: bytes, to_addr, ref: bytes = b"") -> _Push:
        """Enqueue (or join) a push; callers may wait on the returned
        event or fire-and-forget."""
        to_addr = tuple(to_addr)
        key = (oid, to_addr)
        with self._cv:
            existing = self._inflight.get(key)
            if existing is not None:
                self.stats["pushes_deduped"] += 1
                return existing
            push = _Push(oid, to_addr, ref)
            self._inflight[key] = push
            self.stats["pushes_started"] += 1
            self._q.append(push)
            self._cv.notify()
        return push

    def _loop(self) -> None:
        while True:
            with self._cv:
                while not self._q:
                    self._cv.wait()
                push = self._q.popleft()
            try:
                self._transfer(push)
                push.ok = True
            except Exception as e:  # noqa: BLE001 — reported to waiter
                push.error = repr(e)
                with self._cv:
                    self.stats["pushes_failed"] += 1
            finally:
                with self._cv:
                    self._inflight.pop((push.oid, push.to_addr), None)
                push.event.set()

    def _transfer(self, push: _Push) -> None:
        if _fp.ENABLED:
            # an error arm fails this push attempt (the object still
            # travels on demand through the pull path); a delay arm
            # stretches the transfer window
            _fp.fire("daemon.push_transfer")
        size = self.objects.nbytes_of(push.oid)
        if size is None:
            raise KeyError(f"push source lost {push.oid!r}")
        # directory dedupe: the owner's object directory already lists
        # the destination as a holder -> nothing to do
        if self._locate is not None:
            try:
                holders = {tuple(a) for a in self._locate(push.oid)}
            except Exception:
                holders = set()
            if push.to_addr in holders:
                push.skipped = True
                with self._cv:
                    self.stats["pushes_skipped_held"] += 1
                return
        peer = self._peer(push.to_addr)
        # receiver probe: a copy that landed outside the directory's
        # view (e.g. a just-finished pull) also dedupes
        meta = peer.call("object_meta", oid=push.oid, timeout=30.0)
        if not meta.get("missing"):
            push.skipped = True
            with self._cv:
                self.stats["pushes_skipped_held"] += 1
            return
        # raw-tier (dtype, shape) travels with the chunks so the
        # receiver's oid index serves the pushed copy as zero-copy
        # views, not as bytes that look like a pickle
        raw_for = getattr(self.objects, "raw_for", None)
        push.raw = raw_for(push.oid) if raw_for is not None else None
        for off in range(0, size, self.chunk):
            want = min(self.chunk, size - off)
            blob = self.objects.read_range(push.oid, off, want)
            if blob is None:    # evicted mid-push
                raise KeyError(f"push source evicted {push.oid!r}")
            out = peer.call("push_chunk", oid=push.oid, off=off,
                            total=size, blob=blob,
                            ref=push.ref,
                            raw=(list(push.raw) if push.raw else None),
                            timeout=60.0)
            with self._cv:
                self.stats["chunks_pushed"] += 1
                self.stats["bytes_pushed"] += len(blob)
            if out.get("have"):
                # the receiver got a copy some other way (a pull landed
                # it): never push a chunk a pull already transferred
                with self._cv:
                    self.stats["pushes_aborted_by_pull"] += 1
                return


class PushReceiver:
    """Receiver-side chunk assembly for the push direction: chunks land in one preallocated buffer; the
    completed object enters the local table like a pulled one."""

    # partially received buffers older than this are abandoned
    # transfers (sender crashed mid-push) and get swept
    PENDING_MAX_AGE_S = 120.0

    def __init__(self, objects, register_oid=None):
        self.objects = objects
        self._register_oid = register_oid
        from ray_tpu_torch._private.lock_sanitizer import tracked_lock
        self._lock = tracked_lock("objectplane.push_rx", reentrant=False)
        # oid -> [bytearray, {offset: nbytes}, total, last_touch]:
        # covered-INTERVAL accounting — concurrent senders (even with
        # different chunk sizes) must not sum overlapping chunks past
        # `total` and land a buffer with holes
        self._pending: Dict[bytes, list] = {}   #: guarded by self._lock
        self.stats = {"chunks_received": 0, "objects_received": 0,
                      "dropped_duplicate": 0, "pending_expired": 0}

    @staticmethod
    def _covered(ranges: Dict[int, int]) -> int:
        """Total bytes covered by the union of (offset, len) ranges."""
        covered = 0
        end = -1
        for off in sorted(ranges):
            stop = off + ranges[off]
            if off > end:
                covered += stop - off
                end = stop
            elif stop > end:
                covered += stop - end
                end = stop
        return covered

    def chunk(self, oid: bytes, off: int, total: int, blob: bytes,
              ref: bytes = b"", raw=None) -> Dict[str, Any]:
        import time as _time
        if self.objects.contains(oid):
            # a pull (or an earlier push) already landed it: tell the
            # sender to stop pushing chunks
            with self._lock:
                self._pending.pop(oid, None)
                self.stats["dropped_duplicate"] += 1
            return {"ok": True, "have": True}
        done = False
        with self._lock:
            entry = self._pending.get(oid)
            if entry is None or entry[2] != total:
                entry = self._pending[oid] = [bytearray(total), {},
                                              total, 0.0]
            buf, ranges, _, _ = entry
            buf[off:off + len(blob)] = blob
            ranges[off] = max(ranges.get(off, 0), len(blob))
            entry[3] = _time.monotonic()
            self.stats["chunks_received"] += 1
            if self._covered(ranges) >= total:
                done = True
                self._pending.pop(oid, None)
        if done:
            self.objects.put(oid, bytes(buf))
            if ref and self._register_oid is not None:
                try:
                    self._register_oid(ref, oid,
                                       raw=tuple(raw) if raw else None)
                except Exception:
                    pass
            with self._lock:
                self.stats["objects_received"] += 1
        return {"ok": True}

    def sweep(self, max_age_s: float = PENDING_MAX_AGE_S) -> int:
        """Drop partial buffers no chunk has touched for ``max_age_s``
        (an abandoned transfer — its sender crashed or gave up): a 1GB
        object abandoned after chunk one must not hold receiver RAM
        forever. Called from the daemon heartbeat loop."""
        import time as _time
        cutoff = _time.monotonic() - max_age_s
        with self._lock:
            stale = [oid for oid, e in self._pending.items()
                     if e[3] < cutoff]
            for oid in stale:
                self._pending.pop(oid, None)
            self.stats["pending_expired"] += len(stale)
        return len(stale)
