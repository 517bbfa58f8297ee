"""Worker-side attach to the node daemon's shm arena (counterpart of
``ray_tpu/objectplane/arena.py``).

The daemon hands its arena's (segment name, capacity) to every worker in
the boot frame (``worker_process._make_boot``). Workers map the segment
lazily on first use (``ShmObjectStore.attach``, shm_open by name) and then:

- resolve host-tier deps as ``np.frombuffer`` views over (offset,
  nbytes) metadata from the daemon — zero serialization for raw-tier
  arrays, zero payload round trip for pickled entries;
- hold a PROCESS-SHARED per-object refcount (the arena header's slot
  table) for every live view, released by a ``weakref.finalize`` when
  the consumer drops the array — LRU eviction in the daemon can never
  unmap a buffer a worker still views;
- direct-put large results by writing a daemon-reserved range in place;
  only the seal message crosses the wire.

Failure is never fatal: an attach that cannot map the segment (no
native build, hardened /dev/shm) disables
the plane for this process and every operation falls back to the
classic per-task RPC path.

Crash safety: every slot ref the daemon increments on this process's
behalf is charged to a per-client grant ledger keyed by this process's
identity (workers: pid+generation, drivers: a connection-scoped id
minted at hello). If this process dies without releasing — SIGKILL mid-
view, mid-direct-put, whatever — the daemon's death signal (worker pipe
EOF or RPC disconnect) funnels into ``reclaim_client``, which drops the
outstanding grants, aborts unsealed reservations, and reaps; a
heartbeat orphan sweep backstops any signal the event path missed. A
crashed client therefore leaks nothing past the next beat — no daemon
restart needed.
"""

from __future__ import annotations

import os
import weakref
from typing import Dict, List, Optional

import numpy as np

from ray_tpu_torch._private import failpoints as _fp


class WorkerArena:
    """One process's attachment to a node arena."""

    def __init__(self, name: str, capacity: int):
        self.name = name
        self.capacity = capacity
        from ray_tpu_torch._private.lock_sanitizer import tracked_lock
        self._lock = tracked_lock("objectplane.worker_arena",
                                  reentrant=False)
        self._store = None          #: guarded by self._lock
        self._failed = False        #: guarded by self._lock
        # live zero-copy views per slot: eviction safety is enforced by
        # the shared slot refcounts; this registry is the local mirror
        # (introspection + exactly-one release per dropped view)
        self._views: Dict[int, int] = {}    #: guarded by self._lock
        self.stats = {"zero_copy_gets": 0, "direct_puts": 0,
                      "attach_failures": 0, "released": 0}

    # -- attach ----------------------------------------------------------
    def store(self):
        """The attached handle, or None when the plane is unavailable
        (then callers take the classic RPC path — never task failure)."""
        with self._lock:
            if self._store is not None:
                return self._store
            if self._failed:
                return None
            try:
                if _fp.ENABLED:
                    # drop/error arm = the mapping fails (a hardened
                    # /dev/shm, a wrong segment): the per-task RPC
                    # fallback, not a task failure
                    if _fp.fire("shm.attach",
                                arena=self.name) is _fp.DROP:
                        raise RuntimeError("shm.attach failpoint drop")
                from ray_tpu_torch.native_store import ShmObjectStore
                self._store = ShmObjectStore.attach(self.name)
            except Exception:
                self._failed = True
                self.stats["attach_failures"] += 1
                return None
            return self._store

    @property
    def attached(self) -> bool:
        with self._lock:
            return self._store is not None

    # -- zero-copy reads -------------------------------------------------
    def view(self, off: int, size: int, slot: int,
             dtype: Optional[str] = None,
             shape=None) -> np.ndarray:
        """Read-only view over arena bytes whose slot ref was already
        taken on our behalf (daemon-side ``get_ext``); a finalizer on
        the returned array drops the ref exactly once."""
        store = self.store()
        if store is None:
            raise RuntimeError("arena not attached")
        try:
            base = store.view_range(off, size)
        except Exception:
            # the granted ref is OURS from the moment the caller hands
            # off: a failed mapping (e.g. meta from a re-created,
            # smaller arena) must release it, not pin the object forever
            self.release_slot(slot)
            raise
        with self._lock:
            self._views[slot] = self._views.get(slot, 0) + 1
        self.stats["zero_copy_gets"] += 1
        # finalizer on the BASE frombuffer array, never a derived view:
        # numpy collapses base chains (a slice of the reshaped array
        # bases on `base`, not on the reshape), so only `base` dying
        # proves no view of the bytes survives
        weakref.finalize(base, self._release_slot, slot)
        arr = base
        if dtype is not None:
            arr = arr.view(np.dtype(dtype))
            if shape is not None:
                arr = arr.reshape(tuple(shape))
        from ray_tpu_torch.objectplane.tiers import count_zero_copy_get
        count_zero_copy_get()
        return arr

    def _release_slot(self, slot: int) -> None:
        with self._lock:
            n = self._views.get(slot, 0) - 1
            if n <= 0:
                self._views.pop(slot, None)
            else:
                self._views[slot] = n
            store = self._store
        self.stats["released"] += 1
        if store is not None:
            try:
                store.ext_release(slot)
            except Exception:
                pass

    def release_slot(self, slot: int) -> None:
        """Drop a granted slot ref that never became a view (a failed
        resolve after the daemon already increfed on our behalf)."""
        store = self.store()
        if store is not None:
            try:
                store.ext_release(slot)
            except Exception:
                pass

    def live_views(self) -> int:
        with self._lock:
            return sum(self._views.values())

    # -- direct put ------------------------------------------------------
    def write(self, off: int, payload) -> None:
        """Fill a daemon-reserved (unsealed) range in place."""
        store = self.store()
        if store is None:
            raise RuntimeError("arena not attached")
        store.write_range(off, payload)
        self.stats["direct_puts"] += 1


# ---------------------------------------------------------------------------
# process-global arena (configured from the worker boot frame)
# ---------------------------------------------------------------------------

_ARENA: List[Optional[WorkerArena]] = [None]
_DISABLED: List[bool] = [False]


def configure(name: str, capacity: int) -> None:
    """Install this process's node arena (worker boot)."""
    _ARENA[0] = WorkerArena(name, capacity)


def get_arena() -> Optional[WorkerArena]:
    if _DISABLED[0]:
        return None
    return _ARENA[0]


def set_disabled(flag: bool) -> None:
    """Force the classic RPC path (tests: mixed classic/attached
    consumers on one daemon)."""
    _DISABLED[0] = bool(flag)


def arena_stats() -> Dict[str, int]:
    a = _ARENA[0]
    if a is None:
        return {}
    out = dict(a.stats)
    out["live_views"] = a.live_views()
    out["attached"] = int(a.attached)
    return out


# ---------------------------------------------------------------------------
# stale-segment hygiene (daemon startup)
# ---------------------------------------------------------------------------

def sweep_stale_segments(prefix: str) -> List[str]:
    """Unlink orphaned /dev/shm segments left by a previous crashed
    daemon of the same node (a SIGKILL'd daemon never reaches
    ``close(unlink=True)``; without the sweep its arena leaks until
    reboot AND a restarted daemon of the same node id would map the
    stale bytes). Called before the new arena is created, scoped to
    this node's deterministic name prefix so other daemons'/drivers'
    live segments are never touched."""
    removed: List[str] = []
    if not prefix:
        return removed
    base = "/dev/shm"
    try:
        names = os.listdir(base)
    except OSError:
        return removed
    for fname in names:
        if fname.startswith(prefix):
            try:
                os.unlink(os.path.join(base, fname))
                removed.append(fname)
            except OSError:
                pass
    return removed
