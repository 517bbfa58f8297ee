"""Binary identifiers for cluster entities (counterpart of
``ray_tpu/_private/ids.py``).

Every cluster entity (node, job, task, actor, object, placement group) is
identified by a fixed-width random binary ID with a stable hex rendering.
IDs embed no lineage structure; the owner and lineage tables in
:mod:`ray_tpu_torch._private.refcount` carry that relationship, which keeps
IDs opaque and cheap to generate.
"""

from __future__ import annotations

import os
import threading

_counter_lock = threading.Lock()
_counter = 0

# Amortized entropy pool: one os.urandom syscall refills ~1k IDs (three IDs
# a task submission put the per-call syscall on the submit path).
_POOL_SIZE = 16384
_pool = b""
_pool_off = 0
_pool_pid = 0
_pool_lock = threading.Lock()


def _refill_locked() -> None:
    global _pool, _pool_off, _pool_pid
    _pool = os.urandom(_POOL_SIZE)
    _pool_off = 0
    _pool_pid = os.getpid()


def _unique_bytes(nbytes: int) -> bytes:
    global _pool_off
    with _pool_lock:
        # a forked child sharing the parent's buffered bytes would mint
        # the parent's ids: refill from the kernel instead
        if _pool_off + nbytes > len(_pool) or _pool_pid != os.getpid():
            _refill_locked()
        out = _pool[_pool_off:_pool_off + nbytes]
        _pool_off += nbytes
    return out


def _drop_pool_after_fork() -> None:
    global _pool, _pool_off
    _pool = b""
    _pool_off = 0
    try:
        # the fork snapshotted the lock held; release the child's copy
        _pool_lock.release()
    except RuntimeError:
        pass


if hasattr(os, "register_at_fork"):
    # hold the lock across the fork: a child forked while another thread
    # was mid-mint would otherwise inherit a forever-held lock
    os.register_at_fork(before=_pool_lock.acquire,
                        after_in_parent=_pool_lock.release,
                        after_in_child=_drop_pool_after_fork)


class BaseID:
    """Immutable fixed-width binary identifier."""

    SIZE = 16
    __slots__ = ("_binary", "_hash")

    def __init__(self, binary: bytes):
        if not isinstance(binary, bytes) or len(binary) != self.SIZE:
            raise ValueError(
                f"{type(self).__name__} requires {self.SIZE} bytes, got {binary!r}"
            )
        self._binary = binary
        self._hash = hash((type(self).__name__, binary))

    @classmethod
    def from_random(cls) -> "BaseID":
        return cls(_unique_bytes(cls.SIZE))

    @classmethod
    def from_hex(cls, hex_str: str) -> "BaseID":
        return cls(bytes.fromhex(hex_str))

    @classmethod
    def nil(cls) -> "BaseID":
        return cls(b"\x00" * cls.SIZE)

    def is_nil(self) -> bool:
        return self._binary == b"\x00" * self.SIZE

    def binary(self) -> bytes:
        return self._binary

    def hex(self) -> str:
        return self._binary.hex()

    def __hash__(self) -> int:
        return self._hash

    def __eq__(self, other) -> bool:
        return type(other) is type(self) and other._binary == self._binary

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self.hex()[:16]})"

    def __reduce__(self):
        return (type(self), (self._binary,))


class NodeID(BaseID):
    SIZE = 16


class JobID(BaseID):
    SIZE = 8


class TaskID(BaseID):
    SIZE = 16


class ActorID(BaseID):
    SIZE = 16


class ObjectID(BaseID):
    SIZE = 20


class PlacementGroupID(BaseID):
    SIZE = 16


class WorkerID(BaseID):
    SIZE = 16


def next_seqno() -> int:
    """Monotonic process-wide sequence number (actor task ordering)."""
    global _counter
    with _counter_lock:
        _counter += 1
        return _counter
