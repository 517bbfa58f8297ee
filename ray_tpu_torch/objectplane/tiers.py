"""The explicit object-store tier model and its observability (counterpart
of ``ray_tpu/objectplane/tiers.py``).

Every stored entry carries one of three tiers:

- ``host-shm``   — host bytes, ideally parked in the node's C++ shm
  arena (zero-copy for every process on the node);
- ``device-hbm`` — CUDA tensors (and containers of them) resident on the
  card; never serialized through host memory on the local path;
- ``spilled``    — pressure-evicted to disk, restored on demand.

Tier occupancy is observable as ``ray_tpu_object_store_bytes{tier}``
(gauge, per process, in ``util/metrics.py``'s registry) and the zero-copy
hit rate as ``ray_tpu_object_zero_copy_gets_total``.
"""

from __future__ import annotations

from typing import Dict

TIER_HOST = "host-shm"
TIER_DEVICE = "device-hbm"
TIER_SPILLED = "spilled"

TIERS = (TIER_HOST, TIER_DEVICE, TIER_SPILLED)


def _store_bytes_gauge():
    from ray_tpu_torch.util.metrics import Gauge
    return Gauge("ray_tpu_object_store_bytes",
                 "object store occupancy by tier (bytes)",
                 tag_keys=("tier",))


def count_zero_copy_get(n: int = 1) -> None:
    """One consumer resolved an object as a view backed by the shared
    arena — no payload serialization, no payload round trip."""
    try:
        from ray_tpu_torch.util.metrics import Counter
        Counter("ray_tpu_object_zero_copy_gets_total",
                "object gets served as zero-copy arena views").inc(n)
    except Exception:
        pass    # metrics must never fail the data path


def count_grants_reclaimed(n: int, reason: str) -> None:
    """Crash reclamation dropped ``n`` external slot refs a dead client
    never released — ``reason`` says which death signal fired (worker
    pipe EOF = ``death``, RPC connection close = ``disconnect``, the
    heartbeat orphan sweep = ``sweep``)."""
    try:
        from ray_tpu_torch.util.metrics import Counter
        Counter("ray_tpu_arena_grants_reclaimed_total",
                "external arena slot refs reclaimed from dead clients",
                tag_keys=("reason",)).inc(n, tags={"reason": reason})
    except Exception:
        pass    # metrics must never fail the data path


def count_spilled_bytes(n: int) -> None:
    """The daemon spilled ``n`` bytes of cold, sealed, unpinned arena
    entries to disk under memory pressure (tier host-shm -> spilled)."""
    try:
        from ray_tpu_torch.util.metrics import Counter
        Counter("ray_tpu_arena_spilled_bytes_total",
                "host-shm arena bytes spilled to disk under memory "
                "pressure").inc(n)
    except Exception:
        pass    # metrics must never fail the data path


def count_restored_bytes(n: int) -> None:
    """A read path restored ``n`` spilled bytes back into the arena
    (tier spilled -> host-shm)."""
    try:
        from ray_tpu_torch.util.metrics import Counter
        Counter("ray_tpu_arena_restored_bytes_total",
                "spilled arena bytes restored into the arena on "
                "demand").inc(n)
    except Exception:
        pass    # metrics must never fail the data path


def count_stale_reservations(n: int = 1) -> None:
    """The orphan sweep aborted ``n`` direct-put reservations whose
    writer died between reserve and seal (bytes un-stranded)."""
    try:
        from ray_tpu_torch.util.metrics import Counter
        Counter("ray_tpu_arena_stale_reservations_total",
                "reserved-but-never-sealed arena entries aborted by "
                "the TTL sweep").inc(n)
    except Exception:
        pass    # metrics must never fail the data path


def raw_put_eligible(value):
    """(dtype_str, shape) when ``value`` qualifies for the RAW tier on
    a direct put, else None — THE single eligibility predicate, shared
    by the worker and driver put paths so the gate can never diverge.
    Raw rides direct puts, so the size gate is
    max(raw_tier_min_bytes, direct_put_min_bytes) (see config.py)."""
    import numpy as np

    from ray_tpu_torch._private.config import cfg
    if (not isinstance(value, np.ndarray) or value.dtype == object
            or not value.flags.c_contiguous
            or value.nbytes < max(int(cfg().direct_put_min_bytes),
                                  int(cfg().raw_tier_min_bytes))):
        return None
    return (value.dtype.str, tuple(value.shape))


def publish_tier_bytes(tier: str, value: int) -> None:
    """Set one tier's occupancy gauge directly (stores that already
    track their own byte counts, e.g. the daemon object table)."""
    try:
        _store_bytes_gauge().set(float(max(value, 0)),
                                 tags={"tier": tier})
    except Exception:
        pass    # metrics must never fail the data path


class TierAccounting:
    """(tier -> bytes) occupancy ledger. Per-store instances chain
    deltas into the process-wide aggregate (``_PROCESS_TIERS``), which
    is the one that mirrors into the
    ``ray_tpu_object_store_bytes{tier}`` gauge — several stores in one
    process (one per virtual node) must not fight over the series."""

    def __init__(self, publish: bool = False, chain=None):
        import threading
        self._lock = threading.Lock()
        self._bytes: Dict[str, int] = {}    #: guarded by self._lock
        self._publish_gauge = publish
        self._chain = chain

    def add(self, tier: str, nbytes: int) -> None:
        with self._lock:
            self._bytes[tier] = self._bytes.get(tier, 0) + nbytes
            value = max(self._bytes[tier], 0)
        if self._publish_gauge:
            publish_tier_bytes(tier, value)
        if self._chain is not None:
            self._chain.add(tier, nbytes)

    def move(self, src: str, dst: str, nbytes: int) -> None:
        """Tier transition (e.g. host-shm -> spilled on pressure)."""
        self.add(src, -nbytes)
        self.add(dst, nbytes)

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._bytes)

    def clear(self) -> None:
        """Zero this ledger, backing the deltas out of the chain too
        (store close must not leave phantom occupancy behind)."""
        with self._lock:
            drained = dict(self._bytes)
            self._bytes.clear()
        for tier, value in drained.items():
            if self._publish_gauge:
                publish_tier_bytes(tier, 0)
            if self._chain is not None and value:
                self._chain.add(tier, -value)


_PROCESS_TIERS = TierAccounting(publish=True)


def store_accounting() -> TierAccounting:
    """A per-store ledger chained into the process aggregate."""
    return TierAccounting(chain=_PROCESS_TIERS)
