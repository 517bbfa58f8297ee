"""The port's zero-copy object plane and crash reclamation (copies of
``tests/test_objectplane.py`` and ``tests/test_reclamation.py`` against
``ray_tpu_torch``).

- native: process-shared slot refcounts block LRU eviction while any
  attached process holds a view; reserve/seal are idempotent;
- store: explicit (host-shm | device-hbm | spilled) tiers with occupancy
  accounting; stale-segment sweep on (re)start;
- cluster end to end (the daemon cluster): same-node consumers see
  read-only arena-backed views (no pickle on the raw path, mutation
  raises), direct puts move only a seal message, classic and attached
  consumers coexist on one daemon, and everything degrades to the per-RPC
  path when the arena is unavailable;
- reclamation: the per-client grant ledger, ``reclaim_client`` and the
  heartbeat orphan sweep of the daemon's ``ObjectTable``;
- the ``shm.attach`` and ``shm.seal`` failpoint seams.
"""

import os
import time
import uuid

import numpy as np
import pytest

import ray_tpu_torch as rt_api
from ray_tpu_torch.native_store import available

needs_native = pytest.mark.skipif(
    not available(), reason="native shm store unavailable (no g++)")

CAP = 4 * 1024 * 1024


# ---------------------------------------------------------------------------
# native: shared-slot ref/release protocol
# ---------------------------------------------------------------------------

@needs_native
def test_ext_ref_blocks_eviction_then_release_frees():
    from ray_tpu_torch.native_store import ShmObjectStore, ShmStoreFull
    store = ShmObjectStore(f"rtpu_tst_ext_{os.getpid()}", 1 << 20)
    try:
        store.put(b"a", b"\x07" * (600 * 1024))
        store.put(b"b", b"\x08" * (300 * 1024))
        # an ATTACHED process's view: ext slot ref taken on its behalf
        off, size, slot = store.get_ext(b"a")
        att = ShmObjectStore.attach(store.name)
        try:
            view = att.view_range(off, size)
            assert bytes(view[:4]) == b"\x07" * 4
            assert store.ext_refs(slot) == 1
            # pressure needing a's bytes: b is evictable, but freeing
            # it cannot make 600 KiB contiguous — and a is PINNED by
            # the attached client's slot ref, so the create must fail
            # instead of unmapping bytes the client still views
            with pytest.raises(ShmStoreFull):
                store.put(b"c", b"\x01" * (600 * 1024))
            assert store.contains(b"a")
            assert bytes(view[:4]) == b"\x07" * 4   # still mapped
            del view
            att.ext_release(slot)
            assert store.ext_refs(slot) == 0
            store.put(b"c", b"\x01" * (600 * 1024))  # now evictable
            assert not store.contains(b"a")
            assert store.contains(b"c")
        finally:
            att.close()
    finally:
        store.close(unlink=True)


@needs_native
def test_deferred_delete_waits_for_ext_release_then_reaps():
    from ray_tpu_torch.native_store import ShmObjectStore
    store = ShmObjectStore(f"rtpu_tst_reap_{os.getpid()}", 1 << 20)
    try:
        store.put(b"x", b"abc" * 1000, pin=True)
        _off, _size, slot = store.get_ext(b"x")
        store.delete(b"x")              # readers outstanding: deferred
        assert store.num_objects() == 1
        assert store.reap() == 0        # still ext-referenced
        store.ext_release(slot)
        assert store.reap() == 3000     # last ref gone: bytes freed
        assert store.num_objects() == 0
    finally:
        store.close(unlink=True)


@needs_native
def test_view_slot_ref_survives_derived_views():
    """Review regression: numpy collapses view base chains, so a slice
    of the reshaped array bases on the frombuffer BASE — the slot ref
    must release only when the base dies (i.e. when NO view of the
    bytes survives), not when the derived array is dropped."""
    import gc

    from ray_tpu_torch.native_store import ShmObjectStore
    from ray_tpu_torch.objectplane.arena import WorkerArena
    store = ShmObjectStore(f"rtpu_tst_deriv_{os.getpid()}", 1 << 20)
    try:
        store.put(b"a", np.arange(1024, dtype=np.float32).tobytes(),
                  pin=True)
        off, size, slot = store.get_ext(b"a")
        wa = WorkerArena(store.name, 0)
        view = wa.view(off, size, slot, dtype="<f4", shape=(1024,))
        sl = view[10:20]
        del view
        gc.collect()
        assert store.ext_refs(slot) == 1    # slice still maps the bytes
        assert float(sl[0]) == 10.0
        del sl
        gc.collect()
        assert store.ext_refs(slot) == 0    # last view gone: released
    finally:
        store.close(unlink=True)


@needs_native
def test_reserve_write_seal_idempotent_via_attach():
    from ray_tpu_torch.native_store import ShmObjectStore
    store = ShmObjectStore(f"rtpu_tst_rsv_{os.getpid()}", 1 << 20)
    try:
        off = store.reserve(b"k", 8)
        assert store.reserve(b"k", 8) == off    # retried reserve
        att = ShmObjectStore.attach(store.name)
        try:
            att.write_range(off, b"12345678")
        finally:
            att.close()
        store.seal(b"k", pin=True)
        store.seal(b"k", pin=True)              # retried seal
        o, s = store.get_ref(b"k")
        assert bytes(store.read_range(o, s)) == b"12345678"
        store.release(b"k")
    finally:
        store.close(unlink=True)


# ---------------------------------------------------------------------------
# stale-segment hygiene (daemon restart)
# ---------------------------------------------------------------------------

@needs_native
def test_object_table_sweeps_stale_segments_of_same_node():
    """A SIGKILL'd daemon leaks its arena in /dev/shm; the successor of
    the SAME node sweeps it before creating a fresh one (and never
    touches other nodes' segments)."""
    from ray_tpu_torch._private.daemon import ObjectTable
    from ray_tpu_torch.native_store import ShmObjectStore
    # the port's own prefix, the full pid and a random suffix: no other
    # test process (this suite's or a second checkout's) meets these names
    tag = f"{os.getpid()}_{uuid.uuid4().hex[:8]}"
    name = f"rtpt_tstsweep{tag}"
    other = f"rtpt_tstother{tag}"
    # "crashed daemon": segment left behind, name never unlinked
    leaked = ShmObjectStore(name, 1 << 20)
    leaked.put(b"stale", b"old-bytes")
    leaked.close(unlink=False)
    bystander = ShmObjectStore(other, 1 << 20)
    try:
        assert os.path.exists(f"/dev/shm/{name}")
        table = ObjectTable(name, 1 << 20)      # the restarted daemon
        try:
            # fresh arena: the stale object is gone, the segment exists
            assert table._shm is not None
            assert not table._shm.contains(b"stale")
            assert os.path.exists(f"/dev/shm/{name}")
            # the other node's live segment was not swept
            assert os.path.exists(f"/dev/shm/{other}")
        finally:
            table.close()
    finally:
        bystander.close(unlink=True)


def test_sweep_stale_segments_scoped_to_prefix(tmp_path):
    from ray_tpu_torch.objectplane.arena import sweep_stale_segments
    assert sweep_stale_segments("") == []     # no prefix: never sweeps


# ---------------------------------------------------------------------------
# tier model
# ---------------------------------------------------------------------------

def test_local_store_tier_accounting_spill_restore(tmp_path):
    from ray_tpu_torch._private.ids import NodeID, ObjectID
    from ray_tpu_torch._private.object_store import LocalObjectStore
    store = LocalObjectStore(NodeID.from_random(), 4000,
                             spill_dir=str(tmp_path))
    store._native = None    # force the pure-python host tier
    a, b = ObjectID.from_random(), ObjectID.from_random()
    store.put(a, b"x" * 3000, nbytes=3000)
    assert store.tier_bytes().get("host-shm") == 3000
    store.put(b, b"y" * 3000, nbytes=3000)      # pressure: a spills
    tiers = store.tier_bytes()
    assert tiers.get("spilled") == 3000
    assert tiers.get("host-shm") == 3000
    assert store.get(a) == b"x" * 3000          # restore flips it back
    tiers = store.tier_bytes()
    assert tiers.get("spilled", 0) in (0, 3000)  # b may have spilled
    store.delete(a)
    store.delete(b)
    tiers = store.tier_bytes()
    assert tiers.get("host-shm", 0) == 0
    assert tiers.get("spilled", 0) == 0
    store.close()


@needs_native
def test_arena_spill_restore_tier_accounting(tmp_path):
    """Arena spill is a tier transition, not a loss: spilled occupancy
    (spilled_bytes / spill_stats) and the spill/restore byte counters
    move in lockstep with the data, and a restore returns every byte to
    host-shm (docs/object_plane.md "Arena spill")."""
    import uuid

    from ray_tpu_torch._private.daemon import ObjectTable
    from ray_tpu_torch.util.metrics import Counter

    def _total(name):
        return sum(v for _, v in Counter(name, "").samples())

    table = ObjectTable(f"rtpu_sp_{os.getpid()}_{uuid.uuid4().hex[:8]}",
                        1 << 22, sweep=False, spill_dir=str(tmp_path))
    if table._shm is None:
        table.close()
        pytest.skip("arena creation failed on this box")
    try:
        n = 300_000
        spilled0 = _total("ray_tpu_arena_spilled_bytes_total")
        restored0 = _total("ray_tpu_arena_restored_bytes_total")
        table.put(b"obj", b"s" * n)
        used_resident = table.used_bytes()
        assert table.spilled_bytes() == 0

        assert table.spill_to_fraction(0.0) == 1
        assert table.spilled_bytes() == n
        stats = table.spill_stats()
        assert stats["spills"] == 1
        assert stats["spilled_bytes"] == n
        assert stats["spilled_now_count"] == 1
        assert _total("ray_tpu_arena_spilled_bytes_total") - spilled0 == n
        # the arena side actually freed (deferred-delete + reap ran)
        assert table.used_bytes() < used_resident
        # directory answers stay exact while parked on disk
        assert table.contains(b"obj")
        assert table.nbytes_of(b"obj") == n

        assert table.get_blob(b"obj") == b"s" * n       # restores
        assert table.spilled_bytes() == 0
        stats = table.spill_stats()
        assert stats["restores"] == 1
        assert stats["restored_bytes"] == n
        assert stats["spilled_now_count"] == 0
        assert _total("ray_tpu_arena_restored_bytes_total") \
            - restored0 == n
    finally:
        table.close()


# ---------------------------------------------------------------------------
# cluster e2e (daemons topology)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="class")
def daemon_cluster():
    rt = rt_api.init(num_nodes=2, resources={"CPU": 4},
                     cluster="daemons", object_store_memory=128 << 20)
    yield rt
    rt_api.shutdown()


@rt_api.remote
def _produce(n):
    return np.full(n // 8, 7.0)


@rt_api.remote
def _consume(refs):
    got = rt_api.get(refs)[0]
    mutated = False
    try:
        got[0] = 1.0
        mutated = True
    except (ValueError, TypeError):
        pass
    from ray_tpu_torch.objectplane.arena import arena_stats
    return {"sum": float(got.sum()), "mutated": mutated,
            "writeable": bool(got.flags.writeable)
            if hasattr(got, "flags") else None,
            "stats": arena_stats()}


class TestOneCluster:
    """The end-to-end tests share one cluster (none kills or mutates it)."""

    @needs_native
    def test_same_node_consumer_gets_arena_backed_readonly_view(
            self, daemon_cluster):
        """The satellite contract: a same-node consumer's buffer is backed
        by the shared arena (zero-copy — the arena's zero_copy_gets counter
        moved in THAT worker), the view is read-only, and mutation raises."""
        r = _produce.remote(1 << 21)
        rt_api.get(r)      # result landed (stored in the daemon)
        out = rt_api.get(_consume.remote([r]))
        assert out["sum"] == 7.0 * (1 << 18)
        assert out["mutated"] is False
        assert out["writeable"] is False
        assert out["stats"]["attached"] == 1
        assert out["stats"]["zero_copy_gets"] >= 1


    @needs_native
    def test_worker_direct_put_roundtrip_and_driver_get(self, daemon_cluster):
        """Worker direct put: payload written in place, only the seal +
        registration messages cross the wire; the driver reads the same
        object back (zero-copy view on this same-host box)."""

        @rt_api.remote
        def put_big():
            a = np.arange(512 * 1024, dtype=np.float32)     # 2 MiB
            ref = rt_api.put(a)
            from ray_tpu_torch.objectplane.arena import arena_stats
            return ref, arena_stats()

        ref, stats = rt_api.get(put_big.remote())
        assert stats["direct_puts"] >= 1
        got = rt_api.get(ref)
        assert got.dtype == np.float32 and got.shape == (512 * 1024,)
        assert float(got[12345]) == 12345.0
        assert got.flags.writeable is False     # raw-tier view/frombuffer


    @needs_native
    def test_multi_return_not_aliased_to_tuple_blob(self, daemon_cluster):
        """Review regression: a multi-return task's stored blob holds the
        WHOLE tuple; the daemon's oid index must not alias ref0 to it, or
        a same-node consumer would read (r0, r1) as r0's value."""

        @rt_api.remote(num_returns=2)
        def duo(n):
            return np.full(n // 8, 1.0), np.full(n // 8, 2.0)

        r0, r1 = duo.remote(1 << 21)
        rt_api.get([r0, r1])

        @rt_api.remote
        def consume(refs):
            v = rt_api.get(refs)[0]
            assert not isinstance(v, tuple), "aliased to the tuple blob"
            return float(v.sum())

        assert rt_api.get(consume.remote([r0])) == float(1 << 18)
        assert rt_api.get(consume.remote([r1])) == 2.0 * (1 << 18)


    @needs_native
    def test_mixed_classic_and_attached_consumers_one_daemon(
            self, daemon_cluster):
        """Classic (plane-disabled) and attached consumers coexist on one
        daemon: both read the same stored object correctly."""

        @rt_api.remote
        def consume_classic(refs):
            from ray_tpu_torch.objectplane import arena as _arena
            _arena.set_disabled(True)
            try:
                got = rt_api.get(refs)[0]
                return float(got.sum())
            finally:
                _arena.set_disabled(False)

        r = _produce.remote(1 << 21)
        rt_api.get(r)
        classic = rt_api.get(consume_classic.remote([r]))
        attached = rt_api.get(_consume.remote([r]))
        assert classic == attached["sum"] == 7.0 * (1 << 18)


    @needs_native
    def test_push_object_dedupes_and_lands_copy(self, daemon_cluster):
        """PushManager contract: a driver-directed push lands the object on
        the peer; a second push of the same object dedupes against the copy
        the destination now holds (directory/receiver probe)."""
        rt = daemon_cluster
        h_a, h_b = list(rt.cluster_backend.daemons.values())
        key = b"put:pushtest-0001"
        h_a.put_object_blob(key, b"z" * (2 << 20))
        out = h_a.push_object(key, h_b.addr)
        assert out["ok"] and not out.get("skipped")
        assert h_b.client.call("object_meta", oid=key)["size"] == 2 << 20
        out2 = h_a.push_object(key, h_b.addr)
        assert out2["ok"] and out2.get("skipped")
        stats = h_a.client.call("daemon_stats")["push_stats"]
        assert stats["pushes_started"] >= 2
        assert stats["pushes_skipped_held"] >= 1
        assert stats["bytes_pushed"] >= 2 << 20


    @needs_native
    def test_remote_store_direct_put_tiers_and_zero_copy_get(
            self, daemon_cluster):
        """Driver-side direct put of a large contiguous array: raw tier,
        host-shm occupancy accounted, zero-copy read-only view back."""
        rt = daemon_cluster
        from ray_tpu_torch._private.ids import ObjectID
        node = next(n for n in rt.nodes()
                    if getattr(n, "daemon", None) is not None)
        store = node.store
        if not store.daemon.objectplane:
            pytest.skip("daemon has no native arena")
        oid = ObjectID.from_random()
        arr = np.arange(256 * 1024, dtype=np.float32)       # 1 MiB
        before = store.stats["direct_puts"]
        store.put(oid, arr)
        assert store.stats["direct_puts"] == before + 1
        assert store.tier_bytes().get("host-shm", 0) >= arr.nbytes
        got = store.get(oid)
        assert got.flags.writeable is False
        assert (got == arr).all()
        del got
        store.delete(oid)


class _FakeObjects:
    def __init__(self):
        self.stored = {}

    def contains(self, oid):
        return oid in self.stored

    def put(self, oid, blob):
        self.stored[oid] = blob


@rt_api.remote
def _filled(i):
    return np.full((3 << 20) // 8, float(i))


@needs_native
def test_memory_pressure_flag_spills_into_the_session_dir(monkeypatch):
    """``RAY_TPU_MEMORY_PRESSURE=1`` (the flag ``memory_pressure``) arms
    each daemon's arena spilling: five 3 MiB results held in an 8 MiB
    arena spill the cold ones into ``spill_<node>`` in the driver's
    session dir, come back intact, and the dir goes with shutdown()."""
    monkeypatch.setenv("RAY_TPU_MEMORY_PRESSURE", "1")
    rt = rt_api.init(num_nodes=1, resources={"CPU": 2}, cluster="daemons",
                     object_store_memory=8 << 20)
    try:
        backend = rt.cluster_backend
        handle = next(iter(backend.daemons.values()))
        refs = [_filled.remote(i) for i in range(5)]
        ready, _ = rt_api.wait(refs, num_returns=5, timeout=60)
        assert len(ready) == 5
        spill = handle.client.call("daemon_stats")["spill"]
        assert spill["spills"] >= 2
        spill_dir = os.path.join(backend.session_dir,
                                 f"spill_{handle.node_id.hex()[:12]}")
        assert os.path.isdir(spill_dir)
        for i, ref in enumerate(refs):
            got = rt_api.get(ref)
            assert got.shape == ((3 << 20) // 8,)
            assert float(got[0]) == float(got[-1]) == float(i)
            del got
        assert handle.client.call("daemon_stats")["spill"]["restores"] >= 2
        session = backend.session_dir
    finally:
        rt_api.shutdown()
    assert not os.path.exists(session)


@rt_api.remote(num_returns=2)
def _two_returns():
    return np.ones(1 << 20, dtype=np.uint8), 5


@rt_api.remote
def _one_return():
    return np.ones(1 << 20, dtype=np.uint8)


@needs_native
def test_two_return_task_holds_one_copy_in_the_arena():
    """A task with two returns costs its array's bytes once in the
    daemon's arena, as a one-return task does: the tuple's blob, which the
    driver fetches once and splits, is freed when the returns are stored
    on their own (JAX's daemons keep it as well and hold the array twice,
    ROADMAP C24), and freeing both refs empties the arena again."""
    rt = rt_api.init(num_nodes=1, resources={"CPU": 2}, cluster="daemons",
                     object_store_memory=64 << 20)
    try:
        handle = next(iter(rt.cluster_backend.daemons.values()))

        def used():
            return handle.client.call("daemon_stats")["store_used"]

        def settle(want, timeout=10.0):
            deadline = time.monotonic() + timeout
            got = used()
            while got != want and time.monotonic() < deadline:
                time.sleep(0.05)
                got = used()
            return got

        base = used()
        one = _one_return.remote()
        rt_api.get(one)
        one_cost = settle(base + (1 << 20)) - base
        del one
        settle(base)
        a, b = _two_returns.remote()
        assert rt_api.get(b) == 5
        assert int(rt_api.get(a).sum()) == 1 << 20
        two_cost = settle(base + one_cost) - base
        assert one_cost == 1 << 20
        assert two_cost == one_cost
        del a, b
        assert settle(base) == base
    finally:
        rt_api.shutdown()


def test_push_receiver_distinct_range_accounting_and_raw_meta():
    """Review regressions: (1) duplicate/overlapping chunks from two
    concurrent senders must not count toward completion twice (a buffer
    with holes would enter the table); (2) raw-tier (dtype, shape)
    metadata travels with the push so the receiver's oid index serves
    the copy as views, not pickle-lookalike bytes."""
    from ray_tpu_torch.objectplane.push import PushReceiver
    objs = _FakeObjects()
    regs = {}
    rx = PushReceiver(objs, register_oid=lambda ref, key, raw=None:
                      regs.__setitem__(ref, (key, raw)))
    rx.chunk(b"o", 0, 8, b"1234")
    out = rx.chunk(b"o", 0, 8, b"1234")     # duplicate offset
    assert not out.get("have")
    assert b"o" not in objs.stored          # 4+4 dup != complete
    rx.chunk(b"o", 4, 8, b"5678", ref=b"r", raw=("<f4", (2,)))
    assert objs.stored[b"o"] == b"12345678"
    assert regs[b"r"] == (b"o", ("<f4", (2,)))


def test_push_receiver_have_short_circuits():
    from ray_tpu_torch.objectplane.push import PushReceiver
    objs = _FakeObjects()
    objs.stored[b"o"] = b"already"
    rx = PushReceiver(objs)
    assert rx.chunk(b"o", 0, 7, b"already").get("have") is True


def test_push_receiver_interval_merge_handles_misaligned_senders():
    """Review regression: completion is the UNION of covered intervals,
    not a sum of per-offset lengths — two senders with different chunk
    sizes must not 'complete' a buffer that still has a hole."""
    from ray_tpu_torch.objectplane.push import PushReceiver
    objs = _FakeObjects()
    rx = PushReceiver(objs)
    rx.chunk(b"m", 0, 10, b"aaaa")      # covers 0-4
    rx.chunk(b"m", 4, 10, b"bbbb")      # covers 4-8
    rx.chunk(b"m", 0, 10, b"aaaaaa")    # covers 0-6 (overlap): union
    #                                     is still only 0-8, but the
    #                                     naive sum would be 14 >= 10
    assert b"m" not in objs.stored      # bytes 8-10 never arrived
    rx.chunk(b"m", 8, 10, b"cc")
    assert objs.stored[b"m"] == b"aaaaaabbcc"


def test_push_receiver_sweep_expires_abandoned_partials():
    from ray_tpu_torch.objectplane.push import PushReceiver
    objs = _FakeObjects()
    rx = PushReceiver(objs)
    rx.chunk(b"s", 0, 100, b"x")        # partial: sender then "dies"
    assert rx.sweep(max_age_s=-1.0) == 1
    assert rx.stats["pending_expired"] == 1
    rx.chunk(b"s", 0, 4, b"full")       # a fresh transfer still works
    assert objs.stored[b"s"] == b"full"


# ---------------------------------------------------------------------------
# graceful degradation
# ---------------------------------------------------------------------------

def test_plane_disabled_falls_back_to_rpc_path():
    """objectplane_attach=False (and equally: no native build) keeps
    every object op on the classic per-RPC path — no-compiler boxes
    stay green."""
    rt = rt_api.init(num_nodes=1, resources={"CPU": 2},
                     cluster="daemons", object_store_memory=64 << 20,
                     _system_config={"objectplane_attach": False})
    try:
        for h in rt.cluster_backend.daemons.values():
            assert h.objectplane is False

        @rt_api.remote
        def round_trip(n):
            a = np.ones(n // 4, dtype=np.float32)
            ref = rt_api.put(a)
            return float(rt_api.get([ref])[0].sum())

        assert rt_api.get(round_trip.remote(1 << 20)) == float(1 << 18)
    finally:
        rt_api.shutdown()


# ---------------------------------------------------------------------------
# reclamation: the grant ledger, reclaim_client and the orphan sweep
# ---------------------------------------------------------------------------


@pytest.fixture
def table():
    from ray_tpu_torch._private.daemon import ObjectTable
    t = ObjectTable(f"rtpu_t_{os.getpid()}_{uuid.uuid4().hex[:8]}",
                    CAP, sweep=False)
    if t._shm is None:
        t.close()
        pytest.skip("arena creation failed on this box")
    try:
        yield t
    finally:
        t.close()


def _pinned(table, oid=b"obj-1", n=200_000):
    """Store a pinned arena entry (blob above the inline threshold)."""
    table.put(oid, b"x" * n)
    return oid


def _refs(table, slot):
    return int(table._shm.ext_refs(slot))


# ---------------------------------------------------------------------------
# the satellite regression: reclaim frees deferred deletes via reap,
# NOT at daemon restart
# ---------------------------------------------------------------------------

@needs_native
def test_reclaim_frees_deferred_delete_without_restart(table):
    """A deferred-deleted entry whose LAST external ref is dropped by
    reclaim_client is freed by the reap reclaim itself runs — the bytes
    are re-allocatable immediately, no daemon restart involved."""
    oid = _pinned(table, n=int(CAP * 0.6))   # > half: two can't coexist
    meta = table.get_ext_meta(oid, "w:4242:1")
    assert meta is not None
    slot = meta[4]
    assert _refs(table, slot) == 1

    # delete while the grant pins it: deferred, bytes still held
    table.delete(oid)
    used_before = table.used_bytes()
    assert used_before >= int(CAP * 0.6)
    assert table.reserve(b"probe", int(CAP * 0.6)) is None  # no room

    dropped, aborted = table.reclaim_client("w:4242:1")
    assert dropped == 1 and aborted == 0
    assert _refs(table, slot) == 0
    # reclaim's own reap freed the deferred entry: same-size reserve
    # now fits in the same (still-running) table
    off = table.reserve(b"probe2", int(CAP * 0.6))
    assert off is not None


@needs_native
def test_double_reclaim_is_idempotent(table):
    """A second death signal for the same client finds an empty ledger:
    nothing is dropped twice (a re-drop would steal refs a later holder
    of the recycled slot legitimately owns)."""
    oid = _pinned(table)
    slot = table.get_ext_meta(oid, "w:7:1")[4]
    # a second, LIVE client shares the slot
    assert table.get_ext_meta(oid, "w:8:1")[4] == slot
    assert _refs(table, slot) == 2

    assert table.reclaim_client("w:7:1") == (1, 0)
    assert _refs(table, slot) == 1          # the live holder's ref
    assert table.reclaim_client("w:7:1") == (0, 0)   # idempotent
    assert _refs(table, slot) == 1
    assert table.reclaim_client("w:8:1") == (1, 0)
    assert _refs(table, slot) == 0


# ---------------------------------------------------------------------------
# the safe bound: ledgers over-count, reclaim never steals
# ---------------------------------------------------------------------------

@needs_native
def test_reclaim_never_steals_a_live_clients_ref(table):
    """The dead client already released one grant with a silent local
    atomic (its ledger over-counts): reclaim drops only
    observed - other clients' charges, leaving the live reader's ref."""
    oid = _pinned(table)
    slot = table.get_ext_meta(oid, "w:100:1")[4]    # dead-to-be
    table.get_ext_meta(oid, "w:100:1")              # granted twice
    table.get_ext_meta(oid, "w:200:1")              # live co-holder
    assert _refs(table, slot) == 3
    table._shm.ext_release(slot)    # dead client's silent release
    assert _refs(table, slot) == 2

    # ledger says 2, but only 1 is really theirs (2 observed - 1 other)
    assert table.reclaim_client("w:100:1") == (1, 0)
    assert _refs(table, slot) == 1  # live holder keeps reading


@needs_native
def test_reclaim_aborts_unsealed_reservations(table):
    """A writer that dies between reserve and seal: reclaim aborts its
    reservation and the key is clean for reuse."""
    assert table.reserve(b"res-1", 1 << 20, "w:55:1") is not None
    assert table.reserve(b"res-2", 1 << 20, "w:55:1") is not None
    used = table.used_bytes()
    assert used >= 2 << 20

    dropped, aborted = table.reclaim_client("w:55:1")
    assert aborted == 2 and dropped == 0
    assert table.used_bytes() < used
    assert table.reserve(b"res-1", 1 << 20, "w:56:1") is not None


@needs_native
def test_sealed_reservation_is_not_reclaimed(table):
    """Seal clears the reservation charge: the writer dying AFTER seal
    must not drop the sealed entry."""
    off = table.reserve(b"sealed", 300_000, "w:9:1")
    assert off is not None
    assert table.seal(b"sealed")
    assert table.reclaim_client("w:9:1") == (0, 0)
    assert table.get_blob(b"sealed") is not None


# ---------------------------------------------------------------------------
# the heartbeat sweep: stale reservations + ledger-drift true-up
# ---------------------------------------------------------------------------

@needs_native
def test_stale_reservations_respect_ttl(table):
    table.reserve(b"old", 4096, "c:abc")
    assert table.stale_reservations(ttl=0.0) == [b"old"]
    assert table.stale_reservations(ttl=3600.0) == []
    time.sleep(0.02)
    assert table.stale_reservations(ttl=0.01) == [b"old"]
    table.abort_reserve(b"old")
    assert table.stale_reservations(ttl=0.0) == []


@needs_native
def test_sweep_force_drops_holderless_refs(table):
    """A slot with outstanding refs but NO ledger holder carries only
    refs of already-reclaimed clients (reclaim's bound left a residue):
    the sweep forces them to zero."""
    oid = _pinned(table)
    slot = table.get_ext_meta(oid, "w:1:1")[4]
    # an untagged incref (legacy path / pre-ledger client): invisible
    # to the ledger, so reclaim's safe bound strands it...
    table._shm.get_ext(oid)
    assert _refs(table, slot) == 2
    assert table.reclaim_client("w:1:1") == (1, 0)
    assert _refs(table, slot) == 1
    # ...until the orphan sweep sees refs with no registered holder
    assert table.sweep_orphan_slots() == 1
    assert _refs(table, slot) == 0


@needs_native
def test_sweep_clamps_single_holder_overcount(table):
    """Silent local releases shrink observed refs below the single
    holder's charge: the sweep clamps the ledger down (preserving the
    ledger >= actual invariant) without dropping the live ref."""
    oid = _pinned(table)
    slot = table.get_ext_meta(oid, "w:3:1")[4]
    table.get_ext_meta(oid, "w:3:1")
    table.get_ext_meta(oid, "w:3:1")
    assert _refs(table, slot) == 3
    table._shm.ext_release(slot)     # two silent client-side releases
    table._shm.ext_release(slot)
    assert _refs(table, slot) == 1

    assert table.sweep_orphan_slots() == 0      # clamp, not drop
    assert _refs(table, slot) == 1
    assert table._ext_slots["w:3:1"][slot] == 1
    # the clamped ledger now reclaims EXACTLY what the client holds
    assert table.reclaim_client("w:3:1") == (1, 0)
    assert _refs(table, slot) == 0


@needs_native
def test_sweep_does_not_touch_live_grants(table):
    oid = _pinned(table)
    slot = table.get_ext_meta(oid, "w:11:1")[4]
    assert table.sweep_orphan_slots() == 0
    assert _refs(table, slot) == 1


# ---------------------------------------------------------------------------
# observability: attribution rows + zero-ref pruning
# ---------------------------------------------------------------------------

@needs_native
def test_slot_ref_stats_attribution_and_pruning(table):
    oid = _pinned(table)
    slot = table.get_ext_meta(oid, "w:21:1")[4]
    table.get_ext_meta(oid, "w:21:1")
    table.get_ext_meta(oid, "c:deadbeef")

    stats = table.slot_ref_stats(attribution=True)
    assert stats["refs"] == 3 and stats["held"] == 1
    rows = {r["client"]: r for r in stats["clients"]}
    assert rows["w:21:1"]["granted"] == 2
    assert rows["c:deadbeef"]["granted"] == 1

    # tagged owner-side releases retire the charges with the refs
    table.ext_release(slot, "w:21:1")
    table.ext_release(slot, "w:21:1")
    table.ext_release(slot, "c:deadbeef")
    stats = table.slot_ref_stats(attribution=True)
    assert stats == {"held": 0, "refs": 0, "clients": []}
    # fully-released slots leave tracking entirely
    assert table._slot_owners == {} and table._ext_slots == {}


@needs_native
def test_ledger_clients_lists_grants_and_reservations(table):
    oid = _pinned(table)
    table.get_ext_meta(oid, "w:31:1")
    table.reserve(b"r", 4096, "c:conn1")
    assert table.ledger_clients() == ["c:conn1", "w:31:1"]


# ---------------------------------------------------------------------------
# native bulk op
# ---------------------------------------------------------------------------

@needs_native
def test_ext_release_n_floors_at_zero(table):
    """rtpu_ext_release_n drops at most what the slot holds and reports
    what it actually dropped (CAS loop floored at zero)."""
    oid = _pinned(table)
    slot = table.get_ext_meta(oid, "w:41:1")[4]
    table.get_ext_meta(oid, "w:41:1")
    assert _refs(table, slot) == 2
    assert table._shm.ext_release_n(slot, 5) == 2   # clamped
    assert _refs(table, slot) == 0
    assert table._shm.ext_release_n(slot, 1) == 0   # already zero
    assert _refs(table, slot) == 0


# ---------------------------------------------------------------------------
# failpoint seams of the worker's side of the plane
# ---------------------------------------------------------------------------

def test_shm_attach_failpoint_drops_to_rpc_fallback(monkeypatch):
    """shm.attach drop arm: the worker's mapping fails -> the plane
    disables for that process and object ops fall back per-RPC; the
    task still succeeds (never task failure)."""
    from ray_tpu_torch._private import failpoints as fp
    monkeypatch.setenv("RAY_TPU_FAILPOINTS", "shm.attach=drop")
    rt_api.init(num_nodes=1, resources={"CPU": 2}, cluster="daemons",
                object_store_memory=64 << 20)
    try:
        @rt_api.remote
        def round_trip(n):
            a = np.ones(n // 4, dtype=np.float32)
            ref = rt_api.put(a)
            total = float(rt_api.get([ref])[0].sum())
            from ray_tpu_torch.objectplane.arena import arena_stats
            return total, arena_stats()

        total, stats = rt_api.get(round_trip.remote(1 << 20))
        assert total == float(1 << 18)
        if stats:   # arena configured: the attach must have failed
            assert stats["attached"] == 0
            assert stats["attach_failures"] >= 1
            assert stats["zero_copy_gets"] == 0
    finally:
        rt_api.shutdown()
        fp.reset()


@needs_native
def test_shm_seal_drop_retries_idempotently(monkeypatch):
    """shm.seal drop arm: the first seal message is lost; the writer
    resends and the retried seal lands the SAME entry (exactly-once
    object, correct bytes)."""
    from ray_tpu_torch._private import failpoints as fp
    monkeypatch.setenv("RAY_TPU_FAILPOINTS", "shm.seal=drop:max=1")
    rt_api.init(num_nodes=1, resources={"CPU": 2}, cluster="daemons",
                object_store_memory=64 << 20)
    try:
        @rt_api.remote
        def put_and_read(n):
            a = np.arange(n // 4, dtype=np.float32)
            ref = rt_api.put(a)
            got = rt_api.get([ref])[0]
            from ray_tpu_torch.objectplane.arena import arena_stats
            return float(got[n // 8]), arena_stats()

        v, stats = rt_api.get(put_and_read.remote(1 << 20))
        assert v == float(1 << 17)
        if stats.get("attached"):
            assert stats["direct_puts"] >= 1    # direct path survived
    finally:
        rt_api.shutdown()
        fp.reset()
