"""The port's native shared-memory object store (``ray_tpu_torch/
native_store.py`` over ``csrc/shm_store.cc``): the tests of
``tests/test_native_store.py`` on the port's store, the runtime's native
tier (``_private/object_store.py``), a mount too small for the arena, and
one sequence run on JAX's store and the port's."""

import gc
import os
import shutil
import subprocess
import sys
import textwrap

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch._private import object_store as port_store
from ray_tpu_torch._private.ids import NodeID, ObjectID
from ray_tpu_torch.native_store import ShmObjectStore, ShmStoreFull, available

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_available_where_gxx_is():
    """``available()`` is False only where g++ is missing, as in JAX."""
    assert available() == (shutil.which("g++") is not None)


needs_gxx = pytest.mark.skipif(not available(), reason="no g++ on this host")


@pytest.fixture
def store():
    s = ShmObjectStore(f"rtpt_test_{os.getpid()}", 1 << 20)  # 1 MiB
    yield s
    s.close()


# ---------------------------------------------------------------------------
# tests/test_native_store.py
# ---------------------------------------------------------------------------

@needs_gxx
def test_put_get_zero_copy(store):
    data = np.arange(1000, dtype=np.float64)
    store.put(b"obj1", data.tobytes())
    view = store.get_view(b"obj1")
    back = np.frombuffer(view, np.float64)
    np.testing.assert_array_equal(back, data)
    assert not view.flags.writeable
    assert store.num_objects() == 1
    assert store.used_bytes() == data.nbytes
    store.release(b"obj1")


@needs_gxx
def test_duplicate_put_rejected(store):
    store.put(b"x", b"abc")
    with pytest.raises(KeyError):
        store.put(b"x", b"def")


@needs_gxx
def test_delete_frees_space(store):
    store.put(b"a", b"\x00" * 1000)
    used = store.used_bytes()
    store.delete(b"a")
    assert store.used_bytes() == used - 1000
    assert not store.contains(b"a")


@needs_gxx
def test_lru_eviction_under_pressure(store):
    # fill the 1 MiB store with 5 x 200 KiB objects (1,024,000 bytes); a
    # sixth requires evicting the least-recently-released object (o0)
    blob = b"\x01" * (200 * 1024)
    for i in range(5):
        store.put(f"o{i}".encode(), blob)
    for i in range(1, 5):
        store.get_view(f"o{i}".encode())
        store.release(f"o{i}".encode())
    store.put(b"new", blob)
    assert store.contains(b"new")
    assert not store.contains(b"o0")
    assert all(store.contains(f"o{i}".encode()) for i in range(1, 5))


@needs_gxx
def test_pinned_objects_not_evicted(store):
    blob = b"\x02" * (300 * 1024)
    for name in (b"a", b"b", b"c"):
        store.put(name, blob)
        store.get_view(name)          # pin
    with pytest.raises(ShmStoreFull):
        store.put(b"d", blob)
    assert all(store.contains(n) for n in (b"a", b"b", b"c"))
    for name in (b"a", b"b", b"c"):
        store.release(name)
    store.put(b"d", blob)             # now eviction can proceed
    assert store.contains(b"d")


@needs_gxx
def test_free_list_coalescing(store):
    third = (1 << 20) // 3 - 64
    for name in (b"a", b"b", b"c"):
        store.put(name, b"\x03" * third)
    store.delete(b"a")
    store.delete(b"b")
    store.put(b"big", b"\x04" * (2 * third))  # needs coalesced a+b
    assert store.contains(b"big")


@needs_gxx
def test_deferred_delete_while_view_held(store):
    data = np.arange(4096, dtype=np.float64)
    store.put(b"live", data.tobytes())
    view = store.get_view(b"live")           # incref
    store.delete(b"live")                    # deferred: ref outstanding
    with pytest.raises(KeyError):
        store.get_view(b"live")
    filler = np.zeros(8192, np.uint8)
    for i in range(20):
        try:
            store.put(b"f%d" % i, filler.tobytes())
        except ShmStoreFull:
            break
    np.testing.assert_array_equal(np.frombuffer(view, np.float64), data)
    before = store.used_bytes()
    store.release(b"live")                   # last ref: frees now
    assert store.used_bytes() == before - data.nbytes


@needs_gxx
def test_deferred_deleted_object_not_evictable(store):
    data = np.ones(1024, np.float64)
    store.put(b"zombie", data.tobytes())
    view = store.get_view(b"zombie")
    store.delete(b"zombie")
    store.evict(1 << 30)
    np.testing.assert_array_equal(np.frombuffer(view, np.float64), data)
    store.release(b"zombie")


@needs_gxx
def test_pinned_delete_frees_space(store):
    data = np.arange(2048, dtype=np.float64)
    store.put(b"pinned", data.tobytes(), pin=True)
    before = store.used_bytes()
    store.delete(b"pinned")
    assert store.used_bytes() == before - data.nbytes
    store.put(b"pinned2", data.tobytes(), pin=True)
    view = store.get_view(b"pinned2")
    store.delete(b"pinned2")
    np.testing.assert_array_equal(np.frombuffer(view, np.float64), data)
    before = store.used_bytes()
    store.release(b"pinned2")
    assert store.used_bytes() == before - data.nbytes


# ---------------------------------------------------------------------------
# the rest of the port's surface: reserve/seal, ext slots, attach, reap
# ---------------------------------------------------------------------------

@needs_gxx
def test_reserve_seal_attach_and_ext_refs(store):
    """A reserved range filled through an attached handle, sealed, read
    through the slot protocol; the slot's ref blocks eviction until
    released, and a deleted object is reaped once its last ext ref goes."""
    off = store.reserve(b"direct", 4096)
    assert store.reserve(b"direct", 4096) == off   # idempotent retry
    with pytest.raises(KeyError):
        store.reserve(b"direct", 8192)
    other = ShmObjectStore.attach(store.name)
    try:
        assert other.attached
        other.write_range(off, np.full(4096, 7, np.uint8))
        store.seal(b"direct", pin=False)
        assert store.stat(b"direct") == (off, 4096, True)
        off2, size, slot = store.get_ext(b"direct")
        assert (off2, size) == (off, 4096)
        assert other.ext_refs(slot) == 1
        assert bytes(other.read_range(off, 4)) == b"\x07" * 4
        assert store.evict(1 << 30) == 0           # held by the slot
        store.delete(b"direct")                    # deferred
        assert store.reap() == 0
        other.ext_release(slot)
        assert store.reap() == 4096
        assert store.num_objects() == 0
        assert other.ext_release_n(slot, 3) == 0   # floors at zero
    finally:
        other.detach_leak()
    with pytest.raises(RuntimeError):
        ShmObjectStore.attach(f"rtpt_absent_{os.getpid()}")


@needs_gxx
def test_unlink_only_keeps_views_valid():
    s = ShmObjectStore(f"rtpt_unlink_{os.getpid()}", 1 << 20)
    data = np.arange(512, dtype=np.float64)
    s.put(b"a", data.tobytes())
    view = s.get_view(b"a")
    s.unlink_only()
    assert not os.path.exists(f"/dev/shm/rtpt_unlink_{os.getpid()}")
    np.testing.assert_array_equal(np.frombuffer(view, np.float64), data)


# ---------------------------------------------------------------------------
# the runtime's native tier
# ---------------------------------------------------------------------------

def _segment(store) -> str:
    return f"/dev/shm/{port_store.arena_name(store.node_id)}"


@needs_gxx
def test_runtime_tier_native_threshold_views_delete_and_close():
    """A 1 MiB array goes native, a 1 KiB one does not; the view is
    read-only and zero-copy; delete while a view lives defers the free to
    the view's release; close unlinks the segment."""
    st = port_store.LocalObjectStore(NodeID.from_random(), 64 << 20)
    try:
        assert st.native_capacity() >= 64 << 20
        assert os.path.exists(_segment(st))
        big, small = ObjectID.from_random(), ObjectID.from_random()
        a = np.arange(1 << 18, dtype=np.float32)            # 1 MiB
        st.put(big, a)
        st.put(small, np.arange(256, dtype=np.float32))     # 1 KiB
        assert st.stats["native_puts"] == 1
        assert st.used_bytes() == 1024      # the arena accounts the big one
        assert st._native.used_bytes() == a.nbytes
        view = st.get(big)
        np.testing.assert_array_equal(view, a)
        assert not view.flags.writeable
        with pytest.raises(ValueError):
            view[0] = 1.0
        assert st.get(small).flags.writeable is False
        st.delete(big)
        assert st._native.used_bytes() == a.nbytes   # a view still reads it
        np.testing.assert_array_equal(view, a)
        del view
        gc.collect()
        assert st._native.used_bytes() == 0
        assert st._native_views == {}
        # a non-contiguous array and an object array keep the Python tier
        st.put(ObjectID.from_random(), np.ones((512, 512), np.float32)[:, ::2])
        st.put(ObjectID.from_random(), np.array([object()] * 20000))
        assert st.stats["native_puts"] == 1
    finally:
        st.close()
    assert not os.path.exists(_segment(st))


@needs_gxx
def test_runtime_close_with_a_live_view_unlinks_only():
    st = port_store.LocalObjectStore(NodeID.from_random(), 16 << 20)
    oid = ObjectID.from_random()
    st.put(oid, np.arange(1 << 16, dtype=np.float64))
    view = st.get(oid)
    st.close()
    assert not os.path.exists(_segment(st))
    assert view[123] == 123.0      # the mapping outlives the name


@needs_gxx
def test_runtime_task_results_go_native_and_shutdown_unlinks():
    rt = ray_tpu_torch.init(num_nodes=1, resources={"CPU": 4})
    try:
        @ray_tpu_torch.remote
        def make(n):
            return np.arange(n, dtype=np.float32)

        (node,) = rt.nodes()
        seg = _segment(node.store)
        assert os.path.exists(seg)
        out = ray_tpu_torch.get(make.remote(1 << 18))
        np.testing.assert_array_equal(out, np.arange(1 << 18,
                                                     dtype=np.float32))
        assert not out.flags.writeable
        assert node.store.stats["native_puts"] == 1
        # the owner memory store's 2**62 bytes cannot be mapped: no arena,
        # as in JAX (ray_tpu/_private/worker.py:204)
        assert rt.memory_store.native_capacity() == 0
        del out
    finally:
        ray_tpu_torch.shutdown()
    assert not os.path.exists(seg)


@needs_gxx
def test_native_store_flag_off(monkeypatch):
    monkeypatch.setenv("RAY_TPU_NATIVE_STORE", "0")
    from ray_tpu_torch._private import config
    config.reset()
    try:
        st = port_store.LocalObjectStore(NodeID.from_random(), 8 << 20)
        st.put(ObjectID.from_random(), np.ones(1 << 18, np.float32))
        assert st.stats["native_puts"] == 0 and st.native_capacity() == 0
        st.close()
    finally:
        config.reset()


@needs_gxx
def test_full_arena_takes_the_python_tier(monkeypatch):
    """JAX's path on RTPU_ERR_FULL: the put lands in the Python tier, the
    value intact."""
    st = port_store.LocalObjectStore(NodeID.from_random(), 8 << 20)
    try:
        def full(*a, **k):
            raise ShmStoreFull("cannot allocate (rc=-1)")

        monkeypatch.setattr(st._native, "put", full)
        oid = ObjectID.from_random()
        a = np.arange(1 << 18, dtype=np.float32)
        st.put(oid, a)
        assert st.stats["native_puts"] == 0
        assert st.used_bytes() == a.nbytes
        np.testing.assert_array_equal(st.get(oid), a)
    finally:
        st.close()


_SMALL_MOUNT = textwrap.dedent("""
    import sys
    import numpy as np
    sys.path.insert(0, {repo!r})
    from ray_tpu_torch._private import object_store as ps
    from ray_tpu_torch._private.ids import NodeID, ObjectID
    from ray_tpu_torch.native_store import ShmObjectStore, ShmStoreFull

    # the arena is sized as JAX's (64 MiB) on an 8 MiB mount: JAX's store
    # takes SIGBUS on the first write past 8 MiB
    s = ShmObjectStore("rtpt_small", 64 << 20)
    s.put(b"a", np.ones(4 << 20, np.uint8))
    try:
        s.put(b"b", np.ones(6 << 20, np.uint8))
        print("no-full")
    except ShmStoreFull:
        print("full")
    s.put(b"c", np.ones(2 << 20, np.uint8))
    print("objects", s.num_objects(), "used", s.used_bytes())
    s.close()

    st = ps.LocalObjectStore(NodeID.from_random(), 64 << 20)
    ids = [ObjectID.from_random() for _ in range(3)]
    arrs = [np.full(3 << 20, i, np.uint8) for i in range(3)]
    for oid, a in zip(ids, arrs):
        st.put(oid, a)
    ok = all((st.get(oid) == a).all() for oid, a in zip(ids, arrs))
    print("tier", st.stats["native_puts"], st.used_bytes(), ok)
    st.close()
""")


@needs_gxx
def test_mount_too_small_for_the_arena_fails_over(tmp_path):
    """/dev/shm smaller than the arena (a container's default mount): a put
    the mount cannot back fails as ShmStoreFull and the runtime's store
    keeps the object in the Python tier, where JAX's store faults. The
    mount is a real 8 MiB tmpfs in a private mount namespace."""
    script = tmp_path / "small.py"
    script.write_text(_SMALL_MOUNT.format(repo=REPO))
    proc = subprocess.run(
        ["unshare", "-rm", "sh", "-c",
         "mount -t tmpfs -o size=8m tmpfs /dev/shm && exec "
         f"{sys.executable} {script}"],
        capture_output=True, text=True, timeout=120)
    if proc.returncode != 0 and "mount" in proc.stderr and \
            "Bus error" not in proc.stderr:
        pytest.skip(f"no private mount namespace here: {proc.stderr[-200:]}")
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.split("\n")
    assert lines[0] == "full"
    assert lines[1] == f"objects 2 used {6 << 20}"
    # two 3 MiB arrays fit the mount beside the header; the third takes
    # the Python tier, every value intact
    assert lines[2] == f"tier 2 {3 << 20} True"


# ---------------------------------------------------------------------------
# one sequence on JAX's store and the port's
# ---------------------------------------------------------------------------

def _sequence(cls, name):
    """put/get/release/delete/evict on a 1 MiB arena; returns what a user
    of the store sees after each step."""
    s = cls(name, 1 << 20)
    trace = []

    def note(what):
        trace.append((what, s.used_bytes(), s.num_objects(),
                      tuple(k for k in (b"a", b"b", b"c", b"d", b"e", b"f",
                                        b"g") if s.contains(k))))

    try:
        rng = np.random.default_rng(0)
        for key, kib in zip((b"a", b"b", b"c", b"d"), (200, 300, 100, 250)):
            s.put(key, rng.integers(0, 255, kib * 1024, np.uint8))
            note(("put", key))
        s.get_view(b"b")
        s.release(b"b")
        s.get_view(b"a")        # held: not evictable
        note("views")
        s.put(b"e", np.zeros(300 * 1024, np.uint8))   # evicts c, then d
        note(("put", b"e"))
        s.delete(b"a")          # deferred: a view holds it
        note(("delete", b"a"))
        s.put(b"f", np.zeros(150 * 1024, np.uint8), pin=True)
        note(("put", b"f"))
        freed = s.evict(600 * 1024)
        note(("evict", freed))
        s.release(b"a")         # the last ref of a deleted object: freed
        note(("release", b"a"))
        try:
            s.put(b"g", np.zeros(900 * 1024, np.uint8))
            note(("put", b"g"))
        except Exception as e:  # noqa: BLE001 - the class is the result
            note(("put", b"g", type(e).__name__))
        s.delete(b"f")
        note(("delete", b"f"))
    finally:
        s.close()
    return trace


@needs_gxx
def test_same_sequence_as_jax_store():
    from ray_tpu import native_store as jax_native
    if not jax_native.available():
        pytest.skip("JAX's native store did not build")
    jax_trace = _sequence(jax_native.ShmObjectStore,
                          f"rtpu_seq_{os.getpid()}")
    port_trace = _sequence(ShmObjectStore, f"rtpt_seq_{os.getpid()}")
    assert port_trace == jax_trace
    # the sequence reached what it was written for
    steps = dict((str(w), (u, n, keys)) for w, u, n, keys in port_trace)
    assert steps[str(("put", b"e"))][2] == (b"a", b"b", b"e")
    assert b"a" not in steps[str(("release", b"a"))][2]
