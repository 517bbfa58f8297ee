"""The port's daemon cluster: head and node-daemon OS processes on the
port's RPC wire (copies of ``tests/test_cluster_daemons.py`` against
``ray_tpu_torch``).

A head (``ray_tpu_torch._private.head``) and node daemons
(``ray_tpu_torch._private.daemon``) run as spawned processes with a typed
RPC contract (the lease protocol, the placement group's two-phase commit),
shm object transfer between processes, daemon-to-daemon object pulls,
active health checking with pubsub death broadcast, and chaos recovery: a
SIGKILL of a daemon process triggers task retry and actor restart with no
``remove_node()`` call in the test.

Tests that neither kill nor mutate the cluster share one class-scoped
cluster; each chaos test boots its own. The head's task-event store, the
post-mortem state read and the per-node agent endpoints are copied into
``tests/test_torch_observability.py``. Left out of JAX's file: the
autoscaler test (autoscaler v2, in no queue of this slice).
"""

import os
import signal
import time

import numpy as np
import pytest

import ray_tpu_torch as rt_api
from ray_tpu_torch import exceptions as exc


@pytest.fixture(scope="class")
def shared_cluster():
    rt = rt_api.init(num_nodes=2, resources={"CPU": 4}, cluster="daemons",
                     object_store_memory=256 << 20)
    yield rt
    rt_api.shutdown()


@pytest.fixture
def daemon_cluster():
    if rt_api.is_initialized():
        pytest.fail("a runtime is already up")
    rt = rt_api.init(num_nodes=2, resources={"CPU": 4}, cluster="daemons",
                     object_store_memory=128 << 20)
    yield rt
    rt_api.shutdown()


def _daemon_handles(rt):
    return list(rt.cluster_backend.daemons.values())


def _left_after(pids, timeout_s: float):
    """The pids still running (not gone, not a zombie) once ``timeout_s``
    has passed or none is left."""
    deadline = time.monotonic() + timeout_s
    while True:
        left = []
        for p in pids:
            try:
                with open(f"/proc/{p}/stat") as f:
                    state = f.read().rsplit(")", 1)[1].split()[0]
            except OSError:
                continue
            if state != "Z":
                left.append(p)
        if not left or time.monotonic() > deadline:
            return left
        time.sleep(0.05)


class TestOneCluster:
    """The tests that neither kill nor mutate the cluster share one."""

    def test_processes_exist(self, shared_cluster):
        rt = shared_cluster
        backend = rt.cluster_backend
        assert backend.head_proc.poll() is None  # head process alive
        handles = _daemon_handles(rt)
        assert len(handles) == 2
        for handle in handles:
            assert handle.proc.poll() is None
            out = handle.client.call("daemon_ping")
            assert out["pid"] == handle.proc.pid

    def test_tasks_execute_in_daemon_workers(self, shared_cluster):
        rt = shared_cluster
        daemon_pids = {h.proc.pid for h in _daemon_handles(rt)}

        @rt_api.remote
        def tree():
            import os
            return os.getpid(), os.getppid()

        results = rt_api.get([tree.remote() for _ in range(8)])
        driver = os.getpid()
        for pid, _ppid in results:
            assert pid != driver
            assert pid not in daemon_pids  # a worker, not the daemon itself

    def test_large_result_via_shm_arena(self, shared_cluster):
        """>100 KiB results stay in the daemon's object table (the shm arena)
        and are fetched across processes on get()."""

        @rt_api.remote
        def big():
            return np.arange(200_000)  # ~1.6 MB

        ref = big.remote()
        out = rt_api.get(ref)
        assert out.shape == (200_000,) and out[-1] == 199_999
        # the blob lives remotely: some daemon's store holds bytes
        used = [h.client.call("daemon_stats")["store_used"]
                for h in _daemon_handles(shared_cluster)]
        assert max(used) > 100_000

    def test_inter_daemon_pull(self, shared_cluster):
        """Object plane: daemon B pulls an object it doesn't have from
        daemon A."""
        a, b = _daemon_handles(shared_cluster)
        blob = b"x" * 300_000
        a.put_object_blob(b"oid-pull-test", blob)
        assert b.pull_object(b"oid-pull-test", a.addr)
        got = b.get_object_blob(b"oid-pull-test")
        assert got == blob

    def test_nested_ops_reach_owner(self, shared_cluster):
        """Worker-initiated core ops flow daemon -> driver."""

        @rt_api.remote
        def inner(x):
            return x + 1

        @rt_api.remote
        def outer():
            refs = [inner.remote(i) for i in range(4)]
            return sum(rt_api.get(refs))

        assert rt_api.get(outer.remote()) == 10

    def test_head_kv(self, shared_cluster):
        head = shared_cluster.cluster_backend.head
        assert head.kv_put(b"k1", b"v1")
        assert head.kv_get(b"k1") == b"v1"
        assert head.kv_keys(b"k") == [b"k1"]
        head.kv_del(b"k1")
        assert head.kv_get(b"k1") is None

    def test_pg_2pc_bundles_on_daemons(self, shared_cluster):
        from ray_tpu_torch.util.placement_group import (placement_group,
                                                        remove_placement_group)

        pg = placement_group([{"CPU": 2}, {"CPU": 2}], strategy="SPREAD")
        try:
            assert pg.wait(15)
            nodes = {b.node_id for b in pg.bundles}
            assert len(nodes) == 2
            # each daemon holds the committed record of its bundle
            states = []
            for handle in _daemon_handles(shared_cluster):
                bundles = handle.client.call("daemon_stats")["bundles"]
                states.extend(v for k, v in bundles.items()
                              if k.startswith(pg.id.hex()))
            assert states == ["COMMITTED", "COMMITTED"]
        finally:
            remove_placement_group(pg)
        # the cancel phase reaches both daemons
        for handle in _daemon_handles(shared_cluster):
            bundles = handle.client.call("daemon_stats")["bundles"]
            assert not any(k.startswith(pg.id.hex()) for k in bundles)

    def test_chunked_64mib_pull(self, shared_cluster):
        """A 64 MiB object moves daemon -> daemon in pull_chunk pieces, not one
        monolithic RPC frame."""
        a, b = _daemon_handles(shared_cluster)
        blob = bytes(bytearray(64 * 1024 * 1024))          # 64 MiB
        a.put_object_blob(b"oid-big", blob)
        try:
            before = b.client.call("daemon_stats")["pull_stats"]
            assert b.pull_object(b"oid-big", a.addr, priority=0)
            after = b.client.call("daemon_stats")["pull_stats"]
            assert after["bytes_pulled"] - before["bytes_pulled"] == len(blob)
            assert (after["chunks_transferred"]
                    - before["chunks_transferred"]) >= 16
            got = b.get_object_blob(b"oid-big")
            assert got == blob
        finally:
            a.free_objects([b"oid-big"])
            b.free_objects([b"oid-big"])

    def test_pull_via_owner_directory(self, shared_cluster):
        """pull_object with no location hint resolves through the owner's
        object directory."""
        rt = shared_cluster
        a, b = _daemon_handles(rt)

        @rt_api.remote
        def big():
            return np.arange(150_000)   # >100 KiB: stays in the daemon table

        ref = big.remote()
        rt_api.get(ref)  # finished and registered
        holder = None
        key = None
        for handle in (a, b):
            node = rt.get_node(handle.node_id)
            for oid in node.store.object_ids():
                if oid == ref.id:
                    holder = handle
                    key = node.store._meta[oid][0]
                    break
            if key:
                break
        assert key is not None
        other = b if holder is a else a
        assert not other.client.call("get_object", oid=key,
                                     prefer_shm=False).get("blob")
        assert other.pull_object(key, from_addr=None, priority=1)
        assert other.get_object_blob(key) is not None

    def test_resource_view_gossip(self, shared_cluster):
        """The driver reports true per-node availability to the head;
        list_nodes and the transient 'resources' channel expose the live view
        (heartbeat static values don't clobber a fresh report)."""
        backend = shared_cluster.cluster_backend
        events = []
        backend.head.subscribe("resources", events.append)

        @rt_api.remote(num_cpus=3)
        def hold():
            time.sleep(3.0)   # longer than the 2 s freshness window: steady
            return 1          # load must not revert to static values

        ref = hold.remote()
        deadline = time.monotonic() + 1.0
        seen_during = None
        while time.monotonic() < deadline:
            per_node = {n["node_id"]: n["available"].get("CPU", 0)
                        for n in backend.head.list_nodes() if n["alive"]}
            if min(per_node.values()) <= 1:
                seen_during = per_node
                break
            time.sleep(0.05)
        assert seen_during is not None, "reported availability never dropped"
        # steady load past the freshness window: the view must NOT revert
        time.sleep(1.5)
        per_node = {n["node_id"]: n["available"].get("CPU", 0)
                    for n in backend.head.list_nodes() if n["alive"]}
        assert min(per_node.values()) <= 1, (
            f"steady load reverted to static availability: {per_node}")
        rt_api.get(ref)
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline:
            per_node = {n["node_id"]: n["available"].get("CPU", 0)
                        for n in backend.head.list_nodes() if n["alive"]}
            if all(v == 4 for v in per_node.values()):
                break
            time.sleep(0.05)
        assert all(v == 4 for v in per_node.values()), per_node
        assert events and "available" in events[-1]

    def test_per_task_borrow_release(self, shared_cluster):
        """Refs the owner pins on a worker task's behalf (a nested put) release
        when THAT task finishes: a long-lived daemon must not pin dead tasks'
        objects."""
        rt = shared_cluster
        from ray_tpu_torch._private.ids import ObjectID

        @rt_api.remote
        def put_and_drop():
            ref = rt_api.put(np.arange(1000))
            return ref.id.hex()      # the hex only: no live ref escapes

        @rt_api.remote
        def put_and_return():
            return rt_api.put(np.arange(1000))

        # dropped borrow: freed once the task is done (the dropped handle can
        # sit in a reply-closure cycle, so nudge the cyclic collector)
        import gc
        oid_hex = rt_api.get(put_and_drop.remote())
        deadline = time.monotonic() + 5.0
        oid = ObjectID.from_hex(oid_hex)
        while time.monotonic() < deadline and rt.refcounter.ref_count(oid):
            gc.collect()
            time.sleep(0.05)
        assert rt.refcounter.ref_count(oid) == 0
        svc = rt.cluster_backend.owner_service
        assert svc.holder.num_keys() == 0, "holder leaked task keys"

        # returned borrow: containment in the result keeps it alive
        inner = rt_api.get(put_and_return.remote())
        assert list(rt_api.get(inner)[:3]) == [0, 1, 2]

    def test_actor_borrow_released_on_death(self, shared_cluster):
        """Actor-lifetime borrows persist across its tasks, then release on the
        actor's death."""
        rt = shared_cluster
        from ray_tpu_torch._private.ids import ObjectID

        @rt_api.remote
        class Holder:
            def make(self):
                self.ref = rt_api.put(np.arange(500))
                return self.ref.id.hex()

            def read(self):
                return int(rt_api.get(self.ref)[1])

        h = Holder.remote()
        oid = ObjectID.from_hex(rt_api.get(h.make.remote()))
        assert rt_api.get(h.read.remote()) == 1   # alive across actor tasks
        assert rt.refcounter.ref_count(oid) > 0
        rt_api.kill(h)
        import gc
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline and rt.refcounter.ref_count(oid):
            gc.collect()
            time.sleep(0.05)
        assert rt.refcounter.ref_count(oid) == 0

    def test_peer_resource_gossip(self, shared_cluster):
        """Daemon-to-daemon anti-entropy: each daemon's view converges to hold
        EVERY node's load entry through peer exchange, and the head's
        membership view gains gossip_load entries pushed by about one node an
        interval."""
        rt = shared_cluster
        handles = _daemon_handles(rt)
        all_ids = {h.node_id.hex() for h in handles}
        deadline = time.monotonic() + 15
        converged = False
        views = []
        while time.monotonic() < deadline and not converged:
            views = [set(h.client.call("syncer_view")["view"])
                     for h in handles]
            converged = all(all_ids <= v for v in views)
            if not converged:
                time.sleep(0.2)
        assert converged, f"gossip never converged: {views}"
        # entries carry real load fields
        view = handles[0].client.call("syncer_view")["view"]
        entry = view[handles[1].node_id.hex()]
        assert {"running", "store_used", "fast_queued"} <= set(entry["load"])
        # the head picked up gossip entries without per-node reports
        deadline = time.monotonic() + 15
        nodes = []
        while time.monotonic() < deadline:
            nodes = rt.cluster_backend.head.list_nodes()
            if any("gossip_load" in n for n in nodes):
                break
            time.sleep(0.2)
        assert any("gossip_load" in n for n in nodes), nodes

    def test_pull_to_node_indexes_the_copy_for_its_workers(
            self, shared_cluster):
        """Runtime.pull_to_node: one chunked daemon-to-daemon pull, after
        which a task on the destination reads the object as a view of its
        own arena (the port's pull twin of the push prefetch)."""
        rt = shared_cluster
        a, b = _daemon_handles(rt)

        @rt_api.remote
        def make():
            return np.arange(1 << 18, dtype=np.float64)     # 2 MiB

        @rt_api.remote
        def read(refs):
            from ray_tpu_torch.objectplane.arena import arena_stats
            x = rt_api.get(refs)[0]
            return float(x.sum()), bool(x.flags.writeable), arena_stats()

        ref = make.options(scheduling_strategy=rt_api.
                           NodeAffinitySchedulingStrategy(
                               node_id=a.node_id.hex(), soft=False)).remote()
        rt_api.wait([ref], timeout=60)
        node_b = rt.get_node(b.node_id)
        before = b.client.call("daemon_stats")["pull_stats"]["bytes_pulled"]
        assert rt.pull_to_node(ref.id, node_b)
        after = b.client.call("daemon_stats")["pull_stats"]["bytes_pulled"]
        assert after - before >= 1 << 21
        assert node_b.store.contains(ref.id)
        total, writeable, stats = rt_api.get(read.options(
            scheduling_strategy=rt_api.NodeAffinitySchedulingStrategy(
                node_id=b.node_id.hex(), soft=False)).remote([ref]))
        assert total == float(np.arange(1 << 18).sum())
        assert not writeable and stats["zero_copy_gets"] >= 1

    def test_driver_gets_are_views_of_the_arena(self, shared_cluster):
        """A task's large result reaches the driver as a read-only view
        inside its daemon's arena, pinned by a slot ref that drops when
        the last view of the bytes goes."""
        import ctypes
        import gc
        rt = shared_cluster

        @rt_api.remote
        def make():
            return np.full(1 << 18, 3.0)

        ref = make.remote()
        arr = rt_api.get(ref)
        (holder,) = [h for h in _daemon_handles(rt)
                     if rt.get_node(h.node_id).store.contains(ref.id)]
        arena = rt.cluster_backend.arenas.handle(holder.arena_name)
        lo = ctypes.addressof(arena._buf)
        assert lo <= arr.__array_interface__["data"][0] < lo + \
            arena.capacity()
        assert not arr.flags.writeable and float(arr[7]) == 3.0

        def refs():
            return holder.client.call("daemon_stats")["slot_refs"]["refs"]

        assert refs() >= 1
        part = arr[5:9]
        del arr
        gc.collect()
        assert refs() >= 1          # a slice still views the bytes
        del part
        gc.collect()
        assert refs() == 0

    def test_the_daemons_never_see_the_card(self, shared_cluster):
        """The head, the daemons and the daemons' workers run with
        CUDA_VISIBLE_DEVICES='' (JAX's daemons with JAX_PLATFORMS=cpu)."""
        backend = shared_cluster.cluster_backend

        def env_of(pid):
            with open(f"/proc/{pid}/environ", "rb") as f:
                pairs = f.read().split(b"\0")
            return dict(p.decode().split("=", 1) for p in pairs if b"=" in p)

        for pid in [backend.head_proc.pid] + [
                h.proc.pid for h in _daemon_handles(shared_cluster)]:
            assert env_of(pid).get("CUDA_VISIBLE_DEVICES") == ""

        @rt_api.remote
        def visible():
            return os.environ.get("CUDA_VISIBLE_DEVICES")

        assert set(rt_api.get([visible.remote() for _ in range(4)])) == {""}

    def test_push_prefetch_stages_a_remote_dependency(self, shared_cluster):
        """A task queued on one daemon with a dependency held by the other:
        the driver has the holder push it over at enqueue (PushManager),
        and the copy is indexed and recorded on the destination."""
        rt = shared_cluster
        a, b = _daemon_handles(rt)

        @rt_api.remote
        def make():
            return np.full(1 << 18, 2.0)

        @rt_api.remote
        def total(x):
            return float(x.sum())

        def on(handle):
            return rt_api.NodeAffinitySchedulingStrategy(
                node_id=handle.node_id.hex(), soft=False)

        ref = make.options(scheduling_strategy=on(a)).remote()
        rt_api.wait([ref], timeout=60)
        before = rt.stats["objects_push_prefetched"]
        pushed = a.client.call("daemon_stats")["push_stats"]["bytes_pushed"]
        assert rt_api.get(total.options(
            scheduling_strategy=on(b)).remote(ref)) == 2.0 * (1 << 18)
        deadline = time.monotonic() + 10
        while (rt.stats["objects_push_prefetched"] == before
               and time.monotonic() < deadline):
            time.sleep(0.05)
        assert rt.stats["objects_push_prefetched"] == before + 1
        assert rt.get_node(b.node_id).store.contains(ref.id)
        assert (a.client.call("daemon_stats")["push_stats"]["bytes_pushed"]
                - pushed) >= 1 << 21

    def test_explicit_lease_protocol(self, shared_cluster):
        """request_worker_lease / push_task / return_worker: the task runs
        on the leased worker, whose lease its final outcome releases (as
        JAX's, the driver's return_worker is then a no-op), so a second
        push on it is refused. The coalesced push_task_batch is the
        common path."""
        import pickle

        from ray_tpu_torch._private import cluster, fast_lane
        from ray_tpu_torch._private.ids import TaskID
        from ray_tpu_torch._private.task_spec import TaskKind, TaskSpec
        from ray_tpu_torch._private.worker_process import (_pack,
                                                           export_function)

        def mul(a, b):
            return os.getpid(), a * b

        handle = _daemon_handles(shared_cluster)[0]
        fid, _ = export_function(mul)
        lease = handle.client.call("request_worker_lease", task_meta={})
        spec = TaskSpec(task_id=TaskID.from_random(), kind=TaskKind.NORMAL,
                        name="mul", func=None)
        kw = dict(spec=pickle.dumps(spec), fid=fid,
                  args=bytes(fast_lane.join_parts(_pack(((3, 5), {})))),
                  lease_id=lease["lease_id"], backpressure=-1)
        out = handle.client.call("push_task", **kw)
        assert out["outcome"] == "ok"
        assert cluster._load_blob(out["blob"]) == (lease["worker_pid"], 15)
        assert handle.client.call("return_worker",
                                  lease_id=lease["lease_id"])["ok"]
        with pytest.raises(rt_api._private.rpc.RemoteError,
                           match="unknown lease"):
            handle.client.call("push_task", **kw)

def test_chaos_sigkill_daemon_task_retry(daemon_cluster, tmp_path):
    """SIGKILL a daemon process mid-task: the head's health check (or the
    driver's first-hand RPC failure) marks the node dead and the task is
    retried elsewhere, with no remove_node() anywhere."""
    rt = daemon_cluster
    marker = str(tmp_path)

    @rt_api.remote(max_retries=2)
    def slow():
        import os as _os
        import time as _time
        n = len(_os.listdir(marker))
        open(_os.path.join(marker, str(n)), "w").close()
        if n == 0:
            _time.sleep(30)
        return "recovered"

    ref = slow.remote()
    deadline = time.monotonic() + 10
    victim = None
    while victim is None and time.monotonic() < deadline:
        for handle in _daemon_handles(rt):
            if handle.client.call("daemon_stats")["running"] > 0:
                victim = handle
                break
        time.sleep(0.05)
    assert victim is not None, "task never started on a daemon"
    os.kill(victim.proc.pid, signal.SIGKILL)
    assert rt_api.get(ref, timeout=60) == "recovered"
    # the dead daemon is gone from the alive set
    assert victim.node_id not in {n.node_id for n in rt.alive_nodes()}


def test_chaos_sigkill_daemon_actor_restart(daemon_cluster):
    """SIGKILL the daemon hosting an actor: max_restarts replays the actor
    on a surviving daemon."""
    rt = daemon_cluster

    @rt_api.remote(max_restarts=1, max_task_retries=2)
    class Svc:
        def pid(self):
            return os.getpid()

    a = Svc.remote()
    pid1 = rt_api.get(a.pid.remote())
    victim = None
    for handle in _daemon_handles(rt):
        if handle.client.call("daemon_stats")["actors"] > 0:
            victim = handle
            break
    assert victim is not None
    os.kill(victim.proc.pid, signal.SIGKILL)
    # a generous budget: the property under test is recovery, not latency
    deadline = time.monotonic() + 90
    pid2 = None
    while time.monotonic() < deadline:
        try:
            pid2 = rt_api.get(a.pid.remote(), timeout=15)
            break
        except (exc.ActorError, exc.ActorUnavailableError,
                exc.TaskError, exc.GetTimeoutError):
            time.sleep(0.3)
    assert pid2 is not None and pid2 != pid1


def test_head_health_check_marks_dead(daemon_cluster):
    """Heartbeat-miss detection: kill a daemon while IDLE (the driver has
    no in-flight RPC to see the failure first-hand): the head's health
    monitor must notice and broadcast the death."""
    rt = daemon_cluster
    victim = _daemon_handles(rt)[0]
    os.kill(victim.proc.pid, signal.SIGKILL)
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        alive = {n.node_id for n in rt.alive_nodes()}
        if victim.node_id not in alive:
            break
        time.sleep(0.1)
    else:
        pytest.fail("head never marked the killed daemon dead")


def test_chaos_sigkill_head_cluster_survives(daemon_cluster):
    """Head FT: SIGKILL the head mid-run; the supervisor respawns it on the
    same port with the sqlite state, the daemons re-register, the KV
    survives, and task submission keeps working."""
    rt = daemon_cluster
    backend = rt.cluster_backend

    backend.head.kv_put(b"pre-crash", b"survives", namespace=b"t")
    old_pid = backend.head_proc.pid
    os.kill(old_pid, signal.SIGKILL)

    # the supervisor respawns the head on the same port
    deadline = time.monotonic() + 15
    while time.monotonic() < deadline:
        if (backend.head_proc.pid != old_pid
                and backend.head_proc.poll() is None):
            break
        time.sleep(0.1)
    assert backend.head_proc.pid != old_pid, "head was not respawned"

    # the persisted KV is reloaded by the restarted head
    assert backend.head.kv_get(b"pre-crash", namespace=b"t") == b"survives"
    backend.head.kv_put(b"post-crash", b"ok", namespace=b"t")
    assert backend.head.kv_get(b"post-crash", namespace=b"t") == b"ok"

    # the daemons survived the outage and re-registered
    deadline = time.monotonic() + 15
    while time.monotonic() < deadline:
        alive = [n for n in backend.head.list_nodes() if n["alive"]]
        if len(alive) == 2:
            break
        time.sleep(0.1)
    assert len(alive) == 2, f"daemons did not re-register: {alive}"
    for handle in _daemon_handles(rt):
        assert handle.proc.poll() is None  # no daemon died with the head

    # the cluster still executes tasks end to end
    @rt_api.remote
    def after():
        return "recovered"

    assert rt_api.get(after.remote(), timeout=30) == "recovered"


# ---------------------------------------------------------------------------
# object-manager depth: chunked pull/push, pull priority, dedup, the owner's
# object directory


# ---------------------------------------------------------------------------


def test_concurrent_pull_dedup(monkeypatch):
    """N concurrent pulls of one object collapse onto one transfer: the
    bytes cross the wire once."""
    import threading as th
    # tiny chunks: the transfer spans many RPCs, so every concurrent pull
    # arrives while it is in flight
    monkeypatch.setenv("RAY_TPU_PULL_CHUNK", str(64 * 1024))
    rt = rt_api.init(num_nodes=2, resources={"CPU": 4}, cluster="daemons",
                     object_store_memory=64 << 20)
    try:
        a, b = _daemon_handles(rt)
        blob = bytes(bytearray(8 * 1024 * 1024))
        a.put_object_blob(b"oid-dedup", blob)
        results = []
        from ray_tpu_torch._private.rpc import Client

        def pull():
            # a connection each: the server runs one connection's requests
            # in order, so sharing one would serialize the pulls
            cli = Client(b.addr, timeout=120.0)
            try:
                out = cli.call("pull_object", oid=b"oid-dedup",
                               from_addr=list(a.addr), priority=2)
                results.append(out.get("ok", False))
            finally:
                cli.close()

        threads = [th.Thread(target=pull) for _ in range(6)]
        before = b.client.call("daemon_stats")["pull_stats"]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        after = b.client.call("daemon_stats")["pull_stats"]
        assert all(results)
        started = after["pulls_started"] - before["pulls_started"]
        deduped = after["pulls_deduped"] - before["pulls_deduped"]
        # one transfer, everyone else joined it; one copy of the bytes
        assert started == 1
        assert deduped == 5
        assert after["bytes_pulled"] - before["bytes_pulled"] == len(blob)
    finally:
        rt_api.shutdown()


def test_pull_priority_ordering():
    """Unit test: queued pulls are served get > wait > task-args."""
    from ray_tpu_torch._private.daemon import (PULL_PRIORITY_GET,
                                               PULL_PRIORITY_TASK_ARGS,
                                               PULL_PRIORITY_WAIT,
                                               PullManager)

    order = []
    gate = __import__("threading").Event()

    class FakeObjects:
        def contains(self, oid):
            return False

        def put(self, oid, blob):
            pass

    class FakePeer:
        def call(self, method, **kw):
            if method == "object_meta":
                gate.wait(5)             # hold transfers until all queued
                order.append(kw["oid"])
                return {"size": 1}
            return {"blob": b"x"}

    pm = PullManager(FakeObjects(), lambda addr: FakePeer(),
                     num_workers=1)
    # the first pull occupies the single worker at the gate; the rest queue
    p0 = pm.request(b"warm", ("h", 1), PULL_PRIORITY_TASK_ARGS)
    time.sleep(0.2)
    p1 = pm.request(b"args", ("h", 1), PULL_PRIORITY_TASK_ARGS)
    p2 = pm.request(b"get", ("h", 1), PULL_PRIORITY_GET)
    p3 = pm.request(b"wait", ("h", 1), PULL_PRIORITY_WAIT)
    gate.set()
    for p in (p0, p1, p2, p3):
        assert p.event.wait(10)
    assert order[0] == b"warm"
    assert order[1:] == [b"get", b"wait", b"args"]


def test_cluster_flag_and_nothing_left_after_shutdown(monkeypatch):
    """``RAY_TPU_CLUSTER=daemons`` selects the daemon cluster (the flag of
    JAX's config table); after shutdown() no head, daemon or worker
    process, no arena segment and no session dir are left."""
    import glob
    monkeypatch.setenv("RAY_TPU_CLUSTER", "daemons")
    rt = rt_api.init(num_nodes=2, resources={"CPU": 2},
                     object_store_memory=64 << 20)
    try:
        backend = rt.cluster_backend
        assert backend is not None and len(backend.daemons) == 2

        @rt_api.remote
        def pid():
            return os.getpid()

        pids = set(rt_api.get([pid.remote() for _ in range(8)]))
        pids |= {backend.head_proc.pid}
        pids |= {h.proc.pid for h in backend.daemons.values()}
        names = [h.arena_name for h in backend.daemons.values()]
        session = backend.session_dir
        assert all(os.path.exists(f"/dev/shm/{n}") for n in names)
    finally:
        rt_api.shutdown()
    assert not _left_after(pids, 10)
    assert not [g for n in names for g in glob.glob(f"/dev/shm/{n}*")]
    assert not os.path.exists(session)


_ORPHAN_DRIVER = """
import json, os, time
import ray_tpu_torch as rt_api
rt = rt_api.init(num_nodes=2, resources={"CPU": 2}, cluster="daemons",
                 object_store_memory=32 << 20)
backend = rt.cluster_backend

@rt_api.remote
def pid():
    return os.getpid()

workers = sorted(set(rt_api.get([pid.remote() for _ in range(4)])))
print(json.dumps({
    "head": backend.head_proc.pid,
    "daemons": [h.proc.pid for h in backend.daemons.values()],
    "workers": workers,
    "arenas": [h.arena_name for h in backend.daemons.values()],
    "session": backend.session_dir}), flush=True)
time.sleep(600)
"""


def test_sigkilled_driver_leaves_no_head_or_daemon(tmp_path):
    """A driver that dies without shutdown() (SIGKILL, a time limit) takes
    its cluster with it: the daemons exit when its connection closes, the
    head once its parent is gone, and neither leaves an arena segment, a
    state file or a session dir behind."""
    import glob
    import json
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = repo + (os.pathsep + env["PYTHONPATH"]
                                if env.get("PYTHONPATH") else "")
    log = tmp_path / "driver.err"
    with open(log, "wb") as err:
        driver = subprocess.Popen([sys.executable, "-c", _ORPHAN_DRIVER],
                                  cwd=str(tmp_path), env=env,
                                  stdout=subprocess.PIPE, stderr=err)
    try:
        line = driver.stdout.readline()
        assert line, (f"driver exited with {driver.wait()}: "
                      f"{log.read_text()[-2000:]}")
        info = json.loads(line)
    finally:
        driver.kill()
        driver.wait()
        driver.stdout.close()
    pids = [info["head"], *info["daemons"], *info["workers"]]
    assert not _left_after(pids, 15)
    assert not [g for n in info["arenas"]
                for g in glob.glob(f"/dev/shm/{n}*")]
    assert not os.path.exists(os.path.join(info["session"],
                                           "head_state.db"))
    assert not os.path.exists(info["session"])


def test_a_daemon_started_by_hand_joins_the_driver(daemon_cluster):
    """A daemon started against the live head (not by the driver) joins it
    through the head's ``added`` event (``ClusterBackend._join_node``): it
    becomes a node, runs tasks, and ends with the driver's shutdown."""
    import json

    from ray_tpu_torch._private import cluster
    from ray_tpu_torch._private.ids import NodeID
    rt = daemon_cluster
    node_id = NodeID.from_random()
    proc, _port = cluster._spawn("ray_tpu_torch._private.daemon", [
        "--head", f"127.0.0.1:{rt.cluster_backend._head_port}",
        "--node-id", node_id.hex(),
        "--resources", json.dumps({"CPU": 2, "joined": 1}),
        "--object-store-bytes", str(64 << 20)])
    try:
        deadline = time.monotonic() + 20
        while rt.get_node(node_id) is None and time.monotonic() < deadline:
            time.sleep(0.05)
        node = rt.get_node(node_id)
        assert node is not None and node.daemon.proc is None

        @rt_api.remote(resources={"joined": 1})
        def where():
            return rt_api.get_runtime_context().get_node_id()

        assert rt_api.get(where.remote(), timeout=30) == node_id.hex()
        assert rt.cluster_resources()["joined"] == 1
    finally:
        rt_api.shutdown()
        try:
            assert proc.wait(timeout=15) == 0
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
