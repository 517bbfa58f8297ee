"""The port's graceful degradation under memory pressure (copies of
``tests/test_pressure.py``):

- watermark parsing and the pure level-fusion rule;
- the PressureController's failpoint seam (``pressure.level``) and
  relief transitions;
- arena spill candidacy (pins always win, the spill-dir budget bounds
  disk), restore idempotency and the failpoint-armed degrade-to-disk
  read path;
- hard-level typed rejection of NEW puts and the driver's RetryPolicy
  ride to success after relief;
- pick_node soft-exclusion of hard-pressure nodes (DRAINING's peer).

- the tenant-aware preemption order (over-quota jobs' workers first).

The ballast-driven campaign lives in the chaos tier:
tests/test_torch_chaos.py::test_chaos_memory_*.
"""

import os
import time
import uuid

import pytest

import ray_tpu_torch as ray_tpu
from ray_tpu_torch._private import failpoints as fp
from ray_tpu_torch._private.pressure import (
    HOST_SOFT_MARGIN,
    PressureController,
    compute_level,
    parse_watermarks,
)
from ray_tpu_torch.native_store import available

needs_native = pytest.mark.skipif(
    not available(), reason="native store unavailable (no compiler)")

CAP = 4 * 1024 * 1024
BIG = 512 * 1024        # comfortably above the inline threshold


@pytest.fixture(autouse=True)
def _reset_failpoints():
    yield
    fp.reset()
    if ray_tpu.is_initialized():    # tests/conftest.py shuts down JAX's
        ray_tpu.shutdown()


# ---------------------------------------------------------------------------
# watermark math (pure)
# ---------------------------------------------------------------------------

def test_parse_watermarks():
    assert parse_watermarks("0.70,0.85") == (0.70, 0.85)
    assert parse_watermarks("0.5,0.5") == (0.5, 0.5)
    # malformed input falls back to the defaults, never disables
    for bad in ("", "nope", "0.9", "0.9,0.2", "0,1", "1.2,1.5"):
        assert parse_watermarks(bad) == (0.70, 0.85)


def test_compute_level_fusion():
    wm = dict(wm_soft=0.70, wm_hard=0.85, host_threshold=0.95)
    assert compute_level(0.0, 0.0, 0.0, **wm) == "ok"
    # host RSS inside the soft margin of the kill threshold -> soft
    assert compute_level(0.95 - HOST_SOFT_MARGIN, 0.0, 0.0, **wm) == "soft"
    # arena over its soft watermark -> soft
    assert compute_level(0.0, 0.70, 0.0, **wm) == "soft"
    # host at the kill threshold -> hard (the monitor is about to shoot)
    assert compute_level(0.95, 0.0, 0.0, **wm) == "hard"
    # arena at the hard watermark -> hard
    assert compute_level(0.0, 0.85, 0.0, **wm) == "hard"
    # arena soft-full while the spill budget is exhausted: nowhere left
    # to degrade to -> hard
    assert compute_level(0.0, 0.70, 1.0, **wm) == "hard"
    # exhausted budget alone (arena comfortable) is NOT pressure
    assert compute_level(0.0, 0.10, 1.0, **wm) == "ok"


# ---------------------------------------------------------------------------
# PressureController: failpoint seam, transitions, relief
# ---------------------------------------------------------------------------

class _StubObjects:
    """Just enough ObjectTable surface for a controller."""

    capacity = 100
    spill_budget = 0
    _shm = None

    def __init__(self):
        self.spill_calls = 0

    def spilled_bytes(self):
        return 0

    def spill_to_fraction(self, target):
        self.spill_calls += 1
        return 0


def test_controller_failpoint_override_then_relief():
    """``pressure.level=return(hard):max=2`` forces two hard ticks (the
    chaos-script idiom — no real ballast); the third tick recomputes
    from the (quiet) fractions and relieves back to ok. Every non-ok
    tick runs a proactive spill pass; transitions invoke on_level."""
    objects = _StubObjects()
    seen = []
    ctl = PressureController(objects, monitor=None, tick_s=60.0,
                             watermarks="0.70,0.85", host_threshold=0.95,
                             on_level=lambda old, new: seen.append((old,
                                                                    new)))
    fp.activate("pressure.level=return(hard):max=2")
    assert ctl.tick() == "hard"
    assert ctl.tick() == "hard"
    assert objects.spill_calls == 2     # proactive degradation ran
    assert ctl.tick() == "ok"           # arm exhausted: relief
    assert seen == [("ok", "hard"), ("hard", "ok")]


def test_controller_drop_arm_skips_tick():
    objects = _StubObjects()
    ctl = PressureController(objects, monitor=None, tick_s=60.0)
    ctl.level = "soft"
    fp.activate("pressure.level=drop")
    assert ctl.tick() == "soft"         # tick skipped: level unchanged
    assert objects.spill_calls == 0


def test_controller_fractions_arena_signal():
    """Arena occupancy feeds the fusion directly (no monitor, no
    budget): past the hard watermark the level goes hard and the
    proactive pass runs."""

    class _FullArena:
        def used_bytes(self):
            return 90

    objects = _StubObjects()
    objects._shm = _FullArena()
    ctl = PressureController(objects, monitor=None, tick_s=60.0,
                             watermarks="0.70,0.85", host_threshold=0.95)
    assert ctl.fractions() == (0.0, 0.90, 0.0)
    assert ctl.tick() == "hard"
    assert objects.spill_calls == 1


# ---------------------------------------------------------------------------
# arena spill: pins win, budget bounds disk, restore idempotency
# ---------------------------------------------------------------------------

@pytest.fixture
def table(tmp_path):
    from ray_tpu_torch._private.daemon import ObjectTable
    t = ObjectTable(f"rtpu_p_{os.getpid()}_{uuid.uuid4().hex[:8]}",
                    CAP, sweep=False, spill_dir=str(tmp_path))
    if t._shm is None:
        t.close()
        pytest.skip("arena creation failed on this box")
    try:
        yield t
    finally:
        t.close()


@needs_native
def test_spill_skips_pinned(table):
    """An entry with an outstanding external slot ref (a held zero-copy
    view) is NEVER spilled — a full-sweep pass parks the cold unpinned
    entry and leaves the pinned one resident, bytes intact."""
    table.put(b"pinned", b"p" * BIG)
    table.put(b"cold", b"c" * BIG)
    meta = table.get_ext_meta(b"pinned", "w:1:1")
    assert meta is not None
    table.spill_to_fraction(0.0)
    stats = table.spill_stats()
    assert stats["spill_skipped_pinned"] >= 1
    assert b"pinned" not in table._spilled
    assert b"cold" in table._spilled
    assert table.get_blob(b"pinned") == b"p" * BIG
    # release the view: the next pass may park it
    table.ext_release(meta[4], "w:1:1")
    table.spill_to_fraction(0.0)
    assert b"pinned" in table._spilled
    assert table.get_blob(b"pinned") == b"p" * BIG   # restores


@needs_native
def test_spill_budget_bounds_disk(table):
    """The spill-dir budget stops the pass: disk consumption never
    exceeds arena_spill_budget_bytes (the level goes hard instead —
    compute_level's budget-exhausted clause)."""
    table.spill_budget = BIG + 1024     # room for exactly one entry
    table.put(b"one", b"1" * BIG)
    table.put(b"two", b"2" * BIG)
    table.spill_to_fraction(0.0)
    assert table.spilled_bytes() <= table.spill_budget
    assert table.spill_stats()["spilled_now_count"] == 1


@needs_native
def test_restore_idempotent_and_failpoint_degrades_to_disk_read(table):
    """arena.restore drop arm: the restore attempt fails but the READ
    still succeeds straight off the spill file (reads never miss); the
    next read retries the restore and flips the tier back. A repeated
    restore of a resident entry is a no-op success."""
    table.put(b"obj", b"z" * BIG)
    table.spill_to_fraction(0.0)
    assert b"obj" in table._spilled
    path = table._spilled[b"obj"][0]
    assert os.path.exists(path)

    fp.activate("arena.restore=drop:max=1")
    assert table.get_blob(b"obj") == b"z" * BIG     # disk-read degrade
    assert b"obj" in table._spilled                 # still parked
    assert table.spill_stats()["restore_failed"] == 1
    assert os.path.exists(path)     # failed attempt consumed nothing

    assert table.get_blob(b"obj") == b"z" * BIG     # retried restore
    assert b"obj" not in table._spilled
    stats = table.spill_stats()
    assert stats["restores"] == 1
    assert stats["restored_bytes"] == BIG
    assert not os.path.exists(path)     # file consumed AFTER the land
    assert table.restore(b"obj") is True            # idempotent
    assert table.spill_stats()["restores"] == 1


@needs_native
def test_spill_failpoint_keeps_entry_resident(table):
    """arena.spill drop arm: the attempt fails, the entry stays at tier
    host-shm, and a later (disarmed) pass parks it."""
    table.put(b"obj", b"q" * BIG)
    fp.activate("arena.spill=drop")
    assert table.spill_to_fraction(0.0) == 0
    assert b"obj" not in table._spilled
    assert table.get_blob(b"obj") == b"q" * BIG
    fp.reset()
    assert table.spill_to_fraction(0.0) == 1
    assert b"obj" in table._spilled


# ---------------------------------------------------------------------------
# hard-level backpressure: typed rejection, retry succeeds after relief
# ---------------------------------------------------------------------------

def test_hard_rejection_is_typed_and_retry_succeeds(monkeypatch):
    """While the daemon's level is hard (failpoint-forced — no real
    ballast), a NEW driver put is rejected with the retriable
    MemoryPressureError; reads still pass. The public ``ray_tpu.put``
    rides RetryPolicy through the remaining hard ticks and lands after
    relief."""
    from ray_tpu_torch._private.ids import ObjectID
    from ray_tpu_torch.exceptions import MemoryPressureError
    monkeypatch.setenv("RAY_TPU_MEMORY_PRESSURE", "1")
    monkeypatch.setenv("RAY_TPU_PRESSURE_TICK_S", "0.05")
    rt = ray_tpu.init(num_nodes=1, resources={"CPU": 2},
                      cluster="daemons")
    try:
        node = rt.nodes()[0]
        handle = next(iter(rt.cluster_backend.daemons.values()))
        pre = ObjectID.from_random()
        node.store.put(pre, b"stored-before-pressure", nbytes=22)

        # the per-node chaos hook (net_chaos's failpoint twin) forces
        # ~2s of hard pressure in THE daemon, then relieves
        handle.client.call(
            "fail_points", spec="pressure.level=return(hard):max=40",
            seed=0)
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline:
            if handle.client.call("daemon_stats")["pressure"] == "hard":
                break
            time.sleep(0.02)
        else:
            pytest.fail("daemon never reached hard pressure")

        # typed rejection of a NEW put at the transport layer
        with pytest.raises(MemoryPressureError):
            handle.put_object_blob(b"put:rejected", b"x" * 1024)
        # reads always pass under pressure
        assert node.store.get(pre) == b"stored-before-pressure"

        # the store-level put retries until the hard arm exhausts (40
        # ticks x 50ms = ~2s << the 30s policy deadline) and then lands
        oid = ObjectID.from_random()
        node.store.put(oid, b"y" * 2048, nbytes=2048)
        assert node.store.get(oid) == b"y" * 2048
        while time.monotonic() < deadline:
            if handle.client.call("daemon_stats")["pressure"] == "ok":
                break
            time.sleep(0.02)
        else:
            pytest.fail("pressure never relieved after arm exhaustion")
    finally:
        ray_tpu.shutdown()


# ---------------------------------------------------------------------------
# tenant-preferring preemption order
# ---------------------------------------------------------------------------

def test_tenant_aware_policy_prefers_over_quota():
    from ray_tpu_torch._private.memory_monitor import (
        RetriableFIFOPolicy,
        TenantAwarePolicy,
        _Candidate,
    )
    cands = [
        _Candidate(1, "task", task_id="a", started_at=5.0,
                   owner_key="job-greedy"),
        _Candidate(2, "task", task_id="b", started_at=9.0,
                   owner_key="job-quiet"),
        _Candidate(3, "task", task_id="c", started_at=7.0,
                   owner_key="job-greedy"),
    ]
    over = set()
    policy = TenantAwarePolicy(RetriableFIFOPolicy(), lambda: over)

    # no tenant over quota: plain host-pressure order (newest first)
    assert policy.pick(cands).task_id == "b"
    assert policy.last_reason == "host"

    # the over-quota tenant's workers go first — newest WITHIN the
    # preferred pool, even though a newer innocent task exists
    over = {"job-greedy"}
    assert policy.pick(cands).task_id == "c"
    assert policy.last_reason == "tenant_quota"

    # no over-quota worker running here: the full pool backstops
    over = {"job-absent"}
    assert policy.pick(cands).task_id == "b"
    assert policy.last_reason == "host"


# ---------------------------------------------------------------------------
# pressure-aware placement
# ---------------------------------------------------------------------------

def _spec(resources):
    from ray_tpu_torch._private.ids import TaskID
    from ray_tpu_torch._private.task_spec import TaskKind, TaskSpec
    return TaskSpec(task_id=TaskID.from_random(), kind=TaskKind.NORMAL,
                    name="t", func=None, resources=resources)


def test_pick_node_soft_excludes_hard_pressure():
    """A hard-pressure node leaves the candidate set like a DRAINING
    one (including cached feasibility sets); when EVERY feasible node
    is pressured the scheduler still places — a pressured node beats a
    failing task."""
    from ray_tpu_torch._private.scheduler import bump_cluster_epoch
    rt = ray_tpu.init(num_nodes=2, resources={"CPU": 4})
    sched = rt.scheduler
    nodes = rt.nodes()
    for _ in range(5):
        sched.pick_node(_spec({"CPU": 1}), nodes)   # warm the cache

    def _set_level(node, level):
        # what DaemonHandle._on_node_pressure does on a level push:
        # flip the Node and invalidate cached feasibility
        node.pressure_level = level
        bump_cluster_epoch()

    victim = nodes[0]
    _set_level(victim, "hard")
    for _ in range(20):
        assert sched.pick_node(
            _spec({"CPU": 1}), nodes).node_id != victim.node_id
    key = (("CPU", 1.0),)
    # soft pressure does NOT exclude (only hard sheds load): the victim
    # is back in the cached candidate set
    _set_level(victim, "soft")
    sched.pick_node(_spec({"CPU": 1}), nodes)
    assert victim.node_id in {n.node_id for n in sched._feas_cache[key]}
    # all-pressured fallback: placement still succeeds
    for n in nodes:
        _set_level(n, "hard")
    assert sched.pick_node(_spec({"CPU": 1}), nodes) is not None
    # relief restores the full candidate set
    for n in nodes:
        _set_level(n, "ok")
    sched.pick_node(_spec({"CPU": 1}), nodes)
    assert len(sched._feas_cache[key]) == 2
