"""Multi-tenant fair share on the port (a copy of ``tests/test_tenancy.py``
against ``ray_tpu_torch``): ledger math, admission verdicts, isolation.

Covers the three layers of the tenancy package:

- :class:`FairShareLedger` unit math — dominant shares, weighted
  deficit ordering over whole same-shape groups, hard-cap clamping;
- admission verdicts end to end — QUEUED work is delayed never lost
  and resumes when quota frees, REJECTED surfaces as the typed
  :class:`AdmissionRejectedError`, verdict counts ride /metrics;
- the isolation acceptance A/B — with fair-share ON a light tenant's
  p99 stays within 3x its solo latency while a heavy tenant saturates
  the cluster; with fair-share OFF the same contention starves it.
"""

import threading
import time
import types

import pytest

import ray_tpu_torch
from ray_tpu_torch._private import failpoints as fp
from ray_tpu_torch._private.ids import JobID
from ray_tpu_torch.exceptions import AdmissionRejectedError
from ray_tpu_torch.tenancy import (ADMITTED, QUEUED, FairShareLedger, JobQuota,
                             TenancyManager, job_context)
from ray_tpu_torch.tenancy.context import canonical_job
from ray_tpu_torch.tenancy.policy import DEFICIT_CAP


@pytest.fixture(autouse=True)
def _reset_failpoints():
    yield
    fp.reset()
    if ray_tpu_torch.is_initialized():
        ray_tpu_torch.shutdown()


# ---------------------------------------------------------------------------
# ledger math (pure unit tests, fixed capacity)
# ---------------------------------------------------------------------------

CAP = {"CPU": 10.0, "memory": 100.0}


def test_dominant_share_is_max_axis_ratio():
    led = FairShareLedger(CAP)
    led.note_admitted("a", {"CPU": 2.0, "memory": 5.0}, 1)
    # max(2/10, 5/100) = 0.2 — CPU dominates
    assert led.dominant_share("a") == pytest.approx(0.2)
    led.note_admitted("a", {"memory": 45.0}, 1)
    # memory now dominates: 50/100
    assert led.dominant_share("a") == pytest.approx(0.5)
    led.note_done("a", {"memory": 45.0})
    assert led.dominant_share("a") == pytest.approx(0.2)


def test_dominant_cost_of_unknown_resource_is_nonzero():
    led = FairShareLedger(CAP)
    # deficits must still be spendable for demands off the capacity map
    assert led.dominant_cost({"accelerator_x": 1.0}) > 0.0


def test_weighted_deficit_accrual_and_ordering():
    led = FairShareLedger(CAP)
    led.ensure("heavy", weight=3.0)
    led.ensure("light", weight=1.0)
    items = [(("heavy", ("s",)), 4), (("light", ("s",)), 4)]
    led.order(items)
    snap = led.snapshot()
    # one round splits QUANTUM by weight share: 0.75 vs 0.25
    assert snap["heavy"]["deficit"] == pytest.approx(0.75)
    assert snap["light"]["deficit"] == pytest.approx(0.25)
    # the higher-deficit job's group comes back first, whole
    assert led.order(items)[0][0] == "heavy"
    # launching spends deficit: once heavy's launches outrun its 3x
    # weighted accrual it falls behind light on the next round
    led.note_admitted("heavy", {"CPU": 2.0}, 12)  # spends 12 * 0.2
    assert led.order(items)[0][0] == "light"


def test_deficit_is_capped_both_ways():
    led = FairShareLedger(CAP)
    items = [(("solo", ("s",)), 1)]
    for _ in range(50):
        led.order(items)    # solo job accrues the full quantum/round
    assert led.snapshot()["solo"]["deficit"] <= DEFICIT_CAP
    led.note_admitted("solo", {"CPU": 10.0}, 30)
    assert led.snapshot()["solo"]["deficit"] >= -DEFICIT_CAP


def test_order_admits_whole_groups_fifo_within_job():
    led = FairShareLedger(CAP)
    led.ensure("a", weight=1.0)
    led.ensure("b", weight=1.0)
    # two same-shape groups per job: blocks stay contiguous per job and
    # FIFO within a job (stable sort), never interleaved task-at-a-time
    items = [(("a", ("x",)), 2), (("b", ("y",)), 2),
             (("a", ("z",)), 1), (("b", ("w",)), 1)]
    keys = led.order(items)
    by_job = [job for job, _shape in keys]
    assert by_job in (["a", "a", "b", "b"], ["b", "b", "a", "a"])
    a_shapes = [shape for job, shape in keys if job == "a"]
    assert a_shapes == [("x",), ("z",)]


def test_queue_empty_job_forfeits_deficit():
    led = FairShareLedger(CAP)
    led.order([(("a", ("s",)), 1)])
    assert led.snapshot()["a"]["deficit"] > 0
    led.observe_queued("node-1", {"a": 0})
    assert led.snapshot()["a"]["deficit"] == 0.0


def test_admit_cap_clamps_group_to_headroom():
    led = FairShareLedger(CAP)
    led.set_quota("a", JobQuota(hard={"CPU": 4.0}))
    led.note_admitted("a", {"CPU": 1.0}, 1)
    # 3 CPUs of headroom left for 1-CPU tasks
    assert led.admit_cap("a", {"CPU": 1.0}, 10) == 3
    assert led.admit_cap("a", {"CPU": 2.0}, 10) == 1
    led.note_admitted("a", {"CPU": 1.0}, 3)
    assert led.admit_cap("a", {"CPU": 1.0}, 10) == 0
    # completions free headroom again
    led.note_done("a", {"CPU": 1.0})
    assert led.admit_cap("a", {"CPU": 1.0}, 10) == 1
    # uncapped jobs are never clamped
    assert led.admit_cap("other", {"CPU": 1.0}, 10) == 10


def test_over_hard_cap_and_soft_cap_checks():
    led = FairShareLedger(CAP)
    led.set_quota("a", JobQuota(hard={"CPU": 2.0}, soft={"memory": 10.0}))
    assert not led.over_hard_cap("a", {"CPU": 1.0})
    led.note_admitted("a", {"CPU": 2.0, "memory": 20.0}, 1)
    assert led.over_hard_cap("a", {"CPU": 1.0})
    assert led.at_hard_cap("a")
    assert led.over_soft_cap("a")           # memory 20 > soft 10
    led.note_done("a", {"CPU": 2.0, "memory": 20.0})
    assert not led.at_hard_cap("a")
    assert not led.over_soft_cap("a")


def test_object_bytes_quota_axis():
    led = FairShareLedger(CAP)
    led.set_quota("a", JobQuota(hard={"object_store_bytes": 100.0}))
    led.note_object_bytes("a", 150.0)
    assert led.over_hard_cap("a", {"CPU": 1.0})
    assert led.admit_cap("a", {"CPU": 1.0}, 5) == 0
    led.note_object_bytes("a", -100.0)
    assert not led.over_hard_cap("a", {"CPU": 1.0})


def test_quota_rejects_unknown_resource_axis():
    with pytest.raises(ValueError):
        JobQuota(hard={"GPUs": 1.0})


# ---------------------------------------------------------------------------
# admission manager (no cluster: fake specs, fixed capacity)
# ---------------------------------------------------------------------------

def _spec(job: str, resources=None):
    jid = JobID(job.encode().ljust(8, b"\0")[:8])
    return types.SimpleNamespace(job_id=jid, resources=resources
                                 or {"CPU": 1.0}), jid.hex()


def _manager(queue_max=4):
    return TenancyManager(runtime=None, enabled=True,
                          capacity_fn=lambda: dict(CAP),
                          default_weight=1.0, queue_max=queue_max)


def test_admit_verdicts_and_typed_rejection():
    ten = _manager(queue_max=2)
    spec, job = _spec("j1")
    assert ten.admit(spec) == ADMITTED
    ten.note_admitted(job, spec.resources, 1)       # pending -> 0
    ten.set_quota(job, hard={"CPU": 1.0})           # now at the cap
    assert ten.admit(spec) == QUEUED                # pending 1
    assert ten.admit(spec) == QUEUED                # pending 2 == max
    with pytest.raises(AdmissionRejectedError):
        ten.admit(spec)
    # dispatch retires the queued submits' inflight demand and
    # completions free the cap: back to ADMITTED. (The verdict folds
    # in submitted-not-yet-dispatched demand, so queued work must
    # actually dispatch — not merely have older tasks complete —
    # before the job reads as under cap again.)
    ten.note_admitted(job, spec.resources, 2)
    for _ in range(3):
        ten.note_done(job, spec.resources)
    assert ten.admit(spec) == ADMITTED


def test_admission_verdict_seam_drop_fails_open_error_degrades():
    ten = _manager()
    spec, job = _spec("j2")
    ten.set_quota(job, hard={"CPU": 0.5})           # every submit over cap
    assert ten.admit(spec) == QUEUED
    fp.activate("admission.verdict=drop")
    assert ten.admit(spec) == ADMITTED              # decision lost: open
    fp.reset()
    fp.activate("admission.verdict=error(RuntimeError)")
    under_spec, _ = _spec("j3")                     # within caps...
    assert ten.admit(under_spec) == QUEUED          # ...but path failed
    assert fp.fire_count("admission.verdict") == 1


def test_quota_sync_seam_drop_keeps_records_dirty():
    calls = []

    class FakeHead:
        def tenancy_set(self, job, rec):
            calls.append(("set", job, rec))

        def tenancy_report(self, jobs):
            calls.append(("report", jobs))

    backend = types.SimpleNamespace(head=FakeHead(), daemons={})
    ten = _manager()
    ten.set_quota("aaaa", hard={"CPU": 2.0}, weight=2.0)
    fp.activate("tenancy.quota_sync=drop")
    ten.maybe_sync(backend)
    assert calls == []                  # tick skipped, nothing sent
    fp.reset()
    ten.maybe_sync(backend)             # dirty record survived the drop
    canon, _ = canonical_job("aaaa")    # short names hash to stable hex
    assert ("set", canon,
            {"quota": {"hard": {"CPU": 2.0}, "soft": {}},
             "weight": 2.0, "name": "aaaa"}) in calls
    # clean now: another tick sends no records (reports may still ride)
    n_sets = sum(1 for c in calls if c[0] == "set")
    ten.maybe_sync(backend)
    assert sum(1 for c in calls if c[0] == "set") == n_sets


def test_quota_sync_skips_daemons_without_capability():
    sent = []

    class FakeClient:
        def call(self, method, **kw):
            sent.append(method)

    old = types.SimpleNamespace(client=FakeClient())    # no hello bit
    new = types.SimpleNamespace(client=FakeClient(),
                                _tenancy_supported=True)
    backend = types.SimpleNamespace(
        head=types.SimpleNamespace(
            tenancy_set=lambda job, rec: None,
            tenancy_report=lambda jobs: None),
        daemons={"old": old, "new": new})
    ten = _manager()
    ten.set_quota("bbbb", hard={"CPU": 1.0})
    ten.maybe_sync(backend)
    # only the daemon that advertised "tenancy" in its hello reply got
    # the job table; the old one fell back to unconditional admission
    assert sent == ["tenancy_sync"]


# ---------------------------------------------------------------------------
# end-to-end verdicts on a live cluster
# ---------------------------------------------------------------------------

def test_queued_is_delayed_never_lost_and_resumes():
    rt = ray_tpu_torch.init(num_nodes=1, resources={"CPU": 2},
                      _system_config={"fairshare": True})
    rt.tenancy.set_quota("capped", hard={"CPU": 1.0})

    @ray_tpu_torch.remote
    def work(i):
        time.sleep(0.05)
        return i

    with job_context("capped"):
        refs = [work.remote(i) for i in range(6)]
    # 1-CPU cap on a 2-CPU box: tasks run one at a time, over-cap ones
    # sit QUEUED at the dispatch gate — and every result still arrives
    assert sorted(ray_tpu_torch.get(refs, timeout=60)) == list(range(6))
    from ray_tpu_torch.util import metrics
    text = metrics.prometheus_text()
    assert "ray_tpu_admission_total" in text
    assert 'verdict="queued"' in text
    assert 'verdict="admitted"' in text


def test_rejected_is_typed_and_queue_resumes_after_quota_raise():
    rt = ray_tpu_torch.init(num_nodes=1, resources={"CPU": 2},
                      _system_config={"fairshare": True,
                                      "admission_queue_max": 3})
    rt.tenancy.set_quota("strict", hard={"CPU": 0.0})

    @ray_tpu_torch.remote
    def work(i):
        return i * 10

    refs = []
    with job_context("strict"):
        for i in range(3):
            refs.append(work.remote(i))     # QUEUED x3 fills the bound
        with pytest.raises(AdmissionRejectedError):
            work.remote(99)
    # raising the quota lets the held backlog drain: delayed, not lost
    rt.tenancy.set_quota("strict", hard={"CPU": 2.0})
    assert sorted(ray_tpu_torch.get(refs, timeout=60)) == [0, 10, 20]
    from ray_tpu_torch.util import metrics
    text = metrics.prometheus_text()
    assert 'verdict="rejected"' in text


def test_job_gauges_and_jobs_view():
    rt = ray_tpu_torch.init(num_nodes=1, resources={"CPU": 2},
                      _system_config={"fairshare": True})

    @ray_tpu_torch.remote
    def work(i):
        return i

    with job_context("viewer", weight=2.0) as jid:
        assert ray_tpu_torch.get([work.remote(i) for i in range(4)],
                           timeout=30) == list(range(4))
    view = rt.tenancy.jobs_view()
    assert view[jid.hex()]["weight"] == 2.0
    assert view[jid.hex()]["name"] == "viewer"
    from ray_tpu_torch.util import metrics
    text = metrics.prometheus_text()
    assert "ray_tpu_job_running_tasks" in text
    assert "ray_tpu_job_queued_tasks" in text


def test_fairshare_off_means_no_admission_and_plain_dispatch():
    rt = ray_tpu_torch.init(num_nodes=1, resources={"CPU": 2})
    assert rt.tenancy.enabled is False
    for node in rt.nodes():
        assert node.tenancy is None     # untenanted dispatch path
    rt.tenancy.set_quota("ignored", hard={"CPU": 0.0})

    @ray_tpu_torch.remote
    def work(i):
        return i

    with job_context("ignored"):
        # quota is recorded but NOT enforced: everything runs
        assert ray_tpu_torch.get([work.remote(i) for i in range(4)],
                           timeout=30) == list(range(4))


def test_child_tasks_inherit_job_id():
    rt = ray_tpu_torch.init(num_nodes=1, resources={"CPU": 2},
                      _system_config={"fairshare": True})

    @ray_tpu_torch.remote
    def leaf():
        from ray_tpu_torch._private import runtime_context
        ctx = runtime_context._ctx.get()
        return ctx.job_id.hex() if ctx and ctx.job_id else None

    @ray_tpu_torch.remote
    def parent():
        return ray_tpu_torch.get(leaf.remote())

    with job_context("lineage") as jid:
        child_job = ray_tpu_torch.get(parent.remote(), timeout=30)
    assert child_job == jid.hex()


# ---------------------------------------------------------------------------
# the isolation acceptance A/B
# ---------------------------------------------------------------------------

def _light_latencies(n=12, sleep_s=0.02):
    """Submit n sequential light-job tasks, returning per-task latency."""

    @ray_tpu_torch.remote
    def light():
        time.sleep(sleep_s)
        return None

    lats = []
    with job_context("light", weight=1.0):
        for _ in range(n):
            t0 = time.perf_counter()
            ray_tpu_torch.get(light.remote(), timeout=120)
            lats.append(time.perf_counter() - t0)
    return lats


def _heavy_backlog(n=100, sleep_s=0.02):
    """Pre-queue n heavy-job tasks WITHOUT consuming the results."""

    @ray_tpu_torch.remote
    def heavy():
        time.sleep(sleep_s)
        return None

    with job_context("heavy", weight=1.0):
        return [heavy.remote() for _ in range(n)]


def _p99(xs):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(0.99 * len(xs)))]


def test_isolation_fair_share_on_vs_off():
    """The headline A/B (ISSUE acceptance): a heavy tenant pre-queues a
    deep backlog on a 2-CPU cluster, then a light tenant submits
    latency-sensitive tasks one at a time.

    OFF: both tenants share one FIFO shape bucket — each light task
    waits behind the heavy backlog (~1s on this sizing), far past 3x
    its solo latency. ON: (job, shape)-keyed buckets + deficit
    ordering let the light job's singleton groups cut ahead, keeping
    its p99 within 3x of max(solo p99, 150ms)."""
    # solo baseline: the light job alone on the cluster
    ray_tpu_torch.init(num_nodes=1, resources={"CPU": 2},
                 _system_config={"fairshare": True})
    solo_p99 = _p99(_light_latencies())
    ray_tpu_torch.shutdown()

    # fair-share ON under contention
    ray_tpu_torch.init(num_nodes=1, resources={"CPU": 2},
                 _system_config={"fairshare": True})
    heavy_refs = _heavy_backlog()
    on_p99 = _p99(_light_latencies())
    ray_tpu_torch.get(heavy_refs, timeout=120)    # heavy work still completes
    ray_tpu_torch.shutdown()

    # fair-share OFF under the same contention
    ray_tpu_torch.init(num_nodes=1, resources={"CPU": 2})
    heavy_refs = _heavy_backlog()
    off_p99 = _p99(_light_latencies())
    ray_tpu_torch.get(heavy_refs, timeout=120)
    ray_tpu_torch.shutdown()

    bound = 3.0 * max(solo_p99, 0.15)
    assert on_p99 <= bound, (
        f"fair-share ON failed isolation: light p99 {on_p99:.3f}s vs "
        f"bound {bound:.3f}s (solo {solo_p99:.3f}s)")
    # OFF must reproduce the starvation the subsystem exists to fix —
    # if it doesn't, this test is not exercising real contention
    assert off_p99 > 3.0 * solo_p99, (
        f"fair-share OFF did not starve the light job: p99 "
        f"{off_p99:.3f}s vs solo {solo_p99:.3f}s — contention too weak")
    assert off_p99 > on_p99, (off_p99, on_p99)


def test_concurrent_multi_job_submits_are_race_free():
    """Two driver threads submitting under different job contexts while
    the dispatcher runs: no lost tasks, no mixed attribution."""
    rt = ray_tpu_torch.init(num_nodes=1, resources={"CPU": 4},
                      _system_config={"fairshare": True})

    @ray_tpu_torch.remote
    def work(i):
        return i

    results = {}

    def run(job, n):
        with job_context(job):
            results[job] = ray_tpu_torch.get(
                [work.remote(i) for i in range(n)], timeout=60)

    threads = [threading.Thread(target=run, args=(f"racer-{k}", 40))
               for k in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert results["racer-0"] == list(range(40))
    assert results["racer-1"] == list(range(40))
    view = rt.tenancy.jobs_view()
    names = {row.get("name") for row in view.values()}
    assert {"racer-0", "racer-1"} <= names
