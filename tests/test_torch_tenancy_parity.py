"""Parity of the port's tenancy layer and compiled DAG with JAX's: one
script runs on both packages and the results are compared exactly.

- the admission verdicts of a fixed submit sequence against a quota, the
  bounded queue's rejection included, on a bare ``TenancyManager`` and on
  a live runtime under ``fairshare=True``;
- the deficit order ``FairShareLedger.order`` gives a fixed backlog of
  weighted jobs over several dispatch rounds;
- a compiled DAG's outputs: in-process actors (channel mode), and the
  port's process-worker actors over shm channels against JAX's in-process
  run of the same DAG.
"""

import gc
import importlib

import numpy as np
import pytest

PACKAGES = ("ray_tpu", "ray_tpu_torch")
CAP = {"CPU": 10.0, "memory": 100.0}


def _ten(pkg):
    return importlib.import_module(f"{pkg}.tenancy")


@pytest.fixture(autouse=True)
def _shutdown_both():
    yield
    for pkg in PACKAGES:
        mod = importlib.import_module(pkg)
        if mod.is_initialized():
            mod.shutdown()


def _verdict_script(pkg):
    """A fixed submit/dispatch/complete sequence on one manager."""
    import types
    ten = _ten(pkg)
    ids = importlib.import_module(f"{pkg}._private.ids")
    exc = importlib.import_module(f"{pkg}.exceptions")
    mgr = ten.TenancyManager(runtime=None, enabled=True,
                             capacity_fn=lambda: dict(CAP),
                             default_weight=1.0, queue_max=3)
    jid = ids.JobID(b"tenant01")
    job = jid.hex()
    spec = types.SimpleNamespace(job_id=jid, resources={"CPU": 1.0})
    big = types.SimpleNamespace(job_id=jid, resources={"CPU": 3.0})
    out = []

    def admit(s):
        try:
            out.append(mgr.admit(s))
        except exc.AdmissionRejectedError:
            out.append("rejected")

    admit(spec)
    mgr.note_admitted(job, spec.resources, 1)
    mgr.set_quota(job, hard={"CPU": 4.0})
    admit(spec)                     # 2 of 4
    admit(big)                      # 5 > 4: queued
    admit(spec)
    admit(spec)
    admit(spec)                     # the bound: rejected
    mgr.note_admitted(job, spec.resources, 1)
    admit(spec)
    for _ in range(2):
        mgr.note_done(job, spec.resources)
    mgr.note_admitted(job, big.resources, 1)
    mgr.note_admitted(job, spec.resources, 2)
    for _ in range(5):
        mgr.note_done(job, spec.resources)
    admit(spec)
    mgr.set_quota(job, hard={"CPU": 100.0}, weight=3.0)
    admit(big)
    view = mgr.jobs_view()[job]
    out.append((view["weight"], view["quota"], view["pending"]))
    return out


def test_admission_verdicts_match_jax():
    got = {pkg: _verdict_script(pkg) for pkg in PACKAGES}
    assert got["ray_tpu"] == got["ray_tpu_torch"]
    assert "queued" in got["ray_tpu"] and "rejected" in got["ray_tpu"]


def _order_script(pkg):
    """Five dispatch rounds over one backlog: each round admits the first
    group whole and completes one task of each job."""
    led = _ten(pkg).FairShareLedger(dict(CAP), default_weight=1.0)
    led.ensure("heavy", weight=3.0)
    led.ensure("light", weight=1.0)
    led.ensure("mid", weight=2.0)
    backlog = {("heavy", ("CPU", 2.0)): 6, ("light", ("CPU", 1.0)): 2,
               ("mid", ("CPU", 1.0)): 3, ("heavy", ("memory", 10.0)): 2,
               ("mid", ("CPU", 3.0)): 1}
    demand = {("CPU", 2.0): {"CPU": 2.0}, ("CPU", 1.0): {"CPU": 1.0},
              ("memory", 10.0): {"memory": 10.0},
              ("CPU", 3.0): {"CPU": 3.0}}
    rounds = []
    for _ in range(5):
        items = [(k, n) for k, n in backlog.items() if n]
        order = led.order(items)
        rounds.append(order)
        first = order[0]
        n = backlog[first]
        led.note_admitted(first[0], demand[first[1]], n)
        backlog[first] = 0
        for job in ("heavy", "light", "mid"):
            led.note_done(job, {"CPU": 1.0})
        led.observe_queued("node", {j: sum(v for (jj, _s), v in
                                           backlog.items() if jj == j)
                                    for j in ("heavy", "light", "mid")})
    snap = led.snapshot()
    return rounds, {j: (r["deficit"], r["dominant_share"], r["running"])
                    for j, r in sorted(snap.items())}


def test_deficit_order_of_a_fixed_backlog_matches_jax():
    got = {pkg: _order_script(pkg) for pkg in PACKAGES}
    assert got["ray_tpu"] == got["ray_tpu_torch"]
    assert len({tuple(r[0]) for r in got["ray_tpu"][0]}) > 1


def _live_script(pkg):
    """A quota'd tenant on a live runtime under ``fairshare=True``: its
    over-quota submits queue, the bound rejects, a raised quota drains
    the backlog and every result arrives."""
    mod = importlib.import_module(pkg)
    exc = importlib.import_module(f"{pkg}.exceptions")
    rt = mod.init(num_nodes=1, resources={"CPU": 2},
                  _system_config={"fairshare": True,
                                  "admission_queue_max": 3})
    try:
        rt.tenancy.set_quota("strict", hard={"CPU": 0.0})

        @mod.remote
        def work(i):
            return i * 10

        refs, outcomes = [], []
        with _ten(pkg).job_context("strict"):
            for i in range(4):
                try:
                    refs.append(work.remote(i))
                    outcomes.append("submitted")
                except exc.AdmissionRejectedError as e:
                    outcomes.append(type(e).__name__)
        rt.tenancy.set_quota("strict", hard={"CPU": 2.0})
        values = sorted(mod.get(refs, timeout=60))
        view = rt.tenancy.jobs_view()
        name_row = next(r for r in view.values()
                        if r.get("name") == "strict")
        return outcomes, values, name_row["quota"]
    finally:
        mod.shutdown()


def test_live_runtime_verdicts_match_jax(monkeypatch):
    monkeypatch.setenv("RAY_TPU_PROCESS_WORKERS", "0")
    gc.collect()
    got = {pkg: _live_script(pkg) for pkg in PACKAGES}
    assert got["ray_tpu"] == got["ray_tpu_torch"]
    assert got["ray_tpu"][0][-1] == "AdmissionRejectedError"


def _dag_script(pkg, in_process):
    mod = importlib.import_module(pkg)
    dag = importlib.import_module(f"{pkg}.dag")
    mod.init(num_nodes=1, resources={"CPU": 8})
    try:
        opts = {"_in_process": True} if in_process else {}

        @mod.remote(**opts)
        class Scale:
            def __init__(self, k):
                self.k = np.float32(k)

            def run(self, x):
                return (np.asarray(x, np.float32) * self.k).astype(
                    np.float32)

        @mod.remote(**opts)
        class Mix:
            def run(self, a, b):
                return np.tanh(a) + b[::-1]

        s1, s2, m = Scale.remote(0.5), Scale.remote(-2.0), Mix.remote()
        with dag.InputNode() as inp:
            graph = m.run.bind(s1.run.bind(inp), s2.run.bind(inp))
        compiled = graph.experimental_compile()
        mode = ("channels" if compiled._executors is not None else
                "shm" if compiled._proc is not None else "dynamic")
        rng = np.random.default_rng(7)
        inputs = [rng.standard_normal(64).astype(np.float32)
                  for _ in range(6)]
        refs = [compiled.execute(x) for x in inputs]
        outs = [np.asarray(mod.get(r, timeout=60)) for r in refs]
        dynamic = [np.asarray(mod.get(graph.execute(x), timeout=60))
                   for x in inputs]
        compiled.teardown()
        return mode, outs, dynamic
    finally:
        mod.shutdown()


def test_compiled_dag_outputs_match_jax(monkeypatch):
    """Channel mode on both packages; then the port's cross-process shm
    mode against the same DAG run in JAX's channel mode. Every output is
    bit for bit JAX's, compiled and dynamic alike."""
    jax_mode, jax_outs, jax_dyn = _dag_script("ray_tpu", in_process=True)
    port_mode, port_outs, port_dyn = _dag_script("ray_tpu_torch",
                                                 in_process=True)
    shm_mode, shm_outs, shm_dyn = _dag_script("ray_tpu_torch",
                                              in_process=False)
    assert (jax_mode, port_mode, shm_mode) == ("channels", "channels",
                                               "shm")
    for got in (port_outs, port_dyn, shm_outs, shm_dyn, jax_dyn):
        for a, b in zip(got, jax_outs):
            assert a.dtype == b.dtype and np.array_equal(a, b)
