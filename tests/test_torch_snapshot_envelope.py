"""The GCS's snapshot and restore and the perf harness's scale envelope on
the port, against the JAX package: a copy of ``tests/test_ops_shell.py``'s
``test_gcs_kv_snapshot_restore``, one KV script over several namespaces on
both packages' GCS (each reading the other's snapshot too), the job table's
round trip, the port's refusal of a snapshot that names a global, and
``envelope_rows`` of both packages under one environment.
"""

import importlib
import pickle

import pytest

import ray_tpu_torch
from ray_tpu._private.gcs import GCS as JGCS
from ray_tpu_torch._private import rpc
from ray_tpu_torch._private.gcs import GCS, JobInfo
from ray_tpu_torch._private.ids import JobID

NAMESPACES = (b"", b"serve", b"tune")


@pytest.fixture
def ray_start_regular():
    """JAX's fixture: a 1-node runtime of 8 CPUs."""
    rt = ray_tpu_torch.init(num_nodes=1, resources={"CPU": 8})
    yield rt
    ray_tpu_torch.shutdown()


def test_gcs_kv_snapshot_restore(ray_start_regular, tmp_path):
    from ray_tpu_torch._private import worker as _worker

    rt = _worker.global_runtime()
    rt.gcs.kv_put(b"cfg", b"value1")
    path = rt.gcs.snapshot(str(tmp_path / "gcs.snap"))

    rt.gcs.kv_del(b"cfg")
    assert rt.gcs.kv_get(b"cfg") is None
    rt.gcs.restore(path)
    assert rt.gcs.kv_get(b"cfg") == b"value1"


def _kv_script(gcs, path):
    """Puts over three namespaces, a snapshot, then deletes, overwrites and
    a new namespace, a restore; returns every namespace's table after."""
    for i, ns in enumerate(NAMESPACES):
        for k in range(3):
            gcs.kv_put(f"k{k}".encode(), f"{ns!r}:{k}".encode(),
                       namespace=ns)
        gcs.kv_put(b"k0", b"kept", overwrite=False, namespace=ns)
    gcs.snapshot(str(path))
    gcs.kv_del(b"k1", namespace=b"serve")
    gcs.kv_put(b"k2", b"changed", namespace=b"")
    gcs.kv_put(b"late", b"x", namespace=b"late")
    gcs.restore(str(path))
    return _tables(gcs)


def _tables(gcs):
    return {ns: {k: gcs.kv_get(k, namespace=ns)
                 for k in sorted(gcs.kv_keys(namespace=ns))}
            for ns in NAMESPACES + (b"late",)}


def test_kv_round_trip_matches_jax(tmp_path):
    """The same script on both GCS: the KV is replaced by the snapshot's
    (the delete and the overwrite undone, the later namespace gone)."""
    ours = _kv_script(GCS(), tmp_path / "port.snap")
    theirs = _kv_script(JGCS(), tmp_path / "jax.snap")
    assert ours == theirs
    assert ours[b"serve"] == {b"k0": b"b'serve':0", b"k1": b"b'serve':1",
                              b"k2": b"b'serve':2"}
    assert ours[b""][b"k2"] == b"b'':2" and ours[b"late"] == {}


@pytest.mark.parametrize("writer", ["ray_tpu", "ray_tpu_torch"])
def test_each_package_reads_the_others_kv_snapshot(tmp_path, writer):
    """A snapshot of KV tables alone is plain data in both packages' files:
    each package restores the other's."""
    src = JGCS() if writer == "ray_tpu" else GCS()
    dst = GCS() if writer == "ray_tpu" else JGCS()
    for ns in NAMESPACES:
        src.kv_put(b"key", ns + b"-value", namespace=ns)
    dst.kv_put(b"gone", b"1")
    dst.restore(src.snapshot(str(tmp_path / "gcs.snap")))
    assert _tables(dst) == _tables(src)
    assert dst.kv_get(b"gone") is None


def test_job_table_round_trip_merges(tmp_path):
    """Jobs are merged on restore (JAX's ``self.jobs.update``): a job added
    after the snapshot stays, a snapshotted one comes back whole."""
    gcs = GCS()
    a, b = JobID.from_random(), JobID.from_random()
    gcs.jobs[a] = JobInfo(a, start_time=12.5, metadata={"owner": "x"})
    path = gcs.snapshot(str(tmp_path / "gcs.snap"))
    gcs.jobs.pop(a)
    gcs.jobs[b] = JobInfo(b)
    gcs.restore(path)
    assert set(gcs.jobs) == {a, b}
    assert gcs.jobs[a] == JobInfo(a, start_time=12.5,
                                  metadata={"owner": "x"})


def test_restore_refuses_a_snapshot_that_names_a_global(tmp_path):
    """A departure: the port reads a snapshot as it reads a wire frame,
    refusing every global, where JAX's ``pickle.load`` would run one."""
    path = tmp_path / "evil.snap"
    path.write_bytes(pickle.dumps({"kv": {}, "jobs": {}, "x": JobInfo}))
    gcs = GCS()
    gcs.kv_put(b"k", b"v")
    with pytest.raises(rpc.RpcError, match="may not name a global"):
        gcs.restore(str(path))
    assert gcs.kv_get(b"k") == b"v"


@pytest.mark.envelope
def test_envelope_rows_match_jax(monkeypatch):
    """Both packages' ``envelope_rows`` under one environment (the drain
    budget at 0, so the ladder stops after its first rung of 100,000
    tasks): the same rows in the same order with the same keys, every
    rung drained and the spread on all 64 nodes."""
    monkeypatch.setenv("PERF_ENVELOPE_DRAIN_BUDGET_S", "0")
    rows = {pkg: importlib.import_module(f"{pkg}._private.perf")
            .envelope_rows() for pkg in ("ray_tpu", "ray_tpu_torch")}
    assert not ray_tpu_torch.is_initialized()
    names = [r["name"] for r in rows["ray_tpu_torch"]]
    assert names == [r["name"] for r in rows["ray_tpu"]] == [
        "queued_100000_task_drain", "actors_5000_create_and_call",
        "spread_256_tasks_64_nodes"]
    for ours, theirs in zip(rows["ray_tpu_torch"], rows["ray_tpu"]):
        assert list(ours) == list(theirs)
    assert rows["ray_tpu_torch"][0]["n"] == 100_000
    assert rows["ray_tpu_torch"][1]["count"] == 5000
    assert rows["ray_tpu_torch"][2]["count"] == rows["ray_tpu"][2]["count"] \
        == 64


def test_perf_main_runs_the_envelope_only_when_asked(monkeypatch, capsys):
    """``main`` prints the envelope's rows behind ``PERF_ENVELOPE=1`` and
    not otherwise, as JAX's does (the other rows stubbed)."""
    perf = importlib.import_module("ray_tpu_torch._private.perf")
    monkeypatch.setattr(perf, "run_microbenchmarks",
                        lambda duration_s: [{"name": "micro"}])
    monkeypatch.setattr(perf, "burst_submit_batched",
                        lambda: {"name": "burst"})
    monkeypatch.setattr(perf, "queued_task_drain",
                        lambda n: {"name": f"drain_{n}"})
    monkeypatch.setattr(perf, "envelope_rows",
                        lambda: [{"name": "envelope"}])
    monkeypatch.setenv("PERF_DRAIN_N", "10")
    for flag, expect in (("0", []), ("1", ["envelope"])):
        monkeypatch.setenv("PERF_ENVELOPE", flag)
        assert perf.main() == 0
        lines = capsys.readouterr().out.splitlines()
        assert [line for line in lines if "envelope" in line] == [
            '{"name": "envelope"}'] * len(expect)
        assert len(lines) == 4 + len(expect)
