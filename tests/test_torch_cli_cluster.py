"""The port's cluster CLI (``python -m ray_tpu_torch.scripts.cli``): a copy
of ``tests/test_cli_cluster.py``'s lifecycle test (start, two drivers join
the same daemons, stop), ``attach`` and ``job-submit`` on a cluster that
``start`` stood up, ``tests/test_loadgen.py``'s loadgen dispatch, and
``tests/test_ops_shell.py``'s job-submission and debug-state tests, against
``ray_tpu_torch``.
"""

import json
import os
import subprocess
import sys
import time

import pytest

import ray_tpu_torch as rt_api

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cli(*argv, timeout=60, env=None):
    env = dict(env or os.environ)
    env["PYTHONPATH"] = REPO + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    return subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch.scripts.cli", *argv],
        capture_output=True, text=True, timeout=timeout, env=env)


def _start(num_daemons=2):
    out = _cli("start", "--head", "--num-daemons", str(num_daemons),
               "--resources", json.dumps({"CPU": 4}),
               "--object-store-bytes", str(64 << 20))
    assert out.returncode == 0, out.stderr[-2000:]
    for line in out.stdout.splitlines():
        if "started at" in line:
            return line.split("started at")[1].split()[0]
    raise AssertionError(out.stdout)


def _alive(address):
    st = _cli("cluster-status", "--address", address)
    if st.returncode != 0:
        return None
    return [n for n in json.loads(st.stdout)["nodes"] if n["alive"]]


def _stop(address):
    stop = _cli("stop", "--address", address)
    assert stop.returncode == 0, stop.stderr[-2000:]
    # the head answers no more
    assert _cli("cluster-status", "--address", address).returncode != 0


def test_cli_start_join_two_drivers_stop():
    address = _start()
    try:
        assert len(_alive(address)) == 2

        # driver 1 joins, runs work, disconnects
        rt = rt_api.init(address=address)
        try:
            handles = list(rt.cluster_backend.daemons.values())
            assert len(handles) == 2
            assert all(h.proc is None for h in handles)  # not ours

            @rt_api.remote
            def who():
                return os.getpid()

            pids = set(rt_api.get([who.remote() for _ in range(4)]))
            assert os.getpid() not in pids
            daemon_pids = {h.client.call("daemon_ping")["pid"]
                           for h in handles}
        finally:
            rt_api.shutdown()

        # the daemons outlived driver 1 (persist mode)
        time.sleep(0.5)
        assert len(_alive(address)) == 2, "daemons died with driver 1"

        # driver 2 joins the SAME daemons and runs work
        rt = rt_api.init(address=address)
        try:
            handles = list(rt.cluster_backend.daemons.values())
            assert {h.client.call("daemon_ping")["pid"]
                    for h in handles} == daemon_pids

            @rt_api.remote
            class Counter:
                def __init__(self):
                    self.n = 0

                def bump(self):
                    self.n += 1
                    return self.n

            c = Counter.remote()
            assert rt_api.get(c.bump.remote()) == 1
            assert rt_api.get(c.bump.remote()) == 2
        finally:
            rt_api.shutdown()
    finally:
        _stop(address)
    for pid in daemon_pids:
        assert not os.path.exists(f"/proc/{pid}") or open(
            f"/proc/{pid}/stat").read().rsplit(")", 1)[1].split()[0] == "Z"


def test_cli_attach_drain_and_job_submit():
    """``attach -- cmd`` runs a second driver with RAY_TPU_ADDRESS set
    (a bare ``init()`` joins), ``drain`` moves a node to DRAINING at the
    head, and ``job-submit`` runs an entrypoint to SUCCEEDED on the
    attached cluster."""
    address = _start()
    try:
        script = ("import os, ray_tpu_torch as rt\n"
                  "r = rt.init()\n"
                  "@rt.remote\n"
                  "def f(x):\n"
                  "    return x * 2\n"
                  "print('ATTACHED', len(r.cluster_backend.daemons),"
                  " rt.get([f.remote(i) for i in range(4)]))\n"
                  "rt.shutdown()\n")
        out = _cli("attach", "--cluster", address, "--",
                   sys.executable, "-c", script, timeout=120)
        assert out.returncode == 0, out.stderr[-2000:]
        assert "ATTACHED 2 [0, 2, 4, 6]" in out.stdout

        env = dict(os.environ, RAY_TPU_ADDRESS=address)
        job = _cli("job-submit", "echo hello_from_job", timeout=120,
                   env=env)
        assert job.returncode == 0, job.stderr[-2000:]
        assert "hello_from_job" in job.stdout and "SUCCEEDED" in job.stdout

        victim = _alive(address)[0]["node_id"]
        dr = _cli("drain", victim, "--address", address,
                  "--deadline-s", "60", "--reason", "cli test")
        assert dr.returncode == 0, dr.stderr[-2000:]
        assert json.loads(dr.stdout)["ok"]
        views = {n["node_id"]: n for n in _alive(address)}
        assert views[victim]["draining"]
        assert views[victim]["drain_reason"] == "cli test"
        # debug lists the cluster's debugger sessions (none here)
        dbg = _cli("debug", "--cluster", address)
        assert dbg.returncode == 0, dbg.stderr[-2000:]
        assert "no active debugger sessions" in dbg.stdout
    finally:
        _stop(address)


def test_ray_tpu_cli_dispatches_loadgen_after_global_flags():
    """``--num-nodes 2 loadgen ...`` reaches the loadgen CLI, as the bare
    ``loadgen ...`` form does."""
    from ray_tpu_torch.scripts import cli

    for argv in (["loadgen", "--help"],
                 ["--num-nodes", "2", "loadgen", "--help"]):
        with pytest.raises(SystemExit) as ei:
            cli.main(argv)
        assert ei.value.code == 0, argv


@pytest.fixture
def one_node():
    rt = rt_api.init(num_nodes=1, resources={"CPU": 8})
    yield rt
    rt_api.shutdown()


def test_job_submission(one_node):
    from ray_tpu_torch.job import JobSubmissionClient

    client = JobSubmissionClient()
    job_id = client.submit_job(
        entrypoint="echo hello_from_job && echo line2")
    assert client.wait_until_finished(job_id, timeout=30) == "SUCCEEDED"
    logs = client.get_job_logs(job_id)
    assert "hello_from_job" in logs and "line2" in logs

    bad = client.submit_job(entrypoint="exit 3")
    assert client.wait_until_finished(bad, timeout=30) == "FAILED"
    assert client.get_job_info(bad).returncode == 3
    assert len(client.list_jobs()) == 2

    env_job = client.submit_job(entrypoint='test "$JOB_FLAG" = on',
                                runtime_env={"env_vars": {"JOB_FLAG": "on"}})
    assert client.wait_until_finished(env_job, timeout=30) == "SUCCEEDED"


def test_debug_state_and_loop_instrumentation(one_node):
    @rt_api.remote
    def f():
        return 1

    rt_api.get([f.remote() for _ in range(5)])
    rt = one_node
    state = rt.debug_state()
    assert "loop=" in state and "tasks_launched" in state
    node = rt.nodes()[0]
    assert node.loop_stats["tasks_launched"] >= 5
    assert node.loop_stats["max_queue_lag_ms"] >= 0
