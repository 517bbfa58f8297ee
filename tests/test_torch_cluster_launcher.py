"""The port's cluster launcher (copies of ``tests/test_cli_cluster.py``'s
``up``/``down``, SSH command-shape and attach-through-the-launcher tests
against ``ray_tpu_torch``, with JSON configs).

``cluster_launcher.up`` stands up a real head and node daemons from a
config file, a driver joins them with ``init(address=...)``, and ``down``
ends every process. The config is JSON (JAX's YAML where ``yaml`` is
installed); the state record lives under the port's own directory. Each
test uses its own cluster name, so tests under xdist share no file.
"""

import json
import os
import subprocess
import sys

import pytest

import ray_tpu_torch as rt_api
from ray_tpu_torch import cluster_launcher as cl

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _config(tmp_path, name: str, count: int) -> str:
    path = tmp_path / "cluster.json"
    path.write_text(json.dumps({
        "cluster_name": name, "provider": {"type": "subprocess"},
        "head": {"resources": {"CPU": 2}},
        "worker": {"resources": {"CPU": 2}, "count": count}}))
    return str(path)


def _alive(pid: int) -> bool:
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


def test_ray_tpu_up_down_subprocess_provider(tmp_path):
    """``up`` with the subprocess provider creates a real head and worker
    daemons a driver can join; ``down`` ends them all."""
    config = _config(tmp_path, f"torch-up-test-{os.getpid()}", 2)
    state = cl.up(config)
    pids = [n["pid"] for n in state["nodes"]]
    try:
        assert state["cluster_name"].startswith("torch-up-test")
        assert os.path.dirname(cl._state_path(state["cluster_name"])) \
            == cl.CLUSTER_STATE_DIR
        assert cl.wait_for_nodes(state["address"], 2, timeout=60)
        rt_api.init(address=state["address"])
        try:
            @rt_api.remote
            def pid():
                import os
                return os.getpid()

            got = set(rt_api.get([pid.remote() for _ in range(4)],
                                 timeout=120))
            assert got and all(p != os.getpid() for p in got)
        finally:
            rt_api.shutdown()
        # idempotent: a second `up` adds nothing
        state2 = cl.up(config)
        assert sum(1 for n in state2["nodes"]
                   if n["kind"] == "worker") == 2
    finally:
        n = cl.down(config)
    assert n == 3    # head + 2 workers
    assert not [p for p in pids if _alive(p)]
    assert not os.path.exists(cl._state_path(state["cluster_name"]))


def test_ssh_provider_command_shape():
    """SshProvider builds the bootstrap command lines; ``run=False``
    returns them without executing."""
    from ray_tpu_torch.cluster_launcher import SshProvider

    p = SshProvider(user="tpu", hosts=["h1", "h2"], key="/k",
                    repo="/srv/ray_tpu", run=False)
    head = p.create_head({"resources": {"CPU": 4}})
    assert head["address"] == "h1:6379"
    assert head["command"][:3] == ["ssh", "-o", "StrictHostKeyChecking=no"]
    assert "tpu@h1" in head["command"]
    assert "ray_tpu_torch._private.head" in head["command"][-1]
    w1 = p.create_worker("h1:6379", {"resources": {"CPU": 4, "GPU": 1}})
    w2 = p.create_worker("h1:6379", {"resources": {"CPU": 4}})
    assert w1["host"] == "h1" and w2["host"] == "h2"  # round robin
    remote = w1["command"][-1]
    assert "--head h1:6379" in remote
    assert "--host 0.0.0.0" in remote
    assert '"GPU": 1' in remote
    assert "ray_tpu_torch._private.daemon" in remote


def test_ray_tpu_attach_runs_command_against_cluster(tmp_path):
    """``attach`` exports RAY_TPU_ADDRESS, so a bare ``init()`` inside the
    command joins the cluster the launcher stood up; the CLI's ``up`` and
    ``down`` drive the same launcher."""
    config = _config(tmp_path, f"torch-attach-test-{os.getpid()}", 1)
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")

    def cli(*args):
        return subprocess.run(
            [sys.executable, "-m", "ray_tpu_torch.scripts.cli", *args],
            capture_output=True, text=True, timeout=120, cwd=REPO, env=env)

    up = cli("up", config)
    assert up.returncode == 0, up.stderr[-2000:]
    address = up.stdout.split(" up at ")[1].split()[0]
    try:
        assert cl.wait_for_nodes(address, 1, timeout=60)
        script = ("import ray_tpu_torch; rt = ray_tpu_torch.init(); "
                  "print('NODES', len(rt.alive_nodes())); "
                  "ray_tpu_torch.shutdown()")
        out = cli("attach", "--cluster", address, "--",
                  sys.executable, "-c", script)
        assert out.returncode == 0, out.stderr[-2000:]
        assert "NODES 1" in out.stdout, out.stdout
    finally:
        down = cli("down", config)
    assert down.returncode == 0 and "terminated 2 nodes" in down.stdout


def test_config_json_first_then_yaml(tmp_path):
    """A JSON config and the same config in JAX's YAML load to the same
    dict, with JAX's defaults filled in."""
    js = tmp_path / "c.json"
    js.write_text(json.dumps({"cluster_name": "x",
                              "worker": {"resources": {"CPU": 2}}}))
    ym = tmp_path / "c.yaml"
    ym.write_text("cluster_name: x\nworker:\n  resources: {CPU: 2}\n")
    want = {"cluster_name": "x", "provider": {"type": "subprocess"},
            "head": {"resources": {"CPU": 4.0}},
            "worker": {"resources": {"CPU": 2}, "count": 1}}
    assert cl._load_config(str(js)) == want
    assert cl._load_config(str(ym)) == want
