"""Cluster launcher: ``ray-tpu up`` / ``down`` from a config file
(counterpart of ``ray_tpu/cluster_launcher.py``).

Three seams, as in JAX's launcher:

- :class:`LauncherProvider`: create, terminate and list raw hosts.
- :class:`SubprocessProvider`: the hosts are processes of this machine;
  ``up`` stands up a real head and node daemons (``cluster._spawn``, the
  card hidden from each), which any driver joins with
  ``ray_tpu_torch.init(address=...)``.
- :class:`SshProvider`: bootstraps a remote host over ``ssh`` with the
  same command lines (command construction only is tested; reaching hosts
  needs sshd and keys).

The config (JSON, or the YAML that JAX's launcher reads):

    {"cluster_name": "demo",
     "provider": {"type": "subprocess"},
     "head": {"resources": {"CPU": 4}},
     "worker": {"resources": {"CPU": 4}, "count": 2}}

``_load_config`` parses the file with ``json`` first: JSON is a subset of
YAML, so a JSON config is also one for JAX's ``yaml.safe_load``. Only when
that fails does it import ``yaml`` (lazily: the card's machine has none).
The cluster's state record lives under the port's own directory,
``<tmp>/ray_tpu_torch/clusters/<name>.json`` (``tempfile.gettempdir()``),
apart from JAX's ``~/.ray_tpu/clusters``, so the two launchers never share
a file.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import tempfile
import time
from typing import Any, Dict, List, Optional

CLUSTER_STATE_DIR = os.path.join(tempfile.gettempdir(), "ray_tpu_torch",
                                 "clusters")
# how long ``terminate`` waits for a process before it SIGKILLs it
TERMINATE_GRACE_S = 15.0
# the checkout this module runs from: an SSH host's default repo path
_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_config(path: str) -> Dict[str, Any]:
    with open(path) as f:
        text = f.read()
    try:
        cfg = json.loads(text)
    except ValueError:
        import yaml
        cfg = yaml.safe_load(text)
    cfg.setdefault("cluster_name", "default")
    cfg.setdefault("provider", {"type": "subprocess"})
    cfg.setdefault("head", {}).setdefault("resources", {"CPU": 4.0})
    cfg.setdefault("worker", {}).setdefault("resources", {"CPU": 4.0})
    cfg["worker"].setdefault("count", 1)
    return cfg


def _state_path(name: str) -> str:
    os.makedirs(CLUSTER_STATE_DIR, exist_ok=True)
    return os.path.join(CLUSTER_STATE_DIR, f"{name}.json")


# ---------------------------------------------------------------------------
# providers
# ---------------------------------------------------------------------------

class LauncherProvider:
    """create_head/create_worker/terminate over raw hosts."""

    def create_head(self, head_cfg: Dict[str, Any]) -> Dict[str, Any]:
        raise NotImplementedError

    def create_worker(self, address: str,
                      worker_cfg: Dict[str, Any]) -> Dict[str, Any]:
        raise NotImplementedError

    def terminate(self, record: Dict[str, Any]) -> None:
        raise NotImplementedError


def _gone(pid: int) -> bool:
    """True once ``pid`` has exited (a zombie counts; one that is our
    child is reaped)."""
    try:
        if os.waitpid(pid, os.WNOHANG)[0] == pid:
            return True
    except ChildProcessError:
        pass
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] == "Z"
    except OSError:
        return True


class SubprocessProvider(LauncherProvider):
    """Real head and daemon OS processes on this machine."""

    def __init__(self, session: Optional[str] = None):
        self.session = session or os.path.join(
            tempfile.gettempdir(), "ray_tpu_torch",
            f"launcher_{os.getpid()}")
        os.makedirs(self.session, exist_ok=True)

    def create_head(self, head_cfg):
        from ray_tpu_torch._private.cluster import _spawn
        head_proc, head_port = _spawn(
            "ray_tpu_torch._private.head",
            ["--state-path", os.path.join(self.session, "head_state.db")],
            output_path=os.path.join(self.session, "head.log"))
        return {"kind": "head", "pid": head_proc.pid,
                "address": f"127.0.0.1:{head_port}"}

    def create_worker(self, address, worker_cfg):
        from ray_tpu_torch._private.cluster import _spawn
        from ray_tpu_torch._private.ids import NodeID
        node_id = NodeID.from_random().hex()
        proc, port = _spawn(
            "ray_tpu_torch._private.daemon",
            ["--head", address, "--node-id", node_id,
             "--resources", json.dumps(worker_cfg["resources"]),
             "--object-store-bytes",
             str(worker_cfg.get("object_store_bytes",
                                256 * 1024 * 1024)),
             "--session-dir", self.session,
             "--persist"],
            output_path=os.path.join(self.session, f"daemon-{node_id[:8]}.log"))
        return {"kind": "worker", "pid": proc.pid, "node_id": node_id,
                "address": f"127.0.0.1:{port}"}

    def terminate(self, record):
        """Stop the process over the wire, as ``ray-tpu stop`` does (a
        daemon ends its workers and unlinks its arena; JAX's launcher
        sends SIGTERM, which in the port starts a graceful drain that
        lasts the drain window with no driver to migrate to), then wait
        for it; SIGTERM and SIGKILL are the fallbacks."""
        from ray_tpu_torch._private import daemon as _daemon  # noqa: F401 - declares daemon_stop
        from ray_tpu_torch._private import rpc
        from ray_tpu_torch._private.head import HeadClient

        pid = record["pid"]
        host, port = record.get("address", ":").rsplit(":", 1)
        try:
            if record["kind"] == "head":
                head = HeadClient((host, int(port)))
                try:
                    head.stop_head()
                finally:
                    head.close()
            else:
                client = rpc.connect((host, int(port)), timeout=5.0)
                try:
                    client.call("daemon_stop", timeout=2.0)
                finally:
                    client.close()
        except (OSError, ValueError, rpc.RpcError):
            try:
                os.kill(pid, signal.SIGTERM)
            except ProcessLookupError:
                return
        deadline = time.monotonic() + TERMINATE_GRACE_S
        while not _gone(pid):
            if time.monotonic() > deadline:
                try:
                    os.kill(pid, signal.SIGKILL)
                except ProcessLookupError:
                    return
                deadline = float("inf")
            time.sleep(0.05)


class SshProvider(LauncherProvider):
    """Bootstrap remote hosts over ssh (the NodeUpdater role).

    ``bootstrap_command``/``head_command`` build the exact remote
    command lines; ``run=False`` (tests) returns them instead of
    executing."""

    def __init__(self, user: str, hosts: List[str], key: str = "",
                 repo: str = _REPO_ROOT, python: str = "python",
                 run: bool = True):
        self.user = user
        self.hosts = list(hosts)
        self.key = key
        self.repo = repo
        self.python = python
        self.run = run
        self._next_host = 0

    def _ssh_base(self, host: str) -> List[str]:
        cmd = ["ssh", "-o", "StrictHostKeyChecking=no"]
        if self.key:
            cmd += ["-i", self.key]
        cmd.append(f"{self.user}@{host}" if self.user else host)
        return cmd

    def head_command(self, host: str) -> List[str]:
        remote = (f"cd {self.repo} && PYTHONPATH={self.repo} "
                  f"CUDA_VISIBLE_DEVICES= nohup {self.python} -m "
                  f"ray_tpu_torch._private.head --port 6379 "
                  f"> /tmp/ray_tpu_torch_head.log 2>&1 & echo started")
        return self._ssh_base(host) + [remote]

    def bootstrap_command(self, host: str, address: str,
                          node_id: str, resources: Dict[str, float]
                          ) -> List[str]:
        remote = (f"cd {self.repo} && PYTHONPATH={self.repo} "
                  f"CUDA_VISIBLE_DEVICES= nohup {self.python} -m "
                  f"ray_tpu_torch._private.daemon --head {address} "
                  f"--node-id {node_id} "
                  f"--resources '{json.dumps(resources)}' --persist "
                  f"--host 0.0.0.0 "
                  f"> /tmp/ray_tpu_torch_daemon.log 2>&1 & echo started")
        return self._ssh_base(host) + [remote]

    def create_head(self, head_cfg):
        host = self.hosts[0]
        cmd = self.head_command(host)
        if self.run:
            subprocess.run(cmd, check=True, timeout=60)
        return {"kind": "head", "host": host, "address": f"{host}:6379",
                "command": cmd}

    def create_worker(self, address, worker_cfg):
        from ray_tpu_torch._private.ids import NodeID
        host = self.hosts[self._next_host % len(self.hosts)]
        self._next_host += 1
        node_id = NodeID.from_random().hex()
        cmd = self.bootstrap_command(host, address, node_id,
                                     worker_cfg["resources"])
        if self.run:
            subprocess.run(cmd, check=True, timeout=60)
        return {"kind": "worker", "host": host, "node_id": node_id,
                "command": cmd}

    def terminate(self, record):
        if not self.run:
            return
        host = record.get("host")
        if host:
            subprocess.run(
                self._ssh_base(host)
                + ["pkill -f ray_tpu_torch._private || true"],
                timeout=60, check=False)


def _make_provider(cfg: Dict[str, Any]) -> LauncherProvider:
    pcfg = cfg["provider"]
    ptype = pcfg.get("type", "subprocess")
    if ptype in ("subprocess", "local"):
        return SubprocessProvider(session=pcfg.get("session"))
    if ptype == "ssh":
        ssh = pcfg.get("ssh", pcfg)
        return SshProvider(user=ssh.get("user", ""),
                           hosts=ssh.get("hosts", []),
                           key=ssh.get("key", ""),
                           repo=ssh.get("repo", _REPO_ROOT),
                           python=ssh.get("python", "python"))
    raise ValueError(f"unknown provider type {ptype!r}")


# ---------------------------------------------------------------------------
# up / down
# ---------------------------------------------------------------------------

def _head_alive(address: str, timeout: float = 3.0) -> bool:
    if not address:
        return False
    try:
        from ray_tpu_torch._private import rpc as _rpc
        host, port = address.rsplit(":", 1)
        _rpc.wait_for_server((host, int(port)), timeout=timeout)
        return True
    except Exception:
        return False


def up(config_path: str, *, provider: Optional[LauncherProvider] = None
       ) -> Dict[str, Any]:
    """Create (or extend) the cluster described by ``config_path``;
    returns the cluster state record (also kept in
    ``CLUSTER_STATE_DIR/<name>.json``)."""
    cfg = _load_config(config_path)
    provider = provider or _make_provider(cfg)
    state_file = _state_path(cfg["cluster_name"])
    state: Dict[str, Any] = {"cluster_name": cfg["cluster_name"],
                             "nodes": []}
    if os.path.exists(state_file):
        with open(state_file) as f:
            state = json.load(f)
        # stale-state recovery: a state file from a crashed/rebooted
        # cluster records a head that no longer answers — probe it, and
        # start fresh instead of wedging every subsequent `up`
        if not _head_alive(state.get("address", "")):
            state = {"cluster_name": cfg["cluster_name"], "nodes": []}
    if not any(n["kind"] == "head" for n in state["nodes"]):
        head = provider.create_head(cfg["head"])
        state["address"] = head["address"]
        state["nodes"].append(head)
    address = state["address"]
    # wait for the head to answer before registering workers
    from ray_tpu_torch._private import rpc as _rpc
    host, port = address.rsplit(":", 1)
    _rpc.wait_for_server((host, int(port)), timeout=30.0)
    have = sum(1 for n in state["nodes"] if n["kind"] == "worker")
    want = int(cfg["worker"]["count"])
    for _ in range(max(0, want - have)):
        state["nodes"].append(
            provider.create_worker(address, cfg["worker"]))
    with open(state_file, "w") as f:
        json.dump(state, f, indent=2)
    return state


def down(config_path: str, *,
         provider: Optional[LauncherProvider] = None) -> int:
    """Terminate every node of the cluster; returns the count."""
    cfg = _load_config(config_path)
    provider = provider or _make_provider(cfg)
    state_file = _state_path(cfg["cluster_name"])
    if not os.path.exists(state_file):
        return 0
    with open(state_file) as f:
        state = json.load(f)
    n = 0
    # workers first, head last (the reference teardown order)
    for record in sorted(state["nodes"],
                         key=lambda r: r["kind"] == "head"):
        provider.terminate(record)
        n += 1
    os.remove(state_file)
    return n


def wait_for_nodes(address: str, count: int,
                   timeout: float = 60.0) -> bool:
    """Block until ``count`` alive nodes registered at the head."""
    from ray_tpu_torch._private.head import HeadClient
    host, port = address.rsplit(":", 1)
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            head = HeadClient((host, int(port)))
            try:
                alive = [n for n in head.list_nodes() if n["alive"]]
            finally:
                head.close()
            if len(alive) >= count:
                return True
        except (OSError, Exception):
            pass
        time.sleep(0.3)
    return False
