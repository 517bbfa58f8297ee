"""The ``ray-tpu`` CLI of the port (counterpart of
``ray_tpu/scripts/cli.py``), run as ``python -m ray_tpu_torch.scripts.cli``.

Cluster lifecycle: ``start --head`` stands up a head and node daemons as
persistent OS processes (the daemons outlive driver disconnects, the head
is not tied to the CLI's pid); any driver joins with
``ray_tpu_torch.init(address="host:port")``; ``stop`` ends every process
of the cluster and unlinks the daemons' arenas. The address of the last
cluster started here is recorded in ``<tmp>/ray_tpu_torch/
current_cluster.json`` (``tempfile.gettempdir()``), apart from JAX's
``/tmp/ray_tpu`` file, so ``stop``, ``cluster-status``, ``drain`` and
``attach`` work without an address. Every process of the cluster runs
with the card hidden (``cluster._spawn``).

``up`` and ``down`` stand a cluster up from a config file and tear it
down (``ray_tpu_torch/cluster_launcher.py``; JSON, or YAML where ``yaml``
is installed).

``status``, ``summary``, ``memory``, ``timeline``, ``profile``,
``microbenchmark``, ``dashboard`` and ``debug`` wait for the modules they
read (ROADMAP A11e). Each exits 2 naming its item.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

CLUSTER_DIR = os.path.join(tempfile.gettempdir(), "ray_tpu_torch")
CLUSTER_FILE = os.path.join(CLUSTER_DIR, "current_cluster.json")

# subcommand -> the ROADMAP item that brings it
_LATER = {
    "status": "A11e (util.state)", "summary": "A11e (util.state)",
    "memory": "A11e (the memory monitor)",
    "timeline": "A11e (the task-event store)",
    "profile": "A11e (profiling)",
    "microbenchmark": "A11e (_private/perf.py)",
    "dashboard": "A11e (the dashboard)", "debug": "A11e (util.rpdb)",
}


def _init_runtime(args):
    import ray_tpu_torch
    if not ray_tpu_torch.is_initialized():
        ray_tpu_torch.init(num_nodes=args.num_nodes)
    return ray_tpu_torch


def _resolve_address(args) -> str:
    addr = getattr(args, "address", None)
    if addr:
        return addr
    addr = _try_cluster_address()
    if not addr:
        raise SystemExit(
            f"no --address given and no local cluster recorded "
            f"({CLUSTER_FILE}); start one with `start --head`")
    return addr


def _try_cluster_address() -> str:
    try:
        with open(CLUSTER_FILE) as f:
            return json.load(f)["address"]
    except Exception:
        return ""


def _head(address: str):
    from ray_tpu_torch._private.head import HeadClient
    host, port = address.rsplit(":", 1)
    return HeadClient((host, int(port)))


def _spawn_head(session: str, port: int = 0):
    from ray_tpu_torch._private.cluster import _spawn
    head_args = ["--state-path", os.path.join(session, "head_state.db")]
    if port:
        head_args += ["--port", str(port)]
    # no --parent-pid: the CLI exits at once, the head stays
    return _spawn("ray_tpu_torch._private.head", head_args,
                  output_path=os.path.join(session, "head.log"))


def cmd_start(args) -> int:
    """Stand up a persistent head and N node daemons."""
    if not args.head:
        raise SystemExit("only --head mode is supported: pass --head "
                         "(a daemon joins a running head with `python -m "
                         "ray_tpu_torch._private.daemon --head host:port`)")
    from ray_tpu_torch._private.cluster import _spawn
    from ray_tpu_torch._private.ids import NodeID

    session = os.path.join(CLUSTER_DIR, f"cluster_{os.getpid()}")
    os.makedirs(session, exist_ok=True)
    head_proc, head_port = _spawn_head(session, args.port)
    address = f"127.0.0.1:{head_port}"
    resources = args.resources or json.dumps(
        {"CPU": float(os.cpu_count() or 4)})
    daemon_pids = []
    for _ in range(args.num_daemons):
        proc, _port = _spawn("ray_tpu_torch._private.daemon", [
            "--head", address,
            "--node-id", NodeID.from_random().hex(),
            "--resources", resources,
            "--object-store-bytes", str(args.object_store_bytes),
            "--session-dir", session,
            "--persist",
        ], output_path=os.path.join(session, "daemon.log"))
        daemon_pids.append(proc.pid)
    _write_record({"address": address, "head_pid": head_proc.pid,
                   "daemon_pids": daemon_pids, "session": session})
    print(f"ray_tpu_torch cluster started at {address} "
          f"({args.num_daemons} daemons)")
    print(f'connect with: ray_tpu_torch.init(address="{address}")')
    sys.stdout.flush()
    if not args.block:
        return 0
    # --block: stay up and respawn a crashed head on the same port
    try:
        while True:
            time.sleep(0.5)
            if head_proc.poll() is None:
                continue
            try:
                head_proc, _ = _spawn_head(session, head_port)
            except (RuntimeError, OSError):
                continue    # the port may linger in TIME_WAIT: retry
            try:    # keep stop's pid fallback pointing at the live head
                with open(CLUSTER_FILE) as f:
                    rec = json.load(f)
                rec["head_pid"] = head_proc.pid
                _write_record(rec)
            except (OSError, ValueError):
                pass
    except KeyboardInterrupt:
        return cmd_stop(args)


def _write_record(rec) -> None:
    os.makedirs(CLUSTER_DIR, exist_ok=True)
    tmp = CLUSTER_FILE + f".{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(rec, f)
    os.replace(tmp, CLUSTER_FILE)


def _gone(pid: int) -> bool:
    """Whether a process (not our child) has exited: no such pid, or a
    zombie nobody reaped yet."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] == "Z"
    except (OSError, IndexError):
        return True


def cmd_stop(args) -> int:
    """Tear down the cluster at --address (or the recorded one): stop
    every registered daemon (its workers end and its arena is unlinked),
    then the head; wait for the processes to leave."""
    import signal

    from ray_tpu_torch._private import daemon as _daemon_schemas  # noqa: F401 - declares daemon_ping/daemon_stop
    from ray_tpu_torch._private import rpc

    address = _resolve_address(args)
    rec = {}
    try:
        with open(CLUSTER_FILE) as f:
            rec = json.load(f)
    except (OSError, ValueError):
        pass
    if rec.get("address") != address:
        rec = {}
    pids = [p for p in [rec.get("head_pid"), *rec.get("daemon_pids", [])]
            if p]
    stopped = 0
    try:
        head = _head(address)
        try:
            for info in head.list_nodes():
                if not info["alive"]:
                    continue
                pid = None
                try:
                    client = rpc.connect(tuple(info["addr"]), timeout=5.0)
                    try:
                        pid = client.call("daemon_ping", timeout=2.0)["pid"]
                        client.call("daemon_stop", timeout=2.0)
                    finally:
                        client.close()
                    stopped += 1
                except (rpc.RpcError, OSError):
                    pass
                if pid:
                    pids.append(pid)
            head.stop_head()
        finally:
            head.close()
    except (OSError, rpc.RpcError):
        # the head is already gone: fall back to the recorded pids
        for pid in pids:
            try:
                os.kill(pid, signal.SIGKILL)
            except OSError:
                pass
    deadline = time.monotonic() + 15.0
    while (any(not _gone(p) for p in set(pids))
           and time.monotonic() < deadline):
        time.sleep(0.05)
    for pid in set(pids):
        if not _gone(pid):
            try:
                os.kill(pid, signal.SIGKILL)
            except OSError:
                pass
    if rec.get("session"):
        shutil.rmtree(rec["session"], ignore_errors=True)
        try:
            os.unlink(CLUSTER_FILE)
        except OSError:
            pass
    print(f"stopped cluster at {address} ({stopped} daemons)")
    return 0


def cmd_cluster_status(args) -> int:
    """Membership of a running cluster (no runtime init)."""
    address = _resolve_address(args)
    head = _head(address)
    try:
        nodes = head.list_nodes()
    finally:
        head.close()
    print(json.dumps({"address": address, "nodes": nodes}, indent=2,
                     default=str))
    return 0


def cmd_drain(args) -> int:
    """Gracefully drain a node of a running cluster (no runtime init):
    the head fences new placements, connected drivers migrate work off,
    and the deadline escalates to the death path."""
    address = _resolve_address(args)
    head = _head(address)
    try:
        out = head.drain_node(args.node_id, args.deadline_s, args.reason)
    finally:
        head.close()
    out.pop("i", None)      # the rpc correlation id, not user-facing
    print(json.dumps({"address": address, "node_id": args.node_id, **out},
                     indent=2, default=str))
    return 0 if out.get("ok") else 1


def cmd_serve_deploy(args) -> int:
    """Deploy Serve applications from a YAML or JSON config."""
    _init_runtime(args)
    from ray_tpu_torch import serve

    handles = serve.run_config(args.config_file)
    print(f"deployed {len(handles)} application(s): {sorted(handles)}")
    if args.http_port >= 0:
        port = serve.start_http_proxy(port=args.http_port)
        print(f"http proxy on :{port}")
        try:
            while True:
                time.sleep(3600)
        except KeyboardInterrupt:
            return 0
    return 0


def cmd_job_submit(args) -> int:
    _init_runtime(args)
    from ray_tpu_torch.job import JobSubmissionClient
    client = JobSubmissionClient()
    job_id = client.submit_job(entrypoint=args.entrypoint)
    status = client.wait_until_finished(job_id, timeout=args.timeout)
    print(client.get_job_logs(job_id), end="")
    print(f"job {job_id}: {status}")
    return 0 if status == "SUCCEEDED" else 1


def cmd_loadgen(args) -> int:
    # reached only when a global flag precedes the subcommand; the bare
    # form short-circuits before argparse in main()
    from ray_tpu_torch.loadgen.__main__ import main as loadgen_main
    return loadgen_main(args.rest)


def cmd_attach(args) -> int:
    """Run a command (or a shell) wired to the running cluster: it gets
    RAY_TPU_ADDRESS, so a bare ``ray_tpu_torch.init()`` joins."""
    import subprocess

    address = args.cluster or _try_cluster_address()
    if not address:
        raise SystemExit("no running cluster (start one with "
                         "`start --head`)")
    env = dict(os.environ)
    env["RAY_TPU_ADDRESS"] = address
    cmd = list(args.cmd)
    if cmd and cmd[0] == "--":
        cmd = cmd[1:]
    cmd = cmd or [os.environ.get("SHELL", "/bin/bash")]
    print(f"attached to {address} (RAY_TPU_ADDRESS set)")
    sys.stdout.flush()
    return subprocess.call(cmd, env=env)


def cmd_up(args) -> int:
    """Create the cluster a config file describes (JAX's ``ray-tpu up``)."""
    from ray_tpu_torch.cluster_launcher import up
    state = up(args.config_file)
    workers = sum(1 for n in state["nodes"] if n["kind"] == "worker")
    print(f"cluster {state['cluster_name']!r} up at {state['address']} "
          f"({workers} workers)")
    print(f'connect with: ray_tpu_torch.init(address="{state["address"]}")')
    return 0


def cmd_down(args) -> int:
    from ray_tpu_torch.cluster_launcher import down
    n = down(args.config_file)
    print(f"terminated {n} nodes")
    return 0


def _cmd_later(args) -> int:
    print(f"`{args.command}` is not ported yet: ROADMAP "
          f"{_LATER[args.command]}", file=sys.stderr)
    return 2


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "loadgen":
        # pass-through BEFORE argparse: the loadgen CLI owns its whole
        # flag surface (argparse.REMAINDER drops a leading `--help`)
        from ray_tpu_torch.loadgen.__main__ import main as loadgen_main
        return loadgen_main(argv[1:])
    parser = argparse.ArgumentParser(
        prog="ray-tpu", description="ray_tpu_torch cluster CLI")
    parser.add_argument("--num-nodes", type=int, default=1)
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("start")
    p.add_argument("--head", action="store_true")
    p.add_argument("--port", type=int, default=0)
    p.add_argument("--num-daemons", type=int, default=2)
    p.add_argument("--resources", default="",
                   help="JSON resource map per daemon")
    p.add_argument("--object-store-bytes", type=int,
                   default=256 * 1024 * 1024)
    p.add_argument("--block", action="store_true",
                   help="stay attached; supervise the head")
    p = sub.add_parser("stop")
    p.add_argument("--address", default="")
    p = sub.add_parser("cluster-status")
    p.add_argument("--address", default="")
    p = sub.add_parser("drain")
    p.add_argument("node_id", help="node id (hex) to drain gracefully")
    p.add_argument("--address", default="")
    p.add_argument("--deadline-s", type=float, default=30.0,
                   dest="deadline_s",
                   help="drain window before escalating to node death")
    p.add_argument("--reason", default="manual drain")
    p = sub.add_parser("serve-deploy")
    p.add_argument("config_file")
    p.add_argument("--http-port", type=int, default=-1,
                   help=">=0: start the HTTP proxy and block")
    p = sub.add_parser("job-submit")
    p.add_argument("entrypoint")
    p.add_argument("--timeout", type=float, default=300.0)
    p = sub.add_parser(
        "loadgen", add_help=False,
        help="open-loop serving load generator "
             "(see `loadgen --help`)")
    p.add_argument("rest", nargs=argparse.REMAINDER)
    p = sub.add_parser("up")
    p.add_argument("config_file", help="cluster config, JSON or YAML (see "
                                       "ray_tpu_torch/cluster_launcher.py)")
    p = sub.add_parser("down")
    p.add_argument("config_file")
    p = sub.add_parser("attach")
    p.add_argument("cmd", nargs=argparse.REMAINDER,
                   help="command to run attached (default: $SHELL)")
    p.add_argument("--cluster", default="",
                   help="head host:port (default: the cluster file)")
    for name in _LATER:
        sub.add_parser(name, add_help=False).add_argument(
            "rest", nargs=argparse.REMAINDER)

    args, extra = parser.parse_known_args(argv)
    if args.command == "loadgen":
        # the global-flag-prefixed form: REMAINDER cannot capture leading
        # option-like tokens (bpo-17050), so hand loadgen everything after
        # its own name (the only global flag takes an int value)
        args.rest = argv[argv.index("loadgen") + 1:]
    elif extra:
        parser.error("unrecognized arguments: " + " ".join(extra))
    if args.command in _LATER:
        return _cmd_later(args)
    handler = {
        "start": cmd_start, "stop": cmd_stop,
        "cluster-status": cmd_cluster_status, "drain": cmd_drain,
        "serve-deploy": cmd_serve_deploy, "job-submit": cmd_job_submit,
        "attach": cmd_attach, "loadgen": cmd_loadgen,
        "up": cmd_up, "down": cmd_down,
    }[args.command]
    return handler(args)


if __name__ == "__main__":
    sys.exit(main())
