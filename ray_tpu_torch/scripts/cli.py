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

The read commands, as in JAX: ``status``, ``summary`` and ``memory`` (the
state API and each node's store), ``timeline`` (the merged chrome trace),
``profile`` (a cluster-wide stack profile), ``microbenchmark`` (the
runtime's core-op rates) and ``dashboard``. Each runs a runtime of its own,
or joins the cluster ``RAY_TPU_ADDRESS`` names. ``debug`` lists the remote
debugger's sessions advertised in the running cluster's KV, or attaches to
one (``util/rpdb.py``).
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


def _init_runtime(args):
    import ray_tpu_torch
    if not ray_tpu_torch.is_initialized():
        ray_tpu_torch.init(num_nodes=args.num_nodes)
    return ray_tpu_torch


def cmd_status(args) -> int:
    ray_tpu_torch = _init_runtime(args)
    from ray_tpu_torch.util import state as st
    print(json.dumps({
        "nodes": st.list_nodes(),
        "cluster_resources": ray_tpu_torch.cluster_resources(),
        "available_resources": ray_tpu_torch.available_resources(),
    }, indent=2, default=str))
    return 0


def cmd_summary(args) -> int:
    _init_runtime(args)
    from ray_tpu_torch.util import state as st
    print(json.dumps({"tasks": st.summarize_tasks(),
                      "actors": len(st.list_actors()),
                      "placement_groups": len(st.list_placement_groups())},
                     indent=2))
    return 0


def cmd_memory(args) -> int:
    """One row a node: its store's bytes and objects, and its bytes by
    tier (``device-hbm`` is the card's memory, held by the driver)."""
    _init_runtime(args)
    from ray_tpu_torch._private import worker as _worker
    rt = _worker.global_runtime()
    rows = []
    for node in rt.nodes():
        rows.append({"node_id": node.node_id.hex()[:16],
                     "used_bytes": node.store.used_bytes(),
                     "num_objects": len(list(node.store.object_ids())),
                     "tier_bytes": dict(node.store.tier_bytes()),
                     "stats": dict(getattr(node.store, "stats", {}))})
    print(json.dumps(rows, indent=2, default=str))
    return 0


def cmd_timeline(args) -> int:
    _init_runtime(args)
    from ray_tpu_torch.util import state as st
    # the merged trace: one lane a process (driver / daemon / worker),
    # clock-corrected spans from the head's task-event store
    path = st.cluster_timeline(args.output)
    print(f"wrote chrome trace to {path}")
    return 0


def cmd_profile(args) -> int:
    """A cluster-wide stack profile: a burst on every process (driver,
    daemons, workers) merged with the head's continuous aggregates, written
    as speedscope JSON (one lane a process) or collapsed stacks."""
    _init_runtime(args)
    from ray_tpu_torch.util import state as st
    node = args.node if not args.all else None
    out = st.cluster_profile(duration_s=args.duration, node=node,
                             path=args.output, fmt=args.format)
    for rec in out["records"]:
        print(f"  {rec['proc']:<24} {rec.get('mode', '?'):<10} "
              f"{rec.get('samples', 0):>6} samples")
    print(f"wrote {args.format} profile ({len(out['records'])} "
          f"processes) to {args.output}")
    return 0


def cmd_microbenchmark(args) -> int:
    from ray_tpu_torch._private.perf import run_microbenchmarks
    for row in run_microbenchmarks(duration_s=args.duration):
        print(json.dumps(row))
    return 0


def cmd_dashboard(args) -> int:
    _init_runtime(args)
    from ray_tpu_torch.dashboard import start_dashboard
    host, port = start_dashboard(port=args.port)
    print(f"dashboard at http://{host}:{port}", flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        return 0


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


def cmd_debug(args) -> int:
    """List the remote debugger's active sessions, or attach to one.
    Listing reads the head KV of the cluster ``--cluster`` or
    ``RAY_TPU_ADDRESS`` names, else this process's runtime when one is up,
    else the cluster file's; never a fresh runtime of its own."""
    import ray_tpu_torch
    from ray_tpu_torch.util import rpdb
    named = args.cluster or os.environ.get("RAY_TPU_ADDRESS", "")
    local = not named and ray_tpu_torch.is_initialized()
    cluster = named or ("" if local else _try_cluster_address())
    if args.session:
        host, _, port = args.session.rpartition(":")
        token = args.token
        if not token and cluster:
            # an externally bound session wants its KV-advertised token
            head = _head(cluster)
            try:
                for s in rpdb.sessions_from_kv(head):
                    if (str(s.get("port")) == port
                            and s.get("host") == (host or "127.0.0.1")
                            and s.get("token")):
                        token = s["token"]
                        break
            finally:
                head.close()
        rpdb.connect(host or "127.0.0.1", int(port), token=token or None)
        return 0
    sessions = []
    if cluster:
        head = _head(cluster)
        try:
            sessions = rpdb.sessions_from_kv(head)
        finally:
            head.close()
    elif local:
        sessions = rpdb.active_sessions()
    if not sessions:
        print("no active debugger sessions")
        return 0
    for s in sessions:
        print(f"{s['host']}:{s['port']}  pid={s['pid']} "
              f"task={s.get('task_id')}  {s.get('banner', '')}")
    return 0


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
    sub.add_parser("status")
    sub.add_parser("summary")
    sub.add_parser("memory")
    p = sub.add_parser("timeline")
    p.add_argument("--output", default=os.path.join(
        tempfile.gettempdir(), "ray_tpu_timeline.json"))
    p = sub.add_parser("profile")
    p.add_argument("--node", default="",
                   help="profile only the daemon whose node id (hex) "
                        "starts with this prefix")
    p.add_argument("--all", action="store_true",
                   help="the whole cluster: driver, every daemon and "
                        "worker, and the head's aggregates (the default "
                        "when --node is not given)")
    p.add_argument("--duration", type=float, default=2.0,
                   help="burst sampling window in seconds")
    p.add_argument("--output", default=os.path.join(
        tempfile.gettempdir(), "ray_tpu_profile.json"))
    p.add_argument("--format", choices=["speedscope", "collapsed"],
                   default="speedscope")
    p = sub.add_parser("microbenchmark")
    p.add_argument("--duration", type=float, default=2.0)
    p = sub.add_parser("dashboard")
    p.add_argument("--port", type=int, default=8265)
    p = sub.add_parser("debug")
    p.add_argument("session", nargs="?", default="",
                   help="host:port of a session to attach; empty = list")
    p.add_argument("--cluster", default="",
                   help="head host:port (default: the cluster file)")
    p.add_argument("--token", default="",
                   help="session token of an externally bound session "
                        "(default: resolved from the cluster KV)")

    args, extra = parser.parse_known_args(argv)
    if args.command == "loadgen":
        # the global-flag-prefixed form: REMAINDER cannot capture leading
        # option-like tokens (bpo-17050), so hand loadgen everything after
        # its own name (the only global flag takes an int value)
        args.rest = argv[argv.index("loadgen") + 1:]
    elif extra:
        parser.error("unrecognized arguments: " + " ".join(extra))
    handler = {
        "start": cmd_start, "stop": cmd_stop,
        "cluster-status": cmd_cluster_status, "drain": cmd_drain,
        "serve-deploy": cmd_serve_deploy, "job-submit": cmd_job_submit,
        "attach": cmd_attach, "loadgen": cmd_loadgen,
        "up": cmd_up, "down": cmd_down,
        "status": cmd_status, "summary": cmd_summary,
        "memory": cmd_memory, "timeline": cmd_timeline,
        "profile": cmd_profile, "microbenchmark": cmd_microbenchmark,
        "dashboard": cmd_dashboard, "debug": cmd_debug,
    }[args.command]
    return handler(args)


if __name__ == "__main__":
    sys.exit(main())
