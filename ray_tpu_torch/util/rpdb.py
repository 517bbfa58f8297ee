"""Distributed debugger: socket-backed pdb sessions in remote workers
(counterpart of ``ray_tpu/util/rpdb.py``).

Reference capability: `python/ray/util/rpdb.py:282` (RemotePdb +
``ray debug``). A task anywhere in the cluster calls
``ray_tpu_torch.util.rpdb.set_trace()`` (or crashes with post-mortem enabled
via ``RAY_TPU_POST_MORTEM=1``): the worker opens a TCP-backed pdb,
ADVERTISES (host, port, task context) in the cluster KV, and blocks
until a client attaches. ``ray-tpu debug`` (scripts/cli.py) lists the
active sessions and bridges the operator's terminal to one; programmatic
attachment uses :func:`connect` below (what the CLI and tests use).

Design notes: the pdb reads/writes a socket makefile, so the worker
needs no tty; sessions self-deregister when the debugger detaches
(continue/quit or client disconnect). The KV namespace is
``rtpu:debug:*`` — the same cluster KV every node can reach.
"""

from __future__ import annotations

import contextlib
import json
import os
import pdb
import socket
import sys
import threading
import time
from typing import Any, Dict, List, Optional

_NS = "rtpu:debug:"


def _kv():
    """Best-effort cluster KV handle (head in daemons mode, gcs local)."""
    from ray_tpu_torch._private import worker

    rt = worker.global_runtime()
    if rt is None:
        return None
    backend = getattr(rt, "cluster_backend", None)
    head = getattr(backend, "head", None)
    if head is not None:
        return head
    return getattr(rt, "gcs", None)


class _SessionRegistry:
    """Worker-side helper: advertise/retract one debug session."""

    def __init__(self, meta: Dict[str, Any]):
        self.key = f"{_NS}{meta['host']}:{meta['port']}".encode()
        self.meta = meta

    def register(self) -> None:
        kv = _kv()
        if kv is not None:
            try:
                kv.kv_put(self.key, json.dumps(self.meta).encode())
            except Exception:
                pass

    def retract(self) -> None:
        kv = _kv()
        if kv is not None:
            try:
                kv.kv_del(self.key)
            except Exception:
                pass


def sessions_from_kv(kv) -> List[Dict[str, Any]]:
    """Advertised sessions from any KV handle (head client or gcs)."""
    out = []
    try:
        for key in kv.kv_keys(_NS.encode()):
            blob = kv.kv_get(key)
            if blob:
                out.append(json.loads(blob))
    except Exception:
        pass
    return sorted(out, key=lambda m: m.get("started_at", 0))


def active_sessions() -> List[Dict[str, Any]]:
    """All advertised debugger sessions (for ``ray-tpu debug``)."""
    kv = _kv()
    if kv is None:
        return []
    return sessions_from_kv(kv)


def _bind_and_advertise() -> tuple:
    """(bind_host, advertise_host). SECURITY: a pdb session is arbitrary
    code execution, so the DEFAULT binds loopback only (matching the
    reference rpdb). Cross-node attachment is an explicit opt-in —
    RAY_TPU_DEBUGGER_EXTERNAL=1 — which binds all interfaces and
    advertises a routable address."""
    if os.environ.get("RAY_TPU_DEBUGGER_EXTERNAL") == "1":
        advertise = "127.0.0.1"
        try:
            host = socket.gethostbyname(socket.gethostname())
            if host and not host.startswith("127."):
                advertise = host
        except OSError:
            pass
        return "0.0.0.0", advertise
    return "127.0.0.1", "127.0.0.1"


class _RemotePdb(pdb.Pdb):
    """pdb over one accepted TCP connection (no tty needed). Cleanup
    (registry retract + socket close) hangs off the continue/quit
    commands because ``set_trace`` must be the session's LAST statement
    — anything after it would be the first thing the tracer stops in."""

    def __init__(self, conn: socket.socket):
        self._conn = conn
        self._io = conn.makefile("rw", buffering=1)
        super().__init__(stdin=self._io, stdout=self._io)
        self.use_rawinput = False
        self.prompt = "(rpdb) "
        self._registry: Optional[_SessionRegistry] = None

    def close(self) -> None:
        if self._registry is not None:
            self._registry.retract()
            self._registry = None
        try:
            self._io.close()
        except Exception:
            pass
        try:
            self._conn.close()
        except Exception:
            pass

    def do_continue(self, arg):
        out = super().do_continue(arg)
        self.close()
        return out

    do_c = do_cont = do_continue

    def do_quit(self, arg):
        try:
            return super().do_quit(arg)
        finally:
            self.close()

    do_q = do_exit = do_quit

    def do_EOF(self, arg):
        # client hung up (Ctrl-D / dropped connection): detach cleanly
        # like quit, never leave the session advertised
        try:
            return super().do_EOF(arg)
        finally:
            self.close()


def _open_session(banner: str) -> Optional[_RemotePdb]:
    """Listen, advertise, block for one client; None if disabled."""
    if os.environ.get("RAY_TPU_DEBUGGER_DISABLED") == "1":
        return None
    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    bind_host, host = _bind_and_advertise()
    # SECURITY: an externally-reachable pdb port is arbitrary code
    # execution, so the opt-in bind requires a shared token before the
    # session starts. The token rides the cluster KV (cluster-internal)
    # so `ray-tpu debug` sends it automatically; a bare network peer
    # that can reach the port cannot produce it.
    token = None
    if bind_host != "127.0.0.1":
        token = os.environ.get("RAY_TPU_DEBUGGER_TOKEN")
        if not token:
            import secrets
            token = secrets.token_hex(16)
    srv.bind((bind_host, 0))
    srv.listen(1)
    _, port = srv.getsockname()
    from ray_tpu_torch._private import runtime_context
    try:
        # the running task's id (JAX reads a ``task_id`` attribute that
        # its RuntimeContext lacks, so its sessions name no task)
        task_id = runtime_context.get_runtime_context().get_task_id()
    except Exception:
        task_id = None
    meta = {
        "host": host, "port": port, "pid": os.getpid(),
        "task_id": task_id, "banner": banner,
        "started_at": time.time(),
    }
    if token is not None:
        meta["token"] = token
    reg = _SessionRegistry(meta)
    reg.register()
    # pool workers have no runtime handle for the KV: the stderr line
    # still reaches the operator via worker-log forwarding
    print(f"[rpdb] {banner}; attach with: ray-tpu debug {host}:{port}",
          file=sys.stderr, flush=True)
    timeout = float(os.environ.get("RAY_TPU_DEBUGGER_TIMEOUT_S", "600"))
    deadline = time.monotonic() + timeout
    conn = None
    try:
        # keep accepting until a client authenticates: one bad/probing
        # connection (port scanner, stale token) must NOT tear the
        # session down — that would be a trivial remote DoS of the
        # breakpoint and silently skip it
        while time.monotonic() < deadline:
            srv.settimeout(max(0.1, deadline - time.monotonic()))
            try:
                cand, _ = srv.accept()
            except socket.timeout:
                break
            if token is None or _check_token(cand, token, timeout):
                conn = cand
                break
            try:
                cand.close()
            except Exception:
                pass
    finally:
        try:
            srv.close()
        except Exception:
            pass
    if conn is None:
        reg.retract()
        return None
    dbg = _RemotePdb(conn)
    dbg._registry = reg
    dbg._io.write(banner + "\n")
    return dbg


def _check_token(conn: socket.socket, token: str,
                 timeout: float) -> bool:
    """First client line must equal the session token (constant-time
    compare). Wrong or missing token: drop the connection without
    starting pdb."""
    import hmac
    try:
        conn.settimeout(min(timeout, 30.0))
        buf = b""
        while b"\n" not in buf and len(buf) < 256:
            chunk = conn.recv(64)
            if not chunk:
                return False
            buf += chunk
        line = buf.split(b"\n", 1)[0].strip().decode(errors="replace")
        ok = hmac.compare_digest(line, token)
        conn.settimeout(None)
        return ok
    except Exception:
        return False


def set_trace(frame=None) -> None:
    """Breakpoint: block this worker until a debugger client attaches
    (reference ``ray.util.pdb.set_trace``). No-op when
    RAY_TPU_DEBUGGER_DISABLED=1 or no client attaches in time."""
    dbg = _open_session(f"breakpoint in pid {os.getpid()}")
    if dbg is None:
        return
    # LAST statement on purpose: the tracer stops at the next executed
    # line, which must be the caller's — cleanup happens in the
    # debugger's continue/quit hooks
    dbg.set_trace(frame or sys._getframe().f_back)


def post_mortem(exc: Optional[BaseException] = None) -> None:
    """Debug a crashed task's traceback in place (reference
    ``ray.util.rpdb._post_mortem``)."""
    exc = exc or sys.exception()
    if exc is None or exc.__traceback__ is None:
        return
    dbg = _open_session(
        f"post-mortem in pid {os.getpid()}: {type(exc).__name__}: {exc}")
    if dbg is None:
        return
    try:
        dbg.interaction(None, exc.__traceback__)
    finally:
        dbg.close()


def post_mortem_enabled() -> bool:
    return os.environ.get("RAY_TPU_POST_MORTEM") == "1"


@contextlib.contextmanager
def post_mortem_on_error():
    """THE task-execution hook (used by both the in-process and the
    pooled-worker paths): on a task exception with post-mortem enabled,
    hold the crashed frame open for an operator, then re-raise the
    ORIGINAL error. Must run INSIDE apply_runtime_env so per-task
    env_vars={"RAY_TPU_POST_MORTEM": "1"} works; a debugger-side
    failure must never mask the user's exception."""
    try:
        yield
    except BaseException as e:  # noqa: BLE001 — re-raised below
        try:
            if post_mortem_enabled():
                post_mortem(e)
        except Exception:
            pass
        raise


# ---------------------------------------------------------------------------
# client side
# ---------------------------------------------------------------------------

def connect(host: str, port: int, *, commands: Optional[List[str]] = None,
            timeout: float = 30.0, token: Optional[str] = None) -> str:
    """Attach to a session. With ``commands`` (tests/automation): send
    each line, return the full transcript. Without: bridge this
    process's stdin/stdout to the session until it closes (the
    ``ray-tpu debug`` interactive path). ``token`` authenticates to an
    externally-bound session (falls back to RAY_TPU_DEBUGGER_TOKEN)."""
    sock = socket.create_connection((host, port), timeout=timeout)
    token = token or os.environ.get("RAY_TPU_DEBUGGER_TOKEN")
    if token:
        sock.sendall(token.encode() + b"\n")
    if commands is None:
        # interactive: the timeout applies to CONNECTING only — an
        # operator reading code at the prompt must not be disconnected
        sock.settimeout(None)
        return _bridge_tty(sock)
    sock.settimeout(timeout)
    transcript = []
    io = sock.makefile("rw", buffering=1)
    try:
        for cmd in commands:
            # read until the prompt, then issue the next command
            transcript.append(_read_until(io, "(rpdb) "))
            io.write(cmd + "\n")
            io.flush()
        transcript.append(_drain(sock, io))
    finally:
        try:
            sock.close()
        except Exception:
            pass
    return "".join(transcript)


def _read_until(io, marker: str) -> str:
    buf = []
    while True:
        ch = io.read(1)
        if not ch:
            return "".join(buf)
        buf.append(ch)
        if "".join(buf[-len(marker):]) == marker:
            return "".join(buf)


def _drain(sock, io) -> str:
    sock.settimeout(1.0)
    buf = []
    try:
        while True:
            ch = io.read(1)
            if not ch:
                break
            buf.append(ch)
    except Exception:
        pass
    return "".join(buf)


def _bridge_tty(sock: socket.socket) -> str:
    """Interactive bridge: stdin -> socket, socket -> stdout."""
    io = sock.makefile("rw", buffering=1)
    stop = threading.Event()

    def pump_out():
        try:
            while not stop.is_set():
                ch = io.read(1)
                if not ch:
                    break
                sys.stdout.write(ch)
                sys.stdout.flush()
        except Exception:
            pass
        stop.set()

    t = threading.Thread(target=pump_out, daemon=True)
    t.start()
    try:
        while not stop.is_set():
            line = sys.stdin.readline()
            if not line:
                break
            io.write(line)
            io.flush()
    finally:
        stop.set()
        try:
            sock.close()
        except Exception:
            pass
    return ""
