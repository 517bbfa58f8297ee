"""The port's remote debugger (copies of ``tests/test_rpdb.py``): socket
pdb sessions advertised in the cluster KV, post-mortem attach, and the
CLI's session listing.
"""

import threading
import time

import pytest

import ray_tpu_torch as ray_tpu
from ray_tpu_torch.util import rpdb


def _attach_when_advertised(commands, out, timeout=30.0):
    """Poll the session registry, then drive the session."""
    deadline = time.time() + timeout
    while time.time() < deadline:
        sessions = rpdb.active_sessions()
        if sessions:
            s = sessions[0]
            out.append(rpdb.connect(s["host"], s["port"],
                                    commands=commands))
            return
        time.sleep(0.1)
    out.append("")


@pytest.fixture
def ray_start_regular():
    rt = ray_tpu.init(num_nodes=1, resources={"CPU": 8})
    yield rt
    ray_tpu.shutdown()


def test_set_trace_breakpoint(ray_start_regular):
    """A task blocks at set_trace(); an attached client inspects locals
    and continues it."""
    @ray_tpu.remote
    def task():
        secret = 41 + 1
        rpdb.set_trace()
        return secret

    ref = task.remote()
    out = []
    t = threading.Thread(target=_attach_when_advertised,
                         args=(["p secret", "c"], out))
    t.start()
    result = ray_tpu.get(ref, timeout=60)
    t.join(timeout=30)
    assert result == 42
    assert "42" in out[0]
    assert rpdb.active_sessions() == []        # deregistered on detach


def test_post_mortem_attach(ray_start_regular):
    """A crashing task holds its frame for post-mortem inspection, then
    the error still propagates to the caller. The flag rides the task's
    runtime_env so it reaches pooled workers forked before the test."""
    @ray_tpu.remote(runtime_env={"env_vars": {"RAY_TPU_POST_MORTEM": "1"}})
    def boom():
        clue = "the-clue"
        raise ValueError(f"exploded with {clue}")

    ref = boom.remote()
    out = []
    t = threading.Thread(target=_attach_when_advertised,
                         args=(["p clue", "q"], out))
    t.start()
    with pytest.raises(Exception, match="exploded"):
        ray_tpu.get(ref, timeout=60)
    t.join(timeout=30)
    assert "the-clue" in out[0]


def test_session_names_its_task(ray_start_regular):
    """A session advertises the id of the task that opened it (JAX's
    sessions advertise none: its lookup reads an attribute its
    RuntimeContext lacks)."""
    @ray_tpu.remote
    def task():
        rpdb.set_trace()
        return ray_tpu.get_runtime_context().get_task_id()

    ref = task.remote()
    deadline = time.time() + 30
    sessions = []
    while not sessions and time.time() < deadline:
        sessions = rpdb.active_sessions()
        time.sleep(0.05)
    assert sessions
    rpdb.connect(sessions[0]["host"], sessions[0]["port"], commands=["c"])
    assert ray_tpu.get(ref, timeout=60) == sessions[0]["task_id"]


def test_disabled_and_timeout_paths(monkeypatch):
    monkeypatch.setenv("RAY_TPU_DEBUGGER_DISABLED", "1")
    rpdb.set_trace()                           # no-op, returns
    monkeypatch.delenv("RAY_TPU_DEBUGGER_DISABLED")
    monkeypatch.setenv("RAY_TPU_DEBUGGER_TIMEOUT_S", "0.2")
    t0 = time.time()
    rpdb.set_trace()                           # nobody attaches
    assert time.time() - t0 < 5


def test_cli_lists_sessions(ray_start_regular, capsys):
    from ray_tpu_torch.scripts.cli import cmd_debug

    class A:
        session = ""
        cluster = ""
        num_nodes = 1
    rc = cmd_debug(A())
    assert rc == 0
    assert "no active debugger sessions" in capsys.readouterr().out
