"""Drivers that share a ``ray-tpu start`` cluster of the port.

A ``--persist`` daemon serves every driver that joins it. Each driver's
traffic must come back to that driver: its workers' nested core ops
(``fetch_function``, ``put``/``get``/``submit``, named-actor lookups), its
workers' output lines, the owner's object directory, and its departure,
which takes only its own actors and leases. The reference (``ray_tpu``)
keeps one driver slot and routes all of it to the latest driver.

One module-scoped cluster of two daemons. This process is the earlier
driver ("A"); a subprocess ("B") joins after it and stays attached for
the module. The subprocess drivers take Python statements on stdin and
answer ``DONE <n> <repr of out>`` or ``FAIL <n> <error>``; their worker
lines arrive on their stdout as the driver prints them.
"""

import json
import os
import subprocess
import sys
import threading
import time
import uuid

import numpy as np
import pytest
import torch

import ray_tpu_torch as rt_api

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the cluster's processes and the subprocess drivers: one thread each
_ENV = dict(os.environ, OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="")
_ENV["PYTHONPATH"] = REPO + (
    os.pathsep + _ENV["PYTHONPATH"] if _ENV.get("PYTHONPATH") else "")

_DRIVER = """\
import json, os, sys
import ray_tpu_torch as rt
r = rt.init(address=sys.argv[1])
ns = {"rt": rt, "r": r, "os": os}
tokens = sorted(h.client_id for h in r.cluster_backend.daemons.values())
print("READY", json.dumps(tokens), flush=True)
for line in sys.stdin:
    n, code = json.loads(line)
    ns["out"] = None
    try:
        exec(code, ns)
        print("DONE", n, json.dumps(repr(ns["out"])), flush=True)
    except BaseException as e:  # noqa: BLE001 - reported to the test
        print("FAIL", n, json.dumps(f"{type(e).__name__}: {e}"), flush=True)
rt.shutdown()
print("BYE", flush=True)
"""


def _cli(*argv, timeout=60):
    return subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch.scripts.cli", *argv],
        capture_output=True, text=True, timeout=timeout, env=_ENV)


class _SubDriver:
    """A driver in a subprocess that stays attached until ``close``."""

    def __init__(self, address: str):
        self.proc = subprocess.Popen(
            [sys.executable, "-c", _DRIVER, address], env=_ENV,
            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, bufsize=1)
        self.lines: list = []
        self._cv = threading.Condition()
        self._n = 0
        threading.Thread(target=self._read, daemon=True).start()
        ready = self._wait(lambda ln: ln.startswith("READY"), 120)
        self.tokens = json.loads(ready.split(" ", 1)[1])

    def _read(self):
        for line in self.proc.stdout:
            with self._cv:
                self.lines.append(line.rstrip("\n"))
                self._cv.notify_all()
        with self._cv:
            self.lines.append("<eof>")
            self._cv.notify_all()

    def _wait(self, pred, timeout):
        deadline = time.monotonic() + timeout
        with self._cv:
            while True:
                for ln in self.lines:
                    if pred(ln):
                        return ln
                if "<eof>" in self.lines:
                    raise AssertionError("driver exited:\n"
                                         + "\n".join(self.lines[-40:]))
                left = deadline - time.monotonic()
                if left <= 0:
                    raise AssertionError("driver timed out:\n"
                                         + "\n".join(self.lines[-40:]))
                self._cv.wait(left)

    def run(self, code: str, timeout: float = 90):
        """Run ``code`` in the driver; the repr of its ``out``."""
        self._n += 1
        n = self._n
        self.proc.stdin.write(json.dumps([n, code]) + "\n")
        self.proc.stdin.flush()
        ln = self._wait(lambda s: s.startswith((f"DONE {n} ", f"FAIL {n} ")),
                        timeout)
        kind, _, body = ln.split(" ", 2)
        if kind == "FAIL":
            raise AssertionError(f"driver failed: {json.loads(body)}")
        return json.loads(body)

    def output(self) -> str:
        with self._cv:
            return "\n".join(self.lines)

    def close(self):
        if self.proc.poll() is None:
            self.proc.stdin.close()
            try:
                self.proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()


def _nested_ops(name, namespace):
    """A task of the earlier driver: a nested put/get and a named-actor
    lookup (module level, so it is defined before the later driver
    joins)."""
    ref = rt_api.put(np.arange(8))
    total = int(rt_api.get(ref).sum())
    actor = rt_api.get_actor(name, namespace=namespace)
    return total, rt_api.get(actor.bump.remote())


@pytest.fixture(scope="module")
def shared():
    if rt_api.is_initialized():
        pytest.fail("a runtime is already up")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    out = _cli("start", "--head", "--num-daemons", "2",
               "--resources", json.dumps({"CPU": 4}),
               "--object-store-bytes", str(64 << 20))
    assert out.returncode == 0, out.stderr[-2000:]
    address = next(line.split("started at")[1].split()[0]
                   for line in out.stdout.splitlines()
                   if "started at" in line)
    later = None
    try:
        rt = rt_api.init(address=address)

        @rt_api.remote
        class Counter:
            def __init__(self):
                self.n = 0

            def bump(self):
                self.n += 1
                return self.n

        name = f"counter-{uuid.uuid4().hex[:8]}"
        counter = Counter.options(name=name).remote()
        nested = rt_api.remote(_nested_ops)
        nodes = sorted(h.node_id.hex()
                       for h in rt.cluster_backend.daemons.values())
        # the earlier driver's function reaches both daemons' workers
        # before the later driver joins
        for node in nodes * 2:
            rt_api.get(nested.options(
                scheduling_strategy=rt_api.NodeAffinitySchedulingStrategy(
                    node_id=node, soft=False)).remote(
                        name, rt.namespace), timeout=60)
        later = _SubDriver(address)
        yield {"rt": rt, "address": address, "later": later,
               "counter": counter, "name": name, "nested": nested,
               "nodes": nodes}
    finally:
        if later is not None:
            later.close()
        if rt_api.is_initialized():
            rt_api.shutdown()
        _cli("stop", "--address", address)
        torch.set_num_threads(threads)


def _on(node):
    return rt_api.NodeAffinitySchedulingStrategy(node_id=node, soft=False)


def _lane_submitted(rt) -> int:
    return sum(h.client.call("daemon_stats")["fast_lane"]["submitted"]
               for h in rt.cluster_backend.daemons.values())


def test_earlier_driver_runs_a_fresh_function_after_a_later_one_joined(
        shared):
    """The reproduction: a function the earlier driver defines after the
    later one joined resolves through the earlier driver, on each daemon."""
    fresh = rt_api.remote(lambda x: ("fresh", x * 3))
    for node in shared["nodes"]:
        assert rt_api.get(fresh.options(scheduling_strategy=_on(node))
                          .remote(5), timeout=60) == ("fresh", 15)
    # the later driver's own fresh function still works
    assert shared["later"].run(
        "out = rt.get(rt.remote(lambda: 'later fresh').remote(), "
        "timeout=60)") == repr("later fresh")


def test_nested_put_get_and_named_actor_lookup_of_the_earlier_driver(
        shared):
    """A task whose function the workers already hold does a nested
    put/get and looks up the earlier driver's named actor: both go to the
    earlier driver, not the later one."""
    rt = shared["rt"]
    for node in shared["nodes"]:
        total, n = rt_api.get(
            shared["nested"].options(scheduling_strategy=_on(node))
            .remote(shared["name"], rt.namespace), timeout=60)
        assert total == 28 and n >= 1


def test_each_driver_gets_its_own_worker_lines(shared, capsys):
    """A marker printed in a task reaches its own driver's stdout and not
    the other's, through workers the two drivers share."""
    later = shared["later"]
    node = shared["nodes"][0]
    mark_a = f"MARK_A_{uuid.uuid4().hex[:8]}"
    mark_b = f"MARK_B_{uuid.uuid4().hex[:8]}"

    def say(mark):
        print(mark, flush=True)
        return mark

    say_a = rt_api.remote(say)
    for _ in range(3):
        assert rt_api.get(say_a.options(scheduling_strategy=_on(node))
                          .remote(mark_a), timeout=60) == mark_a
        later.run(
            "out = rt.get(rt.remote(lambda m: print(m, flush=True) or m)"
            ".options(scheduling_strategy=rt.NodeAffinitySchedulingStrategy("
            f"node_id={node!r}, soft=False)).remote({mark_b!r}), "
            "timeout=60)")
    _each_mark_reaches_its_driver(capsys, later, mark_a, mark_b)


def _each_mark_reaches_its_driver(capsys, later, mark_a, mark_b):
    """``mark_a`` reaches this driver's stdout only, ``mark_b`` the later
    driver's only."""
    seen = ""
    deadline = time.monotonic() + 20
    while time.monotonic() < deadline:
        seen += capsys.readouterr().out
        if mark_a in seen and mark_b in later.output():
            break
        time.sleep(0.1)
    time.sleep(0.6)     # a line routed wrong would land by now
    seen += capsys.readouterr().out
    assert mark_a in seen, seen[-2000:]
    assert mark_b in later.output(), later.output()[-2000:]
    assert mark_b not in seen, seen[-2000:]
    assert mark_a not in later.output(), later.output()[-2000:]


def test_a_thread_of_the_earlier_drivers_task_keeps_its_driver(
        shared, capsys, tmp_path):
    """A thread that a task of the earlier driver started, still running
    after the later driver's tasks ran in that worker, sends its nested ops
    (a fresh function's task, a get of the earlier driver's object) and its
    lines to the earlier driver."""
    later = shared["later"]
    node = shared["nodes"][0]
    go = str(tmp_path / "go")
    mark_a = f"BG_A_{uuid.uuid4().hex[:8]}"
    mark_b = f"BG_B_{uuid.uuid4().hex[:8]}"

    def spawn(fn, box, path, mark):
        def body():
            deadline = time.monotonic() + 60
            while not os.path.exists(path) and time.monotonic() < deadline:
                time.sleep(0.02)
            try:
                out = (rt_api.get(fn.remote(5), timeout=60),
                       int(rt_api.get(box[0], timeout=20).sum()))
            except Exception as e:  # noqa: BLE001 - the test reads it
                out = repr(e)
            with open(path + ".out", "w") as f:
                f.write(repr(out))
            print(mark, flush=True)

        threading.Thread(target=body, daemon=True).start()
        return os.getpid()

    fresh = rt_api.remote(lambda x: ("thread", x * 2))
    box = [rt_api.put(np.arange(8))]    # held here until the thread read it
    pid = rt_api.get(rt_api.remote(spawn).options(
        scheduling_strategy=_on(node)).remote(fresh, box, go, mark_a),
        timeout=60)
    # the later driver's tasks until one has run in that worker
    hits = later.run(
        "f = rt.remote(lambda m: print(m, flush=True) or os.getpid())"
        ".options(scheduling_strategy=rt.NodeAffinitySchedulingStrategy("
        f"node_id={node!r}, soft=False))\n"
        "out = 0\n"
        "for _ in range(400):\n"
        f"    if rt.get(f.remote({mark_b!r}), timeout=60) == {pid}:\n"
        "        out += 1\n"
        "        if out == 2:\n"
        "            break\n")
    assert hits == "2", f"the later driver's tasks never reached pid {pid}"
    open(go, "w").close()
    deadline = time.monotonic() + 90
    while not os.path.exists(go + ".out") and time.monotonic() < deadline:
        time.sleep(0.05)
    time.sleep(0.1)
    with open(go + ".out") as f:
        assert f.read() == repr((("thread", 10), 28))
    _each_mark_reaches_its_driver(capsys, later, mark_a, mark_b)


def test_object_of_the_earlier_driver_read_from_the_other_daemon(shared):
    """The owner's object directory: daemon 2, asked through the earlier
    driver's connection to pull a result that lives on daemon 1 with no
    hint, asks the earlier driver where it is."""
    rt = shared["rt"]
    first, second = shared["nodes"]

    @rt_api.remote
    def block(n):
        return np.full(n, 2.0)

    ref = block.options(scheduling_strategy=_on(first)).remote(1 << 17)
    rt_api.wait([ref], timeout=60)
    node1 = next(n for n in rt.nodes() if n.node_id.hex() == first)
    node2 = next(n for n in rt.nodes() if n.node_id.hex() == second)
    key, _nbytes, _raw = node1.store.meta_of(ref.id)
    assert node2.daemon.pull_object(key, None, 0)

    @rt_api.remote
    def total(x):
        return float(x.sum())

    assert rt_api.get(total.options(scheduling_strategy=_on(second))
                      .remote(ref), timeout=60) == float(2 << 17)


@pytest.mark.parametrize("leaver", ["earlier", "later"])
def test_either_driver_leaves_first(shared, leaver):
    """Two more drivers, each with an actor and a worker lease on every
    daemon. The one that leaves takes its record and leases with it; the
    other's tasks, actors and nested ops keep working."""
    rt = shared["rt"]
    setup = ("@rt.remote\n"
             "class Box:\n"
             "    def __init__(self):\n"
             "        self.v = 0\n"
             "    def add(self, k):\n"
             "        self.v += k\n"
             "        return self.v\n"
             "box = Box.remote()\n"
             "rt.get(box.add.remote(1), timeout=60)\n"
             "for h in r.cluster_backend.daemons.values():\n"
             "    h.client.call('request_worker_lease', task_meta={})\n"
             "out = 'set'\n")
    drivers = {"earlier": _SubDriver(shared["address"])}
    try:
        drivers["earlier"].run(setup)
        drivers["later"] = _SubDriver(shared["address"])
        drivers["later"].run(setup)
        gone = drivers.pop(leaver)
        stayer = next(iter(drivers.values()))
        gone.close()
        deadline = time.monotonic() + 20
        while True:
            rows = [row for h in rt.cluster_backend.daemons.values()
                    for row in h.client.call("daemon_stats")["drivers"]]
            tokens = {row["token"] for row in rows}
            if not tokens & set(gone.tokens) or time.monotonic() > deadline:
                break
            time.sleep(0.1)
        assert not tokens & set(gone.tokens), rows
        assert set(stayer.tokens) <= tokens, rows
        leases = {row["token"]: row["leases"] for row in rows}
        assert all(leases[t] == 1 for t in stayer.tokens), rows
        assert stayer.run(
            "f = rt.remote(lambda x: x + 100)\n"
            "ref = rt.put(list(range(5)))\n"
            "g = rt.remote(lambda r: sum(rt.get(r[0])))\n"
            "out = (rt.get(f.remote(1), timeout=60), "
            "rt.get(box.add.remote(2), timeout=60), "
            "rt.get(g.remote([ref]), timeout=60))") == repr((101, 3, 10))
        # the module's drivers are untouched
        assert rt_api.get(shared["counter"].bump.remote(), timeout=60) >= 1
        assert shared["later"].run("out = 7 * 6") == "42"
    finally:
        for d in drivers.values():
            d.close()


def test_lane_task_and_targeted_lane_actor_run_fresh_functions(shared):
    """The lanes carry the driver's token in their frames: a lane-bound
    task and a targeted-lane actor call of the earlier driver resolve
    fresh functions, and nested ops, through it."""
    rt = shared["rt"]
    before = _lane_submitted(rt)
    fresh = rt_api.remote(lambda x: x * 7)
    assert rt_api.get(fresh.remote(6), timeout=60) == 42
    assert _lane_submitted(rt) > before, "the task did not ride the lane"

    @rt_api.remote
    class Relay:
        def apply(self, fn, x):
            ref = rt_api.put(x)
            return rt_api.get(fn.remote(rt_api.get(ref)))

    relay = Relay.remote()
    twice = rt_api.remote(lambda x: ("twice", 2 * x))
    before = _lane_submitted(rt)
    assert rt_api.get(relay.apply.remote(twice, 21),
                      timeout=60) == ("twice", 42)
    assert _lane_submitted(rt) > before, "the call did not ride the lane"
    deadline = time.monotonic() + 15
    while True:
        ex = rt._actor_executors.get(relay._actor_id)
        if ex is not None and ex.instance is not None:
            break
        assert time.monotonic() < deadline, "actor executor never appeared"
        time.sleep(0.05)
    assert getattr(ex.instance, "fast_tag", None), "actor not lane-bound"


def test_log_stream_marks_each_change_of_the_writing_threads_driver(
        tmp_path):
    """A worker's stream puts a marker line before a write of another
    driver's thread (on a line of its own after a partial line); the
    monitor passes a marker found inside a line (C code's partial write)
    as the end of that line, and forgets a dead worker's driver after the
    scan that reads its last lines."""
    from ray_tpu_torch._private import log_monitor as lm

    local = threading.local()
    path = tmp_path / "worker-4242.out"
    with open(path, "w") as raw:
        stream = lm.OwnerMarkedStream(raw, lambda: getattr(local, "own",
                                                           None))
        stream.write("boot\n")              # no driver: every driver

        def write(own, text):
            local.own = own
            stream.write(text)

        for own, text in (("A", "a1\n"), ("A", "a2 partial"), ("B", "b1\n")):
            t = threading.Thread(target=write, args=(own, text))
            t.start()
            t.join()
        raw.write("c-level" + lm.OWNER_MARK + "A\n")   # past the stream
        stream.flush()
        raw.write("a3\n")
    seen = []
    mon = lm.LogMonitor(str(tmp_path), lambda p, s, ln: seen.append(ln),
                        interval=3600.0,
                        on_owner=lambda p, s, tok: seen.append((s, tok)))
    try:
        mon.poll_once()
        assert seen == ["boot", ("out", "A"), "a1", "a2 partial",
                        ("out", "B"), "b1", "c-level", ("out", "A"), "a3"]
        mon.forget(4242)
        mon.poll_once()
        assert seen[-2:] == [("out", ""), ("err", "")]
    finally:
        mon.stop()
