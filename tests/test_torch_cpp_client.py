"""The port's native C++ client on the port's wire (copies of
``tests/test_cpp_client.py`` against ``ray_tpu_torch``, the embedded
program's output held to JAX's, and the frame codec's cases).

``csrc/cpp_client.cc`` reads and writes the port's frame encoding (a
protocol-5 pickle of plain data) with no Python in its process: the head's
KV, a daemon's object table, ``daemon_ping`` and the cross-language calls
of ``ray_tpu_torch.xlang``. The codec cases hold its writer to
``rpc.loads_frame`` and its reader to ``rpc.dumps_frame``. One cluster
of two daemons serves the module: no test kills it.
"""

import os
import pickle
import subprocess

import numpy as np
import pytest

import ray_tpu_torch as rt_api
from ray_tpu_torch._private import rpc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(REPO, "ray_tpu_torch", "csrc")


@pytest.fixture(scope="module")
def daemon_cluster():
    if rt_api.is_initialized():
        pytest.fail("a runtime is already up")
    rt = rt_api.init(num_nodes=2, resources={"CPU": 4}, cluster="daemons",
                     object_store_memory=128 << 20)
    yield rt
    rt_api.shutdown()


def _daemon(rt, index: int = 0):
    return list(rt.cluster_backend.daemons.values())[index]


def test_cpp_client_kv_and_objects(daemon_cluster):
    from ray_tpu_torch.cpp_client import CppClient

    rt = daemon_cluster
    backend = rt.cluster_backend
    daemon = _daemon(rt)

    # head KV: written from C++, read from Python, and back
    cpp_head = CppClient(backend.head.addr)
    try:
        cpp_head.kv_put(b"cpp-key", b"written-by-cpp")
        assert backend.head.kv_get(b"cpp-key") == b"written-by-cpp"
        backend.head.kv_put(b"py-key", b"written-by-python")
        assert cpp_head.kv_get(b"py-key") == b"written-by-python"
        assert cpp_head.kv_get(b"absent") is None
    finally:
        cpp_head.close()

    # the daemon's object plane, with a blob large enough for the arena
    cpp = CppClient(daemon.addr)
    try:
        assert cpp.ping() == daemon.proc.pid
        blob = np.arange(100_000, dtype=np.int64).tobytes()  # ~800 KB
        cpp.put_object(b"cpp-oid", blob)
        assert daemon.get_object_blob(b"cpp-oid") == blob
        daemon.put_object_blob(b"py-oid", b"x" * 300_000)
        assert cpp.get_object(b"py-oid") == b"x" * 300_000
        assert cpp.get_object(b"missing-oid") is None
    finally:
        cpp.close()


def test_cpp_submits_python_task(daemon_cluster):
    """C++ -> Python task: a function exported by name, plain arguments in,
    a plain result out, run on a pooled worker process."""
    from ray_tpu_torch import xlang
    from ray_tpu_torch.cpp_client import CppClient

    # local defs: the by-value pickler carries them, so the daemon's
    # workers need no importable test module
    def _scale(x, factor):
        return [v * factor for v in x]

    def _iota(n):
        return list(range(n))

    daemon = _daemon(daemon_cluster)
    xlang.export_task("scale", _scale)
    xlang.export_task("iota", _iota)
    cpp = CppClient(daemon.addr)
    try:
        assert cpp.submit_task("scale", [1, 2, 3], 10) == [10, 20, 30]
        # 70,000 elements: many APPENDS batches through the C++ reader
        big = cpp.submit_task("iota", 70_000)
        assert len(big) == 70_000 and big[-1] == 69_999
        with pytest.raises(RuntimeError, match="no exported"):
            cpp.submit_task("nope", 1)
    finally:
        cpp.close()


def test_cpp_drives_python_actor(daemon_cluster):
    """C++ -> Python actor: created by exported class name, stateful calls
    in order, errors surfaced as application failures."""
    from ray_tpu_torch import xlang
    from ray_tpu_torch.cpp_client import CppClient

    class _Counter:
        """Exported to C++ by name; its state lives on a pool worker."""

        def __init__(self, start):
            self.value = int(start)

        def add(self, n):
            self.value += int(n)
            return self.value

        def get(self):
            return self.value

        def boom(self):
            raise ValueError("counter exploded")

    daemon = _daemon(daemon_cluster)
    xlang.export_actor_class("Counter", _Counter)
    cpp = CppClient(daemon.addr)
    try:
        cpp.create_actor("Counter", "c1", 100)
        assert cpp.call_actor("c1", "add", 5) == 105
        assert cpp.call_actor("c1", "add", 7) == 112
        assert cpp.call_actor("c1", "get") == 112
        with pytest.raises(RuntimeError, match="exploded"):
            cpp.call_actor("c1", "boom")
        assert cpp.call_actor("c1", "get") == 112   # state survives
        with pytest.raises(RuntimeError, match="no xlang actor"):
            cpp.call_actor("ghost", "get")
        with pytest.raises(RuntimeError, match="no exported"):
            cpp.create_actor("NoSuchClass", "c2")
        with pytest.raises(RuntimeError, match="already taken"):
            cpp.create_actor("Counter", "c1", 0)
    finally:
        cpp.close()


def _demo_exports(xlang):
    def add(a, b):
        return a + b

    def greet(who):
        return f"hello {who}"

    class Counter:
        def __init__(self, start):
            self.n = start

        def inc(self, k):
            self.n += k
            return self.n

    xlang.export_task("add", add)
    xlang.export_task("greet", greet)
    xlang.export_actor_class("Counter", Counter)


def _run_demo(demo: str, head_port: int, daemon, lib: str) -> dict:
    out = subprocess.run(
        [demo, "127.0.0.1", str(head_port), daemon.addr[0],
         str(daemon.addr[1]), lib],
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    return dict(line.split("=", 1)
                for line in out.stdout.strip().splitlines())


def _build_demo(src_dir: str, out: str) -> str:
    subprocess.run(["g++", "-O2", "-std=c++17", "-Wall", "-o", out,
                    os.path.join(src_dir, "api_demo.cc"), "-ldl"],
                   check=True, timeout=120)
    return out


def test_embedded_cpp_api_program(daemon_cluster, tmp_path):
    """A native C++ program (``csrc/api_demo.cc`` over the header API
    ``csrc/ray_tpu_api.h``) drives the cluster end to end: KV, objects,
    by-name tasks and a stateful named actor, with no Python in its
    process."""
    from ray_tpu_torch import _build, xlang

    rt = daemon_cluster
    _demo_exports(xlang)
    demo = _build_demo(CSRC, str(tmp_path / "api_demo"))
    daemon = _daemon(rt)
    got = _run_demo(demo, rt.cluster_backend.head.addr[1], daemon,
                    str(_build.build_host("cpp_client")))
    assert got["KV"] == "embedded-value"
    assert int(got["PING"]) == daemon.proc.pid
    assert int(got["OBJ"]) == 300000
    assert int(got["ADD"]) == 42
    assert got["GREET"] == "hello embedded"
    assert int(got["COUNT1"]) == 101
    assert int(got["COUNT2"]) == 106
    assert got["MISSING_OK"] == "0"
    assert got["DONE"] == "1"


def test_embedded_program_matches_jax(daemon_cluster, tmp_path):
    """JAX's demo against JAX's cluster and the port's demo against the
    port's cluster print the same lines, but the daemon's pid."""
    import ray_tpu
    from ray_tpu import cpp_client as jax_cpp
    from ray_tpu import xlang as jax_xlang
    from ray_tpu_torch import _build, xlang

    rt = daemon_cluster
    _demo_exports(xlang)
    port_demo = _build_demo(CSRC, str(tmp_path / "port_demo"))
    # the second daemon: the first one's actor name is taken by the
    # program's earlier run
    port = _run_demo(port_demo, rt.cluster_backend.head.addr[1],
                     _daemon(rt, 1), str(_build.build_host("cpp_client")))

    native = os.path.join(REPO, "native")
    assert jax_cpp._load() is not None      # builds JAX's library
    jax_demo = _build_demo(native, str(tmp_path / "jax_demo"))
    jrt = ray_tpu.init(num_nodes=1, resources={"CPU": 4},
                       cluster="daemons")
    try:
        _demo_exports(jax_xlang)
        jdaemon = list(jrt.cluster_backend.daemons.values())[0]
        jax = _run_demo(jax_demo, jrt.cluster_backend._head_port, jdaemon,
                        os.path.join(native, "libray_tpu_cpp_client.so"))
    finally:
        ray_tpu.shutdown()
    assert int(port.pop("PING")) > 0 and int(jax.pop("PING")) > 0
    assert port == jax


# ---------------------------------------------------------------------------
# the frame codec
# ---------------------------------------------------------------------------

def test_cpp_encoder_frames_decode_in_python():
    """What the C++ writer emits is a frame ``rpc.loads_frame`` reads."""
    from ray_tpu_torch.cpp_client import frame_encode_test

    for n_blob in (0, 200, 70_000):
        value = rpc.loads_frame(frame_encode_test(n_blob))
        assert value == {
            "none": None, "t": True, "f": False, "small": -7,
            "big": 2 ** 40 + 3, "neg": -(2 ** 40), "pi": 3.25,
            "s": "héllo", "long": "w" * 300, "b": b"\x00\x01",
            "blob": b"Z" * n_blob, "list": [1, [2, "x"], {}], "empty": []}


@pytest.mark.parametrize("value", [
    {"m": "kv_get", "i": 7, "key": b"k", "ns": b""},
    # memoised strings: one str object repeated is written once and got
    {"a": ["same", "same", "same"], "b": "same"},
    # past 64 KiB Python writes a FRAME opcode first; past 255 bytes BINBYTES
    {"blob": b"\x07" * (70 << 10), "text": "t" * 70_000},
    # ints around the BININT, LONG1 and sign edges
    {"ints": [0, 1, 255, 256, 65535, 65536, 2 ** 31 - 1, 2 ** 31,
              -2 ** 31, -2 ** 31 - 1, 2 ** 40, -(2 ** 63), 2 ** 63 - 1,
              -1, -255, -256]},
    {"floats": [0.0, -1.5, 1e300, float("inf")]},
    {"nested": [[1, [2, [3, {"k": [4, {"z": None}]}]]], {"x": {"y": {}}}],
     "flags": [True, False, None]},
    {"tuple": (1, "two", 3.0), "t1": (1,), "t0": (), "set": {5},
     "bytearray": bytearray(b"ba"), "inner": {"s": 1}},
], ids=["request", "memo", "large", "ints", "floats", "nested", "others"])
def test_python_frames_decode_in_cpp(value):
    """``dumps_frame`` output decodes in C++ and comes back equal through
    the C++ writer (tuples and sets come back as lists, a bytearray as
    bytes, as the writer has no other container)."""
    from ray_tpu_torch.cpp_client import frame_roundtrip

    blob = rpc.dumps_frame(value)
    back = rpc.loads_frame(frame_roundtrip(blob))

    def plain(v):
        if isinstance(v, (list, tuple, set)):
            return [plain(x) for x in (sorted(v) if isinstance(v, set)
                                       else v)]
        if isinstance(v, dict):
            return {k: plain(x) for k, x in v.items()}
        if isinstance(v, bytearray):
            return bytes(v)
        return v

    assert back == plain(value)
    if value.get("blob") is not None:
        assert b"\x95" in blob[:3]        # the FRAME opcode was there


def test_frame_naming_a_global_is_refused():
    """A pickle that names a global is a decode error in C++, as it is in
    ``rpc.loads_frame``."""
    from ray_tpu_torch.cpp_client import frame_roundtrip

    for evil in (pickle.dumps({"x": np.float32(1.0)}, protocol=5),
                 pickle.dumps(os.getcwd, protocol=2),
                 pickle.dumps(ValueError("x"), protocol=5)):
        with pytest.raises(rpc.RpcError):
            rpc.loads_frame(evil)
        with pytest.raises(ValueError, match="refused pickle opcode"):
            frame_roundtrip(evil)
    with pytest.raises(ValueError, match="truncated|STOP"):
        frame_roundtrip(rpc.dumps_frame({"a": 1})[:-3])
