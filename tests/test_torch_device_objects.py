"""Cross-process device objects on the port: the tests of
``tests/test_device_objects.py`` (a sharded value's round trip keeps its
mesh and placements; replicated, plain and bf16 values round-trip) with a
gloo ``DTensor`` on four CPU ranks, the wire format's CPU cases, and one
script on both packages with process workers on (JAX's default), compared
by results and exception class names."""

import os
import pickle

import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu_torch
from ray_tpu_torch._private.device_objects import wire_dumps, wire_loads
from ray_tpu_torch._private.serialization import SerializationContext
from ray_tpu_torch.parallel import spawn_ranks

import torch_rank_bodies as bodies


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("spec", [("dp", "tp"), ()],
                         ids=["sharded", "replicated"])
def test_dtensor_wire_roundtrip_keeps_its_mesh(spec, one_thread):
    """tests/test_device_objects.py:20 and :39 on a (2, 2) ("dp", "tp")
    gloo mesh: the rebuilt value is a DTensor on an equivalent mesh with
    the same placements and the same shards; where no process group is,
    the same blob loads as a plain tensor of the whole value."""
    x = np.arange(32.0, dtype=np.float32).reshape(8, 4)
    outs = spawn_ranks(4, bodies.device_objects_roundtrip, x, spec)
    want_placements = (["Shard(dim=0)", "Shard(dim=1)"] if spec
                       else ["Replicate()", "Replicate()"])
    for out in outs:
        assert out["is_dtensor"]
        assert out["names"] == ("dp", "tp")
        assert out["placements"] == want_placements
        assert out["local_equal"]
        np.testing.assert_array_equal(out["full"], x)
        assert out["bf16"] == "torch.bfloat16"
        np.testing.assert_array_equal(out["plain"], np.arange(6))
    plain = wire_loads(outs[0]["blob"])
    assert type(plain) is torch.Tensor
    np.testing.assert_array_equal(plain.numpy(), x)


def test_wire_roundtrip_of_cpu_tensors_is_bit_equal():
    g = torch.Generator().manual_seed(0)
    values = {
        "bf16": torch.randn(64, 33, generator=g).to(torch.bfloat16),
        "f32": torch.randn(5, 7, generator=g),
        "i64": torch.arange(-5, 5),
        "bool": torch.tensor([True, False, True]),
        "scalar": torch.tensor(3.5),
        "empty": torch.empty(0, 4),
        "strided": torch.randn(6, 8, generator=g)[:, ::2],
        "param": torch.nn.Parameter(torch.ones(3)),
    }
    back = wire_loads(wire_dumps(values))
    for k, v in values.items():
        b = back[k]
        assert b.dtype == v.dtype and b.shape == v.shape and b.device == \
            v.device, k
        assert torch.equal(b.view(torch.uint8) if b.dtype == torch.bfloat16
                           else b, v.detach().view(torch.uint8)
                           if v.dtype == torch.bfloat16 else v.detach()), k
    assert type(back["param"]) is torch.nn.Parameter
    assert back["param"].requires_grad


def test_cuda_device_falls_back_to_the_cpu_where_there_is_none():
    """A tensor recorded on ``cuda:0`` rebuilds on the CPU in a process
    that has no card (a worker process), with the same bits."""
    from ray_tpu_torch._private import device_objects as do
    t = torch.arange(10, dtype=torch.float16)
    raw, dtype, shape, _, grad, meta = do.reduce_tensor(t)
    out = do.rebuild_tensor((raw, dtype, shape, "cuda:0", grad, meta))
    assert out.device.type == ("cuda" if torch.cuda.is_available()
                               else "cpu")
    assert torch.equal(out.cpu(), t)


def test_the_wire_reducer_is_scoped():
    """``pickle`` and ``copy.deepcopy`` of a tensor keep torch's own
    reduce: the wire's reducer is never registered in copyreg."""
    import copyreg
    t = torch.arange(4)
    assert torch.Tensor not in copyreg.dispatch_table
    blob = pickle.dumps(t)
    assert b"rebuild_tensor" not in blob or b"device_objects" not in blob
    assert b"device_objects" in wire_dumps(t)
    ctx = SerializationContext()
    assert torch.equal(ctx.deserialize(ctx.serialize(t)), t)


# ---------------------------------------------------------------------------
# one script on both packages, process workers on
# ---------------------------------------------------------------------------

def _error_name(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the class name is the result
        return type(e).__name__
    return None


def _script(pkg):
    out = {}
    driver = os.getpid()

    @pkg.remote
    def where():
        return os.getpid() != driver

    scale = 3

    @pkg.remote
    def closure(x):
        return x * scale

    @pkg.remote
    def nested(xs):
        return sum(pkg.get([closure.remote(x) for x in xs]))

    @pkg.remote(num_returns=2)
    def two():
        return "a", "b"

    @pkg.remote(max_retries=0)
    def fails():
        raise KeyError("missing")

    @pkg.remote
    def gen(n):
        for i in range(n):
            yield i * 10

    @pkg.remote
    def total(arr):
        return float(arr.sum()), arr.dtype.str

    class Local:
        def __init__(self, v):
            self.v = v

    @pkg.remote
    def make_local(v):
        return Local(v)

    @pkg.remote
    class Counter:
        def __init__(self, start):
            self.n = start

        def inc(self, k=1):
            self.n += k
            return self.n

        def where(self):
            return os.getpid() != driver

        def boom(self):
            raise ValueError("actor error")

    out["in_worker"] = pkg.get(where.remote())
    out["closure"] = pkg.get(closure.remote(4))
    out["lambda"] = pkg.get(pkg.remote(lambda x: x + 1).remote(1))
    out["nested"] = pkg.get(nested.remote([1, 2, 3]))
    out["two"] = pkg.get(list(two.remote()))
    out["failing_task"] = _error_name(lambda: pkg.get(fails.remote()))
    out["streaming"] = [pkg.get(r) for r in gen.remote(4)]
    out["numpy"] = pkg.get(total.remote(np.arange(6, dtype=np.float32)))
    local = pkg.get(make_local.remote(7))
    out["local_class"] = (type(local).__name__, local.v,
                          isinstance(local, Local))
    c = Counter.remote(10)
    out["actor"] = [pkg.get(c.inc.remote()), pkg.get(c.inc.remote(5))]
    out["actor_in_worker"] = pkg.get(c.where.remote())
    out["actor_error"] = _error_name(lambda: pkg.get(c.boom.remote()))
    ref = pkg.put({"k": [1, 2]})
    out["put_arg"] = pkg.get(pkg.remote(lambda d: d["k"][1]).remote(ref))
    pkg.kill(c)
    out["killed_actor"] = _error_name(lambda: pkg.get(c.inc.remote()))
    return out


@pytest.fixture
def process_workers_on(monkeypatch):
    monkeypatch.setenv("RAY_TPU_PROCESS_WORKERS", "1")
    yield
    ray_tpu.shutdown()
    ray_tpu_torch.shutdown()


def test_one_script_with_process_workers_gives_equal_results(
        process_workers_on):
    ray_tpu.init(num_nodes=1, resources={"CPU": 8})
    try:
        jax_out = _script(ray_tpu)
    finally:
        ray_tpu.shutdown()
    ray_tpu_torch.init(num_nodes=1, resources={"CPU": 8})
    try:
        port_out = _script(ray_tpu_torch)
    finally:
        ray_tpu_torch.shutdown()
    assert port_out == jax_out
    assert port_out["in_worker"] and port_out["actor_in_worker"]
    assert port_out["local_class"] == ("Local", 7, True)
    assert port_out["failing_task"] == "TaskError(KeyError)"
