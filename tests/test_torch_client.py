"""The port's remote driver over a socket (``ray_tpu_torch.util.client``):
copies of the six tests of ``tests/test_client.py``."""

import numpy as np
import pytest

import ray_tpu_torch as rt_api
from ray_tpu_torch.util.client import connect, serve_cluster


@pytest.fixture
def client():
    rt_api.init(num_nodes=1, resources={"CPU": 8})
    server = serve_cluster(port=0)
    c = connect(f"{server.address[0]}:{server.address[1]}")
    yield c
    c.close()
    server.shutdown()
    rt_api.shutdown()


def test_client_put_get(client):
    ref = client.put({"a": np.arange(5)})
    back = client.get(ref)
    np.testing.assert_array_equal(back["a"], np.arange(5))


def test_client_tasks(client):
    def square(x):
        return x * x

    f = client.remote(square)
    refs = [f.remote(i) for i in range(5)]
    assert client.get(refs) == [0, 1, 4, 9, 16]


def test_client_task_with_ref_arg(client):
    def add(a, b):
        return a + b

    f = client.remote(add)
    r1 = client.put(10)
    assert client.get(f.remote(r1, 5)) == 15


def test_client_actors(client):
    class Counter:
        def __init__(self, start):
            self.n = start

        def inc(self, k=1):
            self.n += k
            return self.n

    A = client.remote(Counter)
    a = A.remote(100)
    assert client.get(a.inc.remote()) == 101
    assert client.get(a.inc.remote(9)) == 110
    client.kill(a)


def test_client_wait_and_resources(client):
    def fast():
        return 1

    f = client.remote(fast)
    refs = [f.remote() for _ in range(4)]
    ready, rest = client.wait(refs, num_returns=4, timeout=30)
    assert len(ready) == 4 and not rest
    assert client.cluster_resources().get("CPU", 0) > 0


def test_client_error_propagation(client):
    def boom():
        raise ValueError("kaboom")

    f = client.remote(boom)
    with pytest.raises(RuntimeError, match="kaboom"):
        client.get(f.remote())
