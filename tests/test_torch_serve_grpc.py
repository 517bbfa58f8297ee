"""Serve's second ingress on the port's RPC wire (copies of the two proxy
tests of ``tests/test_failure_detection.py`` against ``ray_tpu_torch``, the
proxy's deadline, handle and cancel contracts, and one deployment
through JAX's gRPC proxy and the port's).

The port's proxy is an ``rpc.Server`` whose stream items are pushed frames
(``serve/grpc_proxy.py``); JAX's is a ``grpc.Server`` with msgpack bodies.
The names and the behaviour are JAX's.
"""

import time

import pytest

import ray_tpu_torch
from ray_tpu_torch import serve
from ray_tpu_torch.serve.grpc_proxy import (GrpcServeClient,
                                            start_grpc_proxy,
                                            stop_grpc_proxy)


@pytest.fixture(scope="module")
def runtime():
    if ray_tpu_torch.is_initialized():
        pytest.fail("a runtime is already up")
    rt = ray_tpu_torch.init(num_nodes=1, resources={"CPU": 8})
    yield rt
    ray_tpu_torch.shutdown()


@pytest.fixture
def proxy(runtime):
    port = start_grpc_proxy()
    client = GrpcServeClient(f"127.0.0.1:{port}")
    yield client
    client.close()
    stop_grpc_proxy()
    serve.shutdown()


def test_serve_grpc_proxy(proxy):
    """The proxy routes to deployment handles."""
    @serve.deployment
    class Doubler:
        def __call__(self, x):
            return x * 2

        def shout(self, s):
            return s.upper()

    serve.run(Doubler.bind())
    client = proxy
    assert client.healthz()
    assert client.predict(21) == 42
    assert client.predict("abc", method="shout") == "ABC"
    assert "default" in client.list_applications()
    with pytest.raises(RuntimeError):
        client.predict(1, application="missing")


def test_serve_grpc_streaming(proxy):
    """Server-streaming Predict: chunks arrive as the replica produces
    them."""
    @serve.deployment
    class Streamer:
        def __call__(self, n):
            for i in range(n):
                time.sleep(0.2)
                yield {"i": i}

    serve.run(Streamer.bind())
    t0 = time.monotonic()
    chunks = []
    t_first = None
    for chunk in proxy.predict_stream(4):
        if t_first is None:
            t_first = time.monotonic() - t0
        chunks.append(chunk)
    t_all = time.monotonic() - t0
    assert [c["i"] for c in chunks] == [0, 1, 2, 3]
    assert t_first < t_all - 0.3, (t_first, t_all)


def test_deadline_handles_and_errors(proxy):
    """The client's deadline bounds the replica wait (DEADLINE_EXCEEDED),
    a stream's error ends it with the replica's exception, values that are
    not plain data come back as their repr, and a redeployed app is served
    through a fresh handle."""
    @serve.deployment
    class Slow:
        def __call__(self, s):
            time.sleep(s)
            return (s, {1: "one"}, object.__name__)

        def broken(self):
            yield 1
            raise ValueError("mid-stream")

        def odd(self):
            return {"set": frozenset([1])}

    serve.run(Slow.bind())
    assert proxy.predict(0) == [0, {1: "one"}, "object"]
    with pytest.raises(RuntimeError, match="DEADLINE_EXCEEDED"):
        proxy.predict(3, timeout=1.0)
    got = []
    with pytest.raises(RuntimeError, match="(?s)INTERNAL.*mid-stream"):
        for c in proxy.predict_stream(method="broken"):
            got.append(c)
    assert got == [1]
    assert proxy.predict(method="odd") == {"set": "frozenset({1})"}

    @serve.deployment
    class Other:
        def __call__(self, x):
            return -x

    serve.run(Other.bind())           # the default app's ingress changes
    assert proxy.predict(5) == -5


def test_stream_cancel_releases_the_pump(proxy):
    """A client that leaves a stream early releases the proxy's pump
    (gRPC's cancel), and the connection goes on serving."""
    import threading

    @serve.deployment
    class Ticker:
        def __call__(self, n):
            for i in range(n):
                time.sleep(0.01)
                yield i

    def pumps():
        return [t for t in threading.enumerate()
                if t.name == "grpc-stream-pump" and t.is_alive()]

    serve.run(Ticker.bind())
    stream = proxy.predict_stream(2000)
    assert [next(stream), next(stream)] == [0, 1]
    assert len(pumps()) == 1
    stream.close()
    deadline = time.monotonic() + 10
    while pumps() and time.monotonic() < deadline:
        time.sleep(0.05)
    assert not pumps()
    # the connection still serves
    assert list(proxy.predict_stream(3)) == [0, 1, 2]


def test_results_match_jax_proxy(proxy):
    """One deployment's unary and streamed results through JAX's gRPC
    proxy and the port's are equal."""
    import ray_tpu
    from ray_tpu import serve as jserve
    from ray_tpu.serve import grpc_proxy as jproxy

    def deploy(srv):
        @srv.deployment
        class Model:
            def __init__(self, bias):
                self.bias = bias

            def __call__(self, xs, scale=1):
                return {"sum": sum(xs) * scale + self.bias,
                        "items": [x + self.bias for x in xs],
                        "pair": (len(xs), "n")}

            def tokens(self, n):
                for i in range(n):
                    yield {"token": i * self.bias, "last": i == n - 1}

        srv.run(Model.bind(3))

    def drive(client) -> dict:
        return {"unary": [client.predict([1, 2, 3]),
                          client.predict([4.5], scale=2)],
                "stream": list(client.predict_stream(4, method="tokens")),
                "apps": client.list_applications(),
                "health": client.healthz()}

    deploy(serve)
    port_out = drive(proxy)
    ray_tpu.init(num_nodes=1, resources={"CPU": 4})
    try:
        deploy(jserve)
        jport = jproxy.start_grpc_proxy()
        jclient = jproxy.GrpcServeClient(f"127.0.0.1:{jport}")
        try:
            jax_out = drive(jclient)
        finally:
            jclient.close()
            jproxy.stop_grpc_proxy()
            jserve.shutdown()
    finally:
        ray_tpu.shutdown()
    assert port_out == jax_out
    assert port_out["unary"][0]["sum"] == 9
