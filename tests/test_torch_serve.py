"""The port's serve against the JAX package's serve tests.

Every test of tests/test_serve.py (deployments, routing, composition,
batching, autoscaling, HTTP), under the same name and bar, on the port's
API, with a fresh ``ray_tpu_torch.init(num_nodes=1, resources={"CPU": 8})``
per test; and the two serve tests of tests/test_failure_detection.py (the
long-poll membership push, controller crash recovery). The LLM app's
streaming test is in tests/test_torch_llm_serve.py, beside the port's
other LLM serving tests. The open-loop autoscale test drives the port's
handle with the JAX package's load generator (duck-typed: it calls
``handle.remote``), which the port has not ported yet.
"""

import json
import time
import urllib.request

import pytest

import ray_tpu_torch
from ray_tpu_torch import serve


@serve.deployment(name="Scaler")
class Scaler:
    """The importable app of the declarative-config tests (the role of
    tests/serve_app_fixture.py, named by ``import_path``)."""

    def __init__(self, factor: int = 2):
        self.factor = factor

    def __call__(self, x):
        return x * self.factor

    def reconfigure(self, user_config):
        self.factor = user_config.get("factor", self.factor)


# a pre-bound Application
app = Scaler.bind(2)


def build_app(args):
    """A builder callable: config args choose the bound arguments."""
    return Scaler.bind(int(args.get("factor", 3)))


@pytest.fixture
def ray_start_regular():
    rt = ray_tpu_torch.init(num_nodes=1, resources={"CPU": 8})
    yield rt
    ray_tpu_torch.shutdown()


@pytest.fixture
def serve_cluster(ray_start_regular):
    yield ray_start_regular
    serve.shutdown()


def test_function_deployment(serve_cluster):
    @serve.deployment
    def echo(x):
        return {"echo": x}

    handle = serve.run(echo.bind())
    assert handle.remote("hi").result() == {"echo": "hi"}


def test_class_deployment_with_state(serve_cluster):
    @serve.deployment(num_replicas=1)
    class Counter:
        def __init__(self, start):
            self.n = start

        def __call__(self):
            self.n += 1
            return self.n

        def peek(self):
            return self.n

    handle = serve.run(Counter.bind(10))
    assert handle.remote().result() == 11
    assert handle.remote().result() == 12
    assert handle.peek.remote().result() == 12


def test_multi_replica_round_robin(serve_cluster):
    import os
    import threading

    @serve.deployment(num_replicas=3)
    class Who:
        def __init__(self):
            self.id = id(self)

        def __call__(self):
            return self.id

    handle = serve.run(Who.bind())
    seen = {handle.remote().result() for _ in range(30)}
    assert len(seen) >= 2  # p2c spreads over replicas


def test_model_composition(serve_cluster):
    @serve.deployment
    class Preprocessor:
        def __call__(self, x):
            return x * 2

    @serve.deployment
    class Model:
        def __init__(self, pre):
            self.pre = pre

        def __call__(self, x):
            doubled = self.pre.remote(x).result()
            return doubled + 1

    handle = serve.run(Model.bind(Preprocessor.bind()))
    assert handle.remote(5).result() == 11


def test_dynamic_batching(serve_cluster):
    @serve.deployment(max_ongoing_requests=16)
    class Batched:
        def __init__(self):
            self.batch_sizes = []

        @serve.batch(max_batch_size=4, batch_wait_timeout_s=0.05)
        def handle(self, items):
            self.batch_sizes.append(len(items))
            return [i * 10 for i in items]

        def __call__(self, x):
            return self.handle(x)

        def sizes(self):
            return self.batch_sizes

    handle = serve.run(Batched.bind())
    resps = [handle.remote(i) for i in range(8)]
    assert sorted(r.result() for r in resps) == [i * 10 for i in range(8)]
    sizes = handle.sizes.remote().result()
    assert max(sizes) > 1  # batching actually happened


def test_reconfigure_user_config(serve_cluster):
    @serve.deployment(user_config={"k": 1})
    class Cfg:
        def __init__(self):
            self.k = None

        def reconfigure(self, cfg):
            self.k = cfg["k"]

        def __call__(self):
            return self.k

    handle = serve.run(Cfg.bind())
    assert handle.remote().result() == 1
    controller = ray_tpu_torch.get_actor("serve_controller")
    ray_tpu_torch.get(controller.reconfigure_deployment.remote("Cfg", {"k": 9}))
    assert handle.remote().result() == 9


def test_replica_failure_recovery(serve_cluster):
    @serve.deployment(num_replicas=2)
    class Fragile:
        def __call__(self):
            return "ok"

    handle = serve.run(Fragile.bind())
    assert handle.remote().result() == "ok"
    controller = ray_tpu_torch.get_actor("serve_controller")
    replicas = ray_tpu_torch.get(
        controller.get_replicas.remote("Fragile"))["replicas"]
    ray_tpu_torch.kill(replicas[0])
    deadline = time.time() + 15
    while time.time() < deadline:
        st = ray_tpu_torch.get(controller.status.remote())["Fragile"]
        if st["num_replicas"] == 2 and st["version"] >= 2:
            break
        time.sleep(0.3)
    st = ray_tpu_torch.get(controller.status.remote())["Fragile"]
    assert st["num_replicas"] == 2
    # traffic still works after recovery
    handle._refresh(force=True)
    assert handle.remote().result() == "ok"


def test_push_metrics_feed_controller(serve_cluster):
    """Replicas PUSH their metrics (reference: autoscaling_state.py) —
    the controller's cache fills without it ever polling, and a killed
    replica's zombie reporter cannot keep its slot looking healthy."""

    @serve.deployment(num_replicas=2)
    class Svc:
        def __call__(self):
            return "ok"

    handle = serve.run(Svc.bind())
    assert handle.remote().result() == "ok"
    controller = ray_tpu_torch.get_actor("serve_controller")

    deadline = time.time() + 10
    while time.time() < deadline:
        st = ray_tpu_torch.get(controller.status.remote())["Svc"]
        if st["metrics_fresh"] == 2:
            break
        time.sleep(0.2)
    assert st["metrics_fresh"] == 2, st

    # kill one replica: its Replica instance (and reporter thread) lives
    # on in-process, but its reports must be rejected/stopped so the
    # slot goes stale, the death is detected, and a replacement lands
    replicas = ray_tpu_torch.get(controller.get_replicas.remote("Svc"))["replicas"]
    dead_id = replicas[0]._actor_id
    ray_tpu_torch.kill(replicas[0])
    deadline = time.time() + 20
    recovered = False
    while time.time() < deadline:
        reps = ray_tpu_torch.get(controller.get_replicas.remote("Svc"))
        ids = [r._actor_id for r in reps["replicas"]]
        if len(ids) == 2 and dead_id not in ids:
            recovered = True
            break
        time.sleep(0.3)
    assert recovered, "dead replica was never replaced"
    handle._refresh(force=True)
    assert handle.remote().result() == "ok"


def test_autoscaling_up(serve_cluster):
    @serve.deployment(autoscaling_config={
        "min_replicas": 1, "max_replicas": 3,
        "target_ongoing_requests": 1.0})
    class Slow:
        def __call__(self):
            time.sleep(1.0)
            return "done"

    handle = serve.run(Slow.bind())
    resps = [handle.remote() for _ in range(6)]
    controller = ray_tpu_torch.get_actor("serve_controller")
    deadline = time.time() + 10
    scaled = False
    while time.time() < deadline:
        st = ray_tpu_torch.get(controller.status.remote())["Slow"]
        if st["target_replicas"] > 1:
            scaled = True
            break
        time.sleep(0.2)
    assert scaled
    for r in resps:
        assert r.result(timeout=30) == "done"


def test_http_proxy(serve_cluster):
    @serve.deployment
    def app(payload):
        return {"got": payload}

    serve.run(app.bind())
    port = serve.start_http_proxy(port=0)
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/", data=json.dumps({"a": 1}).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as resp:
        body = json.loads(resp.read())
    assert body == {"got": {"a": 1}}


def test_serve_status_and_delete(serve_cluster):
    @serve.deployment(num_replicas=2)
    def f(x):
        return x

    serve.run(f.bind())
    st = serve.status()
    assert st["f"]["num_replicas"] == 2
    serve.delete("default")
    assert "f" not in serve.status()


def test_local_testing_mode():
    """No cluster needed: the app graph runs in-process."""
    @serve.deployment
    class Pre:
        def __call__(self, x):
            return x + 1

    @serve.deployment(user_config={"scale": 10})
    class Model:
        def __init__(self, pre):
            self.pre = pre
            self.scale = 1

        def reconfigure(self, cfg):
            self.scale = cfg["scale"]

        def __call__(self, x):
            return self.pre.remote(x).result() * self.scale

    handle = serve.run(Model.bind(Pre.bind()), local_testing_mode=True)
    assert handle.remote(4).result() == 50


# ---------------------------------------------------------------------------
# Streaming responses (reference: replica.py:1028 handle_request_streaming,
# proxy.py:1009 streaming proxy path)
# ---------------------------------------------------------------------------

def test_streaming_handle_first_chunk_before_completion(serve_cluster):
    """The defining property of streaming: chunk 1 is consumable BEFORE
    the replica's generator has finished producing."""

    @serve.deployment
    class Streamer:
        def __call__(self, n):
            for i in range(n):
                time.sleep(0.2)
                yield {"i": i}

    handle = serve.run(Streamer.bind())
    t0 = time.monotonic()
    gen = handle.options(stream=True).remote(5)
    first = next(iter(gen))
    t_first = time.monotonic() - t0
    rest = list(gen)
    t_all = time.monotonic() - t0
    assert first == {"i": 0}
    assert [c["i"] for c in rest] == [1, 2, 3, 4]
    # 5 chunks x 0.2s ~= 1.0s total; the first must arrive well before
    assert t_first < t_all - 0.3, (t_first, t_all)


def test_streaming_non_generator_degrades_to_single_chunk(serve_cluster):
    @serve.deployment
    def plain(x):
        return {"just": x}

    handle = serve.run(plain.bind())
    chunks = list(handle.options(stream=True).remote("one"))
    assert chunks == [{"just": "one"}]


def test_http_proxy_sse_streaming(serve_cluster):
    """SSE through the HTTP proxy: first data: event readable before the
    generator completes (a real TTFT)."""

    @serve.deployment
    class SSEApp:
        def __call__(self, payload):
            n = int(payload.get("n", 3)) if isinstance(payload, dict) else 3
            for i in range(n):
                time.sleep(0.25)
                yield {"chunk": i}

    serve.run(SSEApp.bind())
    port = serve.start_http_proxy(port=0)
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/",
        data=json.dumps({"n": 4}).encode(),
        headers={"Content-Type": "application/json",
                 "Accept": "text/event-stream"})
    t0 = time.monotonic()
    with urllib.request.urlopen(req, timeout=30) as resp:
        assert resp.headers["Content-Type"] == "text/event-stream"
        events = []
        t_first = None
        for raw in resp:
            line = raw.decode().strip()
            if not line.startswith("data: "):
                continue
            if t_first is None:
                t_first = time.monotonic() - t0
            body = line[len("data: "):]
            if body == "[DONE]":
                break
            events.append(json.loads(body))
    t_all = time.monotonic() - t0
    assert [e["chunk"] for e in events] == [0, 1, 2, 3]
    assert t_first < t_all - 0.3, (t_first, t_all)


# ---------------------------------------------------------------------------
# Declarative app config (reference: serve/schema.py + `serve deploy`)
# ---------------------------------------------------------------------------

def test_run_config_from_yaml(serve_cluster, tmp_path):
    cfg = tmp_path / "app.yaml"
    cfg.write_text("""
applications:
  - name: default
    import_path: tests.test_torch_serve:app
    deployments:
      - name: Scaler
        num_replicas: 2
        user_config: {factor: 5}
""")
    handles = serve.run_config(str(cfg))
    assert set(handles) == {"default"}
    # user_config override applied via reconfigure
    assert handles["default"].remote(10).result(timeout=30) == 50
    st = serve.status()
    dep = st["Scaler"]
    assert dep["target_replicas"] == 2


def test_run_config_builder_with_args(serve_cluster):
    handles = serve.run_config({
        "applications": [{
            "name": "built",
            "import_path": "tests.test_torch_serve:build_app",
            "args": {"factor": 7},
        }]})
    assert handles["built"].remote(3).result(timeout=30) == 21


def test_run_config_rejects_bad_entries(serve_cluster, tmp_path):
    with pytest.raises(ValueError, match="applications"):
        serve.run_config({"nope": []})
    with pytest.raises(ValueError, match="unknown deployment option"):
        serve.run_config({"applications": [{
            "import_path": "tests.test_torch_serve:app",
            "deployments": [{"name": "Scaler", "bogus_knob": 1}]}]})


def test_run_config_validation_errors(serve_cluster):
    import pytest as _pytest

    # typo'd deployment name must raise, not silently no-op
    with _pytest.raises(ValueError, match="match no deployment"):
        serve.run_config({"applications": [{
            "import_path": "tests.test_torch_serve:app",
            "deployments": [{"name": "Sclaer", "num_replicas": 9}]}]})
    # override entry without a name
    with _pytest.raises(ValueError, match="missing 'name'"):
        serve.run_config({"applications": [{
            "import_path": "tests.test_torch_serve:app",
            "deployments": [{"num_replicas": 2}]}]})
    # internal fields are not part of the declarative surface
    with _pytest.raises(ValueError, match="unknown deployment option"):
        serve.run_config({"applications": [{
            "import_path": "tests.test_torch_serve:app",
            "deployments": [{"name": "Scaler",
                             "func_or_class": "x:y"}]}]})
    # duplicate app names shadow routes
    with _pytest.raises(ValueError, match="duplicate application"):
        serve.run_config({"applications": [
            {"import_path": "tests.test_torch_serve:app"},
            {"import_path": "tests.test_torch_serve:app"}]})
    # a typo'd path is a file error, not a schema error
    with _pytest.raises(FileNotFoundError):
        serve.run_config("/nonexistent/app.yaml")


def test_http_proxy_ingress_backpressure(serve_cluster):
    """The asyncio ingress sheds load with 503 + Retry-After once
    max_ongoing_requests is hit (reference: proxy backpressure), instead
    of queueing unboundedly."""
    import http.client
    import threading as _threading

    @serve.deployment(max_ongoing_requests=16)
    def slow(payload):
        time.sleep(1.0)
        return {"ok": True}

    serve.run(slow.bind())
    port = serve.start_http_proxy(port=0, max_ongoing_requests=2)
    codes = []
    lock = _threading.Lock()

    def hit():
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
        try:
            conn.request("POST", "/", body=json.dumps({}),
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            with lock:
                codes.append((resp.status,
                              resp.getheader("Retry-After")))
            resp.read()
        finally:
            conn.close()

    threads = [_threading.Thread(target=hit) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    status_codes = [c for c, _ in codes]
    assert status_codes.count(200) >= 2
    assert 503 in status_codes, codes
    assert any(ra == "1" for c, ra in codes if c == 503)


def test_http_proxy_keep_alive(serve_cluster):
    """Two requests ride ONE connection (HTTP/1.1 keep-alive)."""
    import http.client

    @serve.deployment
    def echo2(payload):
        return {"got": payload}

    serve.run(echo2.bind())
    port = serve.start_http_proxy(port=0)
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        for i in range(2):
            conn.request("POST", "/", body=json.dumps({"i": i}),
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            assert resp.status == 200
            assert json.loads(resp.read()) == {"got": {"i": i}}
    finally:
        conn.close()
    proxy = serve.api._http_server
    assert proxy.stats["requests"] >= 2


# ---------------------------------------------------------------------------
# Queue-depth routing + metrics-driven autoscaling (the serving tier must
# be measurable and reactive under open-loop load)
# ---------------------------------------------------------------------------

def test_router_rng_not_in_lockstep():
    """Every handle family seeds its P2C rng from urandom: a FIXED seed
    marched independent client processes through identical replica
    pairs (the herd all picks the same victim); ``seed=`` keeps tests
    deterministic."""
    from ray_tpu_torch.serve.router import _HandleState

    s1 = _HandleState("d", None)
    s2 = _HandleState("d", None)
    assert [s1.rng.random() for _ in range(8)] != \
           [s2.rng.random() for _ in range(8)]
    a = _HandleState("d", None, seed=5)
    b = _HandleState("d", None, seed=5)
    assert [a.rng.random() for _ in range(8)] == \
           [b.rng.random() for _ in range(8)]


def test_replica_reports_callable_queue_depth(serve_cluster):
    """The optional ``queue_depth()`` protocol (an LLM engine's waiting
    queue) rides the existing report_metrics push into the
    controller's depth view."""

    @serve.deployment(num_replicas=1)
    class WithBacklog:
        def queue_depth(self):
            return 7

        def __call__(self):
            return "ok"

    handle = serve.run(WithBacklog.bind())
    assert handle.remote().result() == "ok"
    controller = ray_tpu_torch.get_actor("serve_controller")
    deadline = time.time() + 10
    d = {}
    while time.time() < deadline:
        d = ray_tpu_torch.get(controller.get_depths.remote("WithBacklog"))
        if d["depths"] and d["depths"][0] >= 7:
            break
        time.sleep(0.2)
    assert d["depths"] and d["depths"][0] >= 7, d


def test_depth_snapshot_published_on_long_poll(serve_cluster):
    """Routers learn depths from the ``depths::<name>`` long-poll key,
    versioned against the membership snapshot they score."""

    @serve.deployment(num_replicas=2)
    def echo3(x):
        return x

    handle = serve.run(echo3.bind())
    assert handle.remote(1).result() == 1
    controller = ray_tpu_torch.get_actor("serve_controller")
    deadline = time.time() + 10
    snap = {}
    while time.time() < deadline:
        snap = ray_tpu_torch.get(controller.listen_for_change.remote(
            {"depths::echo3": -1}))
        if snap.get("depths::echo3"):
            break
    entry = snap["depths::echo3"]["snapshot"]
    assert len(entry["depths"]) == 2
    d = ray_tpu_torch.get(controller.get_depths.remote("echo3"))
    assert entry["version"] <= d["version"]
    # the depth gauge landed in the (in-process) controller's registry
    from ray_tpu_torch.util.metrics import registry
    assert "ray_tpu_serve_replica_depth" in registry()


def test_stalled_replica_stops_receiving_new_requests(
        serve_cluster, tmp_path):
    """The routing criterion: once a replica's REPORTED depth
    rises (here: a wedged engine reporting queue backlog through the
    ``queue_depth()`` protocol), a FRESH handle — an independent client
    with no local in-flight knowledge, which a fixed-seed local-only
    router could never steer — routes around it."""
    claim = str(tmp_path / "slow.claim")

    @serve.deployment(num_replicas=2, max_ongoing_requests=8)
    class HalfStalled:
        def __init__(self, claim_path):
            import os as _os
            try:
                fd = _os.open(claim_path,
                              _os.O_CREAT | _os.O_EXCL | _os.O_WRONLY)
                _os.close(fd)
                self.role = "slow"      # first replica claims the stall
            except FileExistsError:
                self.role = "fast"

        def queue_depth(self):
            # the stalled replica's engine backlog keeps growing; the
            # healthy one stays empty
            return 50 if self.role == "slow" else 0

        def __call__(self):
            if self.role == "slow":
                time.sleep(8.0)
            return self.role

    serve.run(HalfStalled.bind(claim))
    controller = ray_tpu_torch.get_actor("serve_controller")
    deadline = time.time() + 10
    d = {"depths": []}
    while time.time() < deadline:
        d = ray_tpu_torch.get(controller.get_depths.remote("HalfStalled"))
        if d["depths"] and max(d["depths"]) >= 50:
            break
        time.sleep(0.2)
    assert d["depths"] and max(d["depths"]) >= 50, d

    # an INDEPENDENT client: fresh handle, empty local in-flight table
    fresh = serve.get_deployment_handle("HalfStalled")
    fresh._state.ensure_long_poll()
    fresh._refresh()
    deadline = time.time() + 10
    while time.time() < deadline:
        with fresh._state.lock:
            if fresh._state.depths and max(fresh._state.depths) >= 50:
                break
        time.sleep(0.1)
    with fresh._state.lock:
        assert fresh._state.depths, "depth snapshot never arrived"
    served = [fresh.remote().result(timeout=4) for _ in range(12)]
    assert served == ["fast"] * 12, served


def test_downscale_drains_in_flight_requests(serve_cluster):
    """Scale-down must not burn in-flight work: routers stop picking
    the victim at the membership publish, the kill waits for its
    reported load to drain."""

    @serve.deployment(num_replicas=2, graceful_shutdown_timeout_s=20.0)
    class Slow:
        def __call__(self, t=2.0):
            time.sleep(t)
            return "done"

    handle = serve.run(Slow.bind())
    resps = [handle.remote(2.0) for _ in range(4)]
    time.sleep(0.3)          # land on both replicas
    controller = ray_tpu_torch.get_actor("serve_controller")
    ray_tpu_torch.get(controller.set_target_replicas.remote("Slow", 1))
    assert [r.result(timeout=30) for r in resps] == ["done"] * 4
    deadline = time.time() + 15
    st = {}
    while time.time() < deadline:
        st = ray_tpu_torch.get(controller.status.remote())["Slow"]
        if st["num_replicas"] == 1:
            break
        time.sleep(0.2)
    assert st["num_replicas"] == 1, st


def test_autoscale_one_to_n_to_one_under_open_loop_load(serve_cluster):
    """A loadgen run visibly drives 1->N replica
    scale-up, and load-off decays back to min without burning any
    in-flight request."""
    import threading as _th

    from ray_tpu_torch.loadgen import SLO, HandleTarget, LoadSpec, run_load

    @serve.deployment(autoscaling_config={
        "min_replicas": 1, "max_replicas": 3,
        "target_ongoing_requests": 1.0,
        "upscale_delay_s": 0.0, "downscale_delay_s": 0.5,
        "downscale_queue_guard_s": 0.0},
        max_ongoing_requests=8, graceful_shutdown_timeout_s=15.0)
    def slowish(payload):
        time.sleep(0.4)
        return {"ok": True}

    handle = serve.run(slowish.bind())
    controller = ray_tpu_torch.get_actor("serve_controller")

    peak = {"target": 1, "replicas": 1}
    stop = _th.Event()

    def watch():
        while not stop.is_set():
            st = ray_tpu_torch.get(controller.status.remote())["slowish"]
            peak["target"] = max(peak["target"], st["target_replicas"])
            peak["replicas"] = max(peak["replicas"], st["num_replicas"])
            time.sleep(0.2)

    watcher = _th.Thread(target=watch, daemon=True)
    watcher.start()
    try:
        spec = LoadSpec(rate=12, duration_s=5, clients=16,
                        arrival="constant", stream=False, seed=0,
                        slo=SLO(e2e_s=60.0), timeout_s=60,
                        drain_timeout_s=120)
        report = run_load(
            HandleTarget(handle, stream=False, timeout_s=60), spec)
    finally:
        stop.set()
        watcher.join(timeout=5)
    # load on -> replicas grew toward max
    assert peak["target"] >= 2, peak
    assert peak["replicas"] >= 2, peak
    # no request burned by scale churn
    assert report["requests"]["errors"] == 0, report.get("error_samples")
    assert report["requests"]["completed"] == report["scheduled_requests"]
    # load off -> decay to min without killing anything mid-flight
    deadline = time.time() + 25
    st = {}
    while time.time() < deadline:
        st = ray_tpu_torch.get(controller.status.remote())["slowish"]
        if st["target_replicas"] == 1 and st["num_replicas"] == 1:
            break
        time.sleep(0.3)
    assert st["target_replicas"] == 1 and st["num_replicas"] == 1, st
    # autoscale introspection surfaced the decision inputs
    assert "total_load" in st["autoscale"] and "desired" in st["autoscale"]


def test_depth_gauge_series_cleared_on_downscale(serve_cluster):
    """A downscaled slot's ray_tpu_serve_replica_depth series must
    disappear from the registry, not report its last depth forever."""
    from ray_tpu_torch.util.metrics import registry

    @serve.deployment(num_replicas=2)
    def echo4(x):
        return x

    handle = serve.run(echo4.bind())
    assert handle.remote(1).result() == 1

    def gauge_slots():
        g = registry().get("ray_tpu_serve_replica_depth")
        if g is None:
            return set()
        return {dict(key).get("slot") for key, _v in g.samples()
                if dict(key).get("deployment") == "echo4"}

    deadline = time.time() + 10
    while time.time() < deadline and len(gauge_slots()) < 2:
        time.sleep(0.2)
    assert len(gauge_slots()) == 2, gauge_slots()

    controller = ray_tpu_torch.get_actor("serve_controller")
    ray_tpu_torch.get(controller.set_target_replicas.remote("echo4", 1))
    deadline = time.time() + 15
    while time.time() < deadline and len(gauge_slots()) != 1:
        time.sleep(0.2)
    assert len(gauge_slots()) == 1, gauge_slots()


def test_idle_deployment_downscales_despite_cluster_pressure(
        serve_cluster):
    """The federated queue-pressure guard is CLUSTER-wide: it must not
    veto downscale of a deployment that itself reports zero load, or an
    unrelated batch sweep pins every idle serve app at peak."""
    import threading as _th

    from ray_tpu_torch.util.metrics import Histogram

    @serve.deployment(autoscaling_config={
        "min_replicas": 1, "max_replicas": 2,
        "target_ongoing_requests": 1.0,
        "upscale_delay_s": 0.0, "downscale_delay_s": 0.2,
        "downscale_queue_guard_s": 0.5})
    def idleapp(x):
        return x

    handle = serve.run(idleapp.bind())
    assert handle.remote(1).result() == 1
    controller = ray_tpu_torch.get_actor("serve_controller")
    ray_tpu_torch.get(controller.set_target_replicas.remote("idleapp", 2))

    # an unrelated workload keeps the cluster-wide queue-phase mean
    # far above the guard for the whole window
    stop = _th.Event()

    def pressure():
        h = Histogram("ray_tpu_task_phase_seconds",
                      "task phase seconds")
        while not stop.is_set():
            h.observe(2.0, tags={"phase": "queue"})
            time.sleep(0.05)

    t = _th.Thread(target=pressure, daemon=True)
    t.start()
    try:
        deadline = time.time() + 20
        st = {}
        while time.time() < deadline:
            st = ray_tpu_torch.get(controller.status.remote())["idleapp"]
            if st["target_replicas"] == 1 and st["num_replicas"] == 1:
                break
            time.sleep(0.3)
    finally:
        stop.set()
        t.join(timeout=5)
    assert st["target_replicas"] == 1 and st["num_replicas"] == 1, st


# ---------------------------------------------------------------------------
# tests/test_failure_detection.py's serve tests
# ---------------------------------------------------------------------------

def test_serve_long_poll_pushes_membership(ray_start_regular):
    """Scaling a deployment is pushed to handles without any request
    traffic (no poll-on-interval staleness window)."""
    @serve.deployment(num_replicas=1)
    class Echo:
        def __call__(self, x):
            return x

    handle = serve.run(Echo.bind())
    assert handle.remote("hi").result() == "hi"
    controller = ray_tpu_torch.get_actor("serve_controller")
    ray_tpu_torch.get(controller.set_target_replicas.remote("Echo", 2))
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        with handle._lock:
            if len(handle._replicas) == 2:
                break
        time.sleep(0.05)
    else:
        pytest.fail("membership change was never pushed to the handle")
    serve.shutdown()


def test_serve_controller_crash_recovery(ray_start_regular):
    """Kill the controller actor: a fresh incarnation restores the
    deployment specs from the checkpoint and RE-BINDS the still-live
    named replicas (stateful replica keeps its state)."""
    from ray_tpu_torch.serve.api import _get_controller

    @serve.deployment(num_replicas=1)
    class Counter:
        def __init__(self):
            self.n = 0

        def __call__(self, _):
            self.n += 1
            return self.n

    handle = serve.run(Counter.bind())
    assert handle.remote(None).result() == 1
    controller = ray_tpu_torch.get_actor("serve_controller")
    ray_tpu_torch.kill(controller)
    time.sleep(0.3)

    # next controller touch recreates it; recovery re-binds the replica
    new_controller = _get_controller(create=True)
    from ray_tpu_torch.serve.router import DeploymentHandle

    h2 = DeploymentHandle("Counter", new_controller)
    deadline = time.monotonic() + 20
    result = None
    while time.monotonic() < deadline:
        try:
            result = h2.remote(None).result(timeout=10)
            break
        except Exception:
            time.sleep(0.2)
    # state preserved => the SAME replica was adopted, not restarted
    assert result == 2
    serve.shutdown()


# ---------------------------------------------------------------------------
# the port's own: the checkpoint, a killed controller, the legacy proxy,
# the metrics exposition
# ---------------------------------------------------------------------------

def test_checkpoint_keeps_init_arguments_uncopied(ray_start_regular):
    """The checkpoint is JAX's, bytes in the GCS KV: a class defined in
    this function (which the by-value pickler carries) and a tensor bound
    as an init argument come back from the bytes, equal and not the same
    objects; the killed controller's loop stops, and a new controller
    recovers the deployment from the bytes."""
    import torch

    from ray_tpu_torch._private import serialization, worker
    from ray_tpu_torch.serve.api import _get_controller
    from ray_tpu_torch.serve.controller import _CKPT_KEY

    weights = torch.arange(6.0)

    @serve.deployment
    class Holder:
        def __init__(self, w):
            self.w = w

        def __call__(self, _):
            return float(self.w.sum())

    handle = serve.run(Holder.bind(weights))
    assert handle.remote(None).result() == 15.0
    gcs = worker.global_runtime().gcs
    blob = gcs.kv_get(_CKPT_KEY)
    assert isinstance(blob, bytes)
    dep, args, kwargs, target = serialization.loads(blob)["Holder"]
    assert args[0] is not weights and torch.equal(args[0], weights)
    assert dep.name == "Holder" and target == 1
    old = ray_tpu_torch.get_actor("serve_controller")
    loop = worker.global_runtime()._actor_executors[
        old._actor_id].instance._thread
    assert loop.is_alive()
    ray_tpu_torch.kill(old)
    loop.join(timeout=10)
    assert not loop.is_alive()
    from ray_tpu_torch.serve.router import DeploymentHandle
    h2 = DeploymentHandle("Holder", _get_controller(create=True))
    assert h2.remote(None).result(timeout=30) == 15.0
    serve.delete("default")
    assert "Holder" not in serialization.loads(gcs.kv_get(_CKPT_KEY))


def test_http_proxy_legacy_threaded(serve_cluster):
    """``legacy_threaded=True``: the stdlib thread-per-connection proxy,
    JSON and SSE."""
    @serve.deployment
    def legacy(payload):
        if payload.get("stream"):
            return (i for i in range(3))
        return {"got": payload}

    serve.run(legacy.bind())
    port = serve.start_http_proxy(port=0, legacy_threaded=True)
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/", data=json.dumps({"a": 1}).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as resp:
        assert json.loads(resp.read()) == {"got": {"a": 1}}
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/", data=json.dumps({"stream": True})
        .encode(), headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as resp:
        body = resp.read().decode()
    assert body == "data: 0\n\ndata: 1\n\ndata: 2\n\ndata: [DONE]\n\n"


def test_metrics_exposition_matches_jax():
    """The same counter, gauge and histogram writes give the same
    snapshot and Prometheus text in both registries."""
    from ray_tpu.util import metrics as jax_metrics
    from ray_tpu_torch.util import metrics as port_metrics

    def drive(m):
        c = m.Counter("parity_requests_total", "requests", ("route",))
        c.inc(tags={"route": "/a"})
        m.Counter("parity_requests_total").inc(2.0, tags={"route": "/a"})
        g = m.Gauge("parity_depth", 'depth "q"\nper slot')
        g.set(3.0, tags={"slot": "0"})
        g.set(4.0, tags={"slot": "1"})
        g.remove(tags={"slot": "1"})
        h = m.Histogram("parity_seconds", "latency",
                        boundaries=(0.1, 1.0))
        for v in (0.05, 0.5, 5.0):
            h.observe(v, tags={"phase": 'q"ueue'})
        snap = [e for e in m.export_snapshot()
                if e["name"].startswith("parity_")]
        return sorted(snap, key=lambda e: e["name"]), \
            m.render_prometheus([({"node_id": "n1"}, snap)])

    assert drive(port_metrics) == drive(jax_metrics)
    assert "ray_tpu_nodes_alive" not in port_metrics.prometheus_text()
