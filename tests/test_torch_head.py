"""The port's head service and its RPC wire (copies of the head tests of
``tests/test_failure_detection.py``, not the drain ones, and the wire
codec's cases).

The wire is a restricted stdlib pickle of plain frames in msgpack's place:
every declared message round-trips, a frame that names a global is refused
by the sender and by the receiver, and a frame over ``MAX_FRAME`` is
refused.
"""

import pickle
import socket
import struct
import threading
import time

import numpy as np
import pytest

from ray_tpu_torch._private import cluster as _cluster  # noqa: F401 - declares
from ray_tpu_torch._private import rpc
from ray_tpu_torch._private.head import HeadClient, HeadService


class _FakeConn:
    """Just enough Connection for direct HeadService handler calls."""

    def __init__(self):
        self.meta = {}
        self.replies = []

    def reply(self, rid, **kw):
        self.replies.append((rid, kw))

    def link(self, peer_role, link_id=""):
        return self         # registration tags the chaos-link identity


def _register(svc, node_id="n1", port=7001):
    return svc.handle_register_node(_FakeConn(), 1, {
        "node_id": node_id, "resources": {"CPU": 4.0}, "labels": {},
        "addr": ["127.0.0.1", port]})


# ---------------------------------------------------------------------------
# the head (copies of tests/test_failure_detection.py)
# ---------------------------------------------------------------------------

def test_head_rejects_zombie_reregistration():
    """A node_id declared dead may not re-register with stale state: the
    register reply mirrors the heartbeat {"dead": True} contract."""
    svc = HeadService()
    try:
        _register(svc)
        svc._mark_dead("n1", "missed heartbeats")
        out = _register(svc)
        assert out.get("dead") and not out.get("ok")
        view = svc.handle_list_nodes(_FakeConn(), 9, {})["nodes"][0]
        assert not view["alive"]
        # a FRESH node id still registers fine
        assert _register(svc, node_id="n2", port=7002)["ok"]
    finally:
        svc._stop.set()


def test_head_client_publish_survives_head_restart():
    """HeadClient.publish rides the reconnect path: with a reconnect window
    it survives the head process being replaced."""
    svc = HeadService()
    server = rpc.Server(svc, host="127.0.0.1", port=0).start()
    port = server.addr[1]
    client = HeadClient(("127.0.0.1", port), reconnect_window=10.0)
    holder = {}
    svc2 = HeadService()
    try:
        client.publish("chan", {"n": 1})
        server.stop()
        svc._stop.set()

        def restart():
            time.sleep(0.4)
            holder["server"] = rpc.Server(
                svc2, host="127.0.0.1", port=port).start()

        t = threading.Thread(target=restart, daemon=True)
        t.start()
        client.publish("chan", {"n": 2})     # rides the redial window
        t.join()
        assert svc2._events["chan"] == [{"n": 2}]
    finally:
        client.close()
        svc2._stop.set()
        if "server" in holder:
            holder["server"].stop()


def test_head_client_close_joins_subscriber_threads():
    """close() closes the per-channel subscriber connections and joins the
    threads (no leaked sockets or parked long-polls)."""
    svc = HeadService()
    server = rpc.Server(svc, host="127.0.0.1", port=0).start()
    client = HeadClient(server.addr, reconnect_window=5.0)
    try:
        seen = []
        client.subscribe("events", seen.append)
        client.publish("events", {"x": 1})
        deadline = time.monotonic() + 5
        while not seen and time.monotonic() < deadline:
            time.sleep(0.02)
        assert seen == [{"x": 1}]
        client.close()
        for t in client._sub_threads:
            t.join(timeout=3.0)
            assert not t.is_alive(), "subscriber thread leaked"
        assert all(c.dead for c in client._sub_clients) \
            or not client._sub_clients
    finally:
        svc._stop.set()
        server.stop()


def test_head_state_survives_restart(tmp_path):
    """With a state path the KV, the pubsub log and the nodes' epochs
    survive the head: a new HeadService on the same sqlite file reloads
    them, and a re-registration gets a strictly higher epoch."""
    path = str(tmp_path / "head.db")
    svc = HeadService(state_path=path)
    try:
        assert _register(svc)["epoch"] == 1
        svc.handle_kv_put(_FakeConn(), 2, {"key": b"k", "value": b"v",
                                           "overwrite": True, "ns": b"n"})
        svc.handle_publish(_FakeConn(), 3, {"channel": "c",
                                            "event": {"a": [1, b"x"]}})
    finally:
        svc._stop.set()
        svc._store.close()
    svc2 = HeadService(state_path=path)
    try:
        got = svc2.handle_kv_get(_FakeConn(), 4, {"key": b"k", "ns": b"n"})
        assert got["value"] == b"v"
        out = svc2.handle_subscribe(_FakeConn(), 5, {"channel": "c",
                                                     "cursor": 0})
        assert out["events"] == [{"a": [1, b"x"]}]
        assert _register(svc2)["epoch"] == 2
    finally:
        svc2._stop.set()


# ---------------------------------------------------------------------------
# the wire's codec
# ---------------------------------------------------------------------------

_SAMPLES = [None, True, 7, -3, 2.5, "s", b"\x00b", bytearray(b"ba"),
            [1, b"x", None], (1, "t"), {"k": {"n": [b"y"]}}, {1, 2}]


def test_every_declared_message_round_trips():
    """Each method the head, the daemons and the owner declare encodes and
    decodes with every field carrying plain data of every kind."""
    from ray_tpu_torch._private import daemon, head  # noqa: F401
    assert {"register_node", "heartbeat", "push_task_batch", "get_object",
            "core_op", "head_stop"} <= set(rpc.SCHEMAS)
    for method, fields in sorted(rpc.SCHEMAS.items()):
        for i, sample in enumerate(_SAMPLES):
            frame = {"m": method, "i": i}
            for f in fields:
                frame[f] = sample
            blob = rpc.dumps_frame(frame)
            assert rpc.loads_frame(blob) == frame, method


def test_a_frame_naming_a_global_is_refused():
    # the sender refuses anything but plain data
    for bad in (np.float32(1.0), np.arange(3), object(), len,
                struct.Struct("!I")):
        with pytest.raises(rpc.RpcError):
            rpc.dumps_frame({"m": "x", "v": bad})
    # the receiver refuses a stream that names a global, whatever it is
    for bad in (np.float32(1.0), ValueError("x"), print):
        blob = pickle.dumps({"m": "x", "v": bad}, protocol=5)
        with pytest.raises(rpc.RpcError):
            rpc.loads_frame(blob)
    with pytest.raises(rpc.RpcError):
        rpc.loads_frame(b"\x80\x05garbage")


def test_a_server_drops_a_peer_that_sends_a_global():
    """A frame naming a global never reaches a handler: the server closes
    the connection on it."""
    calls = []

    class Svc:
        def handle_head_stop(self, conn, rid, msg):
            calls.append(msg)
            return {"ok": True}

    server = rpc.Server(Svc(), host="127.0.0.1", port=0).start()
    try:
        good = rpc.Client(server.addr, timeout=5.0)
        assert good.call("head_stop")["ok"]
        good.close()
        sock = socket.create_connection(server.addr, timeout=5.0)
        blob = pickle.dumps({"m": "head_stop", "i": 1,
                             "v": np.float32(1.0)}, protocol=5)
        sock.sendall(struct.pack("!I", len(blob)) + blob)
        sock.settimeout(5.0)
        assert sock.recv(4) == b""       # closed, no reply
        sock.close()
        assert len(calls) == 1
    finally:
        server.stop()


def test_a_frame_over_max_frame_is_refused(monkeypatch):
    monkeypatch.setattr(rpc, "MAX_FRAME", 1024)
    a, b = socket.socketpair()
    try:
        with pytest.raises(rpc.RpcError):
            rpc.send_frame_bytes(a, b"x" * 1025, threading.Lock())
        rpc.send_frame_bytes(a, rpc.dumps_frame({"m": "ok"}),
                             threading.Lock())
        assert rpc._recv_frame(b) == {"m": "ok"}
        # a header announcing more than MAX_FRAME is refused on receipt
        a.sendall(struct.pack("!I", 4096))
        with pytest.raises(rpc.RpcError):
            rpc._recv_frame(b)
    finally:
        a.close()
        b.close()


def test_a_client_refuses_to_send_unplain_data():
    class Svc:
        def handle_head_stop(self, conn, rid, msg):
            return {"ok": True}

    server = rpc.Server(Svc(), host="127.0.0.1", port=0).start()
    client = rpc.Client(server.addr, timeout=5.0)
    try:
        with pytest.raises(rpc.RpcError):
            client.call("publish", channel="c", event=np.int64(3))
        # the connection stays usable: nothing was sent
        assert client.call("head_stop")["ok"]
        with pytest.raises(rpc.RpcError):
            client.call("undeclared_method")
    finally:
        client.close()
        server.stop()


def test_tuples_and_lists_answer_alike():
    """msgpack hands a tuple back as a list; the port's wire keeps it a
    tuple. The handlers that take addresses or id lists give the same
    result either way."""
    svc = HeadService()
    try:
        for addr in (("127.0.0.1", 7001), ["127.0.0.1", 7001]):
            out = svc.handle_register_node(_FakeConn(), 1, {
                "node_id": f"n{type(addr).__name__}",
                "resources": {"CPU": 1.0}, "labels": {}, "addr": addr})
            assert out["ok"]
        views = svc.handle_list_nodes(_FakeConn(), 2, {})["nodes"]
        assert [v["addr"] for v in views] == [["127.0.0.1", 7001]] * 2
    finally:
        svc._stop.set()


def test_wire_counters_count_requests():
    """wire_metric_entries: requests by method on both sides, and the
    bytes and frames moved."""
    class Svc:
        def handle_head_stop(self, conn, rid, msg):
            return {"ok": True}

    def entries():
        return {e["name"]: e["samples"] for e in rpc.wire_metric_entries()}

    def count(samples, method):
        return sum(v for labels, v in samples
                   if labels == [["method", method]])

    server = rpc.Server(Svc(), host="127.0.0.1", port=0).start()
    client = rpc.Client(server.addr, timeout=5.0)
    try:
        before = entries()
        for _ in range(3):
            client.call("head_stop")
        after = entries()
        for name in ("ray_tpu_rpc_client_requests_total",
                     "ray_tpu_rpc_server_requests_total"):
            assert count(after[name], "head_stop") - count(
                before.get(name, []), "head_stop") == 3
        sent = dict((tuple(map(tuple, k)), v)
                    for k, v in after["ray_tpu_wire_frames_total"])
        assert sent[(("direction", "sent"),)] >= 6   # 3 calls + 3 replies
        assert after["ray_tpu_rpc_inflight"] == [[[], 0]]
    finally:
        client.close()
        server.stop()
