"""The port's datasources, streaming hash shuffle and S3 seam on its
runtime: the JAX package's ``tests/test_datasources.py`` (SQL,
WebDataset, JSON/numpy/webdataset writers, TFRecord, Avro, Delta, ORC,
``from_torch``), ``tests/test_hash_shuffle.py`` (aggregator actors, tagged
sides, reaping; plus the actor ordering the shuffle relies on) and
``tests/test_s3_filesystem.py`` (an in-process mock S3 server on
localhost) copied. The formats that need pyarrow skip without it.
"""

import json
import sqlite3
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch import data
from ray_tpu_torch.data.block import block_from_rows, concat_blocks
from ray_tpu_torch.data.hash_shuffle import run_streaming_shuffle


@pytest.fixture
def ray_start_regular():
    rt = ray_tpu_torch.init(num_nodes=1, resources={"CPU": 8})
    yield rt
    ray_tpu_torch.shutdown()


# ---------------------------------------------------------------------------
# tests/test_datasources.py
# ---------------------------------------------------------------------------

def test_read_sql_sqlite(ray_start_regular, tmp_path):
    db = str(tmp_path / "t.db")
    conn = sqlite3.connect(db)
    conn.execute("CREATE TABLE users (id INTEGER, name TEXT, score REAL)")
    conn.executemany("INSERT INTO users VALUES (?, ?, ?)",
                     [(i, f"u{i}", i * 1.5) for i in range(20)])
    conn.commit()
    conn.close()

    ds = data.read_sql("SELECT * FROM users WHERE id < 10",
                       lambda: sqlite3.connect(db))
    rows = ds.take_all()
    assert len(rows) == 10
    assert rows[3] == {"id": 3, "name": "u3", "score": 4.5}

    # paged: 3 tasks cover the full result set exactly once
    ds = data.read_sql("SELECT * FROM users", lambda: sqlite3.connect(db),
                       parallelism=3)
    rows = ds.take_all()
    assert sorted(r["id"] for r in rows) == list(range(20))


def test_webdataset_roundtrip(ray_start_regular, tmp_path):
    out = str(tmp_path / "shards")
    ds = data.from_items([
        {"__key__": f"s{i:03d}", "img": bytes([i] * 4),
         "cls": str(i % 3), "meta": {"n": i}}
        for i in range(6)])
    ds.write_webdataset(out)

    back = data.read_webdataset(out + "/*.tar").take_all()
    assert len(back) == 6
    by_key = {r["__key__"]: r for r in back}
    assert by_key["s002"]["img"] == bytes([2] * 4)
    assert by_key["s002"]["cls"] == b"2"            # str columns -> raw
    assert json.loads(by_key["s004"]["meta"]) == {"n": 4}


def test_webdataset_ragged_and_multipart_extensions(ray_start_regular,
                                                    tmp_path):
    """First-dot key splitting (000.seg.png stays with 000) and samples
    missing an extension get None instead of silently dropping data."""
    import io
    import tarfile

    shard = tmp_path / "w"
    shard.mkdir()
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w") as tar:
        for name, payload in [("000.jpg", b"img0"),
                              ("000.seg.png", b"mask0"),
                              ("001.jpg", b"img1"),
                              ("001.json", b"{}")]:
            info = tarfile.TarInfo(name)
            info.size = len(payload)
            tar.addfile(info, io.BytesIO(payload))
    (shard / "s.tar").write_bytes(buf.getvalue())

    rows = {r["__key__"]: r
            for r in data.read_webdataset(str(shard / "s.tar")).take_all()}
    assert set(rows) == {"000", "001"}
    assert rows["000"]["seg.png"] == b"mask0"      # multi-part extension
    assert rows["000"]["json"] is None             # ragged -> None
    assert rows["001"]["json"] == b"{}"
    assert rows["001"]["seg.png"] is None


def test_write_json_roundtrip(ray_start_regular, tmp_path):
    pytest.importorskip("pyarrow")
    out = str(tmp_path / "j")
    data.from_items([{"a": i, "b": f"x{i}"} for i in range(7)]
                    ).write_json(out)
    back = data.read_json(out + "/*.json").take_all()
    assert sorted(r["a"] for r in back) == list(range(7))
    assert {r["b"] for r in back} == {f"x{i}" for i in range(7)}


def test_write_numpy_roundtrip(ray_start_regular, tmp_path):
    out = str(tmp_path / "n")
    arr = np.arange(12.0)
    data.from_numpy(arr, column="v").write_numpy(out, "v")
    back = data.read_numpy(out + "/*.npy", column="v").take_all()
    got = np.sort(np.asarray([r["v"] for r in back]))
    np.testing.assert_array_equal(got, arr)


def test_tfrecords_roundtrip(ray_start_regular, tmp_path):
    """TFRecord write/read without TensorFlow: bytes/float/int features,
    scalars and lists, crc-framed."""
    out = str(tmp_path / "tfr")
    rows = [{"name": f"r{i}", "img": bytes([i, i + 1]),
             "score": i * 0.5, "labels": [i, i * 2], "neg": -i}
            for i in range(8)]
    data.from_items(rows).write_tfrecords(out)
    back = sorted(data.read_tfrecords(out + "/*.tfrecord").take_all(),
                  key=lambda r: r["name"])
    assert len(back) == 8
    r3 = back[3]
    # features are ALWAYS lists (proto semantics, shard-consistent)
    assert r3["name"] == [b"r3"]          # strings round-trip as bytes
    assert r3["img"] == [bytes([3, 4])]
    assert abs(r3["score"][0] - 1.5) < 1e-6
    assert r3["labels"] == [3, 6]
    assert r3["neg"] == [-3]               # negative int64 varint


def test_tfrecords_crc_detects_corruption(tmp_path):
    from ray_tpu_torch.data.tfrecords import (decode_example, encode_example,
                                        read_tfrecord_frames,
                                        write_tfrecord_frame)
    payload = encode_example({"a": 1})
    frame = bytearray(write_tfrecord_frame(payload))
    assert decode_example(next(read_tfrecord_frames(bytes(frame)))) == \
        {"a": [1]}                         # decode keeps proto lists
    frame[14] ^= 0xFF                      # flip a payload byte
    with pytest.raises(ValueError, match="crc"):
        list(read_tfrecord_frames(bytes(frame)))
    # truncation raises the same error family, not struct.error
    with pytest.raises(ValueError, match="truncated"):
        list(read_tfrecord_frames(bytes(
            write_tfrecord_frame(payload))[:-2]))
    # out-of-int64-range values are rejected, not silently wrapped
    with pytest.raises(ValueError, match="int64"):
        encode_example({"x": 2 ** 63})


def test_tfrecords_ragged_list_column(ray_start_regular, tmp_path):
    """A column mixing 1-element and longer lists stays ALL lists
    (per-row unwrapping would crash Arrow on mixed types)."""
    out = str(tmp_path / "ragged")
    data.from_items([{"labels": [5]}, {"labels": [1, 2]}]
                    ).write_tfrecords(out)
    back = data.read_tfrecords(out + "/*.tfrecord").take_all()
    assert sorted(back, key=lambda r: len(r["labels"])) == \
        [{"labels": [5]}, {"labels": [1, 2]}]


def test_avro_round_trip(ray_start_regular, tmp_path):
    """write_avro -> read_avro round trip through the native container
    codec (deflate blocks), nullable columns included."""
    from ray_tpu_torch import data

    ds = data.from_items([
        {"a": 1, "b": "x", "c": 1.5, "ok": True, "raw": b"p"},
        {"a": 2, "b": "y", "c": 2.5, "ok": False, "raw": b"q"},
        {"a": 3, "b": None, "c": 3.5, "ok": True, "raw": b"r"},
    ])
    out = str(tmp_path / "avro_out")
    ds.write_avro(out)
    back = data.read_avro(out)
    rows = sorted(back.take_all(), key=lambda r: r["a"])
    assert [r["a"] for r in rows] == [1, 2, 3]
    assert rows[0]["b"] == "x" and rows[2]["b"] is None
    assert rows[1]["c"] == 2.5 and rows[0]["ok"] is True
    assert rows[2]["raw"] == b"r"


def test_avro_codec_spec_shapes(tmp_path):
    """The codec handles spec shapes beyond what write_avro emits:
    unions, enums, arrays, maps, fixed, nested records, both codecs."""
    from ray_tpu_torch.data.avro import read_container, write_container

    schema = {
        "type": "record", "name": "outer", "fields": [
            {"name": "u", "type": ["null", "string", "long"]},
            {"name": "e", "type": {"type": "enum", "name": "col",
                                   "symbols": ["RED", "BLUE"]}},
            {"name": "xs", "type": {"type": "array", "items": "long"}},
            {"name": "m", "type": {"type": "map", "values": "double"}},
            {"name": "fx", "type": {"type": "fixed", "name": "f4",
                                    "size": 4}},
            {"name": "inner", "type": {
                "type": "record", "name": "pt", "fields": [
                    {"name": "x", "type": "double"},
                    {"name": "y", "type": "double"}]}},
        ]}
    records = [
        {"u": None, "e": "RED", "xs": [1, 2, 3], "m": {"a": 0.5},
         "fx": b"abcd", "inner": {"x": 1.0, "y": 2.0}},
        {"u": "s", "e": "BLUE", "xs": [], "m": {},
         "fx": b"wxyz", "inner": {"x": -1.0, "y": 0.25}},
        {"u": 7, "e": "RED", "xs": [10], "m": {"k": 2.0, "j": 3.0},
         "fx": b"0000", "inner": {"x": 0.0, "y": 0.0}},
    ]
    for codec in ("null", "deflate"):
        blob = write_container(schema, records, codec=codec)
        got_schema, got = read_container(blob)
        assert got == records
        assert got_schema["name"] == "outer"


def test_delta_lake_read(ray_start_regular, tmp_path):
    """Native Delta transaction-log replay: add/remove actions resolve
    to the live parquet files; time travel via version=N."""
    import json as _json

    pa = pytest.importorskip("pyarrow")
    import pyarrow.parquet as pq

    from ray_tpu_torch import data

    table_dir = tmp_path / "dtable"
    log = table_dir / "_delta_log"
    log.mkdir(parents=True)

    def write_part(name, ids):
        pq.write_table(pa.table({"id": pa.array(ids)}),
                       table_dir / name)

    def commit(version, actions):
        with open(log / f"{version:020d}.json", "w") as f:
            for a in actions:
                f.write(_json.dumps(a) + "\n")

    write_part("part-0.parquet", [1, 2])
    write_part("part-1.parquet", [3, 4])
    write_part("part-2.parquet", [5, 6])
    commit(0, [{"metaData": {"id": "t"}},
               {"add": {"path": "part-0.parquet"}}])
    commit(1, [{"add": {"path": "part-1.parquet"}}])
    # version 2 compacts part-0+1 away into part-2
    commit(2, [{"remove": {"path": "part-0.parquet"}},
               {"remove": {"path": "part-1.parquet"}},
               {"add": {"path": "part-2.parquet"}}])

    latest = sorted(r["id"] for r in
                    data.read_delta(str(table_dir)).take_all())
    assert latest == [5, 6]
    v1 = sorted(r["id"] for r in
                data.read_delta(str(table_dir), version=1).take_all())
    assert v1 == [1, 2, 3, 4]


def test_orc_round_trip(ray_start_regular, tmp_path):
    pytest.importorskip("pyarrow.orc")
    from ray_tpu_torch import data

    ds = data.from_items([{"a": i, "b": f"s{i}"} for i in range(12)])
    out = str(tmp_path / "orc_out")
    ds.write_orc(out)
    back = sorted(data.read_orc(out).take_all(), key=lambda r: r["a"])
    assert [r["a"] for r in back] == list(range(12))
    assert back[3]["b"] == "s3"


def test_from_torch(ray_start_regular):
    import torch
    from torch.utils.data import Dataset as TorchDataset

    from ray_tpu_torch import data

    class Squares(TorchDataset):
        def __len__(self):
            return 8

        def __getitem__(self, i):
            return torch.tensor([i, i * i])

    rows = data.from_torch(Squares()).take_all()
    assert len(rows) == 8
    assert list(rows[3]["item"]) == [3, 9]


def test_delta_lake_checkpoint_parts(ray_start_regular, tmp_path):
    """Multi-part checkpoints: EVERY part of the newest checkpoint
    version feeds the replay base (one part alone drops files)."""
    import json as _json

    pa = pytest.importorskip("pyarrow")
    import pyarrow.parquet as pq

    from ray_tpu_torch import data

    table_dir = tmp_path / "dtable"
    log = table_dir / "_delta_log"
    log.mkdir(parents=True)
    pq.write_table(pa.table({"id": pa.array([1, 2])}),
                   table_dir / "part-a.parquet")
    pq.write_table(pa.table({"id": pa.array([3, 4])}),
                   table_dir / "part-b.parquet")
    pq.write_table(pa.table({"id": pa.array([5])}),
                   table_dir / "part-c.parquet")

    def ckpt_rows(rows, name):
        pq.write_table(pa.table({
            "add": pa.array(rows, type=pa.struct(
                [("path", pa.string())])),
            "remove": pa.array([None] * len(rows), type=pa.struct(
                [("path", pa.string())])),
        }), log / name)

    # checkpoint v1 in two parts covering part-a and part-b
    ckpt_rows([{"path": "part-a.parquet"}],
              "00000000000000000001.checkpoint.0000000001.0000000002"
              ".parquet")
    ckpt_rows([{"path": "part-b.parquet"}],
              "00000000000000000001.checkpoint.0000000002.0000000002"
              ".parquet")
    # commit 2 after the checkpoint adds part-c
    with open(log / f"{2:020d}.json", "w") as f:
        f.write(_json.dumps({"add": {"path": "part-c.parquet"}}) + "\n")

    got = sorted(r["id"] for r in
                 data.read_delta(str(table_dir)).take_all())
    assert got == [1, 2, 3, 4, 5]


# ---------------------------------------------------------------------------
# tests/test_hash_shuffle.py
# ---------------------------------------------------------------------------

def _mk_block(vals):
    return block_from_rows([{"v": int(v)} for v in vals])


# Closures, not module functions: cloudpickle ships them BY VALUE, so
# daemons-mode workers need no importable test module.
def _make_mod_partition():
    def _mod_partition(block, n):
        import numpy as np
        out = [block.take(np.nonzero(block.to_numpy("v") % n == p)[0])
               for p in range(n)]
        return out if n > 1 else out[0]
    return _mod_partition


_mod_partition = _make_mod_partition()


def _make_slow_mod_partition():
    inner = _make_mod_partition()

    def _slow_mod_partition(block, n, delay_s):
        import time
        time.sleep(delay_s)
        return inner(block, n)
    return _slow_mod_partition


_slow_mod_partition = _make_slow_mod_partition()


def _make_fin_rows():
    def _fin_rows(shards):
        from ray_tpu_torch.data.block import concat_blocks
        return concat_blocks(shards.get("d", []))
    return _fin_rows


_fin_rows = _make_fin_rows()


def test_streaming_shuffle_partitions_correctly(ray_start_regular):
    refs = [ray_tpu_torch.put(_mk_block(range(i * 10, i * 10 + 10)))
            for i in range(4)]
    outs = run_streaming_shuffle([("d", refs, _mod_partition, (3,))],
                                 3, _fin_rows, lambda p: ())
    blocks = ray_tpu_torch.get(outs, timeout=120)
    for p, b in enumerate(blocks):
        vals = b.to_numpy("v")
        assert all(v % 3 == p for v in vals)
    total = sum(b.num_rows for b in blocks)
    assert total == 40


def test_streaming_shuffle_staggered_maps(ray_start_regular):
    """Finalize must wait for every shard even when partition tasks
    finish wildly out of order (explicit dataflow deps, not actor
    submission order)."""
    refs = [ray_tpu_torch.put(_mk_block(range(i * 8, i * 8 + 8)))
            for i in range(5)]
    delays = [0.4, 0.0, 0.3, 0.05, 0.2]
    sides = [("d", [r], _slow_mod_partition, (2, d))
             for r, d in zip(refs, delays)]
    outs = run_streaming_shuffle(sides, 2, _fin_rows, lambda p: ())
    blocks = ray_tpu_torch.get(outs, timeout=120)
    assert sum(b.num_rows for b in blocks) == 40
    evens = blocks[0].to_numpy("v")
    assert len(evens) == 20 and all(v % 2 == 0 for v in evens)


def test_streaming_shuffle_two_tagged_sides(ray_start_regular):
    """Join-style: two sides land in the same aggregators, separated
    by tag at finalize."""
    left = [ray_tpu_torch.put(_mk_block([0, 1, 2, 3]))]
    right = [ray_tpu_torch.put(_mk_block([2, 3, 4, 5]))]

    def fin(shards):
        l = concat_blocks(shards.get("l", []))
        r = concat_blocks(shards.get("r", []))
        return {"left": l.num_rows, "right": r.num_rows}

    outs = run_streaming_shuffle(
        [("l", left, _mod_partition, (2,)),
         ("r", right, _mod_partition, (2,))],
        2, fin, lambda p: ())
    got = ray_tpu_torch.get(outs, timeout=120)
    assert got[0] == {"left": 2, "right": 2}   # evens both sides
    assert got[1] == {"left": 2, "right": 2}


def _alive_actors() -> int:
    from ray_tpu_torch._private import worker
    from ray_tpu_torch._private.gcs import ActorState
    return len([a for a in worker.global_runtime().gcs.actors.values()
                if a.state == ActorState.ALIVE])


def test_aggregator_actors_reaped(ray_start_regular):
    """Once outputs materialize, the per-shuffle actors die (the actor
    table is read from the port's GCS: it has no ``util.state`` yet)."""
    refs = [ray_tpu_torch.put(_mk_block(range(6)))]
    before = _alive_actors()
    outs = run_streaming_shuffle([("d", refs, _mod_partition, (2,))],
                                 2, _fin_rows, lambda p: ())
    ray_tpu_torch.get(outs, timeout=120)
    deadline = time.time() + 20
    while time.time() < deadline:
        alive = _alive_actors()
        if alive <= before:
            break
        time.sleep(0.2)
    assert alive <= before, f"aggregators leaked: {alive} > {before}"


def test_actor_calls_run_in_submission_order(ray_start_regular):
    """The shuffle's aggregators rely on it (hash_shuffle.py): an actor's
    calls whose arguments are ready run in the order they were submitted,
    here 200 of them from one caller."""
    @ray_tpu_torch.remote
    class Log:
        def __init__(self):
            self.seen = []

        def add(self, i):
            self.seen.append(i)
            return i

        def read(self):
            return list(self.seen)

    log = Log.remote()
    refs = [log.add.remote(i) for i in range(200)]
    assert ray_tpu_torch.get(log.read.remote(), timeout=60) == list(
        range(200))
    assert ray_tpu_torch.get(refs, timeout=60) == list(range(200))


# ---------------------------------------------------------------------------
# tests/test_s3_filesystem.py
# ---------------------------------------------------------------------------

class _MockS3Handler(BaseHTTPRequestHandler):
    store = {}   # "bucket/key" -> bytes

    def log_message(self, *args):
        pass

    def _path_key(self):
        return urllib.parse.unquote(self.path.split("?")[0]).lstrip("/")

    def do_PUT(self):
        length = int(self.headers.get("Content-Length", 0))
        self.store[self._path_key()] = self.rfile.read(length)
        self.send_response(200)
        self.end_headers()

    def do_HEAD(self):
        if self._path_key() in self.store:
            self.send_response(200)
        else:
            self.send_response(404)
        self.end_headers()

    def do_GET(self):
        parsed = urllib.parse.urlparse(self.path)
        q = urllib.parse.parse_qs(parsed.query)
        key = self._path_key()
        if "list-type" in q:   # ListObjectsV2
            bucket = key
            prefix = q.get("prefix", [""])[0]
            delim = q.get("delimiter", [""])[0]
            keys, prefixes = [], set()
            for full in sorted(self.store):
                b, _, k = full.partition("/")
                if b != bucket or not k.startswith(prefix):
                    continue
                rest = k[len(prefix):]
                if delim and delim in rest:
                    prefixes.add(prefix + rest.split(delim)[0] + delim)
                else:
                    keys.append(k)
            ns = 'xmlns="http://s3.amazonaws.com/doc/2006-03-01/"'
            body = f'<ListBucketResult {ns}>'
            for k in keys:
                body += f"<Contents><Key>{k}</Key></Contents>"
            for p in sorted(prefixes):
                body += (f"<CommonPrefixes><Prefix>{p}</Prefix>"
                         f"</CommonPrefixes>")
            body += "</ListBucketResult>"
            blob = body.encode()
            self.send_response(200)
            self.send_header("Content-Length", str(len(blob)))
            self.end_headers()
            self.wfile.write(blob)
            return
        blob = self.store.get(key)
        if blob is None:
            self.send_response(404)
            self.end_headers()
            return
        self.send_response(200)
        self.send_header("Content-Length", str(len(blob)))
        self.end_headers()
        self.wfile.write(blob)


@pytest.fixture
def mock_s3():
    _MockS3Handler.store = {}
    server = ThreadingHTTPServer(("127.0.0.1", 0), _MockS3Handler)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    from ray_tpu_torch.data.s3_filesystem import enable_s3
    fs = enable_s3(
        endpoint_url=f"http://127.0.0.1:{server.server_address[1]}",
        access_key="test", secret_key="secret")
    yield fs
    server.shutdown()
    from ray_tpu_torch.data.filesystem import _REGISTRY
    _REGISTRY.pop("s3", None)


def test_s3_roundtrip_and_listing(mock_s3):
    fs = mock_s3
    with fs.open_output("bkt/dir/a.txt") as f:
        f.write(b"alpha")
    with fs.open_output("bkt/dir/b.txt") as f:
        f.write(b"beta")
    with fs.open_output("bkt/other/c.txt") as f:
        f.write(b"gamma")

    assert fs.open_input("bkt/dir/a.txt").read() == b"alpha"
    assert fs.exists("bkt/dir/a.txt")
    assert not fs.exists("bkt/dir/zzz.txt")
    assert fs.isdir("bkt/dir")
    assert not fs.isdir("bkt/dir/a.txt")
    assert fs.listdir("bkt/dir") == ["bkt/dir/a.txt", "bkt/dir/b.txt"]
    assert fs.listdir("bkt") == ["bkt/dir", "bkt/other"]
    assert fs.glob("bkt/dir/*.txt") == ["bkt/dir/a.txt", "bkt/dir/b.txt"]
    with pytest.raises(FileNotFoundError):
        fs.open_input("bkt/nope")


def test_s3_dataset_roundtrip(mock_s3, ray_start_regular):
    """End to end through ray_tpu_torch.data: write + read parquet on
    s3://."""
    pytest.importorskip("pyarrow")
    from ray_tpu_torch import data

    ds = data.from_items([{"x": i, "y": float(i * i)} for i in range(50)])
    ds.write_parquet("s3://bkt/ds")
    back = data.read_parquet("s3://bkt/ds")
    rows = sorted(back.take_all(), key=lambda r: r["x"])
    assert len(rows) == 50
    assert rows[7] == {"x": 7, "y": 49.0}


def test_s3_csv_roundtrip(mock_s3, ray_start_regular):
    pytest.importorskip("pyarrow")
    from ray_tpu_torch import data

    ds = data.from_items([{"a": i} for i in range(10)])
    ds.write_csv("s3://bkt/csvs")
    back = data.read_csv("s3://bkt/csvs")
    assert sorted(r["a"] for r in back.take_all()) == list(range(10))


def test_s3_writer_abort_on_exception(mock_s3):
    """An exception inside the with-block must not upload partial bytes."""
    fs = mock_s3
    with pytest.raises(RuntimeError, match="boom"):
        with fs.open_output("bkt/bad.bin") as f:
            f.write(b"partial")
            raise RuntimeError("boom")
    assert not fs.exists("bkt/bad.bin")


@pytest.fixture
def mock_gs():
    """GCS interop XML API speaks the same protocol as S3 — the same
    mock serves both schemes."""
    _MockS3Handler.store = {}
    server = ThreadingHTTPServer(("127.0.0.1", 0), _MockS3Handler)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    from ray_tpu_torch.data.s3_filesystem import enable_gs
    fs = enable_gs(
        endpoint_url=f"http://127.0.0.1:{server.server_address[1]}",
        access_key="gtest", secret_key="gsecret")
    yield fs
    server.shutdown()
    from ray_tpu_torch.data.filesystem import _REGISTRY
    _REGISTRY.pop("gs", None)
    _REGISTRY.pop("gcs", None)


def test_gs_dataset_roundtrip(mock_gs, ray_start_regular):
    """gs:// paths flow through every reader/writer via the seam."""
    pytest.importorskip("pyarrow")
    from ray_tpu_torch import data

    ds = data.from_items([{"a": i, "b": i * i} for i in range(12)])
    ds.write_parquet("gs://bkt/ds")
    back = data.read_parquet("gs://bkt/ds/*.parquet")
    rows = sorted(back.take_all(), key=lambda r: r["a"])
    assert [r["b"] for r in rows] == [i * i for i in range(12)]
    # gcs:// alias resolves to the same filesystem
    from ray_tpu_torch.data.filesystem import resolve_filesystem
    assert resolve_filesystem("gcs://x/y")[0] is mock_gs
