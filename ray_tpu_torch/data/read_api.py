"""Dataset creation (counterpart of ``ray_tpu/data/read_api.py``; reference:
`python/ray/data/read_api.py` — 41 datasources; here: range/items/numpy/
pandas/arrow + parquet/csv/json/text/binary files, each file a parallel read
task). The readers of parquet, csv, json, orc and Delta import pyarrow,
``from_pandas``/``from_arrow`` take those packages' tables and
``read_images`` imports PIL, each when called; the numpy, text, binary, SQL,
TFRecord, Avro and WebDataset readers need nothing beyond the stdlib and
numpy."""

from __future__ import annotations

import glob as _glob
import os
from typing import Any, Callable, Dict, List, Optional

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.data import logical as L
from ray_tpu_torch.data.block import (Block, block_from_arrow,
                                      block_from_batch, block_from_rows)
from ray_tpu_torch.data.dataset import Dataset

DEFAULT_BLOCK_ROWS = 1000


def _from_blocks(blocks: List[Block]) -> Dataset:
    refs = [ray_tpu_torch.put(b) for b in blocks]
    return Dataset(L.InputData("input", [], block_refs=refs))


def range(n: int, *, parallelism: int = -1) -> Dataset:  # noqa: A001
    import builtins
    if parallelism <= 0:
        parallelism = max(1, min(64, n // DEFAULT_BLOCK_ROWS or 1))
    tasks = []
    for i in builtins.range(parallelism):
        lo = i * n // parallelism
        hi = (i + 1) * n // parallelism
        tasks.append(lambda lo=lo, hi=hi: Block({"id": np.arange(lo, hi)}))
    return Dataset(L.Read("read_range", [], read_tasks=tasks))


def from_items(items: List[Any], *, parallelism: int = 4) -> Dataset:
    import builtins
    if not items:
        return _from_blocks([Block()])
    rows = [it if isinstance(it, dict) else {"item": it} for it in items]
    n = len(rows)
    parallelism = max(1, min(parallelism, n))
    blocks = []
    for i in builtins.range(parallelism):
        lo, hi = i * n // parallelism, (i + 1) * n // parallelism
        blocks.append(block_from_rows(rows[lo:hi]))
    return _from_blocks(blocks)


def from_numpy(arr: np.ndarray, column: str = "data") -> Dataset:
    return _from_blocks([block_from_batch({column: arr})])


def from_pandas(df) -> Dataset:
    return _from_blocks([block_from_batch(df)])


def from_arrow(table) -> Dataset:
    return _from_blocks([block_from_arrow(table)])


def _expand_paths(paths, suffix: str) -> List[str]:
    from ray_tpu_torch.data.filesystem import expand_paths
    return expand_paths(paths, suffix)


def _file_read_dataset(paths, suffix: str, reader: Callable,
                       name: str) -> Dataset:
    from ray_tpu_torch.data import filesystem as fsmod

    files = _expand_paths(paths, suffix)
    # Read tasks execute in worker processes: ship the driver's
    # registered filesystems with the task so s3://-style schemes
    # resolve there too (reference: the fs object travels with the
    # read task, not via global state).
    registry = dict(fsmod._REGISTRY)

    def run(f):
        for scheme, fs in registry.items():
            # Overwrite, never setdefault: pooled workers OUTLIVE a
            # driver-side re-registration (e.g. a new S3 endpoint), and a
            # stale entry would shadow the one this task shipped with.
            fsmod._REGISTRY[scheme] = fs
        return reader(f)

    tasks = [lambda f=f: run(f) for f in files]
    return Dataset(L.Read(name, [], read_tasks=tasks))


def _seam_open(f):
    """Open one (possibly scheme-qualified) path through the filesystem
    seam so every reader works on any registered fs (s3://, ...)."""
    from ray_tpu_torch.data.filesystem import resolve_filesystem
    fs, local = resolve_filesystem(f)
    return fs.open_input(local)


def read_parquet(paths) -> Dataset:
    import pyarrow.parquet as pq
    return _file_read_dataset(paths, ".parquet",
                              lambda f: block_from_arrow(
                                  pq.read_table(_seam_open(f))),
                              "read_parquet")


def read_csv(paths) -> Dataset:
    import pyarrow.csv as pacsv
    return _file_read_dataset(paths, ".csv",
                              lambda f: block_from_arrow(
                                  pacsv.read_csv(_seam_open(f))),
                              "read_csv")


def read_json(paths) -> Dataset:
    import pyarrow.json as pajson
    return _file_read_dataset(paths, ".json",
                              lambda f: block_from_arrow(
                                  pajson.read_json(_seam_open(f))),
                              "read_json")


def read_text(paths) -> Dataset:
    def reader(f):
        with _seam_open(f) as fh:
            text = fh.read().decode()
        return block_from_rows(
            [{"text": line} for line in text.splitlines()])
    return _file_read_dataset(paths, ".txt", reader, "read_text")


def read_binary_files(paths) -> Dataset:
    def reader(f):
        from ray_tpu_torch.data.filesystem import resolve_filesystem
        fs, local = resolve_filesystem(f)
        with fs.open_input(local) as fh:
            return block_from_rows([{"bytes": fh.read(), "path": f}])
    return _file_read_dataset(paths, "", reader, "read_binary_files")


_IMAGE_SUFFIXES = (".png", ".jpg", ".jpeg", ".bmp", ".gif", ".webp")


def read_images(paths, *, size=None, mode: str = "RGB") -> Dataset:
    """Decode image files into an ``image`` tensor column (HWC uint8),
    optionally resizing to ``size=(h, w)`` (reference:
    ``data/read_api.py read_images`` / image datasource)."""
    def reader(f):
        import numpy as _np
        from PIL import Image

        from ray_tpu_torch.data.filesystem import resolve_filesystem
        fs, local = resolve_filesystem(f)
        with fs.open_input(local) as fh:
            img = Image.open(fh)
            img.load()
        if mode:
            img = img.convert(mode)
        if size is not None:
            img = img.resize((size[1], size[0]))
        arr = _np.ascontiguousarray(img)
        return block_from_batch(
            {"image": _np.ascontiguousarray(arr[None, ...]),
             "path": _np.asarray([f])})

    def _is_file(f):
        from ray_tpu_torch.data.filesystem import resolve_filesystem
        fs, local = resolve_filesystem(f)
        return fs.exists(local) and not fs.isdir(local)

    files = [f for f in _expand_paths(paths, "")
             if f.lower().endswith(_IMAGE_SUFFIXES) and _is_file(f)]
    tasks = [lambda f=f: reader(f) for f in files]
    return Dataset(L.Read("read_images", [], read_tasks=tasks))


def read_numpy(paths, column: str = "data") -> Dataset:
    """One block per .npy file."""
    def reader(f):
        from ray_tpu_torch.data.filesystem import resolve_filesystem
        fs, local = resolve_filesystem(f)
        with fs.open_input(local) as fh:
            arr = np.load(fh)
        return block_from_batch({column: arr})
    return _file_read_dataset(paths, ".npy", reader, "read_numpy")


def read_sql(sql: str, connection_factory, *,
             parallelism: int = 1) -> Dataset:
    """Rows of a SQL query as a dataset (reference: `data/read_api.py`
    read_sql / SQLDatasource). ``connection_factory`` returns a DB-API
    connection (e.g. ``lambda: sqlite3.connect(path)``) — it is called
    INSIDE each read task, so the dataset ships the factory, never a
    live connection. ``parallelism > 1`` pages the result set with
    ORDER BY 1 + LIMIT/OFFSET across independent query executions: the
    query's FIRST column must be a stable (ideally unique) key or rows
    may repeat/drop across pages."""
    def run_query(q: str):
        conn = connection_factory()
        try:
            cur = conn.cursor()
            cur.execute(q)
            cols = [d[0] for d in cur.description]
            rows = [dict(zip(cols, r)) for r in cur.fetchall()]
            return block_from_rows(rows)
        finally:
            conn.close()

    def read_page(p: int, n: int):
        # each task counts then reads its page: the count is redundant
        # across tasks, but the DRIVER never touches the database — a
        # DB reachable only from workers (private subnet, worker-held
        # credentials) still works, and the count subquery is cheap
        # next to the page pull
        conn = connection_factory()
        try:
            cur = conn.cursor()
            cur.execute(f"SELECT COUNT(*) FROM ({sql}) AS __sub")
            total = cur.fetchone()[0]
        finally:
            conn.close()
        per = max(1, (total + n - 1) // n)
        return run_query(
            f"SELECT * FROM ({sql}) AS __sub ORDER BY 1 "
            f"LIMIT {per} OFFSET {p * per}")

    import builtins
    n = max(1, parallelism)
    if n == 1:
        tasks = [lambda: run_query(sql)]
    else:
        tasks = [lambda p=p: read_page(p, n) for p in builtins.range(n)]
    return Dataset(L.Read("read_sql", [], read_tasks=tasks))


def read_tfrecords(paths) -> Dataset:
    """TFRecord shards of tf.train.Example protos, WITHOUT TensorFlow
    (reference: `data/read_api.py` read_tfrecords imports TF; this
    image has none — `data/tfrecords.py` speaks the framing + proto
    wire format directly, crc-checked)."""
    from ray_tpu_torch.data.tfrecords import (decode_example,
                                        read_tfrecord_frames)

    def reader(f):
        with _seam_open(f) as fh:
            blob = fh.read()
        rows = [decode_example(p) for p in read_tfrecord_frames(blob)]
        # features stay LISTS (proto semantics): any unwrap heuristic
        # is per-file and would disagree across shards of one dataset
        all_cols = {c for r in rows for c in r}
        for r in rows:
            for c in all_cols:
                r.setdefault(c, None)
        return block_from_rows(rows)

    return _file_read_dataset(paths, ".tfrecord", reader,
                              "read_tfrecords")


def read_webdataset(paths) -> Dataset:
    """WebDataset tar shards: files grouped by basename stem into one
    row per sample, keyed by extension (reference: `data/read_api.py`
    read_webdataset). E.g. ``000.jpg`` + ``000.cls`` -> one row
    ``{"__key__": "000", "jpg": b..., "cls": b...}``."""
    import io
    import tarfile

    def reader(f):
        with _seam_open(f) as fh:
            data = fh.read()
        samples: dict = {}
        order: list = []
        with tarfile.open(fileobj=io.BytesIO(data)) as tar:
            for member in tar.getmembers():
                if not member.isfile():
                    continue
                # WebDataset convention: key = path up to the FIRST dot
                # of the basename; everything after is the (possibly
                # multi-part) extension, e.g. 000.seg.png -> ("000",
                # "seg.png")
                prefix, _, base = member.name.rpartition("/")
                stem, _, ext = base.partition(".")
                key = f"{prefix}/{stem}" if prefix else stem
                if key not in samples:
                    samples[key] = {"__key__": key}
                    order.append(key)
                samples[key][ext] = tar.extractfile(member).read()
        rows = [samples[k] for k in order]
        # uniform column set: a sample missing an extension seen in
        # others gets None (block_from_rows keys off the first row)
        all_cols = {c for r in rows for c in r}
        for r in rows:
            for c in all_cols:
                r.setdefault(c, None)
        return block_from_rows(rows)

    return _file_read_dataset(paths, ".tar", reader, "read_webdataset")


def read_avro(paths) -> Dataset:
    """Avro Object Container Files (reference: `data/read_api.py`
    read_avro via fastavro; this image has no avro wheel —
    `data/avro.py` speaks the container framing + binary encoding
    directly, null/deflate codecs)."""
    from ray_tpu_torch.data.avro import read_container

    def reader(f):
        with _seam_open(f) as fh:
            blob = fh.read()
        _, records = read_container(blob)
        rows = [r if isinstance(r, dict) else {"value": r}
                for r in records]
        all_cols = {c for r in rows for c in r}
        for r in rows:
            for c in all_cols:
                r.setdefault(c, None)
        return block_from_rows(rows)

    return _file_read_dataset(paths, ".avro", reader, "read_avro")


def read_delta(path: str, *, version: Optional[int] = None) -> Dataset:
    """Delta Lake table (reference: `data/read_api.py` read_delta via
    deltalake; that wheel is absent, so this speaks the open Delta
    transaction-log protocol directly): replay `_delta_log/*.json`
    commits (add/remove actions) up to ``version``, then read the
    surviving parquet data files in parallel. Checkpoint parquet files
    are also honored as the replay base when present."""
    import json as _json

    from ray_tpu_torch.data.filesystem import resolve_filesystem
    fs, local = resolve_filesystem(path)
    log_dir = f"{local.rstrip('/')}/_delta_log"

    entries = sorted(
        p for p in fs.listdir(log_dir)
        if p.endswith(".json")
        and p.rsplit("/", 1)[-1].split(".")[0].isdigit())
    live: Dict[str, bool] = {}
    base_version = -1
    # checkpoint base: the newest usable checkpoint VERSION — reading
    # EVERY part of it (the spec allows multi-part checkpoints,
    # N.checkpoint.<part>.<parts>.parquet; one part alone silently
    # drops files)
    by_version: Dict[int, List[str]] = {}
    for p in fs.listdir(log_dir):
        name = p.rsplit("/", 1)[-1]
        if ".checkpoint." in name and name.endswith(".parquet"):
            head = name.split(".")[0]
            if head.isdigit():
                by_version.setdefault(int(head), []).append(p)
    usable = [v for v in by_version
              if version is None or v <= version]
    if usable:
        import pyarrow.parquet as pq
        ck_version = max(usable)
        for part in sorted(by_version[ck_version]):
            with fs.open_input(part) as f:
                table = pq.read_table(f)
            for row in table.to_pylist():
                add = row.get("add")
                if add and add.get("path"):
                    live[add["path"]] = True
                rm = row.get("remove")
                if rm and rm.get("path"):
                    live.pop(rm["path"], None)
        base_version = ck_version
    for entry in entries:
        v = int(entry.rsplit("/", 1)[-1].split(".")[0])
        if v <= base_version or (version is not None and v > version):
            continue
        with fs.open_input(entry) as f:
            for line in f.read().decode().splitlines():
                if not line.strip():
                    continue
                action = _json.loads(line)
                if "add" in action:
                    live[action["add"]["path"]] = True
                elif "remove" in action:
                    live.pop(action["remove"]["path"], None)

    scheme = path.split("://", 1)[0] + "://" if "://" in path else ""
    files = [f"{scheme}{local.rstrip('/')}/{rel}"
             for rel in sorted(live)]
    if not files:
        return _from_blocks([Block()])

    def reader(f):
        import pyarrow.parquet as pq
        with _seam_open(f) as fh:
            return block_from_arrow(pq.read_table(fh))

    return _file_read_dataset(files, ".parquet", reader, "read_delta")


def read_orc(paths) -> Dataset:
    """Apache ORC files (reference: `data/read_api.py` read_orc via
    pyarrow.orc — available in this image's pyarrow)."""
    def reader(f):
        import io as _io

        from pyarrow import orc as _orc
        with _seam_open(f) as fh:
            data = fh.read()
        return block_from_arrow(_orc.ORCFile(_io.BytesIO(data)).read())

    return _file_read_dataset(paths, ".orc", reader, "read_orc")


def from_torch(torch_dataset, *, parallelism: int = 4) -> Dataset:
    """Materialize a torch.utils.data.Dataset (map-style or iterable)
    into blocks (reference: `data/read_api.py` from_torch; torch is CPU
    -only in this image, which is exactly the ingest role)."""
    try:
        n = len(torch_dataset)
        items = [torch_dataset[i] for i in builtins_range(n)]
    except TypeError:
        items = list(torch_dataset)     # iterable-style

    def to_row(item):
        import numpy as _np
        try:
            import torch as _torch
            is_tensor = isinstance(item, _torch.Tensor)
        except ImportError:
            is_tensor = False
        if is_tensor:
            return {"item": _np.asarray(item)}
        if isinstance(item, dict):
            return item
        if isinstance(item, (tuple, list)):
            return {f"field_{i}": (_np.asarray(v)
                                   if hasattr(v, "numpy") else v)
                    for i, v in enumerate(item)}
        return {"item": item}

    return from_items([to_row(it) for it in items],
                      parallelism=parallelism)


import builtins as _builtins

builtins_range = _builtins.range
