"""Avro Object Container File codec (no external avro library; counterpart
of ``ray_tpu/data/avro.py``, the same code).

Reference capability: ``python/ray/data/datasource/avro_datasource.py``
(reads Avro via the `fastavro` wheel). That wheel is not in this image,
so this is a native implementation of the parts the datasource needs:
the 1.11 container-file framing (magic, metadata map, sync-marker
delimited blocks, null/deflate codecs) and the binary encoding for the
standard types — null, boolean, int/long (zigzag varint), float,
double, bytes, string, record, enum, array, map, union, fixed.

Writer support covers the schemas :func:`infer_schema` produces from
Arrow-typed rows (the ``write_avro`` path); the reader handles any
spec-compliant file.
"""

from __future__ import annotations

import io
import json
import os
import struct
import zlib
from typing import Any, BinaryIO, Dict, Iterator, List, Optional, Tuple

MAGIC = b"Obj\x01"
SYNC_SIZE = 16


# ---------------------------------------------------------------------------
# primitive binary encoding
# ---------------------------------------------------------------------------

def _zigzag_encode(n: int) -> int:
    return (n << 1) ^ (n >> 63) if n < 0 else n << 1


def _zigzag_decode(n: int) -> int:
    return (n >> 1) ^ -(n & 1)


def write_long(out: io.BytesIO, n: int) -> None:
    z = _zigzag_encode(n)
    while True:
        b = z & 0x7F
        z >>= 7
        if z:
            out.write(bytes([b | 0x80]))
        else:
            out.write(bytes([b]))
            return


def read_long(buf: BinaryIO) -> int:
    shift = 0
    accum = 0
    while True:
        byte = buf.read(1)
        if not byte:
            raise EOFError("truncated varint")
        b = byte[0]
        accum |= (b & 0x7F) << shift
        if not b & 0x80:
            return _zigzag_decode(accum)
        shift += 7


def write_bytes(out: io.BytesIO, b: bytes) -> None:
    write_long(out, len(b))
    out.write(b)


def read_n(buf: BinaryIO, n: int) -> bytes:
    data = buf.read(n)
    if len(data) != n:
        raise EOFError("truncated data")
    return data


# ---------------------------------------------------------------------------
# schema-driven encode/decode
# ---------------------------------------------------------------------------

def _named(schema: Any) -> Any:
    """Resolve {'type': X, ...} wrappers to X for primitive checks."""
    if isinstance(schema, dict) and isinstance(schema.get("type"), str) \
            and schema["type"] in _PRIMITIVES and len(schema) == 1:
        return schema["type"]
    return schema


_PRIMITIVES = ("null", "boolean", "int", "long", "float", "double",
               "bytes", "string")


def encode(out: io.BytesIO, schema: Any, value: Any,
           names: Optional[Dict[str, Any]] = None) -> None:
    names = names if names is not None else {}
    schema = _named(schema)
    if isinstance(schema, str):
        if schema in names:
            encode(out, names[schema], value, names)
        elif schema == "null":
            pass
        elif schema == "boolean":
            out.write(b"\x01" if value else b"\x00")
        elif schema in ("int", "long"):
            write_long(out, int(value))
        elif schema == "float":
            out.write(struct.pack("<f", float(value)))
        elif schema == "double":
            out.write(struct.pack("<d", float(value)))
        elif schema == "bytes":
            write_bytes(out, bytes(value))
        elif schema == "string":
            write_bytes(out, str(value).encode())
        else:
            raise ValueError(f"unknown schema {schema!r}")
        return
    if isinstance(schema, list):                     # union
        for i, branch in enumerate(schema):
            if _matches(branch, value, names):
                write_long(out, i)
                encode(out, branch, value, names)
                return
        raise ValueError(f"no union branch for {type(value)}")
    t = schema["type"]
    if t == "record":
        names[schema["name"]] = schema
        for field in schema["fields"]:
            encode(out, field["type"], value.get(field["name"]), names)
    elif t == "enum":
        names[schema["name"]] = schema
        write_long(out, schema["symbols"].index(value))
    elif t == "fixed":
        names[schema["name"]] = schema
        out.write(bytes(value))
    elif t == "array":
        if value:
            write_long(out, len(value))
            for item in value:
                encode(out, schema["items"], item, names)
        write_long(out, 0)
    elif t == "map":
        if value:
            write_long(out, len(value))
            for k, v in value.items():
                write_bytes(out, str(k).encode())
                encode(out, schema["values"], v, names)
        write_long(out, 0)
    else:
        encode(out, t, value, names)


def _matches(schema: Any, value: Any, names: Dict[str, Any]) -> bool:
    schema = _named(schema)
    if isinstance(schema, str):
        if schema in names:
            return _matches(names[schema], value, names)
        return {
            "null": value is None,
            "boolean": isinstance(value, bool),
            "int": isinstance(value, int) and not isinstance(value, bool),
            "long": isinstance(value, int) and not isinstance(value, bool),
            "float": isinstance(value, float),
            "double": isinstance(value, float),
            "bytes": isinstance(value, (bytes, bytearray)),
            "string": isinstance(value, str),
        }.get(schema, False)
    if isinstance(schema, list):
        return any(_matches(b, value, names) for b in schema)
    t = schema.get("type")
    if t == "record":
        return isinstance(value, dict)
    if t == "enum":
        return isinstance(value, str) and value in schema["symbols"]
    if t == "array":
        return isinstance(value, list)
    if t == "map":
        return isinstance(value, dict)
    if t == "fixed":
        return isinstance(value, (bytes, bytearray))
    return _matches(t, value, names)


def decode(buf: BinaryIO, schema: Any,
           names: Optional[Dict[str, Any]] = None) -> Any:
    names = names if names is not None else {}
    schema = _named(schema)
    if isinstance(schema, str):
        if schema in names:
            return decode(buf, names[schema], names)
        if schema == "null":
            return None
        if schema == "boolean":
            return read_n(buf, 1) == b"\x01"
        if schema in ("int", "long"):
            return read_long(buf)
        if schema == "float":
            return struct.unpack("<f", read_n(buf, 4))[0]
        if schema == "double":
            return struct.unpack("<d", read_n(buf, 8))[0]
        if schema == "bytes":
            return read_n(buf, read_long(buf))
        if schema == "string":
            return read_n(buf, read_long(buf)).decode()
        raise ValueError(f"unknown schema {schema!r}")
    if isinstance(schema, list):                     # union
        return decode(buf, schema[read_long(buf)], names)
    t = schema["type"]
    if t == "record":
        names[schema["name"]] = schema
        return {f["name"]: decode(buf, f["type"], names)
                for f in schema["fields"]}
    if t == "enum":
        names[schema["name"]] = schema
        return schema["symbols"][read_long(buf)]
    if t == "fixed":
        names[schema["name"]] = schema
        return read_n(buf, schema["size"])
    if t == "array":
        out: List[Any] = []
        while True:
            n = read_long(buf)
            if n == 0:
                return out
            if n < 0:            # block with byte-size prefix
                read_long(buf)
                n = -n
            for _ in range(n):
                out.append(decode(buf, schema["items"], names))
    if t == "map":
        m: Dict[str, Any] = {}
        while True:
            n = read_long(buf)
            if n == 0:
                return m
            if n < 0:
                read_long(buf)
                n = -n
            for _ in range(n):
                key = read_n(buf, read_long(buf)).decode()
                m[key] = decode(buf, schema["values"], names)
    return decode(buf, t, names)


# ---------------------------------------------------------------------------
# container file
# ---------------------------------------------------------------------------

def read_container(data: bytes) -> Tuple[Any, List[Any]]:
    """Parse one Object Container File; returns (schema, records)."""
    buf = io.BytesIO(data)
    if read_n(buf, 4) != MAGIC:
        raise ValueError("not an Avro object container file")
    meta: Dict[str, bytes] = {}
    while True:
        n = read_long(buf)
        if n == 0:
            break
        if n < 0:
            read_long(buf)
            n = -n
        for _ in range(n):
            key = read_n(buf, read_long(buf)).decode()
            meta[key] = read_n(buf, read_long(buf))
    schema = json.loads(meta["avro.schema"].decode())
    codec = meta.get("avro.codec", b"null").decode()
    if codec not in ("null", "deflate"):
        raise ValueError(f"unsupported avro codec {codec!r}")
    sync = read_n(buf, SYNC_SIZE)
    records: List[Any] = []
    while True:
        probe = buf.read(1)
        if not probe:
            break
        buf.seek(-1, os.SEEK_CUR)
        count = read_long(buf)
        nbytes = read_long(buf)
        payload = read_n(buf, nbytes)
        if codec == "deflate":
            payload = zlib.decompress(payload, -15)
        block = io.BytesIO(payload)
        for _ in range(count):
            records.append(decode(block, schema))
        if read_n(buf, SYNC_SIZE) != sync:
            raise ValueError("sync marker mismatch")
    return schema, records


def write_container(schema: Any, records: List[Any], *,
                    codec: str = "deflate",
                    records_per_block: int = 4096) -> bytes:
    """Serialize records into one Object Container File."""
    if codec not in ("null", "deflate"):
        raise ValueError(f"unsupported avro codec {codec!r}")
    out = io.BytesIO()
    out.write(MAGIC)
    meta = {"avro.schema": json.dumps(schema).encode(),
            "avro.codec": codec.encode()}
    write_long(out, len(meta))
    for k, v in meta.items():
        write_bytes(out, k.encode())
        write_bytes(out, v)
    write_long(out, 0)
    # deterministic sync marker from content is fine (spec: any 16 bytes)
    import hashlib
    sync = hashlib.md5(json.dumps(schema).encode()).digest()
    out.write(sync)
    for lo in range(0, len(records), records_per_block):
        chunk = records[lo:lo + records_per_block]
        payload_buf = io.BytesIO()
        for rec in chunk:
            encode(payload_buf, schema, rec)
        payload = payload_buf.getvalue()
        if codec == "deflate":
            cobj = zlib.compressobj(9, zlib.DEFLATED, -15)
            payload = cobj.compress(payload) + cobj.flush()
        write_long(out, len(chunk))
        write_long(out, len(payload))
        out.write(payload)
        out.write(sync)
    return out.getvalue()


def infer_schema(rows: List[Dict[str, Any]],
                 name: str = "row") -> Dict[str, Any]:
    """Record schema from python rows (None -> nullable union)."""
    fields: Dict[str, set] = {}
    for row in rows:
        for k, v in row.items():
            fields.setdefault(k, set()).add(_pytype_to_avro(v))
    out_fields = []
    for k, types in fields.items():
        types.discard(None)
        tl = sorted(types)
        if not tl:
            ftype: Any = "null"
        elif len(tl) == 1:
            ftype = tl[0]
        else:
            ftype = tl
        # null-pad: any row missing the key (or None) needs the union —
        # unless the column is all-null already ("null" alone is valid;
        # ["null","null"] is a spec-forbidden duplicate-branch union)
        if ftype != "null" and any(
                k not in row or row[k] is None for row in rows):
            ftype = (["null", ftype] if isinstance(ftype, str)
                     else ["null", *ftype])
        out_fields.append({"name": k, "type": ftype})
    return {"type": "record", "name": name, "fields": out_fields}


def _pytype_to_avro(v: Any) -> Optional[str]:
    import numpy as np
    if v is None:
        return None
    if isinstance(v, bool) or isinstance(v, np.bool_):
        return "boolean"
    if isinstance(v, (int, np.integer)):
        return "long"
    if isinstance(v, (float, np.floating)):
        return "double"
    if isinstance(v, (bytes, bytearray)):
        return "bytes"
    if isinstance(v, str):
        return "string"
    raise TypeError(f"cannot map {type(v)} to an Avro type")
