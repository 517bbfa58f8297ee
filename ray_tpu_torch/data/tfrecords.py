"""TFRecord + tf.train.Example codec, dependency-free (counterpart of
``ray_tpu/data/tfrecords.py``, the same code).

Reference capability: `python/ray/data/read_api.py` read_tfrecords /
`datasource/tfrecords_datasource.py` (which imports TensorFlow). This
image has no TF, and the formats are simple enough to speak directly:

- TFRecord framing: ``u64 length | u32 masked-crc32c(length) | payload
  | u32 masked-crc32c(payload)`` (crc32c = Castagnoli polynomial, NOT
  zlib's crc32; mask = ((crc >> 15 | crc << 17) + 0xa282ead8)).
- tf.train.Example proto: ``features.feature`` map of name ->
  Feature{ bytes_list=1 | float_list=2 | int64_list=3 }, hand-decoded
  with a minimal varint/length-delimited parser (floats are packed or
  unpacked fixed32, int64s packed or unpacked varints).

Scalars unwrap to plain values; multi-element lists stay lists.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, Iterator, List, Tuple

# ---------------------------------------------------------------------------
# crc32c (Castagnoli), table-driven
# ---------------------------------------------------------------------------

_CRC_TABLE: List[int] = []


def _crc_table() -> List[int]:
    global _CRC_TABLE
    if not _CRC_TABLE:
        poly = 0x82F63B78
        table = []
        for n in range(256):
            c = n
            for _ in range(8):
                c = (c >> 1) ^ poly if c & 1 else c >> 1
            table.append(c)
        _CRC_TABLE = table
    return _CRC_TABLE


def crc32c(data: bytes) -> int:
    table = _crc_table()
    crc = 0xFFFFFFFF
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# TFRecord framing
# ---------------------------------------------------------------------------

def read_tfrecord_frames(blob: bytes) -> Iterator[bytes]:
    off = 0
    n = len(blob)
    while off < n:
        if off + 12 > n:
            raise ValueError("truncated TFRecord header")
        (length,) = struct.unpack_from("<Q", blob, off)
        (len_crc,) = struct.unpack_from("<I", blob, off + 8)
        if _masked_crc(blob[off:off + 8]) != len_crc:
            raise ValueError("TFRecord length crc mismatch")
        start = off + 12
        if start + length + 4 > n:
            raise ValueError("truncated TFRecord payload")
        payload = blob[start:start + length]
        (data_crc,) = struct.unpack_from("<I", blob, start + length)
        if _masked_crc(payload) != data_crc:
            raise ValueError("TFRecord data crc mismatch")
        yield payload
        off = start + length + 4


def write_tfrecord_frame(payload: bytes) -> bytes:
    header = struct.pack("<Q", len(payload))
    return (header + struct.pack("<I", _masked_crc(header)) + payload
            + struct.pack("<I", _masked_crc(payload)))


# ---------------------------------------------------------------------------
# minimal protobuf wire codec (the subset tf.train.Example uses)
# ---------------------------------------------------------------------------

def _read_varint(buf: bytes, off: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[off]
        off += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, off
        shift += 7


def _write_varint(value: int) -> bytes:
    out = bytearray()
    while True:
        bits = value & 0x7F
        value >>= 7
        if value:
            out.append(bits | 0x80)
        else:
            out.append(bits)
            return bytes(out)


def _fields(buf: bytes) -> Iterator[Tuple[int, int, Any]]:
    """(field_number, wire_type, value) over one message."""
    off = 0
    n = len(buf)
    while off < n:
        key, off = _read_varint(buf, off)
        field, wt = key >> 3, key & 7
        if wt == 0:                     # varint
            val, off = _read_varint(buf, off)
        elif wt == 2:                   # length-delimited
            ln, off = _read_varint(buf, off)
            val = buf[off:off + ln]
            off += ln
        elif wt == 5:                   # fixed32
            (val,) = struct.unpack_from("<I", buf, off)
            off += 4
        elif wt == 1:                   # fixed64
            (val,) = struct.unpack_from("<Q", buf, off)
            off += 8
        else:
            raise ValueError(f"unsupported wire type {wt}")
        yield field, wt, val


def _decode_feature(buf: bytes) -> List[Any]:
    for field, wt, val in _fields(buf):
        if field == 1:                  # BytesList { repeated bytes 1 }
            return [v for f, _, v in _fields(val) if f == 1]
        if field == 2:                  # FloatList { repeated float 1 }
            out: List[float] = []
            for f, w, v in _fields(val):
                if f != 1:
                    continue
                if w == 2:              # packed
                    out.extend(struct.unpack(f"<{len(v) // 4}f", v))
                else:                   # unpacked fixed32
                    out.append(struct.unpack("<f",
                                             struct.pack("<I", v))[0])
            return out
        if field == 3:                  # Int64List { repeated int64 1 }
            out = []
            for f, w, v in _fields(val):
                if f != 1:
                    continue
                if w == 2:              # packed varints
                    off = 0
                    while off < len(v):
                        x, off = _read_varint(v, off)
                        out.append(x - (1 << 64) if x >= 1 << 63 else x)
                else:
                    out.append(v - (1 << 64) if v >= 1 << 63 else v)
            return out
    return []


def decode_example(payload: bytes) -> Dict[str, Any]:
    """tf.train.Example bytes -> {name: list}. Features are ALWAYS
    lists here (proto semantics); per-COLUMN scalar unwrapping is the
    reader's job — a per-row unwrap would mix scalars and lists in one
    column when lengths vary ([5] vs [1, 2])."""
    row: Dict[str, Any] = {}
    for field, _, val in _fields(payload):
        if field != 1:                  # Example.features
            continue
        for f2, _, fmap in _fields(val):
            if f2 != 1:                 # Features.feature map entry
                continue
            name = b""
            feat: List[Any] = []
            for f3, _, v3 in _fields(fmap):
                if f3 == 1:
                    name = v3
                elif f3 == 2:
                    feat = _decode_feature(v3)
            row[name.decode()] = feat
    return row




def _ld(field: int, payload: bytes) -> bytes:
    return _write_varint(field << 3 | 2) + _write_varint(
        len(payload)) + payload


def encode_example(row: Dict[str, Any]) -> bytes:
    """{name: value} -> tf.train.Example bytes. bytes/str -> BytesList,
    float -> FloatList, int/bool -> Int64List (lists of same kind ok)."""
    entries = b""
    for name, value in row.items():
        vals = value if isinstance(value, (list, tuple)) else [value]
        if all(isinstance(v, (bytes, str)) for v in vals):
            inner = b"".join(
                _ld(1, v.encode() if isinstance(v, str) else v)
                for v in vals)
            feature = _ld(1, inner)
        elif all(isinstance(v, bool) or isinstance(v, int)
                 for v in vals):
            for v in vals:
                if not -(1 << 63) <= int(v) < (1 << 63):
                    raise ValueError(
                        f"feature {name!r}: {v} outside int64 range "
                        f"(would wrap silently on round-trip)")
            packed = b"".join(_write_varint(int(v) & ((1 << 64) - 1))
                              for v in vals)
            feature = _ld(3, _ld(1, packed))
        elif all(isinstance(v, (int, float)) for v in vals):
            packed = struct.pack(f"<{len(vals)}f",
                                 *[float(v) for v in vals])
            feature = _ld(2, _ld(1, packed))
        else:
            raise TypeError(
                f"feature {name!r}: unsupported value types "
                f"{[type(v).__name__ for v in vals]}")
        entry = _ld(1, name.encode()) + _ld(2, feature)
        entries += _ld(1, entry)
    return _ld(1, entries)              # Example.features
