"""Blocks: the unit of distributed data (counterpart of
``ray_tpu/data/block.py``).

JAX's block is a ``pyarrow.Table``; the card's machine has no pyarrow, so
the port's block is its own table of named numpy columns, one length each:

- a **1-D column** holds numbers or booleans in their numpy dtype;
- a **tensor column** is an N-D array whose first axis is the row (JAX's
  fixed-shape tensor column): it keeps its dtype and shape;
- an **object column** holds Python values: strings, bytes, lists, dicts,
  ragged arrays and any column with a ``None`` in it.

Rows, batches and conversions follow pyarrow's semantics case by case
(``to_pylist`` gives Python scalars, ``None`` stays ``None``, a tensor row
is a flat list; ``to_batch`` stacks equal-length lists and turns a numeric
column with nulls into float64 with NaN). Every column is a read-only view:
a block in the object store is shared by reference, so a batch handed to a
user function must not be able to write into it (JAX's Arrow batches are
read-only too). The block reports its columns' bytes through
``__sizeof__``, which the object store's accounting reads, and pickles for
spilling. ``"pyarrow"``/``"arrow"`` and ``"pandas"`` batches import those
packages when asked for.
"""

from __future__ import annotations

import sys
from typing import Any, Dict, Iterable, List, Optional, Sequence

import numpy as np

Row = Dict[str, Any]


def _frozen(arr: np.ndarray) -> np.ndarray:
    if not arr.flags.writeable:
        return arr
    view = arr.view()
    view.flags.writeable = False
    return view


def _object_column(values: Sequence[Any]) -> np.ndarray:
    col = np.empty(len(values), dtype=object)
    for i, v in enumerate(values):      # element by element: a list value
        col[i] = v                      # must not broadcast into the array
    return col


def _is_number(v) -> bool:
    return (isinstance(v, (int, float, np.integer, np.floating))
            and not isinstance(v, (bool, np.bool_)))


def _column_from_values(values: Sequence[Any]) -> np.ndarray:
    """A column from a list of Python values, as ``pa.array`` infers it:
    ints int64, floats float64 (numpy scalars keep their dtype), booleans
    bool; strings, bytes, nested values and anything with ``None`` an
    object column."""
    if values and all(v is not None for v in values):
        if all(isinstance(v, (bool, np.bool_)) for v in values):
            return np.asarray(values, dtype=bool)
        if all(_is_number(v) for v in values):
            arr = np.asarray(values)
            if arr.dtype != object:
                return arr
    return _object_column(values)


def _column_from_numpy(v) -> np.ndarray:
    """A batch value as a column: an N-D numeric array is a tensor column
    (dtype and shape kept), a 1-D one keeps its dtype, numpy strings and
    bytes become object columns, a list is inferred as ``pa.array`` would."""
    if isinstance(v, (list, tuple)):
        arr = np.asarray(v)
        if arr.ndim > 1 and arr.dtype != object:
            return arr
        return _column_from_values(list(v))
    arr = np.asarray(v)       # numpy, or anything with __array__
    if arr.ndim == 0:
        raise TypeError("a batch column must have a row axis")
    if arr.dtype.kind in "US":
        return _object_column(arr.tolist())
    return arr


def _py(x):
    """A stored element as pyarrow's ``to_pylist`` gives it."""
    if isinstance(x, np.generic):
        return x.item()
    if isinstance(x, np.ndarray):
        return x.tolist()
    return x


class Schema:
    """Column names and types of a block (JAX returns ``pa.Schema``): a
    type is the numpy dtype of a 1-D column, ``(dtype, row shape)`` of a
    tensor column, or ``object``."""

    def __init__(self, names: List[str], types: List[Any]):
        self.names = list(names)
        self.types = list(types)

    def __repr__(self) -> str:
        return "Schema(" + ", ".join(
            f"{n}: {t}" for n, t in zip(self.names, self.types)) + ")"


class Block:
    """A table of named, read-only numpy columns of ``num_rows`` rows."""

    __slots__ = ("_columns", "num_rows", "_nbytes")

    def __init__(self, columns: Optional[Dict[str, np.ndarray]] = None,
                 num_rows: Optional[int] = None):
        columns = dict(columns or {})
        lengths = {len(c) for c in columns.values()}
        if len(lengths) > 1:
            raise ValueError(f"columns of unequal lengths {sorted(lengths)}")
        n = lengths.pop() if lengths else 0
        if num_rows is not None and columns and num_rows != n:
            raise ValueError(f"num_rows {num_rows} != column length {n}")
        self._columns = {k: _frozen(np.asarray(c)) for k, c in
                         columns.items()}
        self.num_rows = n if columns else int(num_rows or 0)
        self._nbytes = None

    # -- pickling (spilling, Tune's trials) and size accounting ----------
    def __getstate__(self):
        return (self._columns, self.num_rows)

    def __setstate__(self, state):
        columns, num_rows = state
        self._columns = {k: _frozen(c) for k, c in columns.items()}
        self.num_rows = num_rows
        self._nbytes = None

    @property
    def nbytes(self) -> int:
        """Bytes of the columns' data (an object column's values counted
        one by one)."""
        if self._nbytes is None:
            self._nbytes = sum(_column_nbytes(c)
                               for c in self._columns.values())
        return self._nbytes

    def __sizeof__(self) -> int:
        return object.__sizeof__(self) + self.nbytes

    # -- table surface (the part of ``pa.Table`` the data layer uses) -----
    @property
    def column_names(self) -> List[str]:
        return list(self._columns)

    @property
    def schema(self) -> Schema:
        types = []
        for c in self._columns.values():
            if c.dtype == object:
                types.append(object)
            elif c.ndim > 1:
                types.append((c.dtype, c.shape[1:]))
            else:
                types.append(c.dtype)
        return Schema(self.column_names, types)

    def column(self, name: str) -> np.ndarray:
        return self._columns[name]

    def __repr__(self) -> str:
        return f"Block({self.num_rows} rows, {self.schema})"

    def slice(self, offset: int = 0, length: Optional[int] = None) -> "Block":
        end = self.num_rows if length is None else min(
            self.num_rows, offset + length)
        offset = min(offset, self.num_rows)
        if not self._columns:
            return Block(num_rows=max(0, end - offset))
        return Block({k: c[offset:end] for k, c in self._columns.items()})

    def take(self, indices) -> "Block":
        idx = np.asarray(indices, dtype=np.int64)
        if not self._columns:
            return Block(num_rows=len(idx))
        return Block({k: c[idx] for k, c in self._columns.items()})

    def select(self, names: Sequence[str]) -> "Block":
        return Block({k: self._columns[k] for k in names},
                     num_rows=self.num_rows)

    def drop_columns(self, names: Sequence[str]) -> "Block":
        missing = [k for k in names if k not in self._columns]
        if missing:
            raise KeyError(f"no column(s) {missing}")
        return Block({k: c for k, c in self._columns.items()
                      if k not in names}, num_rows=self.num_rows)

    def rename_columns(self, names: Sequence[str]) -> "Block":
        if len(names) != len(self._columns):
            raise ValueError(f"{len(names)} names for "
                             f"{len(self._columns)} columns")
        return Block(dict(zip(names, self._columns.values())),
                     num_rows=self.num_rows)

    def append_column(self, name: str, column) -> "Block":
        if name in self._columns:
            raise ValueError(f"column {name!r} exists")
        cols = dict(self._columns)
        cols[name] = _column_from_numpy(column)
        return Block(cols)

    def sort_by(self, sorting) -> "Block":
        """``sorting``: a column name or ``[(name, "ascending" |
        "descending")]``; stable, as pyarrow's, by the first key then the
        next."""
        if isinstance(sorting, str):
            sorting = [(sorting, "ascending")]
        order = np.arange(self.num_rows)
        for name, direction in reversed(list(sorting)):
            col = self._columns[name][order]
            descending = direction == "descending"
            if col.dtype == object:
                # Python's sort is stable both ways; nulls go last
                valid = [i for i, v in enumerate(col) if v is not None]
                rank = sorted(valid, key=col.__getitem__,
                              reverse=descending) + [
                    i for i, v in enumerate(col) if v is None]
            elif descending:
                # stable descending: equal keys keep their order
                rank = len(col) - 1 - np.argsort(col[::-1],
                                                 kind="stable")[::-1]
            else:
                rank = np.argsort(col, kind="stable")
            order = order[np.asarray(rank, dtype=np.int64)]
        return self.take(order)

    def to_pylist(self) -> List[Row]:
        cols = {k: _pylist(c) for k, c in self._columns.items()}
        return [{k: v[i] for k, v in cols.items()}
                for i in range(self.num_rows)]

    def to_numpy(self, name: str) -> np.ndarray:
        """A column as pyarrow's ``to_numpy(zero_copy_only=False)`` gives
        it: numeric columns as stored, a numeric object column with nulls
        as float64 with NaN, other object columns as object arrays."""
        return _nulls_as_nan(self._columns[name])

    def to_pandas(self):
        import pandas as pd
        return pd.DataFrame({k: (c if c.ndim == 1 else list(c))
                             for k, c in self._columns.items()})

    def to_arrow(self):
        """This block as a ``pyarrow.Table`` (imports pyarrow)."""
        import pyarrow as pa
        return pa.table({k: _arrow_column(c)
                         for k, c in self._columns.items()})

    def join(self, right: "Block", keys: str, join_type: str = "inner",
             right_suffix: str = "_r") -> "Block":
        """Hash join on one key column, with pyarrow's join types and
        column layout: the key once, a right column that collides with a
        left one suffixed, unmatched rows' other side ``None``. Rows come
        left by left, each with its matches in right order, then the
        unmatched right rows."""
        return _join(self, right, keys, join_type, right_suffix)


# ---------------------------------------------------------------------------
# column helpers
# ---------------------------------------------------------------------------

def _column_nbytes(col: np.ndarray) -> int:
    if col.dtype != object:
        return int(col.nbytes)
    total = int(col.nbytes)
    for v in col:
        if isinstance(v, (bytes, bytearray, str)):
            total += len(v)
        elif isinstance(v, np.ndarray):
            total += int(v.nbytes)
        elif v is not None:
            total += sys.getsizeof(v)
    return total


def _pylist(col: np.ndarray) -> list:
    if col.dtype != object:
        if col.ndim > 1:                  # pyarrow's tensor rows are flat
            return [r.ravel().tolist() for r in col]
        return col.tolist()
    return [_py(v) for v in col]


def _nulls_as_nan(col: np.ndarray) -> np.ndarray:
    if col.dtype != object or not len(col):
        return col
    values = [v for v in col if v is not None]
    if len(values) < len(col) and values and all(_is_number(v)
                                                 for v in values):
        return np.asarray([np.nan if v is None else v for v in col],
                          dtype=np.float64)
    return col


def _arrow_column(col: np.ndarray):
    import pyarrow as pa
    if col.dtype != object:
        if col.ndim > 1:
            return pa.FixedShapeTensorArray.from_numpy_ndarray(
                np.ascontiguousarray(col))
        return pa.array(col)
    return pa.array([_py(v) for v in col])


def block_from_arrow(table) -> Block:
    """A ``pyarrow.Table`` as a block: numeric columns without nulls as
    numpy arrays, fixed-shape tensor columns as N-D arrays, every other
    column as Python values (``to_pylist``)."""
    import pyarrow as pa
    cols: Dict[str, np.ndarray] = {}
    for name in table.column_names:
        col = table.column(name)
        chunked = col.combine_chunks() if isinstance(
            col, pa.ChunkedArray) else col
        t = chunked.type
        if isinstance(t, pa.FixedShapeTensorType):
            cols[name] = chunked.to_numpy_ndarray()
        elif chunked.null_count == 0 and (
                pa.types.is_integer(t) or pa.types.is_floating(t)
                or pa.types.is_boolean(t)):
            cols[name] = chunked.to_numpy(zero_copy_only=False)
        else:
            cols[name] = _object_column(chunked.to_pylist())
    return Block(cols, num_rows=table.num_rows)


def block_from_rows(rows: List[Row]) -> Block:
    if not rows:
        return Block()
    if not isinstance(rows[0], dict):
        rows = [{"item": r} for r in rows]
    names = list(rows[0])
    return Block({k: _column_from_values([r.get(k) for r in rows])
                  for k in names})


def block_from_batch(batch) -> Block:
    if isinstance(batch, Block):
        return batch
    if isinstance(batch, dict):
        return Block({k: _column_from_numpy(v) for k, v in batch.items()})
    mod = type(batch).__module__.split(".")[0]
    if mod == "pyarrow":
        return block_from_arrow(batch)
    if mod == "pandas":
        import pandas as pd
        if isinstance(batch, pd.DataFrame):
            return Block({c: _column_from_numpy(batch[c].to_numpy())
                          for c in batch.columns}, num_rows=len(batch))
    raise TypeError(f"cannot convert {type(batch)} to a block")


class BlockAccessor:
    """Format adapter over a block (reference: BlockAccessor.for_block)."""

    def __init__(self, block: Block):
        self.block = block

    @staticmethod
    def for_block(block: Block) -> "BlockAccessor":
        return BlockAccessor(block)

    def num_rows(self) -> int:
        return self.block.num_rows

    def size_bytes(self) -> int:
        return self.block.nbytes

    def schema(self) -> Schema:
        return self.block.schema

    def to_rows(self) -> List[Row]:
        return self.block.to_pylist()

    def to_batch(self, batch_format: str = "numpy"):
        """``"numpy"``/``"dict"``: a dict of arrays (read-only views of the
        block's; equal-length lists stacked, ragged ones an object array
        of arrays); ``"block"``: the block itself; ``"pyarrow"``/
        ``"arrow"`` and ``"pandas"`` convert through those packages."""
        if batch_format in ("numpy", "dict"):
            out: Dict[str, np.ndarray] = {}
            for name in self.block.column_names:
                col = self.block.to_numpy(name)
                if col.dtype == object and len(col) and \
                        isinstance(col[0], (list, np.ndarray)):
                    parts = [np.asarray(x) for x in col]
                    try:
                        col = np.stack(parts)
                    except ValueError:
                        col = _object_column(parts)   # ragged
                out[name] = _frozen(col)
            return out
        if batch_format == "block":
            return self.block
        if batch_format in ("pyarrow", "arrow"):
            return self.block.to_arrow()
        if batch_format == "pandas":
            return self.block.to_pandas()
        raise ValueError(f"unknown batch_format {batch_format!r}")

    def slice(self, start: int, end: int) -> Block:
        return self.block.slice(start, end - start)

    def take_rows(self, indices: np.ndarray) -> Block:
        return self.block.take(indices)


def _concat_columns(parts: List[np.ndarray]) -> np.ndarray:
    if all(p.dtype != object for p in parts) and \
            len({p.shape[1:] for p in parts}) == 1:
        return np.concatenate(parts)
    values: list = []
    for p in parts:
        values.extend(p if p.dtype == object and p.ndim == 1 else list(p))
    return _column_from_values(values) if all(
        np.ndim(v) == 0 for v in values) else _object_column(values)


def concat_blocks(blocks: Iterable[Block]) -> Block:
    """Rows of ``blocks`` in order. Schemas are promoted as pyarrow's
    ``promote_options="default"``: a column one block lacks is ``None``
    there. All-empty inputs keep the first schema that has columns."""
    blocks = list(blocks)
    nonempty = [b for b in blocks if b.num_rows > 0]
    if not nonempty:
        for b in blocks:
            if b.column_names:
                return b.slice(0, 0)
        return Block()
    if len(nonempty) == 1:
        return nonempty[0]
    names: List[str] = []
    for b in nonempty:
        names.extend(k for k in b.column_names if k not in names)
    cols = {}
    for k in names:
        parts = [b.column(k) if k in b.column_names
                 else _object_column([None] * b.num_rows) for b in nonempty]
        cols[k] = _concat_columns(parts)
    return Block(cols)


def split_block(block: Block, num_splits: int) -> List[Block]:
    n = block.num_rows
    out = []
    for i in range(num_splits):
        lo = i * n // num_splits
        hi = (i + 1) * n // num_splits
        out.append(block.slice(lo, hi - lo))
    return out


# ---------------------------------------------------------------------------
# join
# ---------------------------------------------------------------------------

_JOIN_TYPES = ("inner", "left outer", "right outer", "full outer",
               "left semi", "left anti", "right semi", "right anti")


def _key_of(v):
    """A hashable key that treats equal numbers alike (1 == 1.0), as the
    join's comparison does."""
    return _py(v)


def _gather(col: np.ndarray, idx: List[Optional[int]]) -> np.ndarray:
    """Rows ``idx`` of ``col``; ``None`` where an index is ``None``."""
    if all(i is not None for i in idx):
        return col[np.asarray(idx, dtype=np.int64)] if idx else col[:0]
    values = [None if i is None else _py(col[i]) if col.ndim == 1
              else col[i] for i in idx]
    return _object_column(values)


def _join(left: Block, right: Block, key: str, how: str,
          suffix: str) -> Block:
    if how not in _JOIN_TYPES:
        raise ValueError(f"join_type must be one of {_JOIN_TYPES}, "
                         f"got {how!r}")
    if key not in left.column_names or key not in right.column_names:
        raise KeyError(f"join key {key!r} missing from a side")
    lkeys = [_key_of(v) for v in left.column(key)]
    rkeys = [_key_of(v) for v in right.column(key)]
    if how in ("right semi", "right anti"):
        lset = {k for k in lkeys if k is not None}
        keep = [j for j, k in enumerate(rkeys)
                if (k in lset) == (how == "right semi")]
        return right.take(keep)
    index: Dict[Any, List[int]] = {}
    for j, k in enumerate(rkeys):
        if k is not None:
            index.setdefault(k, []).append(j)
    if how in ("left semi", "left anti"):
        keep = [i for i, k in enumerate(lkeys)
                if (k in index) == (how == "left semi")]
        return left.take(keep)
    li: List[Optional[int]] = []
    ri: List[Optional[int]] = []
    matched_right = set()
    unmatched_left = []
    for i, k in enumerate(lkeys):
        js = index.get(k, []) if k is not None else []
        for j in js:
            li.append(i)
            ri.append(j)
            matched_right.add(j)
        if not js:
            unmatched_left.append(i)
    if how in ("left outer", "full outer"):
        li.extend(unmatched_left)
        ri.extend([None] * len(unmatched_left))
    if how in ("right outer", "full outer"):
        rest = [j for j in range(right.num_rows) if j not in matched_right]
        li.extend([None] * len(rest))
        ri.extend(rest)
    cols: Dict[str, np.ndarray] = {}
    lnames = left.column_names
    if how == "right outer":
        for name in lnames:
            if name != key:
                cols[name] = _gather(left.column(name), li)
        for name in right.column_names:
            out = name if name == key or name not in lnames \
                else name + suffix
            cols[out] = _gather(right.column(name), ri)
        return Block(cols)
    for name in lnames:
        cols[name] = _gather(left.column(name), li)
    if how == "full outer":
        # the key is coalesced: a right-only row takes the right's key
        keys = [(_py(left.column(key)[i]) if i is not None
                 else _py(right.column(key)[j])) for i, j in zip(li, ri)]
        cols[key] = _column_from_values(keys)
    for name in right.column_names:
        if name == key:
            continue
        out = name + suffix if name in lnames else name
        cols[out] = _gather(right.column(name), ri)
    return Block(cols, num_rows=len(li))
