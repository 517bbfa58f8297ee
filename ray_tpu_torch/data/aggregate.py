"""Aggregation functions (counterpart of ``ray_tpu/data/aggregate.py``;
reference: `python/ray/data/aggregate.py`). A column is read as
``Block.to_numpy`` gives it, the counterpart of pyarrow's
``to_numpy(zero_copy_only=False)``."""

from __future__ import annotations

from typing import Optional

import numpy as np


class AggregateFn:
    name: str = "agg"

    def compute(self, block) -> float:
        raise NotImplementedError

    def _col(self, block, on: Optional[str]):
        if on is None:
            on = block.column_names[0]
        return block.to_numpy(on)


class Count(AggregateFn):
    def __init__(self, on: Optional[str] = None):
        self.on = on
        self.name = "count()"

    def compute(self, block):
        return int(block.num_rows)


class Sum(AggregateFn):
    def __init__(self, on: Optional[str] = None):
        self.on = on
        self.name = f"sum({on or ''})"

    def compute(self, block):
        return self._col(block, self.on).sum()


class Min(AggregateFn):
    def __init__(self, on: Optional[str] = None):
        self.on = on
        self.name = f"min({on or ''})"

    def compute(self, block):
        return self._col(block, self.on).min()


class Max(AggregateFn):
    def __init__(self, on: Optional[str] = None):
        self.on = on
        self.name = f"max({on or ''})"

    def compute(self, block):
        return self._col(block, self.on).max()


class Mean(AggregateFn):
    def __init__(self, on: Optional[str] = None):
        self.on = on
        self.name = f"mean({on or ''})"

    def compute(self, block):
        return float(self._col(block, self.on).mean())


class Std(AggregateFn):
    def __init__(self, on: Optional[str] = None, ddof: int = 1):
        self.on = on
        self.ddof = ddof
        self.name = f"std({on or ''})"

    def compute(self, block):
        return float(np.std(self._col(block, self.on), ddof=self.ddof))
