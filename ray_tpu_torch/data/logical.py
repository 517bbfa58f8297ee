"""Logical plan + rule-based optimizer (counterpart of
``ray_tpu/data/logical.py``, the same code).

Reference: `python/ray/data/_internal/logical/` — lazy Dataset builds a
LogicalPlan DAG; rules (notably operator fusion) rewrite it before the
planner produces physical operators (`planner/planner.py:171`,
`logical/optimizers.py`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple


@dataclasses.dataclass
class LogicalOp:
    name: str
    inputs: List["LogicalOp"]

    def chain(self) -> List["LogicalOp"]:
        """Linear chains only (union/zip handled by the planner)."""
        out: List[LogicalOp] = []
        node: Optional[LogicalOp] = self
        while node is not None:
            out.append(node)
            node = node.inputs[0] if node.inputs else None
        return list(reversed(out))


@dataclasses.dataclass
class InputData(LogicalOp):
    """Materialized input block refs."""
    block_refs: List[Any] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class Read(LogicalOp):
    """Datasource read: list of zero-arg task fns, each producing a block."""
    read_tasks: List[Callable] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class MapBatches(LogicalOp):
    fn: Callable = None
    batch_format: str = "numpy"
    fn_constructor: Optional[Callable] = None   # actor-pool (stateful) map
    concurrency: Optional[Tuple[int, int]] = None
    batch_size: Optional[int] = None


@dataclasses.dataclass
class MapRows(LogicalOp):
    fn: Callable = None
    kind: str = "map"          # map | filter | flat_map


@dataclasses.dataclass
class AllToAll(LogicalOp):
    kind: str = "repartition"  # repartition | shuffle | sort
    num_outputs: Optional[int] = None
    key: Optional[str] = None
    descending: bool = False
    seed: Optional[int] = None


@dataclasses.dataclass
class Limit(LogicalOp):
    limit: int = 0


@dataclasses.dataclass
class Union(LogicalOp):
    pass


@dataclasses.dataclass
class Zip(LogicalOp):
    pass


@dataclasses.dataclass
class Join(LogicalOp):
    key: Optional[str] = None
    how: str = "inner"
    num_partitions: Optional[int] = None


@dataclasses.dataclass
class Aggregate(LogicalOp):
    key: Optional[str] = None
    aggs: List[Any] = dataclasses.field(default_factory=list)
    map_groups_fn: Optional[Callable] = None
    batch_format: str = "numpy"


# ---------------------------------------------------------------------------
# Optimizer
# ---------------------------------------------------------------------------

def optimize(root: LogicalOp) -> LogicalOp:
    """Apply rewrite rules bottom-up. Today: row-op → batch-op lowering is
    done in the planner; the key rule here is map fusion (reference
    `logical/rules/operator_fusion.py`): adjacent stateless maps execute as
    one task, halving object-store traffic."""
    root = _fuse_maps(root)
    return root


def _fusable(op: LogicalOp) -> bool:
    return (isinstance(op, (MapRows,))
            or (isinstance(op, MapBatches) and op.fn_constructor is None))


def _fuse_maps(op: LogicalOp) -> LogicalOp:
    if op.inputs:
        op.inputs = [_fuse_maps(i) for i in op.inputs]
    child = op.inputs[0] if op.inputs else None
    if child is not None and _fusable(op) and _fusable(child):
        fused = FusedMap(
            name=f"{child.name}->{op.name}", inputs=child.inputs,
            stages=(_stages(child) + _stages(op)))
        return fused
    return op


@dataclasses.dataclass
class FusedMap(LogicalOp):
    stages: List[LogicalOp] = dataclasses.field(default_factory=list)


def _stages(op: LogicalOp) -> List[LogicalOp]:
    return list(op.stages) if isinstance(op, FusedMap) else [op]
