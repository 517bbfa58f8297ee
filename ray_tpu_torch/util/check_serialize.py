"""Serializability inspector (counterpart of
``ray_tpu/util/check_serialize.py``): walks closures and attributes to find
the leaves that fail to pickle.

What it inspects is what goes to a worker process: the port's by-value
pickler (``_private/serialization.py``; JAX's is ``cloudpickle``), which
carries lambdas, closures and classes defined in functions by value.
"""

from __future__ import annotations

import inspect
from typing import Any, List, Set, Tuple

from ray_tpu_torch._private import serialization


class FailureTuple:
    def __init__(self, obj: Any, name: str, parent: Any):
        self.obj = obj
        self.name = name
        self.parent = parent

    def __repr__(self):
        return f"FailureTuple(obj={self.name!r}, parent={self.parent!r})"


def _check(obj: Any, name: str, parent: Any, failures: List[FailureTuple],
           seen: Set[int], depth: int) -> bool:
    try:
        serialization.dumps(obj)
        return True
    except Exception:
        pass
    if id(obj) in seen or depth > 4:
        return False
    seen.add(id(obj))
    found_leaf = False
    # descend into closures
    if inspect.isfunction(obj) and obj.__closure__:
        for var, cell in zip(obj.__code__.co_freevars, obj.__closure__):
            try:
                inner = cell.cell_contents
            except ValueError:
                continue
            if not _check(inner, var, name, failures, seen, depth + 1):
                found_leaf = True
    # descend into attributes / dict values
    attrs = {}
    if hasattr(obj, "__dict__") and isinstance(obj.__dict__, dict):
        attrs = obj.__dict__
    elif isinstance(obj, dict):
        attrs = obj
    for key, val in list(attrs.items())[:64]:
        try:
            serialization.dumps(val)
        except Exception:
            if not _check(val, str(key), name, failures, seen, depth + 1):
                found_leaf = True
    if not found_leaf:
        failures.append(FailureTuple(obj, name, parent))
    return False


def inspect_serializability(obj: Any, name: str = "obj"
                            ) -> Tuple[bool, List[FailureTuple]]:
    """Returns (is_serializable, failure_leaves)."""
    failures: List[FailureTuple] = []
    ok = _check(obj, name, None, failures, set(), 0)
    return ok, failures
