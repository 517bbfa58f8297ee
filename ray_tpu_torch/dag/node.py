"""DAG node types (counterpart of ``ray_tpu/dag/node.py``)."""

from __future__ import annotations

import itertools
from typing import Any, Dict, List, Optional, Tuple


class DAGNode:
    _ids = itertools.count()

    def __init__(self, args: Tuple = (), kwargs: Optional[Dict] = None):
        self.id = next(DAGNode._ids)
        self.args = args
        self.kwargs = kwargs or {}

    def upstream(self) -> List["DAGNode"]:
        out = []
        for a in list(self.args) + list(self.kwargs.values()):
            if isinstance(a, DAGNode):
                out.append(a)
        return out

    # -- execution --------------------------------------------------------
    def execute(self, *input_args, **input_kwargs):
        """Dynamic execution: walk the DAG, submit tasks, return the final
        ObjectRef(s)."""
        from ray_tpu_torch.dag.compiled import _execute_dag
        return _execute_dag(self, input_args, input_kwargs)

    def experimental_compile(self, *,
                             buffer_size_bytes: int = 1 << 20
                             ) -> "CompiledDAG":
        from ray_tpu_torch.dag.compiled import CompiledDAG
        return CompiledDAG(self, buffer_size_bytes=buffer_size_bytes)

    # -- traversal --------------------------------------------------------
    def topo_sort(self) -> List["DAGNode"]:
        seen: Dict[int, DAGNode] = {}
        order: List[DAGNode] = []

        def visit(node: DAGNode):
            if node.id in seen:
                return
            seen[node.id] = node
            for up in node.upstream():
                visit(up)
            order.append(node)

        visit(self)
        return order


class InputNode(DAGNode):
    """Placeholder for the value passed at execute() time. Supports
    ``with InputNode() as inp:``."""

    def __init__(self):
        super().__init__()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


class FunctionNode(DAGNode):
    def __init__(self, remote_function, args, kwargs):
        super().__init__(args, kwargs)
        self.remote_function = remote_function

    def __repr__(self):
        return f"FunctionNode({self.remote_function._function_name})"


class ClassMethodNode(DAGNode):
    def __init__(self, actor_handle, method_name: str, args, kwargs):
        super().__init__(args, kwargs)
        self.actor_handle = actor_handle
        self.method_name = method_name

    def __repr__(self):
        return f"ClassMethodNode({self.method_name})"


class MultiOutputNode(DAGNode):
    def __init__(self, outputs: List[DAGNode]):
        super().__init__(tuple(outputs), {})
