"""Static DAGs over tasks and actors, compiled or dynamic (counterpart of
``ray_tpu/dag``).

DAG nodes are built with ``.bind()`` on remote functions and actor
methods, executed dynamically (``execute``: one task submit a node) or
compiled (``experimental_compile``) into a static schedule over
pre-allocated channels: in-process slots between in-process actors, or
one shared-memory buffer per edge between process-worker actors.
Accelerator dataflow between ranks belongs to the parallel layer
(``ray_tpu_torch.parallel``); this is the host-level capability.
"""

from ray_tpu_torch.dag.node import (ClassMethodNode, DAGNode,
                                    FunctionNode, InputNode,
                                    MultiOutputNode)
from ray_tpu_torch.dag.compiled import CompiledDAG

__all__ = ["InputNode", "DAGNode", "FunctionNode", "ClassMethodNode",
           "MultiOutputNode", "CompiledDAG"]
