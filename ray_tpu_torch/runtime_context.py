"""Runtime context — the reference's import path (``ray_tpu.runtime_context``)
re-exporting the implementation."""

from ray_tpu_torch._private.runtime_context import (RuntimeContext,
                                                    get_runtime_context)

__all__ = ["RuntimeContext", "get_runtime_context"]
