"""ray_tpu_torch — the PyTorch/CUDA port of ``ray_tpu`` for one NVIDIA H100.

The JAX package ``ray_tpu`` stays the reference; each module here keeps the
name and layout of its counterpart there, so ``ray_tpu_torch/x/y.py`` ports
``ray_tpu/x/y.py``. The port imports ``torch`` and ``numpy`` only — never
``jax`` and nothing of ``ray_tpu``; what it needs from a JAX-free module of the
reference it carries as its own copy.

Entry points take ``device=None``, which means CUDA and raises when no card is
present; only an explicit ``device="cpu"`` runs on the CPU (the tests do).

Ported so far: the serving slice — ``ops`` (norms, rope, the paged- and
ragged-decode attention kernels in ``csrc/``), ``models.llama`` (the KV-cache
inference paths), ``llm`` (block pool, tokenizer, continuous-batching engine,
``LLMServer``) — the single-device training slice — ``ops.attention``
(reference, blockwise and flash attention, the flash forward kernel in
``csrc/``), ``models.llama`` (``apply``, ``loss``, remat), ``train``
(``make_train_step``) and ``bench`` (``run_train``) — and the other model
families, each trained by the same ``make_train_step``: ``models.mlp``,
``models.gpt2``, ``models.vit`` and ``models.moe`` (einsum dispatch, with the
router math of ``ops.moe_dispatch``), benchmarked by ``bench.run_family`` —
and the parallel layer: ``parallel`` (the named ``DeviceMesh``, JAX's
logical-axis rules as DTensor placements, process-group bring-up and the
``spawn_ranks`` gloo launcher), the sharded ``make_train_step`` on
DTensors with each family's ``param_shardings``, the vocab-parallel
embedding, flash attention on local shards, ``train.checkpoint`` and the
``examples`` that train on a mesh — and sequence, expert and pipeline
parallelism on that mesh: ``parallel.collectives`` (JAX's ppermute,
all_to_all, psum, pmean and pvary with their transposes), ring and Ulysses
attention (``ops.ring_attention``, ``ops.ulysses``), the MoE's expert
all-to-all (``ops.moe_dispatch.expert_alltoall_ffn``), the GPipe schedule
(``parallel.pipeline``), ``models.llama_pp.PipelinedLlama`` and
``dryrun.dryrun_mesh`` — and the RL learners: ``rl`` (the numpy envs,
connectors and multi-agent runner as the port's own copies; PPO, DQN,
IMPALA/APPO, SAC, BC and offline DQN taking their gradient steps in torch
on the learner's device, optax's Adam and RMSprop in ``rl.optim``, JAX
learner state carried across by ``rl.convert``, and the data-parallel
``LearnerGroup`` over the mesh's ``dp`` axis) — and the runtime's in-process
core: tasks, actors, objects, named and detached actors (``init``,
``remote``, ``get``, ``put``, ``wait``, ``get_actor`` and the rest of
``ray_tpu``'s core API below), every task and actor running in the calling
process with the card as the ``GPU`` resource and CUDA tensors kept in the
object store's device tier, with ``rl.Algorithm`` and ``rl.tuned_examples``
on it — and serve on that core: ``serve`` (deployments, handles with
power-of-two-choices routing, the controller, the HTTP proxy) with
``util.metrics``, and the serving app (``llm.build_llm_app``,
``llm.prefix_router``, ``llm.disagg``'s prefill/decode graph) — and the
libraries on that core: ``tune`` (Tuner, schedulers, searchers) and
``util``'s ``ActorPool``, ``Queue``, ``multiprocessing.Pool`` and
``collective`` — and ``data`` on that core (blocks of numpy columns, the
streaming executor with its actor pools and hash shuffle,
``streaming_split``, the readers and writers), whose ``to_jax`` feeds the
card through pinned memory and a side stream.

Importing the package imports no ``torch``: the runtime checks for tensors
only once ``torch`` is in ``sys.modules``, and detects the card at ``init``.
"""

from __future__ import annotations

import inspect as _inspect
from typing import Any, Dict, List, Optional, Sequence, Union

from ray_tpu_torch import exceptions
from ray_tpu_torch._private import worker as _worker
from ray_tpu_torch._private.object_ref import ObjectRef
from ray_tpu_torch._private.runtime_context import get_runtime_context
from ray_tpu_torch._private.task_spec import (
    NodeAffinitySchedulingStrategy, NodeLabelSchedulingStrategy,
    PlacementGroupSchedulingStrategy)
from ray_tpu_torch.actor import (ActorClass, ActorHandle, exit_actor,
                                 get_actor)
from ray_tpu_torch.remote_function import ObjectRefGenerator, RemoteFunction

__all__ = [
    "init", "shutdown", "is_initialized", "remote", "get", "put", "wait",
    "kill", "cancel", "get_actor", "get_runtime_context", "ObjectRef",
    "ObjectRefGenerator", "ActorHandle", "exit_actor", "cluster_resources",
    "available_resources", "nodes", "exceptions", "method",
    "NodeAffinitySchedulingStrategy", "NodeLabelSchedulingStrategy",
    "PlacementGroupSchedulingStrategy",
]


def init(num_nodes: int = 1,
         resources: Optional[Dict[str, float]] = None,
         object_store_memory: int = 2 * 1024 ** 3,
         namespace: Optional[str] = None,
         ignore_reinit_error: bool = False,
         _system_config: Optional[Dict[str, Any]] = None
         ) -> "_worker.Runtime":
    """Start the runtime with ``num_nodes`` virtual nodes in this process.

    ``resources=None`` detects this host's: its CPUs, and its CUDA cards as
    ``GPU`` when it has any. ``_system_config`` overrides flags of the table
    in ``ray_tpu_torch/_private/config.py``; an unknown flag raises."""
    if _worker.global_runtime() is not None:
        if ignore_reinit_error:
            return _worker.global_runtime()
        raise RuntimeError("ray_tpu_torch.init() called twice "
                           "(use ignore_reinit_error=True to allow)")
    from ray_tpu_torch._private.config import apply_system_config
    apply_system_config(_system_config)
    return _worker.init_runtime(
        num_nodes=num_nodes, resources_per_node=resources,
        object_store_memory=object_store_memory, namespace=namespace)


def shutdown() -> None:
    _worker.shutdown_runtime()


def is_initialized() -> bool:
    return _worker.global_runtime() is not None


def _make_remote(obj, options: Dict[str, Any]):
    if _inspect.isclass(obj):
        return ActorClass(obj, options)
    if callable(obj):
        return RemoteFunction(obj, options)
    raise TypeError("@remote decorates a function or a class, "
                    f"got {type(obj).__name__}")


def remote(*args, **kwargs):
    """``@remote`` / ``@remote(**options)`` decorator for tasks and actors."""
    if len(args) == 1 and not kwargs and (callable(args[0])
                                          or _inspect.isclass(args[0])):
        return _make_remote(args[0], {})
    if args:
        raise TypeError("@remote takes only keyword options")
    return lambda obj: _make_remote(obj, kwargs)


def method(**options):
    """Per-method defaults on actor classes (e.g. num_returns)."""
    def decorator(m):
        m.__ray_tpu_method_options__ = options
        return m
    return decorator


def get(refs: Union[ObjectRef, Sequence[ObjectRef]],
        *, timeout: Optional[float] = None) -> Any:
    rt = _worker.global_worker()
    if isinstance(refs, ObjectRef):
        return rt.get([refs], timeout=timeout)[0]
    if isinstance(refs, (list, tuple)):
        bad = [r for r in refs if not isinstance(r, ObjectRef)]
        if bad:
            raise TypeError(f"get() expects ObjectRefs, got {type(bad[0])}")
        return rt.get(list(refs), timeout=timeout)
    raise TypeError(f"get() expects an ObjectRef or list, got {type(refs)}")


def put(value: Any) -> ObjectRef:
    return _worker.global_worker().put(value)


def wait(refs: Sequence[ObjectRef], *, num_returns: int = 1,
         timeout: Optional[float] = None, fetch_local: bool = True):
    if isinstance(refs, ObjectRef):
        raise TypeError("wait() expects a list of ObjectRefs")
    return _worker.global_worker().wait(
        list(refs), num_returns=num_returns, timeout=timeout,
        fetch_local=fetch_local)


def kill(actor: ActorHandle, *, no_restart: bool = True) -> None:
    _worker.global_worker().kill_actor(actor._ray_actor_id,
                                       no_restart=no_restart)


def cancel(ref: ObjectRef, *, force: bool = False,
           recursive: bool = True) -> None:
    _worker.global_worker().cancel(ref, force=force, recursive=recursive)


def cluster_resources() -> Dict[str, float]:
    return _worker.global_worker().cluster_resources()


def available_resources() -> Dict[str, float]:
    return _worker.global_worker().available_resources()


def nodes() -> List[Dict[str, Any]]:
    rt = _worker.global_worker()
    out = []
    for info in rt.gcs.nodes.values():
        out.append({
            "NodeID": info.node_id.hex(),
            "Alive": info.alive,
            "Draining": False,
            "Resources": dict(info.resources),
            "Labels": dict(info.labels),
        })
    return out
