"""Device mesh with named parallelism axes (counterpart of
``ray_tpu/parallel/mesh.py``).

JAX's ``jax.sharding.Mesh`` over named axes becomes a ``torch.distributed``
``DeviceMesh`` over the same six names, one rank a device:

  dp    data parallel (gradient all-reduce)
  fsdp  sharded data parallel (weight all-gather / grad reduce-scatter)
  pp    pipeline parallel
  tp    tensor parallel (Megatron-style within-layer sharding)
  sp    sequence/context parallel
  ep    expert parallel

A ``PartitionSpec`` becomes a DTensor placement list (``placements``): mesh
dim ``a`` holds ``Shard(i)`` when tensor dim ``i`` names ``a``, else
``Replicate()``. The DTensors themselves live on ``active_mesh(mesh)``, the
axes of more than one rank: DTensor's sharding propagation enumerates
strategies over every mesh dim, and the first matmul of a new shape costs
about ten times more host time for each dim the mesh has, every dim of
size 1 included (``python -m ray_tpu_torch.profile_mesh``: over a minute
on six dims on the CPU). A size-1 axis shards nothing, so dropping it
changes no layout.

The logical-axis rules (``DEFAULT_RULES``) and ``logical_to_spec`` are
JAX's, so a family declares its sharding once, by the same names in both
packages. GSPMD's propagation becomes DTensor's;
``shard_constraint`` is a ``redistribute``, and ``shard_map_compat`` runs a
function on each rank's local shards (``local_map``).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import (DTensor, Partial, Placement,
                                      Replicate, Shard)
from torch.distributed.tensor.experimental import local_map

from ray_tpu_torch._device import DeviceLike, resolve_device

# outer -> inner order; the inner axes are the closest ranks
DEFAULT_AXIS_ORDER = ("pp", "dp", "fsdp", "sp", "tp", "ep")

Spec = Tuple[object, ...]


@dataclass(frozen=True)
class MeshSpec:
    """Sizes for each named parallelism axis (1 = unused but present)."""

    dp: int = 1
    fsdp: int = 1
    pp: int = 1
    tp: int = 1
    sp: int = 1
    ep: int = 1

    @property
    def num_devices(self) -> int:
        return self.dp * self.fsdp * self.pp * self.tp * self.sp * self.ep

    def sizes(self) -> Dict[str, int]:
        return {"pp": self.pp, "dp": self.dp, "fsdp": self.fsdp,
                "sp": self.sp, "tp": self.tp, "ep": self.ep}

    @staticmethod
    def auto(num_devices: int, *, tp: int = 1, pp: int = 1, sp: int = 1,
             ep: int = 1, fsdp: int = 1) -> "MeshSpec":
        """Fill dp with whatever is left after the explicit axes."""
        used = tp * pp * sp * ep * fsdp
        if num_devices % used != 0:
            raise ValueError(
                f"{num_devices} devices not divisible by tp*pp*sp*ep*fsdp="
                f"{used}")
        return MeshSpec(dp=num_devices // used, fsdp=fsdp, pp=pp, tp=tp,
                        sp=sp, ep=ep)


def build_mesh(spec: MeshSpec, devices: Optional[Sequence[int]] = None,
               axis_order: Tuple[str, ...] = DEFAULT_AXIS_ORDER,
               device: DeviceLike = None) -> DeviceMesh:
    """A ``DeviceMesh`` with all six named axes (size-1 axes included), the
    ranks ``devices`` (default: every rank of the group) laid out row-major
    as JAX reshapes its device list. ``device`` is the card (``None``) or
    ``"cpu"``. With no process group and a one-rank spec, a world-size-1
    group is started in this process (NCCL on the card, gloo on the CPU);
    a larger spec needs the ranks started first (``initialize_multihost``
    under ``torchrun``, or ``spawn_ranks``)."""
    from ray_tpu_torch.parallel.multihost import init_single_process

    dev = resolve_device(device)
    if not dist.is_initialized():
        if spec.num_devices != 1:
            raise ValueError(
                f"mesh spec needs {spec.num_devices} ranks (={spec.sizes()})"
                " and no process group is running: start the ranks with "
                "torchrun + initialize_multihost, or spawn_ranks")
        init_single_process(dev)
    ranks = (list(range(dist.get_world_size())) if devices is None
             else [int(r) for r in devices])
    if spec.num_devices != len(ranks):
        raise ValueError(
            f"mesh spec needs {spec.num_devices} devices "
            f"(={spec.sizes()}), got {len(ranks)}")
    sizes = spec.sizes()
    shape = tuple(sizes[a] for a in axis_order)
    return DeviceMesh(dev.type, torch.tensor(ranks).reshape(shape),
                      mesh_dim_names=tuple(axis_order))


def mesh_from_string(desc: str, devices: Optional[Sequence[int]] = None,
                     device: DeviceLike = None) -> DeviceMesh:
    """Build a mesh from 'dp=2,tp=2,sp=2' style descriptions."""
    kwargs: Dict[str, int] = {}
    for part in desc.replace(" ", "").split(","):
        if not part:
            continue
        k, _, v = part.partition("=")
        kwargs[k] = int(v)
    return build_mesh(MeshSpec(**kwargs), devices, device=device)


def axis_size(mesh: Optional[DeviceMesh], name: str) -> int:
    """The size of mesh axis ``name`` (1 without a mesh or when the mesh
    leaves the axis out; JAX's ``mesh.shape.get(name, 1)``)."""
    if mesh is None or name not in (mesh.mesh_dim_names or ()):
        return 1
    return mesh.size(mesh.mesh_dim_names.index(name))


@functools.lru_cache(maxsize=16)
def active_mesh(mesh: DeviceMesh) -> DeviceMesh:
    """The sub-mesh of ``mesh``'s axes that have more than one rank (its
    first axis when none has), in mesh order: where the port's DTensors
    live. Every function of this module that takes a mesh works on it."""
    names = tuple(mesh.mesh_dim_names or ())
    if mesh.ndim == 1 or not names:
        return mesh
    keep = tuple(n for n in names if axis_size(mesh, n) > 1) or names[:1]
    if keep == names:
        return mesh
    return mesh[keep[0]] if len(keep) == 1 else mesh[keep]


# ---------------------------------------------------------------------------
# Logical axis rules: map tensor-dimension names to mesh axes.
# ---------------------------------------------------------------------------

# Megatron-style sharding vocabulary for transformer weights/activations.
DEFAULT_RULES: Dict[str, Optional[object]] = {
    # activations
    "batch": ("dp", "fsdp"),   # batch dim sharded over data axes
    "seq": "sp",               # sequence dim sharded for context parallelism
    "embed": None,             # activation embed dim replicated
    "heads": "tp",             # attention heads over tensor axis
    "kv_heads": "tp",
    "head_dim": None,
    # weights
    "embed_in": "fsdp",        # weight embed dim sharded for ZeRO/FSDP
    "mlp": "tp",               # FFN hidden over tensor axis
    "vocab": "tp",             # embedding/LM-head vocab over tensor axis
    "experts": "ep",           # MoE expert dim
    "stages": "pp",            # stacked pipeline stage dim
}


def logical_to_spec(names: Sequence[Optional[str]],
                    rules: Optional[Dict] = None) -> Spec:
    """('batch','seq','embed') -> (('dp','fsdp'), 'sp', None): JAX's
    ``PartitionSpec`` as a plain tuple, one entry per tensor dim."""
    rules = {**DEFAULT_RULES, **(rules or {})}
    out = []
    for name in names:
        if name is None:
            out.append(None)
        else:
            if name not in rules:
                raise KeyError(f"no sharding rule for logical axis {name!r}")
            out.append(rules[name])
    return tuple(out)


def placements(mesh: DeviceMesh, spec: Spec,
               shape: Optional[Sequence[int]] = None) -> List[Placement]:
    """A spec (``logical_to_spec``'s tuple) as DTensor placements on
    ``active_mesh(mesh)``: ``Shard(i)`` on each mesh dim that tensor dim
    ``i`` names, ``Replicate()`` on the others. A tuple entry shards one
    dim over several axes, the first the major one, as JAX's
    ``PartitionSpec``.

    Raises as JAX does on a mesh axis named twice or unknown, and, given
    ``shape``, on a dim the axis sizes do not divide (DTensor itself would
    shard it unevenly)."""
    full = tuple(mesh.mesh_dim_names or ())
    mesh = active_mesh(mesh)
    names = tuple(mesh.mesh_dim_names or ())
    out: List[Placement] = [Replicate() for _ in names]
    used: Dict[str, int] = {}
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        where = []
        for axis in axes:
            if axis not in full and axis not in DEFAULT_AXIS_ORDER:
                raise ValueError(f"spec {spec}: no mesh axis {axis!r} in "
                                 f"{full}")
            if axis in used:
                raise ValueError(f"spec {spec}: mesh axis {axis!r} is named "
                                 f"twice (dims {used[axis]} and {dim})")
            used[axis] = dim
            if axis in names:           # an axis of size 1 shards nothing
                where.append(names.index(axis))
        if where != sorted(where):
            # DTensor nests the shards of one dim in mesh-dim order
            raise ValueError(f"spec {spec}: the axes {axes} of dim {dim} "
                             f"must follow the mesh order {names}")
        if shape is not None:
            n = 1
            for i in where:
                n *= mesh.size(i)
            if shape[dim] % n:
                raise ValueError(
                    f"spec {spec}: dim {dim} of shape {tuple(shape)} is not "
                    f"divisible by the {n} shards of {axes}")
        for i in where:
            out[i] = Shard(dim)
    return out


def named_sharding(mesh: DeviceMesh, *names: Optional[str],
                   rules: Optional[Dict] = None,
                   shape: Optional[Sequence[int]] = None) -> List[Placement]:
    """The placements of logical axis names on ``mesh`` (JAX's
    ``NamedSharding(mesh, logical_to_spec(names))``)."""
    return placements(mesh, logical_to_spec(names, rules), shape)


def shard_constraint(x: DTensor, mesh: DeviceMesh, *names: Optional[str],
                     rules: Optional[Dict] = None) -> DTensor:
    """``with_sharding_constraint`` by logical axis names: ``x`` moved to
    those placements (no-op where it already has them)."""
    if not isinstance(x, DTensor):
        raise TypeError(f"shard_constraint takes a DTensor, got "
                        f"{type(x).__name__}")
    want = named_sharding(mesh, *names, rules=rules, shape=x.shape)
    if tuple(x.placements) == tuple(want):
        return x
    return x.redistribute(active_mesh(mesh), want)


def replicated(mesh: DeviceMesh) -> List[Placement]:
    return [Replicate() for _ in range(active_mesh(mesh).ndim)]


def summed_over(mesh: DeviceMesh, pl: Sequence[Placement],
                axes: Sequence[str]) -> List[Placement]:
    """``pl`` with ``Partial()`` on the mesh dims of ``axes`` where ``pl``
    replicates: the placements of a gradient computed on local shards
    whose ranks along those axes each saw their own share of the data (the
    sum ``shard_map``'s transpose takes over an axis a spec leaves out)."""
    names = active_mesh(mesh).mesh_dim_names
    return [Partial() if n in axes and p == Replicate() else p
            for n, p in zip(names, pl)]


def local_mesh_devices(n: Optional[int] = None) -> List[int]:
    """Ranks for a mesh; n=None -> every rank of the process group."""
    ranks = list(range(dist.get_world_size()))
    return ranks if n is None else ranks[:n]


def distribute(x: torch.Tensor, mesh: DeviceMesh,
               pl: Sequence[Placement]) -> DTensor:
    """A DTensor of the global value ``x`` (the same on every rank) with
    placements ``pl``: each rank keeps its own chunk, and nothing moves
    between ranks (``distribute_tensor`` would scatter from rank 0)."""
    mesh = active_mesh(mesh)
    coord = mesh.get_coordinate()
    local = x
    for mesh_dim, p in enumerate(pl):
        if isinstance(p, Shard):
            n = mesh.size(mesh_dim)
            if local.shape[p.dim] % n:
                raise ValueError(f"dim {p.dim} of shape {tuple(x.shape)} is "
                                 f"not divisible by {n} shards")
            local = local.chunk(n, dim=p.dim)[coord[mesh_dim]]
        elif not isinstance(p, Replicate):
            raise ValueError(f"distribute: no placement {p} for a global "
                             "value")
    return DTensor.from_local(local.contiguous(), mesh, list(pl),
                              run_check=False, shape=x.shape,
                              stride=x.contiguous().stride())


def shard_map_compat(fn: Callable, mesh: DeviceMesh, in_specs, out_specs,
                     in_grad_specs=None) -> Callable:
    """``fn`` run on each rank's local shards (JAX's ``shard_map``): the
    DTensor arguments are first moved to ``in_specs`` (placement lists;
    ``None`` for an argument that is not a DTensor), ``fn`` sees their
    local tensors and its outputs are wrapped with ``out_specs`` (a
    ``Partial()`` there is a sum over that axis still to do, JAX's psum
    left to the next constraint). ``in_grad_specs`` are the placements of
    the inputs' gradients where they differ from ``in_specs``, such as
    ``Partial()`` over an axis whose ranks each saw part of the batch."""
    mesh = active_mesh(mesh)
    mapped = local_map(fn, out_placements=out_specs, in_placements=in_specs,
                       in_grad_placements=in_grad_specs, device_mesh=mesh)

    def call(*args):
        moved = tuple(
            a.redistribute(mesh, spec) if isinstance(a, DTensor)
            and tuple(a.placements) != tuple(spec) else a
            for a, spec in zip(args, in_specs))
        return mapped(*moved)

    return call
