"""Cross-process device objects: the tensor wire format (counterpart of
``ray_tpu/_private/device_objects.py``).

Within one process the object store keeps a live CUDA tensor in its device
tier and consumers get it with no copy (``_private/object_store.py``). Only
when a value crosses a PROCESS boundary (driver -> worker process and back)
does it pass through here: a tensor travels as **(host bytes, dtype, shape,
device)** and the consumer rebuilds it on that device when it has one, else
on the CPU. A worker process has the card hidden
(``_private/platform.py``), so it gets CPU tensors, as JAX's CPU-pinned
worker gets its one CPU device.

A ``DTensor`` also carries its mesh shape, dimension names, device type and
placements. The consumer rebuilds it on an equivalent local mesh when its
process group has exactly that many ranks (every rank loads together, as
with any DTensor collective), and as a plain tensor otherwise; JAX's
``NamedSharding`` round trip. A ``Partial`` placement travels reduced, as
``Replicate``. Reading a DTensor whose mesh spans several ranks gathers it
(``full_tensor``), so every rank of the mesh must dump it together.

The reducer is scoped to the wire's pickler and never registered in
``copyreg``: ``pickle`` and ``copy.deepcopy`` of a tensor elsewhere keep
torch's own semantics.

The process router dumps a task's or an actor's payload with
``host_only=True``: the pickler then raises :class:`DeviceValue` where it
meets a tensor or a ``torch.device`` off the CPU, wherever it sits (an
argument, a module's parameters, a dataclass, a function's closure or
globals). A worker process sees only the CPU, so such work stays in the
driver, the one process that owns the card.
"""

from __future__ import annotations

import io
import sys
import threading
from typing import Any, Dict, Optional, Tuple

_MESHES: Dict[Tuple, Any] = {}
_MESHES_LOCK = threading.Lock()


def _dtensor_type():
    """The DTensor class, if torch's DTensor module is loaded (no DTensor
    can exist before it is)."""
    mod = sys.modules.get("torch.distributed.tensor")
    return getattr(mod, "DTensor", None) if mod is not None else None


def is_tensor(obj: Any) -> bool:
    """True for a plain strided ``torch.Tensor`` or a ``DTensor``; cheap for
    every other value (no torch import). Subclasses such as
    ``nn.Parameter`` keep their own reduce, which reaches their data as a
    plain tensor."""
    torch = sys.modules.get("torch")
    if torch is None:
        return False
    t = type(obj)
    if t is torch.Tensor:
        return obj.layout == torch.strided
    dt = _dtensor_type()
    return dt is not None and t is dt


class DeviceValue(Exception):
    """A value dumped with ``host_only`` names a device other than the
    CPU."""


def _off_host_device(obj: Any):
    """The device a tensor or a ``torch.device`` names when it is not the
    CPU, else None."""
    torch = sys.modules.get("torch")
    if torch is None:
        return None
    if type(obj) is torch.device:
        device = obj
    elif is_tensor(obj):
        device = obj.device
    else:
        return None
    return device if device.type != "cpu" else None


def tensor_reduce(obj) -> Tuple:
    """The (callable, args) reduce tuple for a tensor: the single
    definition every port pickler that may carry user values shares."""
    return (rebuild_tensor, (reduce_tensor(obj),))


def wire_dumps(value: Any, buffer_callback=None,
               host_only: bool = False) -> bytes:
    """Pickle ``value`` with the by-value pickler and this tensor reducer,
    scoped to this pickler only. Every port boundary that carries user
    values across a process dumps through here. With ``buffer_callback``
    large contiguous buffers (numpy arrays, tensors' host bytes) go out of
    band, protocol 5's way. With ``host_only`` a tensor or device off the
    CPU raises :class:`DeviceValue` instead of crossing as host bytes."""
    buf = io.BytesIO()
    pickler = _wire_pickler()(buf, buffer_callback=buffer_callback)
    pickler.host_only = host_only
    pickler.dump(value)
    return buf.getvalue()


_WIRE_PICKLER = []


def _wire_pickler():
    if not _WIRE_PICKLER:
        from ray_tpu_torch._private.serialization import ByValuePickler

        class _WirePickler(ByValuePickler):
            host_only = False

            def reducer_override(self, obj):
                if self.host_only:
                    device = _off_host_device(obj)
                    if device is not None:
                        raise DeviceValue(
                            f"{type(obj).__name__} on {device}")
                if is_tensor(obj):
                    return tensor_reduce(obj)
                return super().reducer_override(obj)

        _WIRE_PICKLER.append(_WirePickler)
    return _WIRE_PICKLER[0]


def wire_loads(blob) -> Any:
    import pickle
    return pickle.loads(blob)


def _placement_to_wire(p) -> Tuple:
    name = type(p).__name__
    if name == "Shard":
        return ("shard", int(p.dim))
    return ("replicate",)       # Replicate, and Partial once reduced


def _placement_from_wire(w):
    from torch.distributed.tensor import Replicate, Shard
    return Shard(w[1]) if w[0] == "shard" else Replicate()


def reduce_tensor(t) -> Tuple:
    """(host bytes as a flat uint8 array, dtype name, shape, device,
    requires_grad, mesh meta or None)."""
    import torch

    meta: Optional[Tuple] = None
    dt = _dtensor_type()
    if dt is not None and isinstance(t, dt):
        mesh = t.device_mesh
        meta = ("mesh", tuple(mesh.mesh.shape),
                tuple(mesh.mesh_dim_names or ()), mesh.device_type,
                tuple(_placement_to_wire(p) for p in t.placements))
        t = t.full_tensor()
    requires_grad = bool(t.requires_grad)
    t = t.detach()
    device = str(t.device)
    host = t.contiguous().cpu()     # device -> host copy (one transfer)
    raw = host.reshape(-1).view(torch.uint8).numpy()
    return (raw, str(host.dtype).replace("torch.", ""), tuple(host.shape),
            device, requires_grad, meta)


def _local_device(device: str) -> str:
    """``device`` when this process has it, else ``"cpu"``."""
    if device.startswith("cuda"):
        import torch
        if torch.cuda.is_available():
            index = int(device.split(":")[1]) if ":" in device else 0
            if index < torch.cuda.device_count():
                return device
    return "cpu"


def _local_mesh(mesh_shape: Tuple, dim_names: Tuple, device_type: str):
    """An equivalent mesh over this process group, or None."""
    import torch.distributed as dist

    need = 1
    for n in mesh_shape:
        need *= n
    if not (dist.is_available() and dist.is_initialized()
            and dist.get_world_size() == need):
        return None
    if device_type == "cuda" and _local_device("cuda") == "cpu":
        return None
    key = (mesh_shape, dim_names, device_type)
    with _MESHES_LOCK:
        mesh = _MESHES.get(key)
        if mesh is None or mesh.get_coordinate() is None:
            from torch.distributed.device_mesh import init_device_mesh
            mesh = init_device_mesh(device_type, mesh_shape,
                                    mesh_dim_names=dim_names or None)
            _MESHES[key] = mesh
    return mesh


def rebuild_tensor(payload: Tuple):
    """Rebuild on the consumer: on the tensor's device when this process
    has it (on an equivalent mesh for a DTensor), else on the CPU."""
    import torch

    raw, dtype_name, shape, device, requires_grad, meta = payload
    if not raw.flags.writeable:
        raw = raw.copy()            # an out-of-band buffer may be read-only
    t = torch.from_numpy(raw).view(getattr(torch, dtype_name)).reshape(shape)
    mesh = _local_mesh(*meta[1:4]) if meta is not None else None
    if mesh is not None:
        from torch.distributed.tensor import distribute_tensor
        placements = [_placement_from_wire(w) for w in meta[4]]
        t = t.to("cpu" if mesh.device_type == "cpu" else
                 torch.device("cuda", torch.cuda.current_device()))
        # every rank holds the whole value: shard locally, no scatter
        out = distribute_tensor(t, mesh, placements, src_data_rank=None)
    else:
        out = t.to(_local_device(device))
    if requires_grad:
        out.requires_grad_(True)
    return out
