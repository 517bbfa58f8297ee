"""Checkpoints: directory handles, tree (de)serialization and top-K
retention (counterpart of ``ray_tpu/train/checkpoint.py``; the JAX module
is the port's reference, this is its own copy).

A tree is nested dicts (string or integer keys), lists and tuples whose
leaves are tensors, DTensors or plain values (numbers, strings, ``None``):
the params, or ``{"params": ..., "opt": optimizer.state_dict()}``. Saving
gathers each DTensor leaf whole (``full_tensor()``, a collective every rank
joins) and rank 0 writes; the tree's shape is described in JSON by its keys
(JAX pickles its treedef). Every dtype is kept exactly: bf16, which numpy
lacks, is stored as raw bytes beside its dtype name, as JAX stores its
ml_dtypes leaves. Restoring places each leaf with given placements on a
mesh, or returns plain tensors.

On a process group of more than one rank, ``Checkpoint.from_pytree`` returns
once the files are complete on every rank (a barrier after rank 0's write);
after ``AsyncCheckpointer.save``, every rank calls ``wait_until_finished``
before any rank reads.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from ray_tpu_torch.parallel.mesh import distribute

_NUMPY_DTYPES = {torch.float32: np.float32, torch.float64: np.float64,
                 torch.float16: np.float16, torch.int64: np.int64,
                 torch.int32: np.int32, torch.int16: np.int16,
                 torch.int8: np.int8, torch.uint8: np.uint8,
                 torch.bool: np.bool_}


def _rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def _barrier() -> None:
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


class Checkpoint:
    """A handle to a checkpoint directory."""

    # async-save state (set by AsyncCheckpointer.save)
    _pending: Optional[threading.Event] = None
    _pending_error: Optional[BaseException] = None

    def __init__(self, path: str):
        self.path = os.path.abspath(path)

    def result(self, timeout: Optional[float] = None) -> "Checkpoint":
        """Wait for this rank's pending async write; raises its error if it
        failed. Synchronous checkpoints return immediately."""
        if self._pending is not None:
            if not self._pending.wait(timeout):
                raise TimeoutError(
                    f"checkpoint write to {self.path} still pending")
            if self._pending_error is not None:
                raise self._pending_error
        return self

    @classmethod
    def from_directory(cls, path: str) -> "Checkpoint":
        return cls(path)

    def to_directory(self, path: Optional[str] = None) -> str:
        if path is None or os.path.abspath(path) == self.path:
            return self.path
        os.makedirs(path, exist_ok=True)
        shutil.copytree(self.path, path, dirs_exist_ok=True)
        return path

    def __repr__(self):
        return f"Checkpoint({self.path})"

    # -- tree payloads ------------------------------------------------------
    @staticmethod
    def _gather_to_host(tree: Any) -> Tuple[Dict[str, np.ndarray], Dict]:
        """Device -> host copy of every leaf (the only part that must block
        the train step: after it, the params may be updated freely). A
        collective when the tree holds DTensors: every rank calls it."""
        arrays: Dict[str, np.ndarray] = {}

        def describe(node):
            if isinstance(node, torch.Tensor):
                t = node.full_tensor() if isinstance(node, DTensor) else node
                # a copy: the caller may update the tensor at once
                t = t.detach().to("cpu", copy=True)
                key = f"a{len(arrays)}"
                if t.dtype in _NUMPY_DTYPES:
                    arrays[key] = t.numpy()
                else:        # no numpy dtype (bf16): its raw bytes
                    arrays[key] = t.contiguous().view(-1).view(
                        torch.uint8).numpy()
                return {"leaf": key, "dtype": str(t.dtype).split(".")[-1],
                        "shape": list(t.shape)}
            if isinstance(node, dict):
                return {"dict": [[k, describe(v)] for k, v in node.items()]}
            if isinstance(node, (list, tuple)):
                kind = "list" if isinstance(node, list) else "tuple"
                return {kind: [describe(v) for v in node]}
            return {"value": node}

        return arrays, {"tree": describe(tree)}

    @staticmethod
    def _write(path: str, arrays, meta) -> None:
        os.makedirs(path, exist_ok=True)
        np.savez(os.path.join(path, "leaves.npz"), **arrays)
        with open(os.path.join(path, "tree.json"), "w") as f:
            json.dump(meta, f)

    @staticmethod
    def from_pytree(tree: Any, path: Optional[str] = None) -> "Checkpoint":
        """Save a tree (params, optimizer state, ...) to a directory; on a
        process group every rank calls it with the same ``path``."""
        path = path or tempfile.mkdtemp(prefix="ray_tpu_torch_ckpt_")
        arrays, meta = Checkpoint._gather_to_host(tree)
        if _rank() == 0:
            Checkpoint._write(path, arrays, meta)
        _barrier()
        return Checkpoint(path)

    def to_pytree(self, placements: Any = None, mesh=None,
                  device: Optional[torch.device] = None) -> Any:
        """Restore. With ``mesh``, each tensor leaf whose node in
        ``placements`` (a tree of the saved tree's shape, or a subtree
        ``None`` for plain leaves below it) is a placement list becomes a
        DTensor with those placements; other leaves are plain tensors on
        ``device`` (default: the mesh's device type, else the CPU). A pending
        async write of this rank is joined first."""
        self.result()
        with open(os.path.join(self.path, "tree.json")) as f:
            meta = json.load(f)
        data = np.load(os.path.join(self.path, "leaves.npz"))
        if device is None:
            device = torch.device(mesh.device_type if mesh is not None
                                  else "cpu")

        def build(node, pl):
            if "leaf" in node:
                dtype = getattr(torch, node["dtype"])
                arr = data[node["leaf"]]
                if dtype in _NUMPY_DTYPES:
                    t = torch.from_numpy(arr.copy())
                else:
                    t = torch.from_numpy(arr.copy()).view(dtype)
                t = t.reshape(node["shape"]).to(device)
                if mesh is not None and pl is not None:
                    return distribute(t, mesh, pl)
                return t
            if "dict" in node:
                return {k: build(v, _child(pl, k)) for k, v in node["dict"]}
            if "list" in node:
                return [build(v, _child(pl, i))
                        for i, v in enumerate(node["list"])]
            if "tuple" in node:
                return tuple(build(v, _child(pl, i))
                             for i, v in enumerate(node["tuple"]))
            return node["value"]

        return build(meta["tree"], placements)


def _child(pl, key):
    """The placements below ``key``: ``None`` stays ``None``; a placement
    list is a leaf's and has no children."""
    if pl is None:
        return None
    return pl[key]


class CheckpointManager:
    """Top-K checkpoint retention with score-based eviction."""

    def __init__(self, root: str, num_to_keep: Optional[int] = None,
                 score_attribute: Optional[str] = None,
                 score_order: str = "max"):
        self.root = root
        self.num_to_keep = num_to_keep
        self.score_attribute = score_attribute
        self.score_order = score_order
        os.makedirs(root, exist_ok=True)
        self._entries: List[Tuple[float, str, Dict]] = []
        self._counter = 0

    def register(self, checkpoint: Checkpoint,
                 metrics: Optional[Dict] = None) -> str:
        """Copy a checkpoint under management; returns the managed path."""
        metrics = metrics or {}
        self._counter += 1
        dest = os.path.join(self.root, f"checkpoint_{self._counter:06d}")
        checkpoint.to_directory(dest)
        with open(os.path.join(dest, "_metrics.json"), "w") as f:
            json.dump({k: v for k, v in metrics.items()
                       if isinstance(v, (int, float, str))}, f)
        score = self._score(metrics)
        self._entries.append((score, dest, metrics))
        self._evict()
        return dest

    def _score(self, metrics: Dict) -> float:
        if self.score_attribute and self.score_attribute in metrics:
            val = float(metrics[self.score_attribute])
            return val if self.score_order == "max" else -val
        return float(self._counter)  # FIFO: newest kept

    def _evict(self) -> None:
        # Entries stay in registration order (latest_checkpoint() relies
        # on it); the victim is selected with min(), not by sorting.
        if self.num_to_keep is None:
            return
        while len(self._entries) > self.num_to_keep:
            victim = min(self._entries, key=lambda e: e[0])
            self._entries.remove(victim)
            shutil.rmtree(victim[1], ignore_errors=True)

    def best_checkpoint(self) -> Optional[Checkpoint]:
        if not self._entries:
            return None
        return Checkpoint(max(self._entries, key=lambda e: e[0])[1])

    def latest_checkpoint(self) -> Optional[Checkpoint]:
        if not self._entries:
            return None
        return Checkpoint(self._entries[-1][1])

    @staticmethod
    def find_latest(root: str) -> Optional[Checkpoint]:
        """Resume support: newest checkpoint dir under ``root``."""
        if not os.path.isdir(root):
            return None
        dirs = sorted(d for d in os.listdir(root)
                      if d.startswith("checkpoint_"))
        return Checkpoint(os.path.join(root, dirs[-1])) if dirs else None


class AsyncCheckpointer:
    """Async checkpoint saves: ``save`` blocks ONLY for the device -> host
    gather (the params may be updated by the next step at once), while
    serialization and disk IO run on rank 0's background writer thread.
    ``wait_until_finished`` joins pending writes (call it before shutdown
    or before trusting the files; on a process group every rank calls it);
    errors surface there and on the returned checkpoint's ``result()``.
    """

    def __init__(self, max_pending: int = 2):
        import queue as _queue

        self._q: "_queue.Queue" = _queue.Queue(maxsize=max_pending)
        self._errors: list = []
        # pending counter under one lock: wait_until_finished must never
        # vouch for an unwritten checkpoint
        self._cond = threading.Condition()
        self._pending_count = 0

        def writer():
            while True:
                item = self._q.get()
                if item is None:
                    return
                ckpt, arrays, meta = item
                try:
                    Checkpoint._write(ckpt.path, arrays, meta)
                except BaseException as e:  # noqa: BLE001 — surfaced
                    ckpt._pending_error = e
                    with self._cond:
                        self._errors.append(e)
                finally:
                    ckpt._pending.set()
                    with self._cond:
                        self._pending_count -= 1
                        self._cond.notify_all()

        self._thread = threading.Thread(target=writer, daemon=True,
                                        name="async-ckpt-writer")
        self._thread.start()

    def save(self, tree, path: Optional[str] = None) -> Checkpoint:
        """Gather to host synchronously (every rank), enqueue rank 0's
        write, return the (pending) checkpoint handle immediately."""
        path = path or tempfile.mkdtemp(prefix="ray_tpu_torch_ckpt_")
        arrays, meta = Checkpoint._gather_to_host(tree)
        ckpt = Checkpoint(path)
        ckpt._pending = threading.Event()
        if _rank() != 0:
            ckpt._pending.set()
            return ckpt
        with self._cond:
            self._pending_count += 1
        self._q.put((ckpt, arrays, meta))
        return ckpt

    def wait_until_finished(self, timeout: Optional[float] = None) -> None:
        """Join all writes enqueued so far, then wait for every rank to get
        here; raises the FIRST error since the last call (then clears it:
        a later successful save is not poisoned by an old failure)."""
        with self._cond:
            if not self._cond.wait_for(
                    lambda: self._pending_count == 0, timeout):
                raise TimeoutError(
                    "async checkpoint writes still pending")
            err = self._errors[0] if self._errors else None
            self._errors.clear()
        _barrier()
        if err is not None:
            raise err

    def close(self) -> None:
        self._q.put(None)
        self._thread.join(timeout=10)
