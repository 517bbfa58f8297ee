"""Process-group bring-up (counterpart of ``ray_tpu/parallel/multihost.py``).

JAX brings up its coordination service (``jax.distributed.initialize``);
here every rank joins a ``torch.distributed`` process group: NCCL on the
card, gloo on the CPU. The rendezvous is resolved from, in order:

1. explicit arguments (a coordinator ``host:port``, the world size and this
   rank): a TCP store, rank 0 its server;
2. torchrun's environment (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``,
   ``WORLD_SIZE``), read by ``pod_topology_from_env`` under JAX's name for
   the function that reads the TPU pod's variables.

A single process with neither does nothing and returns ``False``, as in
JAX. JAX's second source, the cluster KV rendezvous (``rendezvous_via_kv``),
needs the runtime's KV store and waits for the port of the runtime
(ROADMAP A13).

``spawn_ranks`` is the port's counterpart of
``ray_tpu/_private/platform.py:force_cpu_platform``: where JAX fakes eight
devices in one process, the port starts one process a rank, joined by gloo,
to run a mesh on the CPU.
"""

from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import pickle
import queue
import shutil
import tempfile
import traceback
from typing import Any, Callable, List, Optional, Tuple

import torch
import torch.distributed as dist



def pod_topology_from_env() -> Optional[Tuple[str, int, int]]:
    """(coordinator_address, num_processes, process_id) from torchrun's
    environment, or None when it is not set."""
    env = os.environ
    if not all(k in env for k in ("MASTER_ADDR", "MASTER_PORT", "RANK",
                                  "WORLD_SIZE")):
        return None
    return (f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}",
            int(env["WORLD_SIZE"]), int(env["RANK"]))


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         backend: Optional[str] = None) -> bool:
    """Join this process to the process group. Returns True when a group of
    more than one rank is running (False: a single process, which needs
    nothing). Idempotent. ``backend`` defaults to NCCL where CUDA is
    available, else gloo; with NCCL the process takes the card
    ``LOCAL_RANK`` (torchrun's variable; default 0)."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    if coordinator_address is not None and (num_processes is None
                                            or process_id is None):
        raise ValueError(
            "an explicit coordinator_address also needs num_processes "
            "and process_id")
    if coordinator_address is None:
        topo = pod_topology_from_env()
        if topo is None:
            return False
        coordinator_address, num_processes, process_id = topo
    if num_processes is None or num_processes <= 1:
        return False
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    host, _, port = coordinator_address.rpartition(":")
    store = dist.TCPStore(host, int(port), num_processes,
                          is_master=process_id == 0,
                          timeout=datetime.timedelta(seconds=300))
    dist.init_process_group(backend, store=store, rank=process_id,
                            world_size=num_processes)
    return True


def init_single_process(device: torch.device) -> None:
    """A world-size-1 group for a one-rank mesh, from an in-process store:
    NCCL for the card, gloo for the CPU."""
    if device.type == "cuda":
        torch.cuda.set_device(device.index or 0)
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                            world_size=1)


def multihost_mesh(spec, *, devices=None, device=None):
    """Build a global mesh over every rank of the group; call AFTER
    ``initialize_multihost``. Per-host data loading should shard by
    ``process_shard``."""
    from ray_tpu_torch.parallel.mesh import build_mesh

    return build_mesh(spec, devices, device=device)


def process_shard(n: int) -> Tuple[int, int]:
    """(start, stop) rows of an n-row global batch for THIS process."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    per = n // world
    return rank * per, rank * per + per


# ---------------------------------------------------------------------------
# the gloo launcher
# ---------------------------------------------------------------------------

def _rank_main(rank: int, world_size: int, store_path: str,
               payload_path: str, results) -> None:
    torch.set_num_threads(1)
    try:
        with open(payload_path, "rb") as f:
            fn, args = pickle.load(f)
        store = dist.FileStore(store_path, world_size)
        dist.init_process_group("gloo", store=store, rank=rank,
                                world_size=world_size)
        results.put((rank, True, fn(*args)))
    except BaseException as e:  # noqa: BLE001 — sent to the caller
        tb = traceback.format_exc()
        try:
            results.put((rank, False, (e, tb)))
        except Exception:  # the exception does not pickle
            results.put((rank, False, (RuntimeError(repr(e)), tb)))
    finally:
        # the report reaches the caller before this rank leaves the group:
        # the peers' "connection closed" errors that its leaving causes
        # come after it
        results.close()
        results.join_thread()
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_ranks(world_size: int, fn: Callable, *args: Any,
                timeout: float = 300.0) -> List[Any]:
    """Run ``fn(*args)`` on ``world_size`` CPU ranks joined by a gloo
    process group; returns each rank's result, rank 0 first.

    Each rank is a fresh process (the ``spawn`` start method), so ``fn``
    and its arguments must pickle: a function of an importable module that
    does not import JAX. They reach the ranks through a file, not the
    process arguments: a start sends those through a pipe that the child
    reads only after importing the parent's main module, so arguments past
    the pipe's buffer would start the ranks one after another (seconds
    each), and gloo's connection timeout then fails the first. The ranks
    meet through a ``FileStore`` in a temporary directory, never a fixed
    port. A rank's exception is raised here, with that rank's traceback in
    its notes; a run that takes longer than ``timeout`` seconds is killed
    and raises ``TimeoutError``."""
    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="ray_tpu_torch_ranks_")
    payload = os.path.join(tmp, "payload.pkl")
    with open(payload, "wb") as f:
        pickle.dump((fn, args), f)
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, world_size, os.path.join(tmp, "store"),
                               payload, results))
             for r in range(world_size)]
    try:
        for p in procs:
            p.start()
        out: dict = {}
        deadline = datetime.datetime.now() + datetime.timedelta(
            seconds=timeout)
        while len(out) < world_size:
            left = (deadline - datetime.datetime.now()).total_seconds()
            try:
                rank, ok, value = results.get(timeout=max(left, 0.01))
            except queue.Empty:
                raise TimeoutError(
                    f"spawn_ranks: {world_size - len(out)} of {world_size} "
                    f"ranks did not finish in {timeout} s") from None
            if not ok:
                exc, tb = value
                exc.add_note(f"rank {rank} of {world_size}:\n{tb}")
                raise exc
            out[rank] = value
        for p in procs:
            p.join(timeout=30)
        return [out[r] for r in range(world_size)]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
        shutil.rmtree(tmp, ignore_errors=True)
