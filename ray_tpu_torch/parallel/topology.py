"""The TPU slice's torus model and sub-slice allocation (counterpart of
``ray_tpu/parallel/topology.py``, with its names and its allocator).

A slice is an axis-aligned box of chips in a 2-D or 3-D torus. Hosts own
contiguous sub-boxes (v5p: 4 chips a host in a (2, 2, 1) block). The
allocator hands out axis-aligned sub-boxes, the most cube-like first, so a
placement group's gang lands on the hosts of one contiguous sub-slice, and
gives the same boxes in the same order as JAX's for the same calls.

The flag ``tpu_topology`` names a TPU slice, as in JAX. On one card the
declared slice is virtual: it binds the runtime's nodes to torus hosts,
and the card runs every task a bundle places. No GPU or NVLink generation
is added to the table: JAX has none.
"""

from __future__ import annotations

import itertools
import math
import os
import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

# generation -> (chips per host, host block shape, torus dims)
TPU_GENERATIONS = {
    "v4": (4, (2, 2, 1), 3),
    "v5p": (4, (2, 2, 1), 3),
    "v5e": (4, (2, 2), 2),
    "v5litepod": (4, (2, 2), 2),
    "v6e": (4, (2, 2), 2),
}


def parse_topology(spec: str) -> Tuple[int, ...]:
    """'4x4x4' -> (4, 4, 4)."""
    try:
        dims = tuple(int(x) for x in spec.lower().split("x"))
    except ValueError:
        raise ValueError(f"bad topology spec {spec!r} (want e.g. '4x4x4')")
    if not dims or any(d <= 0 for d in dims):
        raise ValueError(f"bad topology spec {spec!r}")
    return dims


@dataclass(frozen=True)
class Chip:
    coords: Tuple[int, ...]
    host_index: int


@dataclass
class SubSlice:
    """An axis-aligned box of chips handed to one mesh / placement bundle."""

    origin: Tuple[int, ...]
    shape: Tuple[int, ...]

    @property
    def num_chips(self) -> int:
        return math.prod(self.shape)

    def chips(self) -> List[Tuple[int, ...]]:
        ranges = [range(o, o + s) for o, s in zip(self.origin, self.shape)]
        return list(itertools.product(*ranges))

    def contains(self, coords: Tuple[int, ...]) -> bool:
        return all(o <= c < o + s
                   for c, o, s in zip(coords, self.origin, self.shape))


class TpuTopology:
    """One TPU slice: chips on a torus, grouped into hosts."""

    def __init__(self, generation: str, topology: str):
        gen = generation.lower()
        if gen not in TPU_GENERATIONS:
            raise ValueError(f"unknown TPU generation {generation!r}; "
                             f"known: {sorted(TPU_GENERATIONS)}")
        self.generation = gen
        self.chips_per_host, host_block, ndims = TPU_GENERATIONS[gen]
        self.dims = parse_topology(topology)
        if len(self.dims) != ndims:
            raise ValueError(
                f"{generation} topologies are {ndims}-D, got {topology!r}")
        self.host_block = host_block
        for d, hb in zip(self.dims, host_block):
            if d % hb != 0:
                raise ValueError(
                    f"topology {topology} not divisible by host block "
                    f"{host_block}")
        self.hosts_grid = tuple(d // hb
                                for d, hb in zip(self.dims, host_block))
        self.num_hosts = math.prod(self.hosts_grid)
        self.num_chips = math.prod(self.dims)
        self._allocated: List[SubSlice] = []

    def __repr__(self):
        return (f"TpuTopology({self.generation}-{self.num_chips}, "
                f"{'x'.join(map(str, self.dims))}, {self.num_hosts} hosts)")

    # -- host mapping ------------------------------------------------------
    def host_of(self, coords: Tuple[int, ...]) -> int:
        idx = 0
        for c, hb, hg in zip(coords, self.host_block, self.hosts_grid):
            idx = idx * hg + (c // hb)
        return idx

    def chips(self) -> List[Chip]:
        out = []
        for coords in itertools.product(*(range(d) for d in self.dims)):
            out.append(Chip(coords, self.host_of(coords)))
        return out

    def hosts_of_subslice(self, sub: SubSlice) -> List[int]:
        return sorted({self.host_of(c) for c in sub.chips()})

    # -- sub-slice allocation (for placement-group bundles) ----------------
    def allocate(self, num_chips: int,
                 max_hosts: Optional[int] = None,
                 accept=None) -> Optional[SubSlice]:
        """Allocate an ICI-contiguous sub-slice of the given chip count.

        Chooses the most cube-like axis-aligned box with that volume that
        fits in the remaining space (greedy first-fit over origins).
        ``max_hosts`` restricts candidates to boxes spanning at most that
        many hosts (STRICT_PACK: 1 — the box must sit inside one host's
        chip block). ``accept(cand)`` lets the caller veto candidates
        that don't suit its bundle->host packing (e.g. host-sized
        bundles need host-block-aligned boxes) — the search then moves
        on to the next shape/origin instead of failing outright.
        """
        shapes = self._candidate_shapes(num_chips)
        for shape in shapes:
            for origin in itertools.product(
                    *(range(0, d - s + 1)
                      for d, s in zip(self.dims, shape))):
                cand = SubSlice(origin, shape)
                if any(self._overlaps(cand, a) for a in self._allocated):
                    continue
                if (max_hosts is not None
                        and len(self.hosts_of_subslice(cand)) > max_hosts):
                    continue
                if accept is not None and not accept(cand):
                    continue
                self._allocated.append(cand)
                return cand
        return None

    def free(self, sub: SubSlice) -> None:
        self._allocated = [a for a in self._allocated if a is not sub]

    def _candidate_shapes(self, volume: int) -> List[Tuple[int, ...]]:
        """All axis-aligned box shapes with the given volume, most
        cube-like (lowest surface area -> best bisection bandwidth) first."""
        nd = len(self.dims)
        out = set()

        def rec(rem: int, dims_left: int, cur: Tuple[int, ...]):
            if dims_left == 1:
                if rem <= self.dims[nd - 1]:
                    out.add(cur + (rem,))
                return
            axis = nd - dims_left
            for d in range(1, min(rem, self.dims[axis]) + 1):
                if rem % d == 0:
                    rec(rem // d, dims_left - 1, cur + (d,))

        rec(volume, nd, ())
        return sorted(out, key=lambda s: (max(s) / max(min(s), 1), s))

    @staticmethod
    def _overlaps(a: SubSlice, b: SubSlice) -> bool:
        return all(ao < bo + bs and bo < ao + as_
                   for ao, as_, bo, bs in zip(a.origin, a.shape,
                                              b.origin, b.shape))


class TpuTopologyManager:
    """Cluster-side view of one TPU slice: binds runtime nodes to torus
    hosts and hands out ICI-contiguous sub-slices under a lock. A gang's
    bundles land on the hosts of one axis-aligned sub-slice, where a plain
    resource count would scatter them."""

    def __init__(self, topology: TpuTopology):
        self.topology = topology
        self._lock = threading.RLock()
        #: guarded by self._lock
        self._host_of_node: Dict[object, int] = {}   # node_id -> host idx
        self._node_of_host: Dict[int, object] = {}  #: guarded by self._lock

    @staticmethod
    def from_spec(spec: str) -> "TpuTopologyManager":
        """'v5p:4x4x4' -> manager over that slice."""
        gen, _, topo = spec.partition(":")
        if not topo:
            raise ValueError(
                f"bad tpu_topology {spec!r} (want '<gen>:<AxBxC>')")
        return TpuTopologyManager(TpuTopology(gen, topo))

    # -- node <-> host binding (first-seen order, stable) ------------------
    def bind_nodes(self, node_ids: Sequence) -> None:
        with self._lock:
            for nid in node_ids:
                if nid in self._host_of_node:
                    continue
                for h in range(self.topology.num_hosts):
                    if h not in self._node_of_host:
                        self._host_of_node[nid] = h
                        self._node_of_host[h] = nid
                        break

    def unbind_node(self, node_id) -> None:
        with self._lock:
            h = self._host_of_node.pop(node_id, None)
            if h is not None:
                self._node_of_host.pop(h, None)

    def node_of_host(self, host: int):
        with self._lock:
            return self._node_of_host.get(host)

    # -- allocation --------------------------------------------------------
    def allocate(self, num_chips: int,
                 max_hosts: Optional[int] = None,
                 accept=None) -> Optional[SubSlice]:
        with self._lock:
            return self.topology.allocate(num_chips, max_hosts=max_hosts,
                                          accept=accept)

    def free(self, sub: SubSlice) -> None:
        with self._lock:
            self.topology.free(sub)

    def chips_by_host(self, sub: SubSlice) -> Dict[int, List[Tuple[int, ...]]]:
        """host index -> the sub-slice chips that host owns."""
        out: Dict[int, List[Tuple[int, ...]]] = {}
        for c in sub.chips():
            out.setdefault(self.topology.host_of(c), []).append(c)
        return out


def detect_local_topology() -> Optional[TpuTopology]:
    """Best-effort topology from the pod's variables, else from the cards.

    ``TPU_ACCELERATOR_TYPE`` (e.g. "v5p-64") and ``TPU_TOPOLOGY`` (e.g.
    "4x4x4") come first, as in JAX. Where JAX counts its non-CPU devices,
    the port counts ``torch.cuda.device_count()`` and keeps JAX's
    single-host fallback: n devices model a flat ``v5e`` slice of
    ``max(n // 2, 1) x min(n, 2)``, which one device cannot form (1 x 1
    is not a whole host block), so one card gives None, as one TPU chip
    does in JAX.
    """
    env_type = os.environ.get("TPU_ACCELERATOR_TYPE")
    env_topo = os.environ.get("TPU_TOPOLOGY")
    if env_type and env_topo:
        gen = env_type.split("-")[0]
        try:
            return TpuTopology(gen, env_topo)
        except ValueError:
            pass
    try:
        import torch
        n = torch.cuda.device_count()
        if not n:
            return None
        # single-host fallback: a flat 2-D slice
        if n in (1, 4, 8):
            return TpuTopology("v5e", f"{max(n // 2, 1)}x{min(n, 2)}")
    except Exception:
        return None
    return None
