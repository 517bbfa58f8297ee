"""Replica placement: SPREAD by default + node compaction (counterpart of
``ray_tpu/serve/deployment_scheduler.py``).

Reference: ``serve/_private/deployment_scheduler.py:275`` (SPREAD default
at :34, ``get_node_to_compact`` :638). Replicas of one deployment spread
across alive nodes (soft node affinity — availability under node loss);
a compaction pass finds the node with the fewest replicas whose replicas
all fit elsewhere and migrates them so the node can be released (the
downscale story for autoscaled clusters). The nodes are the virtual nodes
of the in-process runtime (``Runtime.alive_nodes``).
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional


class DeploymentScheduler:
    def __init__(self):
        self._lock = threading.Lock()
        # deployment -> replica handle id -> node_id hex
        self._placements: Dict[str, Dict[int, str]] = {}
        self._rr = 0
        # node_hex -> blocked-until timestamp: a just-compacted node must
        # not immediately receive the replicas evicted from it
        self._blocked: Dict[str, float] = {}

    def block_node(self, node_hex: str, ttl_s: float = 60.0) -> None:
        import time
        with self._lock:
            self._blocked[node_hex] = time.time() + ttl_s

    def _is_blocked(self, node_hex: str) -> bool:
        import time
        with self._lock:
            until = self._blocked.get(node_hex)
            if until is None:
                return False
            if time.time() >= until:
                del self._blocked[node_hex]
                return False
            return True

    # -- placement --------------------------------------------------------
    def _alive_nodes(self) -> List:
        from ray_tpu_torch._private import worker

        rt = worker.global_runtime()
        return rt.alive_nodes() if rt is not None else []

    def pick_node_for_replica(self, deployment: str) -> Optional[str]:
        """SPREAD: the alive node hosting the fewest replicas of this
        deployment (round-robin tiebreak)."""
        nodes = self._alive_nodes()
        unblocked = [n for n in nodes
                     if not self._is_blocked(n.node_id.hex())]
        nodes = unblocked or nodes
        if not nodes:
            return None
        with self._lock:
            counts = {}
            placed = self._placements.get(deployment, {})
            for node_hex in placed.values():
                counts[node_hex] = counts.get(node_hex, 0) + 1
            self._rr += 1
            ordered = sorted(
                nodes, key=lambda n: (counts.get(n.node_id.hex(), 0),
                                      (hash(n.node_id.hex()) + self._rr)
                                      % len(nodes)))
            return ordered[0].node_id.hex()

    def record(self, deployment: str, replica, node_hex: str) -> None:
        with self._lock:
            self._placements.setdefault(deployment, {})[id(replica)] = \
                node_hex

    def forget(self, deployment: str, replica) -> None:
        with self._lock:
            self._placements.get(deployment, {}).pop(id(replica), None)

    def forget_deployment(self, deployment: str) -> None:
        with self._lock:
            self._placements.pop(deployment, None)

    # -- compaction -------------------------------------------------------
    def get_node_to_compact(self) -> Optional[str]:
        """The node hosting the fewest (but >0) replicas, if every other
        alive node could absorb them (reference :638). Returns its hex id
        or None."""
        nodes = self._alive_nodes()
        if len(nodes) < 2:
            return None
        with self._lock:
            per_node: Dict[str, int] = {}
            for placed in self._placements.values():
                for node_hex in placed.values():
                    per_node[node_hex] = per_node.get(node_hex, 0) + 1
        candidates = [(count, node_hex)
                      for node_hex, count in per_node.items() if count > 0]
        if len(candidates) < 2:
            return None  # all replicas already on one node
        count, node_hex = min(candidates)
        if self._is_blocked(node_hex):
            return None
        others = [n for n in nodes if n.node_id.hex() != node_hex]
        if not others:
            return None
        # Availability gate: moving the victim's replicas must not shrink
        # any deployment's node-span below min(2, current span) — SPREAD
        # placement exists for fault tolerance; compaction must not
        # quietly collapse a 2-node deployment onto one node.
        with self._lock:
            for deployment, placed in self._placements.items():
                spans = set(placed.values())
                if node_hex not in spans:
                    continue
                span_after = len(spans - {node_hex})
                # only a MULTI-node deployment loses availability by the
                # move; a single-node deployment just relocates
                if len(spans) >= 2 and span_after < 2:
                    return None
        return node_hex

    def replicas_on(self, node_hex: str) -> List:
        with self._lock:
            out = []
            for deployment, placed in self._placements.items():
                for rid, n in placed.items():
                    if n == node_hex:
                        out.append((deployment, rid))
            return out
