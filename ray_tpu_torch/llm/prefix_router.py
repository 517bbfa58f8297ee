"""Prefix-aware request routing (the port's own copy of
``ray_tpu/llm/prefix_router.py``).

Reference: `python/ray/llm/_internal/serve/request_router/prefix_aware/`
(PrefixAwarePow2ReplicaRouter): requests whose prompts share a prefix go
to the same replica so its KV/prefix cache hits; cold prefixes fall back
to power-of-two-choices.
"""

from __future__ import annotations

import random
import threading
from typing import Dict, List, Optional, Sequence, Tuple


class PrefixTree:
    """Token-prefix → replica map with per-node hit accounting."""

    def __init__(self, block_size: int = 16, max_nodes: int = 100_000):
        self.block_size = block_size
        self.max_nodes = max_nodes
        self._map: Dict[Tuple, int] = {}
        self._lock = threading.Lock()

    def _blocks(self, tokens: Sequence[int]) -> List[Tuple]:
        out = []
        for i in range(self.block_size, len(tokens) + 1, self.block_size):
            out.append(tuple(tokens[:i]))
        return out

    def lookup(self, tokens: Sequence[int]) -> Tuple[Optional[int], int]:
        """Longest cached prefix → (replica, matched_len)."""
        best, matched = None, 0
        with self._lock:
            for block in self._blocks(tokens):
                replica = self._map.get(block)
                if replica is None:
                    break
                best, matched = replica, len(block)
        return best, matched

    def insert(self, tokens: Sequence[int], replica: int) -> None:
        with self._lock:
            if len(self._map) > self.max_nodes:
                self._map.clear()   # cheap global eviction
            for block in self._blocks(tokens):
                self._map[block] = replica


class PrefixAwareRouter:
    """Pick a replica index for a tokenized prompt."""

    def __init__(self, num_replicas: int, *, block_size: int = 16,
                 imbalance_limit: float = 2.0, seed: int = 0):
        self.num_replicas = num_replicas
        self.tree = PrefixTree(block_size=block_size)
        self.inflight = [0] * num_replicas
        self.imbalance_limit = imbalance_limit
        self._rng = random.Random(seed)
        self._lock = threading.Lock()

    def route(self, prompt_tokens: Sequence[int]) -> int:
        replica, matched = self.tree.lookup(prompt_tokens)
        with self._lock:
            mean = sum(self.inflight) / max(1, self.num_replicas)
            if (replica is not None
                    and self.inflight[replica] <= max(
                        self.imbalance_limit * mean, mean + 2)):
                chosen = replica           # prefix affinity wins
            elif self.num_replicas == 1:
                chosen = 0
            else:                           # cold prefix: P2C
                a, b = self._rng.sample(range(self.num_replicas), 2)
                chosen = a if self.inflight[a] <= self.inflight[b] else b
            self.inflight[chosen] += 1
        self.tree.insert(prompt_tokens, chosen)
        return chosen

    def on_finished(self, replica: int) -> None:
        with self._lock:
            self.inflight[replica] = max(0, self.inflight[replica] - 1)
