"""Host-side block pool for the paged KV cache.

The port's own copy of ``ray_tpu/llm/paged_cache.py`` (the port imports
nothing of ``ray_tpu``); kept identical below this paragraph.

Reference capability: vLLM's BlockSpaceManager / prefix caching (the
engine behind `ray.llm`, outside the reference tree; its TPU/HBM
config surface at `python/ray/llm/_internal/serve/deployments/llm/vllm/
vllm_models.py:126-207`). PAPERS.md: PagedAttention (Kwon et al.).

Design (vLLM-v1-shaped, TPU-adapted):

- The DEVICE side is one pool ``[L, num_blocks, block_size, Hkv, D]``
  per k/v (allocated once, scanned over L); THIS module is the host
  side: free-list, per-block refcounts, and the content-hash prefix
  index. No jax imports — pure Python, unit-testable anywhere.
- Blocks are IMMUTABLE once full. A prompt's full blocks are hashed by
  chain ``h_i = hash(h_{i-1}, tokens_i)``; identical prefixes across
  live requests resolve to the SAME physical blocks (refcount++), so
  admission skips both HBM and prefill FLOPs for the shared prefix.
  Writes only ever target a request's own tail blocks (a prefix hit is
  full-block-granular, so the write offset always lands in a private
  block) — classic copy-on-write never triggers without beam search,
  which keeps the device side scatter-free.
- Freed blocks go to an LRU free-list but KEEP their prefix-index entry
  (content stays valid in HBM) until the block is reallocated — a later
  request with the same prefix can resurrect a "free" block. This is
  the cross-request prefix cache; eviction is allocation itself.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

_NO_HASH = None


class BlockPool:
    """Refcounted physical blocks + content-hash prefix index."""

    def __init__(self, num_blocks: int, block_size: int):
        if num_blocks < 1 or block_size < 1:
            raise ValueError("num_blocks and block_size must be >= 1")
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.refcount = [0] * num_blocks
        # LRU order: oldest-freed first == evicted first
        self._free: "OrderedDict[int, None]" = OrderedDict(
            (i, None) for i in range(num_blocks))
        # content hash -> physical block (live or cached-free)
        self._by_hash: Dict[int, int] = {}
        self._hash_of: List[Optional[int]] = [_NO_HASH] * num_blocks
        self.stats = {"prefix_hits": 0, "prefix_queries": 0,
                      "evictions": 0}

    # -- introspection ----------------------------------------------------
    @property
    def num_free(self) -> int:
        return len(self._free)

    def cached_free_blocks(self) -> int:
        """Free blocks still carrying reusable prefix content."""
        return sum(1 for b in self._free if self._hash_of[b] is not None)

    # -- hashing ----------------------------------------------------------
    @staticmethod
    def chain_hashes(tokens: Sequence[int], block_size: int,
                     extra_key: Optional[Tuple] = None) -> List[int]:
        """Hash chain over the FULL blocks of ``tokens``. ``extra_key``
        (e.g. a model/adapter id) salts the chain so different models
        never share blocks.

        Content addressing uses sha256, not Python ``hash()``: a 64-bit
        hash collision (or a crafted token sequence in a multi-tenant
        server) would silently map different block contents onto the
        same physical block and serve wrong KV. The digest cost is
        negligible next to prefill FLOPs (vLLM made the same move)."""
        import hashlib

        hashes: List[int] = []
        prev = hashlib.sha256(repr(extra_key).encode()).digest()
        for start in range(0, len(tokens) - block_size + 1, block_size):
            h = hashlib.sha256(prev)
            h.update(repr(tuple(tokens[start:start + block_size]))
                     .encode())
            prev = h.digest()
            hashes.append(int.from_bytes(prev[:16], "little"))
        return hashes

    # -- allocation -------------------------------------------------------
    def match_prefix(self, hashes: Sequence[int]) -> List[int]:
        """Longest prefix of ``hashes`` resolvable to live-or-cached
        blocks. Returns the physical ids (NOT yet referenced)."""
        out: List[int] = []
        self.stats["prefix_queries"] += 1
        for h in hashes:
            b = self._by_hash.get(h)
            if b is None:
                break
            out.append(b)
        if out:
            self.stats["prefix_hits"] += 1
        return out

    def ref(self, block: int) -> None:
        """Take a reference; resurrects a cached-free block."""
        if self.refcount[block] == 0:
            self._free.pop(block, None)
        self.refcount[block] += 1

    def alloc(self, n: int) -> Optional[List[int]]:
        """Allocate ``n`` fresh (private, writable) blocks, or None if
        the pool can't cover it. Eviction = reusing the LRU free block,
        dropping whatever prefix content it still cached."""
        if n > len(self._free):
            return None
        out = []
        for _ in range(n):
            b, _ = self._free.popitem(last=False)
            old = self._hash_of[b]
            if old is not None:
                self._by_hash.pop(old, None)
                self._hash_of[b] = _NO_HASH
                self.stats["evictions"] += 1
            self.refcount[b] = 1
            out.append(b)
        return out

    def seal(self, block: int, content_hash: int) -> None:
        """Mark a full block's content, making it prefix-shareable. If
        an identical block is already indexed, the index keeps the OLD
        one (dedup happens at the next admission, not retroactively)."""
        if self._hash_of[block] is not None:
            return
        if content_hash in self._by_hash:
            return
        self._by_hash[content_hash] = block
        self._hash_of[block] = content_hash

    def unref(self, block: int) -> None:
        """Drop a reference; at zero the block joins the free list but
        keeps its prefix-index entry (cached-free) until reallocated."""
        if self.refcount[block] <= 0:
            raise ValueError(f"unref of unreferenced block {block}")
        self.refcount[block] -= 1
        if self.refcount[block] == 0:
            self._free[block] = None   # append = most-recently-freed

    def unref_all(self, blocks: Sequence[int]) -> None:
        for b in blocks:
            self.unref(b)


class SlotAllocation:
    """A slot's logical->physical block mapping plus which of its
    blocks were prefix hits (already containing K/V)."""

    __slots__ = ("blocks", "shared_blocks", "sealed_upto")

    def __init__(self, blocks: List[int], shared_blocks: int):
        self.blocks = blocks              # physical ids, logical order
        self.shared_blocks = shared_blocks
        self.sealed_upto = shared_blocks  # blocks already hash-indexed

    @property
    def capacity(self) -> int:
        return len(self.blocks)


def allocate_slot(pool: BlockPool, prompt: Sequence[int],
                  reserve_tokens: Optional[int] = None,
                  extra_key: Optional[Tuple] = None
                  ) -> Optional[Tuple[SlotAllocation, int]]:
    """Allocate blocks for a request: longest shared prefix from the
    pool's index + fresh blocks covering the rest of ``reserve_tokens``
    (default: the prompt). Decode-time growth goes through
    ``ensure_capacity``; exhaustion there triggers engine preemption.

    Returns (allocation, shared_token_count) or None if the pool cannot
    cover the non-shared remainder right now.
    """
    bs = pool.block_size
    reserve_tokens = max(reserve_tokens or 0, len(prompt))
    hashes = pool.chain_hashes(prompt, bs, extra_key)
    shared = pool.match_prefix(hashes)
    # never share the block holding the LAST prompt token: a FULL-prompt
    # hit would skip prefill entirely and the engine still needs the
    # last-token logits — keep >=1 token of real prefill.
    if len(shared) * bs >= len(prompt):
        shared = shared[:max(0, (len(prompt) - 1) // bs)]
    n_shared_tok = len(shared) * bs
    total_blocks = (reserve_tokens + bs - 1) // bs
    n_fresh = total_blocks - len(shared)
    # ref shared blocks FIRST: alloc() below may otherwise evict a
    # cached-free block that match_prefix just handed us
    for b in shared:
        pool.ref(b)
    fresh = pool.alloc(n_fresh)
    if fresh is None:
        pool.unref_all(shared)
        return None
    alloc = SlotAllocation(list(shared) + fresh, len(shared))
    return alloc, n_shared_tok


def ensure_capacity(pool: BlockPool, alloc: SlotAllocation,
                    needed_tokens: int) -> bool:
    """Grow ``alloc`` until it covers ``needed_tokens``. False = pool
    exhausted (caller preempts someone)."""
    bs = pool.block_size
    need = (needed_tokens + bs - 1) // bs - len(alloc.blocks)
    if need <= 0:
        return True
    fresh = pool.alloc(need)
    if fresh is None:
        return False
    alloc.blocks.extend(fresh)
    return True


def seal_prompt_blocks(pool: BlockPool, alloc: SlotAllocation,
                       prompt: Sequence[int],
                       extra_key: Optional[Tuple] = None) -> None:
    """After prefill lands, index the prompt's full blocks so later
    requests can share them."""
    bs = pool.block_size
    hashes = pool.chain_hashes(prompt, bs, extra_key)
    for i in range(alloc.sealed_upto, len(hashes)):
        pool.seal(alloc.blocks[i], hashes[i])
    alloc.sealed_upto = max(alloc.sealed_upto, len(hashes))
