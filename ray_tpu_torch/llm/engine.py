"""Continuous-batching inference engine with a paged KV cache (counterpart of
``ray_tpu/llm/engine.py``).

The same scheduler as the JAX engine — paged KV pool with a scratch block,
content-hashed prefix reuse, bucketed and batched prefill, chunked prefill,
recompute preemption, ``prefill_only`` / ``submit_prefilled`` handoff — over
the port's ``LlamaModel`` on one device:

- JAX's jitted programs are plain method calls (PyTorch runs eagerly);
- the KV pool is updated in place where JAX donated it (``_decode`` and
  ``_insert`` write into ``self.kv``);
- sampling draws from a ``torch.Generator`` on the engine's device, seeded 0
  as the JAX engine seeds its key with 0. Its streams are not JAX's: greedy
  (temperature 0) decoding matches the JAX engine token for token, sampled
  decoding is reproducible for a fixed seed.
"""

from __future__ import annotations

import dataclasses
import itertools
import queue
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ray_tpu_torch.llm.paged_cache import (BlockPool, SlotAllocation,
                                           allocate_slot, ensure_capacity,
                                           seal_prompt_blocks)
from ray_tpu_torch.models.llama import take_last


@dataclasses.dataclass
class SamplingParams:
    max_tokens: int = 64
    temperature: float = 0.0
    top_k: int = 0                 # 0 = no top-k
    stop_token_ids: tuple = ()
    seed: int = 0


class Request:
    _ids = itertools.count()

    def __init__(self, prompt_tokens: List[int], sampling: SamplingParams):
        self.id = next(Request._ids)
        self.prompt = list(prompt_tokens)
        self.sampling = sampling
        self.output: List[int] = []
        self.stream: "queue.Queue" = queue.Queue()
        self.submitted_at = time.perf_counter()
        self.first_token_at: Optional[float] = None
        self.finished_at: Optional[float] = None
        self.done = threading.Event()
        self.finish_reason: Optional[str] = None
        self.preemptions = 0

    @property
    def ttft_s(self) -> Optional[float]:
        if self.first_token_at is None:
            return None
        return self.first_token_at - self.submitted_at

    def cache_tokens(self) -> List[int]:
        """Tokens whose K/V must be cached before the next decode step —
        the prompt plus everything generated so far (non-empty output
        only after a preemption re-admission)."""
        return self.prompt + self.output

    def iter_tokens(self):
        """Stream tokens as they are generated."""
        while True:
            tok = self.stream.get()
            if tok is None:
                return
            yield tok


class ContinuousBatchingEngine:
    def __init__(self, model, params, *, max_slots: int = 32,
                 max_seq: int = 1024,
                 prefill_buckets: tuple = (32, 64, 128, 256, 512),
                 block_size: Optional[int] = None,
                 num_blocks: Optional[int] = None):
        self.model = model
        self.params = params
        self.device = model.device
        self.max_slots = max_slots
        self.max_seq = max_seq
        self.buckets = tuple(b for b in sorted(prefill_buckets)
                             if b <= max_seq)
        if not self.buckets:
            raise ValueError(
                f"no prefill bucket fits max_seq={max_seq}: "
                f"{prefill_buckets}")
        requested = block_size
        block_size = requested if requested is not None else 32
        if self.buckets and block_size > self.buckets[0]:
            # prefill scatters whole buckets into blocks, so every bucket
            # must be block-aligned; shrink toward the smallest bucket, LOUD
            # only for an explicit request (see the JAX engine)
            if requested is not None:
                import warnings
                warnings.warn(
                    f"block_size={requested} exceeds the smallest "
                    f"prefill bucket {self.buckets[0]}; using "
                    f"{self.buckets[0]} — resize num_blocks "
                    f"accordingly", stacklevel=2)
            block_size = self.buckets[0]
        for b in self.buckets:
            if b % block_size != 0:
                raise ValueError(
                    f"prefill bucket {b} not a multiple of "
                    f"block_size {block_size}")
        self.block_size = block_size
        self.blocks_per_slot = (max_seq + block_size - 1) // block_size
        if num_blocks is None:
            num_blocks = max_slots * self.blocks_per_slot
        self.num_blocks = num_blocks
        self.pool = BlockPool(num_blocks, block_size)
        # +1: physical block ``num_blocks`` is the SCRATCH block — every
        # padded table/scatter entry points there, so inactive slots and
        # bucket padding write garbage into scratch instead of a live
        # block, and every device index stays in bounds
        self.kv = model.init_kv_pool(num_blocks + 1, block_size)

        self.slots: List[Optional[Request]] = [None] * max_slots
        self.allocs: List[Optional[SlotAllocation]] = [None] * max_slots
        self.offsets = np.zeros(max_slots, np.int32)   # tokens cached/slot
        self._tables = np.full((max_slots, self.blocks_per_slot),
                               num_blocks, np.int32)
        self._admit_order: List[int] = []   # oldest-first slot ids
        self.waiting: "deque[Request]" = deque()
        self._lock = threading.Lock()
        self._gen = torch.Generator(device=self.device).manual_seed(0)

        self.stats = {"requests": 0, "tokens_generated": 0,
                      "decode_steps": 0, "prefills": 0,
                      "prefix_prefills": 0, "prefix_tokens_reused": 0,
                      "preemptions": 0}

    def _dev(self, array) -> torch.Tensor:
        """Host array -> a fresh tensor on the engine's device."""
        return torch.tensor(np.asarray(array), device=self.device)

    # -- device-side pieces (JAX: jitted programs) ------------------------
    def _prefill(self, params, tokens, lengths):
        """BATCHED prefill: tokens [N, Tb], lengths [N]; returns each
        request's last-valid-token logits [N, V] + a BUCKET-SIZED cache
        [L, N, Tb, Hkv, D] that admission scatters into pool blocks."""
        N, Tb = tokens.shape
        small = self.model.init_kv_cache(N, Tb)
        logits, small = self.model.forward_step(
            params, tokens, small,
            torch.zeros(N, dtype=torch.int32, device=self.device))
        return take_last(logits, lengths), small

    def _insert(self, small, block_ids) -> None:
        """Scatter bucket prefill K/V [L, N, Tb, Hkv, D] into pool blocks,
        in place (JAX: a donated pool). ``block_ids`` [N*nb] flat physical
        ids in logical order (padding = num_blocks, the scratch block, so
        duplicates only ever land there)."""
        L, N, Tb = small["k"].shape[:3]
        bs = self.block_size
        nb = Tb // bs
        for name in ("k", "v"):
            blocks = small[name].reshape(L, N * nb, bs, *small[name].shape[3:])
            self.kv[name][:, block_ids] = blocks.to(self.kv[name].dtype)

    def _gather(self, block_ids):
        """Gather prefix blocks [N, Pb] -> dense [L, N, Pb*bs, Hkv, D]."""
        k = self.kv["k"][:, block_ids]          # [L, N, Pb, bs, Hkv, D]
        v = self.kv["v"][:, block_ids]
        L, N, Pb, bs = k.shape[:4]
        return (k.reshape(L, N, Pb * bs, *k.shape[4:]),
                v.reshape(L, N, Pb * bs, *v.shape[4:]))

    def _sample(self, logits: torch.Tensor, temps: np.ndarray,
                top_ks: np.ndarray) -> np.ndarray:
        """logits [B, V] -> tokens [B] (numpy). Rows with temperature <= 0
        are greedy; the rest sample from the top-k-masked softmax."""
        greedy = torch.argmax(logits, dim=-1)
        if not (temps > 0.0).any():
            return greedy.cpu().numpy()
        V = logits.shape[-1]
        t = self._dev(temps).to(logits.dtype)
        tk = self._dev(top_ks).to(torch.int64)
        scaled = logits / torch.clamp(t, min=1e-6)[:, None]
        kth = torch.sort(scaled, dim=-1).values.gather(
            1, (V - torch.clamp(tk, min=1))[:, None])
        masked = torch.where(scaled >= kth, scaled,
                             torch.full_like(scaled, -1e30))
        scaled = torch.where((tk > 0)[:, None], masked, scaled)
        probs = torch.softmax(scaled, dim=-1)
        sampled = torch.multinomial(probs, 1, generator=self._gen)[:, 0]
        return torch.where(t <= 0.0, greedy, sampled).cpu().numpy()

    # -- public API --------------------------------------------------------
    def submit(self, prompt_tokens: List[int],
               sampling: Optional[SamplingParams] = None) -> Request:
        req = Request(prompt_tokens, sampling or SamplingParams())
        self.stats["requests"] += 1
        # deque.append is atomic — submitters never contend on the
        # engine-step lock (a step can span a whole prefill+decode)
        self.waiting.append(req)
        return req

    def has_work(self) -> bool:
        return (bool(self.waiting)
                or any(s is not None for s in self.slots))

    def step(self) -> int:
        """One engine iteration: admit+prefill, then one decode step for
        all active slots. Returns number of active slots."""
        with self._lock:
            self._admit()
            return self._decode_step()

    def _bucket_for(self, n: int) -> Optional[int]:
        for b in self.buckets:
            if n <= b:
                return b
        return None

    # -- admission ---------------------------------------------------------
    def _admit(self) -> None:
        """Admit as many waiting requests as slots AND pool blocks
        allow. Prefix-hit requests prefill through the suffix path; the
        rest batch per bucket (one forward per bucket). Pool exhaustion
        stops admission (FIFO order held)."""
        free = [i for i, r in enumerate(self.slots) if r is None]
        if not free or not self.waiting:
            return
        by_bucket: Dict[int, List] = {}
        chunked_group: List = []
        while free and self.waiting:
            req = self.waiting.popleft()
            toks = req.cache_tokens()
            n = len(toks)
            never_fits = ((n + 1 + self.block_size - 1)
                          // self.block_size > self.num_blocks)
            if n >= self.max_seq or never_fits:
                req.finish_reason = ("length" if req.output
                                     else "prompt_too_long")
                req.finished_at = time.perf_counter()
                req.done.set()
                req.stream.put(None)
                continue
            # +1 so the first decode write never needs a growth step
            alloc = allocate_slot(self.pool, toks, n + 1)
            if alloc is None:
                # pool can't host it right now — put it back, stop
                self.waiting.appendleft(req)
                break
            alloc, shared_tok = alloc
            slot = free.pop(0)
            bucket = self._bucket_for(n)
            if shared_tok > 0 or bucket is None:
                # prefix hit, or context longer than the largest bucket:
                # CHUNKED prefill over the cached/growing prefix
                chunked_group.append((slot, req, alloc, shared_tok))
            else:
                by_bucket.setdefault(bucket, []).append(
                    (slot, req, alloc))
        # single-chunk prefix hits with identical padded shapes BATCH
        # through prefill_with_prefix's N dimension; multi-chunk contexts
        # go one by one
        big = self.buckets[-1]
        by_shape: Dict[tuple, List] = {}
        singles: List = []
        for item in chunked_group:
            _, req, alloc, shared_tok = item
            suffix_len = len(req.cache_tokens()) - shared_tok
            if 0 < shared_tok and suffix_len <= big:
                pb_pad = self._pad_pow2(
                    max(shared_tok // self.block_size, 1),
                    self.blocks_per_slot)
                key = (pb_pad, self._bucket_for(suffix_len))
                by_shape.setdefault(key, []).append(item)
            else:
                singles.append(item)
        for (pb_pad, s_bucket), group in by_shape.items():
            self._admit_prefix_batch(pb_pad, s_bucket, group)
        for slot, req, alloc, shared_tok in singles:
            self._admit_chunked(slot, req, alloc, shared_tok)
        for bucket, group in by_bucket.items():
            self._admit_bucket(bucket, group)

    def _pad_pow2(self, n: int, cap: int) -> int:
        p = 1
        while p < n:
            p *= 2
        return min(p, cap)

    def _admit_bucket(self, bucket: int, group: List) -> None:
        """Batched no-prefix prefill: one forward + one pool scatter +
        one sample for the whole group."""
        bs = self.block_size
        nb = bucket // bs
        # padded to a power of two like the JAX engine (there: to bound jit
        # specializations; here it keeps the two engines' batches alike)
        n_pad = self._pad_pow2(len(group), self.max_slots)
        lengths = np.ones(n_pad, np.int32)
        toks = np.zeros((n_pad, bucket), np.int32)
        block_ids = np.full(n_pad * nb, self.num_blocks, np.int32)
        for row, (slot, req, alloc) in enumerate(group):
            seq = req.cache_tokens()
            lengths[row] = len(seq)
            toks[row, :len(seq)] = seq
            ids = alloc.blocks[:nb]
            block_ids[row * nb:row * nb + len(ids)] = ids
        last_logits, small = self._prefill(
            self.params, self._dev(toks), self._dev(lengths))
        self._insert(small, self._dev(block_ids))
        self.stats["prefills"] += 1
        toks_out = self._sample_batch(last_logits,
                                      [req for _, req, _ in group], n_pad)
        now = time.perf_counter()
        for row, (slot, req, alloc) in enumerate(group):
            self._activate(slot, req, alloc, int(lengths[row]), now)
            self._emit(slot, int(toks_out[row]))

    def _admit_prefix_batch(self, pb_pad: int, s_bucket: int,
                            group: List) -> None:
        """Batched suffix prefill for same-shape prefix hits: one gather +
        one forward + one scatter + one sample for the wave."""
        bs = self.block_size
        nb = s_bucket // bs
        n_pad = self._pad_pow2(len(group), self.max_slots)
        ids = np.zeros((n_pad, pb_pad), np.int32)
        toks = np.zeros((n_pad, s_bucket), np.int32)
        plens = np.zeros(n_pad, np.int32)
        slens = np.ones(n_pad, np.int32)
        block_ids = np.full(n_pad * nb, self.num_blocks, np.int32)
        for row, (slot, req, alloc, shared) in enumerate(group):
            seq = req.cache_tokens()
            pb = shared // bs
            ids[row, :pb] = alloc.blocks[:pb]
            suffix = seq[shared:]
            toks[row, :len(suffix)] = suffix
            plens[row] = shared
            slens[row] = len(suffix)
            avail = alloc.blocks[pb:pb + nb]
            block_ids[row * nb:row * nb + len(avail)] = avail
            self.stats["prefix_prefills"] += 1
            self.stats["prefix_tokens_reused"] += shared
        pk, pv = self._gather(self._dev(ids))
        last_logits, small = self.model.prefill_with_prefix(
            self.params, self._dev(toks), pk, pv, self._dev(plens),
            self._dev(slens))
        self._insert(small, self._dev(block_ids))
        self.stats["prefills"] += 1
        toks_out = self._sample_batch(last_logits,
                                      [req for _, req, _, _ in group],
                                      n_pad)
        now = time.perf_counter()
        for row, (slot, req, alloc, shared) in enumerate(group):
            self._activate(slot, req, alloc, len(req.cache_tokens()), now)
            self._emit(slot, int(toks_out[row]))

    def _prefill_chunk(self, alloc: SlotAllocation, seq: List[int],
                       pos: int, chunk_len: int):
        """Prefill ``seq[pos:pos+chunk_len]`` attending over the
        already-cached ``pos`` tokens (gathered dense from the pool),
        scattering the chunk's K/V into the slot's blocks. ``pos`` is
        block-aligned. Returns the chunk's last-token logits."""
        bs = self.block_size
        pb = pos // bs
        chunk = seq[pos:pos + chunk_len]
        s_bucket = self._bucket_for(len(chunk))
        # the gathered prefix is padded to a power-of-two block count;
        # padded rows are position-masked
        pb_pad = self._pad_pow2(max(pb, 1), self.blocks_per_slot)
        ids = np.zeros((1, pb_pad), np.int32)
        ids[0, :pb] = alloc.blocks[:pb]
        pk, pv = self._gather(self._dev(ids))
        toks = np.zeros((1, s_bucket), np.int32)
        toks[0, :len(chunk)] = chunk
        last_logits, small = self.model.prefill_with_prefix(
            self.params, self._dev(toks), pk, pv,
            self._dev(np.asarray([pos], np.int32)),
            self._dev(np.asarray([len(chunk)], np.int32)))
        nb = s_bucket // bs
        block_ids = np.full(nb, self.num_blocks, np.int32)
        avail = alloc.blocks[pb:pb + nb]
        block_ids[:len(avail)] = avail
        # chunk cache is [L, 1, Tb, ...]: reuse the batched scatter
        self._insert(small, self._dev(block_ids))
        self.stats["prefills"] += 1
        return last_logits

    def _admit_chunked(self, slot: int, req: Request,
                       alloc: SlotAllocation, shared_tok: int) -> None:
        """Single-request chunked prefill: the cached prefix (shared
        blocks and/or earlier chunks) is attended as context, so any
        context length admits."""
        seq = req.cache_tokens()
        n = len(seq)
        if shared_tok > 0:
            self.stats["prefix_prefills"] += 1
            self.stats["prefix_tokens_reused"] += shared_tok
        pos = shared_tok
        big = self.buckets[-1]
        last_logits = None
        while pos < n:
            chunk_len = min(big, n - pos)
            last_logits = self._prefill_chunk(alloc, seq, pos, chunk_len)
            pos += chunk_len
        toks_out = self._sample_batch(last_logits, [req], 1)
        self._activate(slot, req, alloc, n, time.perf_counter())
        self._emit(slot, int(toks_out[0]))

    def _activate(self, slot: int, req: Request, alloc: SlotAllocation,
                  n_cached: int, now: float) -> None:
        seal_prompt_blocks(self.pool, alloc, req.cache_tokens())
        if req.first_token_at is None:
            req.first_token_at = now
        self.slots[slot] = req
        self.allocs[slot] = alloc
        self.offsets[slot] = n_cached
        self._tables[slot] = self.num_blocks
        self._tables[slot, :len(alloc.blocks)] = alloc.blocks
        self._admit_order.append(slot)

    def _sample_batch(self, logits, reqs: List[Request], n_pad: int):
        temps = np.zeros(n_pad, np.float32)
        top_ks = np.zeros(n_pad, np.int32)
        for row, req in enumerate(reqs):
            temps[row] = req.sampling.temperature
            top_ks[row] = req.sampling.top_k
        return self._sample(logits, temps, top_ks)

    # -- decode ------------------------------------------------------------
    def _preempt(self, slot: int) -> None:
        """Free a slot's blocks and requeue its request (recompute
        preemption): generated tokens fold into the prompt so the
        re-admission prefill rebuilds the full context."""
        req = self.slots[slot]
        self.pool.unref_all(self.allocs[slot].blocks)
        self.slots[slot] = None
        self.allocs[slot] = None
        self.offsets[slot] = 0
        self._tables[slot] = self.num_blocks   # idle writes go to scratch
        self._admit_order.remove(slot)
        req.preemptions += 1
        self.stats["preemptions"] += 1
        self.waiting.appendleft(req)

    def _grow_or_preempt(self) -> None:
        """Every active slot must have capacity for its next token's K/V
        before the batched decode runs. Exhaustion preempts the YOUNGEST
        slot until the older ones fit — the victim may be the grower."""
        for slot in list(self._admit_order):      # oldest first
            if self.slots[slot] is None:
                continue
            alloc = self.allocs[slot]
            while not ensure_capacity(self.pool, alloc,
                                      int(self.offsets[slot]) + 1):
                victims = [s for s in self._admit_order
                           if s != slot] or [slot]
                victim = victims[-1]
                self._preempt(victim)
                if victim == slot:
                    break
            if self.slots[slot] is not None:
                self._tables[slot, :len(alloc.blocks)] = alloc.blocks

    def _decode_step(self) -> int:
        self._grow_or_preempt()
        active = [i for i, r in enumerate(self.slots) if r is not None]
        if not active:
            return 0
        last_tokens = np.zeros(self.max_slots, np.int32)
        temps = np.zeros(self.max_slots, np.float32)
        top_ks = np.zeros(self.max_slots, np.int32)
        for i in active:
            req = self.slots[i]
            last_tokens[i] = req.output[-1] if req.output else \
                (req.prompt[-1] if req.prompt else 0)
            temps[i] = req.sampling.temperature
            top_ks[i] = req.sampling.top_k
        # the pool is updated in place (JAX: donated)
        logits, self.kv = self.model.decode_step_paged(
            self.params, self._dev(last_tokens), self.kv,
            self._dev(self._tables), self._dev(self.offsets))
        toks = self._sample(logits, temps, top_ks)
        self.stats["decode_steps"] += 1
        for i in active:
            self.offsets[i] += 1
            self._emit(i, int(toks[i]))
        return len(active)

    def _emit(self, slot: int, tok: int) -> None:
        req = self.slots[slot]
        req.output.append(tok)
        req.stream.put(tok)
        self.stats["tokens_generated"] += 1
        stop = (tok in req.sampling.stop_token_ids
                or len(req.output) >= req.sampling.max_tokens
                or self.offsets[slot] + 1 >= self.max_seq)
        if stop:
            req.finish_reason = ("stop" if tok in req.sampling.stop_token_ids
                                 else "length")
            req.finished_at = time.perf_counter()
            req.stream.put(None)
            req.done.set()
            # blocks go cached-free: content stays prefix-reusable until
            # the pool reallocates them
            self.pool.unref_all(self.allocs[slot].blocks)
            self.slots[slot] = None
            self.allocs[slot] = None
            self.offsets[slot] = 0
            self._tables[slot] = self.num_blocks   # idle writes → scratch
            self._admit_order.remove(slot)

    # -- prefill/decode disaggregation handoff -----------------------------
    def prefill_only(self, prompt_tokens: List[int]):
        """Prefill WITHOUT occupying a decode slot: returns (kv_small,
        last_logits_numpy, prompt_len) for transfer to a decode engine.
        ``kv_small`` holds CPU tensors in the model dtype (numpy has no
        bfloat16; the JAX engine returns numpy arrays here)."""
        n = len(prompt_tokens)
        bucket = self._bucket_for(n)
        if bucket is None:
            raise ValueError(f"prompt of {n} tokens exceeds buckets")
        toks = np.zeros((1, bucket), np.int32)
        toks[0, :n] = prompt_tokens
        last_logits, small = self._prefill(
            self.params, self._dev(toks), self._dev(np.asarray([n], np.int32)))
        kv = {"k": small["k"].cpu(), "v": small["v"].cpu()}
        self.stats["prefills"] += 1
        return kv, last_logits[0].cpu().numpy(), n

    def submit_prefilled(self, prompt_tokens: List[int], kv: Dict[str, Any],
                         last_logits, sampling: Optional[SamplingParams]
                         = None) -> Optional[Request]:
        """Admit a request whose prefill happened elsewhere. Returns None
        if no slot (or pool room) is free (caller retries)."""
        req = Request(prompt_tokens, sampling or SamplingParams())
        n = len(prompt_tokens)
        if n >= self.max_seq:
            req.finish_reason = "prompt_too_long"
            req.finished_at = time.perf_counter()
            req.done.set()
            req.stream.put(None)
            return req
        with self._lock:
            free = [i for i, s in enumerate(self.slots) if s is None]
            if not free:
                return None
            bs = self.block_size
            Tb = kv["k"].shape[2]
            nb = Tb // bs
            need = max((n + 1 + bs - 1) // bs, 1)
            blocks = self.pool.alloc(max(need, 0))
            if blocks is None:
                return None
            alloc = SlotAllocation(blocks, 0)
            block_ids = np.full(nb, self.num_blocks, np.int32)
            avail = blocks[:nb]
            block_ids[:len(avail)] = avail
            small = {name: torch.as_tensor(kv[name]).to(self.device)
                     for name in ("k", "v")}
            self._insert(small, self._dev(block_ids))
            slot = free[0]
            logits = torch.as_tensor(np.asarray(last_logits),
                                     device=self.device)[None]
            toks_out = self._sample_batch(logits, [req], 1)
            self.stats["requests"] += 1
            self._activate(slot, req, alloc, n, time.perf_counter())
            self._emit(slot, int(toks_out[0]))
        return req

    # -- convenience -------------------------------------------------------
    def generate(self, prompts: List[List[int]],
                 sampling: Optional[SamplingParams] = None
                 ) -> List[Request]:
        reqs = [self.submit(p, sampling) for p in prompts]
        while self.has_work():
            self.step()
        return reqs

    def run_forever(self, stop_event: threading.Event,
                    idle_sleep_s: float = 0.002) -> None:
        """Background engine loop (used by the serving integration)."""
        while not stop_event.is_set():
            if self.step() == 0 and not self.waiting:
                time.sleep(idle_sleep_s)
