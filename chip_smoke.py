#!/usr/bin/env python3
"""Drive the PyTorch port (``ray_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

1. Builds the port's CUDA kernels from ``ray_tpu_torch/csrc`` with nvcc.
2. Holds each kernel against its plain PyTorch version on the card: bf16 at
   the serving slice's shapes (32 slots, 32 query / 8 KV heads, head_dim
   128, block 32, lengths spread over 1..1024) and f32 at the repo's test
   shapes, and times kernel, plain version and a library yardstick
   (``scaled_dot_product_attention`` on the dense view; the port never calls
   it) beside the least time the card could take.
3. Drives the main path with every launch counter at 0: ``LLMServer`` on the
   card with Llama-3-8B's widths (random weights from seed 0) answers 16
   requests through ``__call__`` and ``stream`` (prompts of 32-256 tokens,
   four sharing a 64-token prefix, 32 new tokens each), then one
   ``forward_step`` with T=1 on a dense cache. The paged kernel must have
   run once per layer per decode step, the ragged kernel once per layer.
4. Compares ``decode_step_paged`` through the kernel with the reference
   implementation on identical (cloned) live pools at the repo's bf16 bar.

It prints the card's name and power limit, a ``{"kernels": [...]}`` line,
and last ``{"ok": true, "device": {...}}``. Any failed phase raises, and the
script then exits non-zero; without a CUDA device it exits 2 and prints no
result.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import threading
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
PEAK_OPS = {"bfloat16": 989e12,    # dense tensor-core rate
            "float32": 67e12}      # outside the tensor cores
# kernel vs plain, bf16 output: mostly relative, two bf16 ulps (2**-6); the
# atol covers outputs near 0, whose magnitude is ~1/sqrt(length)
BF16_TOL = dict(atol=5e-3, rtol=1.6e-2)
STEP_TOL = dict(atol=0.15, rtol=0.05)   # tests/test_llm_paged.py bf16 bar


def log(msg: str) -> None:
    print(msg, flush=True)


def tol_ratio(a, b, tol=BF16_TOL) -> float:
    """max |a - b| / (atol + rtol |b|): above 1 fails ``tol``."""
    a, b = a.float(), b.float()
    return ((a - b).abs() / (tol["atol"] + tol["rtol"] * b.abs())) \
        .max().item()


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(bytes_moved: float, ops: float, dtype) -> tuple:
    dname = str(dtype).replace("torch.", "")
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS[dname]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def decode_work(lengths, H, Hkv, D, elt, tables_read=0):
    """Bytes and operations one decode-attention call needs for these
    lengths: K and V of the live context, q, out, lengths and the table
    entries it reads; two multiply-adds per (head, row, d)."""
    live = int(sum(lengths))
    B = len(lengths)
    nbytes = (2 * live * Hkv * D * elt + 2 * B * H * D * elt + 4 * B
              + 4 * tables_read)
    return nbytes, 4 * H * D * live


def sdpa_ms(q, k_dense, v_dense, lengths, iters):
    """The library yardstick: one SDPA call on the dense [B, S, Hkv, D]
    view with a length mask and grouped heads."""
    import torch
    import torch.nn.functional as F
    S = k_dense.shape[1]
    qq = q[:, :, None, :]                                   # [B, H, 1, D]
    kk = k_dense.transpose(1, 2)                            # [B, Hkv, S, D]
    vv = v_dense.transpose(1, 2)
    mask = (torch.arange(S, device=q.device)[None, :]
            < lengths[:, None])[:, None, None, :]
    return cuda_ms(lambda: F.scaled_dot_product_attention(
        qq, kk, vv, attn_mask=mask, enable_gqa=True), iters)


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def check_kernels(dev, gen) -> list:
    import torch
    from ray_tpu_torch.ops import decode_attention as dec
    from ray_tpu_torch.ops import paged_attention as paged

    def rand(shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    # f32 at the repo's test shapes, the repo's own tolerances
    q, kp, vp = (rand((4, 8, 128), torch.float32),
                 rand((32, 16, 4, 128), torch.float32),
                 rand((32, 16, 4, 128), torch.float32))
    tables = torch.randperm(32, generator=gen, device=dev)[:24] \
        .view(4, 6).int()
    lens = torch.tensor([1, 16, 37, 96], dtype=torch.int32, device=dev)
    out = paged.paged_decode_attention_kernel(q, kp, vp, tables, lens)
    plain = paged._paged_decode_plain(q, kp, vp, tables, lens,
                                      scale=128 ** -0.5)
    torch.testing.assert_close(out, plain, atol=1e-4, rtol=1e-4)
    err_paged_f32 = (out - plain).abs().max().item()
    errs_ragged_f32 = []
    for B, S, H, Hkv, D, lengths in ((4, 256, 8, 2, 32, [1, 100, 200, 256]),
                                     (2, 96, 4, 4, 16, [37, 96])):
        q = rand((B, H, D), torch.float32)
        k = rand((B, S, Hkv, D), torch.float32)
        v = rand((B, S, Hkv, D), torch.float32)
        lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
        out = dec.ragged_decode_attention_kernel(q, k, v, lens)
        plain = dec._ragged_decode_plain(q, k, v, lens, block_k=64,
                                         scale=D ** -0.5)
        torch.testing.assert_close(out, plain, atol=2e-6, rtol=2e-5)
        errs_ragged_f32.append((out - plain).abs().max().item())
    log(f"f32 at the repo's test shapes: paged max_abs_err "
        f"{err_paged_f32:.3e} (tol 1e-4), ragged {errs_ragged_f32} "
        f"(rtol 2e-5 atol 2e-6)")

    # bf16 at the slice's shapes
    B, H, Hkv, D, bs, maxb = 32, 32, 8, 128, 32, 32
    NB = B * maxb + 1                          # + the engine's scratch block
    dt = torch.bfloat16
    scale = D ** -0.5
    lengths = np.linspace(1, maxb * bs, B).round().astype(np.int32)
    lens = torch.from_numpy(lengths).to(dev)
    # a wrong kernel to hold the bound against: each slot longer than 512
    # loses its last 32-row tile
    long_slots = torch.from_numpy(np.flatnonzero(lengths > 512)).to(dev)
    short = torch.from_numpy(lengths - ((lengths - 1) % 32 + 1)).to(dev)
    q = rand((B, H, D), dt)
    kp, vp = rand((NB, bs, Hkv, D), dt), rand((NB, bs, Hkv, D), dt)
    tables = torch.randperm(NB - 1, generator=gen, device=dev) \
        .view(B, maxb).int()
    rows = []

    # paged
    out = paged.paged_decode_attention_kernel(q, kp, vp, tables, lens)
    plain = paged._paged_decode_plain(q, kp, vp, tables, lens, scale=scale)
    torch.testing.assert_close(out.float(), plain.float(), **BF16_TOL)
    wrong = paged._paged_decode_plain(q, kp, vp, tables, short, scale=scale)
    skip_ratio = tol_ratio(wrong[long_slots], plain[long_slots])
    ms = cuda_ms(lambda: paged._launch_paged(q, kp, vp, tables, lens,
                                             scale), 50)
    plain_ms = cuda_ms(lambda: paged._paged_decode_plain(
        q, kp, vp, tables, lens, scale=scale), 5)
    dense_k = kp[tables.long()].reshape(B, maxb * bs, Hkv, D)
    dense_v = vp[tables.long()].reshape(B, maxb * bs, Hkv, D)
    lib_ms = sdpa_ms(q, dense_k, dense_v, lens, 20)
    nbytes, ops = decode_work(lengths, H, Hkv, D, 2,
                              tables_read=int(np.sum(-(-lengths // bs))))
    b_ms, b_by = bound_ms(nbytes, ops, dt)
    rows.append({"name": "paged_decode_attention",
                 "route": "cuda",
                 "source": "ray_tpu_torch/csrc/decode_attention.cu",
                 "replaces": "ray_tpu/ops/paged_attention.py:55",
                 "max_abs_err": (out.float() - plain.float()).abs().max()
                 .item(),
                 "tol_ratio": tol_ratio(out, plain), "skip_ratio": skip_ratio,
                 "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                 "bound_by": b_by, "library_ms": lib_ms})

    # ragged, dense cache [B, S, Hkv, D] with S = 1024
    S = maxb * bs
    k, v = dense_k.contiguous(), dense_v.contiguous()
    out = dec.ragged_decode_attention_kernel(q, k, v, lens)
    plain = dec._ragged_decode_plain(q, k, v, lens, block_k=128, scale=scale)
    torch.testing.assert_close(out.float(), plain.float(), **BF16_TOL)
    wrong = dec._ragged_decode_plain(q, k, v, short, block_k=128,
                                     scale=scale)
    skip_ratio = tol_ratio(wrong[long_slots], plain[long_slots])
    ms = cuda_ms(lambda: dec._launch_ragged(q, k, v, lens, scale), 50)
    plain_ms = cuda_ms(lambda: dec._ragged_decode_plain(
        q, k, v, lens, block_k=128, scale=scale), 5)
    lib_ms = sdpa_ms(q, k, v, lens, 20)
    nbytes, ops = decode_work(lengths, H, Hkv, D, 2)
    b_ms, b_by = bound_ms(nbytes, ops, dt)
    rows.append({"name": "ragged_decode_attention",
                 "route": "cuda",
                 "source": "ray_tpu_torch/csrc/decode_attention.cu",
                 "replaces": "ray_tpu/ops/decode_attention.py:49",
                 "max_abs_err": (out.float() - plain.float()).abs().max()
                 .item(),
                 "tol_ratio": tol_ratio(out, plain), "skip_ratio": skip_ratio,
                 "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                 "bound_by": b_by, "library_ms": lib_ms})
    for r in rows:
        log(f"{r['name']}: bf16 B={B} H={H} Hkv={Hkv} D={D} "
            f"sum(len)={int(lengths.sum())}: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.3f} ms, sdpa {r['library_ms']:.4f} ms, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}), max_abs_err "
            f"{r['max_abs_err']:.3e}, {r['tol_ratio']:.2f}x the tolerance "
            f"{BF16_TOL}; a version that skips the last tile of the slots "
            f"longer than 512 reads {r['skip_ratio']:.2f}x it")
        if r["skip_ratio"] <= 1:
            raise RuntimeError(f"{r['name']}: the bf16 tolerance does not "
                               f"tell a skipped last tile from the kernel")
    return rows


# ---------------------------------------------------------------------------
# phase 3: the main path
# ---------------------------------------------------------------------------

def serve_requests(server, vocab: int, rng) -> dict:
    """16 requests through ``__call__`` and ``stream``; four share a
    64-token prefix and arrive once the first of them has its first token
    (its prompt blocks are sealed at admission), so the prefix path runs."""
    prefix = [int(t) for t in rng.integers(0, vocab, 64)]
    plain_lens = rng.integers(32, 257, 12)
    prompts = [[int(t) for t in rng.integers(0, vocab, n)]
               for n in plain_lens]
    sharers = [prefix + [int(t) for t in rng.integers(0, vocab, n)]
               for n in (20, 60, 120, 192)]
    results = {}
    lock = threading.Lock()

    def call(i, prompt):
        out = server({"prompt": prompt, "max_tokens": 32})
        with lock:
            results[i] = (out["finish_reason"], len(out["token_ids"]))

    def stream(i, prompt, first=None):
        n = 0
        reason = None
        for chunk in server.stream({"prompt": prompt, "max_tokens": 32}):
            if chunk.get("done"):
                reason = chunk["finish_reason"]
            else:
                n += 1
                if first is not None:
                    first.set()
        with lock:
            results[i] = (reason, n)

    t0 = time.perf_counter()
    first = threading.Event()
    threads = [threading.Thread(target=stream, args=(0, sharers[0], first))]
    for i, p in enumerate(prompts):
        fn = call if i % 2 else stream
        threads.append(threading.Thread(target=fn, args=(i + 1, p)))
    for t in threads:
        t.start()
    if not first.wait(600):
        raise RuntimeError(f"no first token from the prefix owner "
                           f"(server error: {server.error!r})")
    late = [threading.Thread(target=call if j % 2 else stream,
                             args=(13 + j, p))
            for j, p in enumerate(sharers[1:])]
    for t in late:
        t.start()
    for t in threads + late:
        t.join(900)
        if t.is_alive():
            raise RuntimeError("a request did not finish in 900 s")
    wall = time.perf_counter() - t0
    if server.error is not None:
        raise RuntimeError("the engine thread failed") from server.error
    if len(results) != 16:
        raise RuntimeError(f"{len(results)} of 16 requests answered")
    for i, (reason, n) in sorted(results.items()):
        if reason not in ("length", "stop") or not 1 <= n <= 32:
            raise RuntimeError(f"request {i}: finish {reason!r}, {n} tokens")
    tokens = sum(n for _, n in results.values())
    return {"wall_s": wall, "tokens": tokens,
            "prompt_tokens": int(plain_lens.sum()) + sum(map(len, sharers))}


def dense_decode(model, params, gen, B: int, S: int, rng) -> None:
    """One ``forward_step`` with T=1 against a dense cache filled with
    random K/V, lengths spread over 1..S: the ragged kernel's path."""
    import torch
    cfg = model.cfg
    cache = model.init_kv_cache(B, S)
    for name in ("k", "v"):
        for layer in cache[name]:
            layer.copy_(torch.randn(layer.shape, generator=gen,
                                    device=model.device))
    offsets = torch.from_numpy(
        np.linspace(0, S - 1, B).round().astype(np.int32)).to(model.device)
    tokens = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)) \
        .to(model.device)
    logits, cache = model.forward_step(params, tokens, cache, offsets)
    torch.cuda.synchronize()
    if logits.shape != (B, 1, cfg.vocab_size) or \
            not torch.isfinite(logits).all():
        raise RuntimeError("forward_step(T=1) logits not finite/shaped")


def live_pool_compare(server, rng) -> dict:
    """decode_step_paged through the kernel and through the reference on
    two clones of one live pool; returns the decode step times."""
    import torch
    from ray_tpu_torch.llm import SamplingParams
    from ray_tpu_torch.models.llama import LlamaModel

    eng = server.engine
    vocab = eng.model.cfg.vocab_size
    for n in (100, 180, 260, 300):
        eng.submit([int(t) for t in rng.integers(0, vocab, n)],
                   SamplingParams(max_tokens=64))
    for _ in range(8):
        eng.step()
    active = [i for i, r in enumerate(eng.slots) if r is not None]
    if len(active) < 4 or (eng.offsets[active] <= eng.block_size).any():
        raise RuntimeError("live pool not set up: slots "
                           f"{active}, offsets {eng.offsets[active]}")
    ker = eng.model
    ref = LlamaModel(dataclasses.replace(ker.cfg,
                                         decode_attention="reference"),
                     device=ker.device)
    tokens = torch.from_numpy(
        rng.integers(0, vocab, eng.max_slots).astype(np.int32)).to(ker.device)
    tables = torch.from_numpy(eng._tables.copy()).to(ker.device)
    offsets = torch.from_numpy(eng.offsets.copy()).to(ker.device)
    pools = [{k: v.clone() for k, v in eng.kv.items()} for _ in range(2)]
    lk, pk = ker.decode_step_paged(eng.params, tokens, pools[0], tables,
                                   offsets)
    lr, pr = ref.decode_step_paged(eng.params, tokens, pools[1], tables,
                                   offsets)
    torch.cuda.synchronize()
    rows = torch.tensor(active, device=ker.device)
    err = (lk[rows] - lr[rows]).abs().max().item()
    torch.testing.assert_close(lk[rows], lr[rows], **STEP_TOL)
    # the step's only pool writes outside the scratch block: each active
    # slot's new row in every layer
    off = offsets[rows].long()
    blk = tables[rows, off // eng.block_size].long()
    for name in ("k", "v"):
        torch.testing.assert_close(
            pk[name][:, blk, off % eng.block_size].float(),
            pr[name][:, blk, off % eng.block_size].float(), **STEP_TOL)
    del pr
    # decode step time, kernel and reference, on the clones
    times = {}
    for label, model, pool in (("kernel", ker, pk), ("reference", ref,
                                                     pools[1])):
        samples = []
        for _ in range(6):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model.decode_step_paged(eng.params, tokens, pool, tables,
                                    offsets)
            torch.cuda.synchronize()
            samples.append((time.perf_counter() - t0) * 1e3)
        times[label] = float(np.median(samples[1:]))
    del pools, pk
    return {"logits_max_abs_err": err, "step_ms": times,
            "active_slots": len(active),
            "live_tokens": int(eng.offsets[active].sum())}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    from ray_tpu_torch import _build
    from ray_tpu_torch.llm import LLMConfig, LLMServer
    from ray_tpu_torch.models.llama import LlamaConfig
    from ray_tpu_torch.ops import decode_attention as dec
    from ray_tpu_torch.ops import paged_attention as paged

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    rng = np.random.default_rng(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)}")

    # 1. build
    t0 = time.perf_counter()
    lib_path = _build.build("decode_attention")
    _build.load_library("decode_attention")
    log(f"build: {lib_path.name} in {time.perf_counter() - t0:.1f} s")
    for line in lib_path.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")

    # 2. kernels against their plain versions
    rows = check_kernels(dev, gen)

    # 3. the main path, every counter at 0
    cfg = dataclasses.replace(LlamaConfig.llama3_8b(),
                              decode_attention="kernel")
    t0 = time.perf_counter()
    server = LLMServer(LLMConfig(model_id="llama3-8b", model_config=cfg,
                                 max_slots=32, max_seq=1024, seed=0),
                       device=dev)
    torch.cuda.synchronize()
    log(f"LLMServer(llama3_8b, {cfg.num_params() / 1e9:.2f} B params, "
        f"{server.engine.num_blocks + 1} pool blocks of "
        f"{server.engine.block_size}) up in {time.perf_counter() - t0:.1f} s;"
        f" {torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated")
    try:
        steps0 = server.engine.stats["decode_steps"]
        paged.paged_decode_attention_kernel.launches = 0
        dec.ragged_decode_attention_kernel.launches = 0
        serving = serve_requests(server, cfg.vocab_size, rng)
        server.shutdown()
        dense_decode(server.model, server.engine.params, gen, 32, 1024, rng)
        launches = {"paged_decode_attention":
                    paged.paged_decode_attention_kernel.launches,
                    "ragged_decode_attention":
                    dec.ragged_decode_attention_kernel.launches}
    finally:
        server.shutdown()
    stats = server.stats()
    steps = stats["decode_steps"] - steps0
    log(f"served 16 requests: {serving['tokens']} tokens in "
        f"{serving['wall_s']:.2f} s ({serving['tokens'] / serving['wall_s']:.1f}"
        f" tokens/s, {serving['prompt_tokens']} prompt tokens), engine stats "
        f"{stats}")
    log(f"launches on the main path: {launches} ({steps} decode steps x "
        f"{cfg.n_layers} layers; one dense T=1 step x {cfg.n_layers})")
    if stats["prefix_prefills"] < 3 or stats["prefix_tokens_reused"] < 192:
        raise RuntimeError(f"the prefix path did not run: {stats}")
    if steps < 1 or launches["paged_decode_attention"] != \
            cfg.n_layers * steps:
        raise RuntimeError(f"paged kernel launches {launches} != "
                           f"{cfg.n_layers} x {steps} decode steps")
    if launches["ragged_decode_attention"] != cfg.n_layers:
        raise RuntimeError(f"ragged kernel launches {launches} != "
                           f"{cfg.n_layers}")
    for r in rows:
        r["launches"] = launches[r["name"]]

    # 4. kernel decode against reference decode on a live pool
    live = live_pool_compare(server, rng)
    log(f"decode_step_paged kernel vs reference on a live pool "
        f"({live['active_slots']} slots, {live['live_tokens']} cached "
        f"tokens, max_slots 32): logits max_abs_err "
        f"{live['logits_max_abs_err']:.3e} (atol 0.15 rtol 0.05); decode "
        f"step {live['step_ms']['kernel']:.2f} ms with the kernel, "
        f"{live['step_ms']['reference']:.2f} ms with the reference")

    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    log(smi)
    log(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
