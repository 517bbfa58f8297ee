"""The port's continuous-batching engine and server held against the JAX
engine on the CPU.

Both engines run the debug model in f32 from the same (converted) params
over the scenarios of tests/test_llm_paged.py; greedy outputs must agree
token for token, and so must the scheduler's stats and the block pool's
final state. Sampling streams differ between ``jax.random`` and torch, so
temperature > 0 is checked for reproducibility and ``top_k=1 == greedy``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.llm import ContinuousBatchingEngine as JEngine
from ray_tpu.llm import SamplingParams as JSampling
from ray_tpu.models.llama import LlamaConfig as JConfig
from ray_tpu.models.llama import LlamaModel as JModel
from ray_tpu_torch.llm import (ContinuousBatchingEngine, LLMConfig,
                               LLMServer, SamplingParams)
from ray_tpu_torch.llm.paged_cache import BlockPool
from ray_tpu_torch.models import LlamaConfig, LlamaModel, params_from_numpy

SIDES = {"jax": (JEngine, JSampling), "torch": (ContinuousBatchingEngine,
                                                 SamplingParams)}


@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(JConfig.debug(vocab_size=512, max_seq_len=128),
                               dtype=jnp.float32)
    tcfg = dataclasses.replace(
        LlamaConfig.debug(vocab_size=512, max_seq_len=128),
        dtype=torch.float32)
    jm = JModel(jcfg)
    jp = jm.init(jax.random.key(0))
    tm = LlamaModel(tcfg, device="cpu")
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return {"jax": (jm, jp), "torch": (tm, tp)}


def _engine(models, side, **kw):
    model, params = models[side]
    return SIDES[side][0](model, params, **kw)


def _summary(eng, reqs):
    return {"outputs": [list(r.output) for r in reqs],
            "finish": [r.finish_reason for r in reqs],
            "preempted": [r.preemptions for r in reqs],
            "stats": dict(eng.stats), "free": eng.pool.num_free,
            "refcount": list(eng.pool.refcount)}


def _block_reclaim(models, side):
    eng = _engine(models, side, max_slots=2, max_seq=64,
                  prefill_buckets=(8, 16), block_size=8)
    reqs = eng.generate([[1, 2, 3], [4, 5, 6, 7, 8, 9]],
                        SIDES[side][1](max_tokens=6))
    return _summary(eng, reqs)


def _prefix_cross_request(models, side):
    prefix = [(7 * i + 3) % 500 for i in range(16)]
    eng = _engine(models, side, max_slots=2, max_seq=64,
                  prefill_buckets=(8, 16, 32), block_size=8)
    sp = SIDES[side][1](max_tokens=4)
    r1 = eng.generate([prefix + [100, 101]], sp)[0]
    r2 = eng.generate([prefix + [200, 201, 202]], sp)[0]
    return _summary(eng, [r1, r2])


def _prefix_concurrent(models, side):
    prefix = [(11 * i + 5) % 500 for i in range(8)]
    eng = _engine(models, side, max_slots=4, max_seq=64,
                  prefill_buckets=(8, 16), block_size=8)
    sp = SIDES[side][1](max_tokens=8)
    r0 = eng.submit(prefix + [100], sp)
    eng.step()                       # prefill + seal the prefix block
    r1 = eng.submit(prefix + [101], sp)
    r2 = eng.submit(prefix + [102], sp)
    eng.step()                       # admits both; r0 still active
    shared = eng.pool.refcount[eng.allocs[0].blocks[0]]
    while eng.has_work():
        eng.step()
    return dict(_summary(eng, [r0, r1, r2]), shared_refcount=shared)


def _preemption(models, side):
    eng = _engine(models, side, max_slots=2, max_seq=64,
                  prefill_buckets=(8, 16), block_size=8, num_blocks=5)
    reqs = eng.generate([[1, 2, 3, 4, 5], [9, 8, 7]],
                        SIDES[side][1](max_tokens=20))
    return _summary(eng, reqs)


def _oversubscribed(models, side):
    eng = _engine(models, side, max_slots=4, max_seq=64,
                  prefill_buckets=(8, 16, 32), block_size=8, num_blocks=6)
    reqs = eng.generate([[10 + i, 20 + i, 30 + i] for i in range(8)],
                        SIDES[side][1](max_tokens=10))
    return _summary(eng, reqs)


def _chunked_prefill(models, side):
    eng = _engine(models, side, max_slots=2, max_seq=64,
                  prefill_buckets=(8, 16), block_size=8)
    prompt = [(13 * i + 11) % 500 for i in range(21)]
    return _summary(eng, eng.generate([prompt],
                                      SIDES[side][1](max_tokens=5)))


def _soak(models, side):
    rng = np.random.default_rng(0)
    eng = _engine(models, side, max_slots=6, max_seq=64,
                  prefill_buckets=(8, 16, 32), block_size=8, num_blocks=40)
    prefixes = [[int(t) for t in rng.integers(1, 500, 8)] for _ in range(3)]
    reqs = []
    for i in range(60):
        if i % 2 == 0:
            p = prefixes[i % 3] + [int(t) for t in rng.integers(1, 500, 3)]
        else:
            p = [int(t) for t in rng.integers(1, 500,
                                              int(rng.integers(2, 20)))]
        reqs.append(eng.submit(p, SIDES[side][1](
            max_tokens=int(rng.integers(1, 8)))))
    while eng.has_work():
        eng.step()
    return _summary(eng, reqs)


SCENARIOS = {
    "block_reclaim": _block_reclaim,
    "prefix_cross_request": _prefix_cross_request,
    "prefix_concurrent": _prefix_concurrent,
    "preemption": _preemption,
    "oversubscribed": _oversubscribed,
    "chunked_prefill": _chunked_prefill,
    "soak": _soak,
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_engine_matches_jax_engine(models, name):
    got = SCENARIOS[name](models, "torch")
    want = SCENARIOS[name](models, "jax")
    assert got["outputs"] == want["outputs"]
    assert got == want
    # and the scenario's own invariants (tests/test_llm_paged.py)
    assert all(c == 0 for c in got["refcount"])
    assert got["free"] == len(got["refcount"])
    if name in ("preemption", "oversubscribed"):
        assert got["stats"]["preemptions"] >= 1 or name == "oversubscribed"
    if name.startswith("prefix") or name == "soak":
        assert got["stats"]["prefix_prefills"] > 0
    if name == "prefix_concurrent":
        assert got["shared_refcount"] == 3


def test_live_pool_decode_kernel_matches_reference(models):
    """decode_step_paged through the kernel (its plain version on CPU)
    against the reference on an identical, cloned live pool."""
    model, params = models["torch"]
    eng = ContinuousBatchingEngine(model, params, max_slots=2, max_seq=64,
                                   prefill_buckets=(8, 16), block_size=8)
    eng.submit([3, 1, 4, 1, 5], SamplingParams(max_tokens=40))
    eng.submit([2, 7, 2, 7, 2, 7, 2, 7, 2], SamplingParams(max_tokens=40))
    for _ in range(12):                     # grow past one block each
        eng.step()
    assert (eng.offsets[:2] > 8).all()
    kmodel = LlamaModel(dataclasses.replace(model.cfg,
                                            decode_attention="kernel"),
                        device="cpu")
    args = (torch.tensor([9, 11]), torch.tensor(eng._tables[:2]),
            torch.tensor(eng.offsets[:2]))
    pools = [{k: v.clone() for k, v in eng.kv.items()} for _ in range(2)]
    lr, pr = model.decode_step_paged(params, args[0], pools[0], *args[1:])
    lk, pk = kmodel.decode_step_paged(params, args[0], pools[1], *args[1:])
    torch.testing.assert_close(lk, lr, rtol=1e-4, atol=1e-4)
    scratch = eng.num_blocks
    torch.testing.assert_close(pk["k"][:, :scratch], pr["k"][:, :scratch])


def test_sampling_reproducible_and_top1_is_greedy(models):
    prompts = [[5, 6, 7], [8, 9, 10, 11]]

    def run(sampling):
        eng = _engine(models, "torch", max_slots=2, max_seq=64,
                      prefill_buckets=(8, 16), block_size=8)
        return [r.output for r in eng.generate(prompts, sampling)]

    hot = SamplingParams(max_tokens=8, temperature=1.5)
    assert run(hot) == run(hot)
    greedy = run(SamplingParams(max_tokens=8))
    assert run(SamplingParams(max_tokens=8, temperature=1.0,
                              top_k=1)) == greedy
    assert greedy == _summary_outputs(models, prompts)


def _summary_outputs(models, prompts):
    eng = _engine(models, "jax", max_slots=2, max_seq=64,
                  prefill_buckets=(8, 16), block_size=8)
    return [r.output for r in eng.generate(prompts, JSampling(max_tokens=8))]


def test_prefill_handoff_matches_local_generation(models):
    prompt = [4, 8, 15, 16, 23, 42]
    pre = _engine(models, "torch", max_slots=1, max_seq=64,
                  prefill_buckets=(8, 16), block_size=8)
    kv, last_logits, n = pre.prefill_only(prompt)
    assert n == len(prompt) and kv["k"].device.type == "cpu"
    dec = _engine(models, "torch", max_slots=1, max_seq=64,
                  prefill_buckets=(8, 16), block_size=8)
    req = dec.submit_prefilled(prompt, kv, last_logits,
                               SamplingParams(max_tokens=6))
    while dec.has_work():
        dec.step()
    local = _engine(models, "torch", max_slots=1, max_seq=64,
                    prefill_buckets=(8, 16), block_size=8)
    want = local.generate([prompt], SamplingParams(max_tokens=6))[0].output
    assert req.output == want
    assert dec.submit_prefilled(list(range(70)), kv, last_logits) \
        .finish_reason == "prompt_too_long"


def test_llm_server_call_and_stream_on_cpu():
    server = LLMServer(LLMConfig(max_slots=2, max_seq=64), device="cpu")
    try:
        out = server({"prompt": "hello", "max_tokens": 5})
        assert out["finish_reason"] in ("length", "stop")
        assert 1 <= len(out["token_ids"]) <= 5
        assert out["usage"]["prompt_tokens"] == 6     # BOS + 5 bytes
        chunks = list(server({"prompt": "hello", "max_tokens": 5,
                              "stream": True}))
        assert chunks[-1]["done"] is True
        assert [c["token_id"] for c in chunks[:-1]] == out["token_ids"]
        assert server.stats()["requests"] == 2
        assert server.queue_depth() == 0
        assert server.error is None
    finally:
        server.shutdown()
    assert not server._thread.is_alive()


@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_llm_server_engine_failure_finishes_requests():
    server = LLMServer(LLMConfig(max_slots=2, max_seq=64), device="cpu")
    try:
        def boom(*_a, **_k):
            raise RuntimeError("device lost")
        server.engine._decode_step = boom
        out = server({"prompt": "hi", "max_tokens": 3})
        assert out["finish_reason"] == "error"
        assert isinstance(server.error, RuntimeError)
    finally:
        server.shutdown()


def test_paged_cache_copy_behaves_like_the_reference():
    from ray_tpu.llm.paged_cache import BlockPool as JPool
    prompt = list(range(9))
    assert BlockPool.chain_hashes(prompt, 4) == JPool.chain_hashes(prompt, 4)
