"""The port's LLM serving app against the JAX package's on the CPU.

JAX's LLM serve tests (tests/test_llm.py, tests/test_serve.py) on the
port's ``build_llm_app``, prefix router and prefill/decode graph with
``device="cpu"``; the same f32 debug Llama params through JAX's apps on
``ray_tpu.serve`` and through the port's two apps on its serve, token for
token; and the two faults repaired in the port's serving: a dropped or
killed ``LLMServer`` stops its engine (C5), and ``LLMConfig`` carries
JAX's ``num_replicas`` and ``max_ongoing_requests`` (C6).
"""

import dataclasses
import gc
import threading
import time
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu_torch
from ray_tpu_torch import serve
from ray_tpu_torch.llm import (ContinuousBatchingEngine, LLMConfig,
                               LLMServer, SamplingParams, build_llm_app)
from ray_tpu_torch.llm.disagg import build_pd_disagg_app
from ray_tpu_torch.models import LlamaConfig, LlamaModel, params_from_numpy


@pytest.fixture(autouse=True)
def one_thread():
    """Small torch models under xdist: one intra-op thread per worker."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture
def ray_start_regular():
    rt = ray_tpu_torch.init(num_nodes=1, resources={"CPU": 8})
    yield rt
    serve.shutdown()
    ray_tpu_torch.shutdown()


def test_llm_serve_app(ray_start_regular):
    app = build_llm_app(LLMConfig(max_slots=2, max_seq=128), device="cpu")
    handle = serve.run(app)
    out = handle.remote({"prompt": "hi", "max_tokens": 4}).result(
        timeout=120)
    assert out["usage"]["completion_tokens"] == 4
    assert out["finish_reason"] == "length"
    assert isinstance(out["text"], str)
    stats = handle.stats.remote().result()
    assert stats["requests"] == 1


def test_llm_serve_token_streaming(ray_start_regular):
    """LLM serving streams engine tokens chunk-by-chunk through Serve."""
    app = build_llm_app(LLMConfig(max_slots=2, max_seq=128), device="cpu")
    handle = serve.run(app)
    gen = handle.options(stream=True).remote(
        {"prompt": "hello", "max_tokens": 8, "stream": True})
    chunks = list(gen)
    assert chunks[-1].get("done") is True
    deltas = [c for c in chunks if "delta" in c]
    assert 1 <= len(deltas) <= 8
    assert chunks[-1]["usage"]["completion_tokens"] == len(deltas)


def test_prefix_router_affinity_and_balance():
    """JAX's test on the port's own copy, and the same choices as JAX's
    router for the same seed."""
    from ray_tpu.llm.prefix_router import PrefixAwareRouter as JRouter
    from ray_tpu_torch.llm.prefix_router import PrefixAwareRouter

    choices = {}
    for cls in (PrefixAwareRouter, JRouter):
        router = cls(4, block_size=4)
        prompt_a = list(range(100, 116))
        r1 = router.route(prompt_a)
        router.on_finished(r1)
        # same prefix → same replica
        assert router.route(prompt_a + [1, 2]) == r1
        router.on_finished(r1)
        # distinct prompts spread across replicas
        seen = []
        for i in range(40):
            prompt = [i * 1000 + j for j in range(16)]
            r = router.route(prompt)
            seen.append(r)
            router.on_finished(r)
        assert len(set(seen)) >= 3
        choices[cls] = [r1] + seen
    assert choices[PrefixAwareRouter] == choices[JRouter]


def test_prefill_decode_disagg_matches_colocated(ray_start_regular):
    """1p1d disaggregated serving produces the same greedy tokens as a
    colocated engine."""
    cfg = LlamaConfig.debug(vocab_size=512, max_seq_len=128)
    model = LlamaModel(cfg, device="cpu")
    params = model.init(0)
    prompt_ids = [1, 7, 42, 99, 3]
    colocated = ContinuousBatchingEngine(model, params, max_slots=1,
                                         max_seq=128,
                                         prefill_buckets=(8,))
    expect = colocated.generate([prompt_ids],
                                SamplingParams(max_tokens=6))[0].output

    app = build_pd_disagg_app(LLMConfig(max_slots=2, max_seq=128),
                              device="cpu")
    handle = serve.run(app)
    out = handle.remote({"prompt": prompt_ids,
                         "max_tokens": 6}).result(timeout=300)
    assert out["token_ids"] == expect
    assert out["finish_reason"] == "length"
    decode = serve.get_deployment_handle("llama-debug-decode")
    (kv_bytes, copy_s), = decode.stats.remote().result()["handoffs"]
    # K and V of the engine's smallest prefill bucket, 32 tokens, in the
    # model dtype
    elt = torch.empty((), dtype=cfg.dtype).element_size()
    assert kv_bytes == (2 * cfg.n_layers * 32 * cfg.n_kv_heads
                        * cfg.head_dim * elt)
    assert copy_s > 0


PROMPTS = ["hello", [1, 7, 42, 99, 3], "the port", list(range(20, 50))]


def _serve_prompts(pkg, handle) -> list:
    outs = [handle.remote({"prompt": p, "max_tokens": 8}) for p in PROMPTS]
    return [o.result(timeout=300)["token_ids"] for o in outs]


def test_apps_match_jax_apps_token_for_token(monkeypatch):
    """The f32 debug Llama's params from JAX's init through JAX's
    ``build_llm_app`` and ``build_pd_disagg_app`` on ``ray_tpu.serve``,
    and the same params converted into the port's two apps on its serve:
    four greedy prompts give equal token ids."""
    from ray_tpu import serve as jserve
    from ray_tpu.llm import LLMConfig as JLLMConfig
    from ray_tpu.llm import build_llm_app as jbuild_llm_app
    from ray_tpu.llm.disagg import build_pd_disagg_app as jbuild_pd
    from ray_tpu.models.llama import LlamaConfig as JConfig
    from ray_tpu.models.llama import LlamaModel as JModel

    jcfg = dataclasses.replace(JConfig.debug(vocab_size=512,
                                             max_seq_len=128),
                               dtype=jnp.float32)
    tcfg = dataclasses.replace(
        LlamaConfig.debug(vocab_size=512, max_seq_len=128),
        dtype=torch.float32)
    jparams = JModel(jcfg).init(jax.random.key(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg,
                                device="cpu")

    monkeypatch.setenv("RAY_TPU_PROCESS_WORKERS", "0")
    ray_tpu.init(num_nodes=1, resources={"CPU": 8})
    try:
        jconfig = JLLMConfig(model_config=jcfg, max_slots=4, max_seq=128)
        want = _serve_prompts(jserve, jserve.run(jbuild_llm_app(jconfig)))
        jserve.delete("default")
        want_pd = _serve_prompts(jserve, jserve.run(jbuild_pd(jconfig),
                                                    name="pd"))
    finally:
        jserve.shutdown()
        ray_tpu.shutdown()

    ray_tpu_torch.init(num_nodes=1, resources={"CPU": 8})
    try:
        config = LLMConfig(model_config=tcfg, max_slots=4, max_seq=128)
        got = _serve_prompts(serve, serve.run(
            build_llm_app(config, params=tparams, device="cpu")))
        serve.delete("default")
        got_pd = _serve_prompts(serve, serve.run(
            build_pd_disagg_app(config, params=tparams, device="cpu"),
            name="pd"))
    finally:
        serve.shutdown()
        ray_tpu_torch.shutdown()
    assert got == want
    assert got_pd == want_pd
    assert all(len(ids) >= 1 for ids in got)
    assert all(len(ids) == 8 for ids in got_pd)


# ---------------------------------------------------------------------------
# C5: a dropped or killed server stops its engine
# ---------------------------------------------------------------------------

def _wait_gone(ref, thread, timeout: float) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        gc.collect()
        if ref() is None and not thread.is_alive():
            return True
        time.sleep(0.05)
    return False


def test_dropped_llm_server_stops_its_engine():
    server = LLMServer(LLMConfig(max_slots=2, max_seq=64), device="cpu")
    assert server({"prompt": "hi", "max_tokens": 2})["token_ids"]
    ref, thread = weakref.ref(server), server._thread
    del server
    assert _wait_gone(ref, thread, 5.0), \
        "the dropped server was not collected or its engine still runs"


def _replica_callable(name: str):
    """The user callable of a deployment's one replica actor."""
    from ray_tpu_torch._private import worker
    controller = ray_tpu_torch.get_actor("serve_controller")
    (replica,) = ray_tpu_torch.get(
        controller.get_replicas.remote(name))["replicas"]
    rt = worker.global_runtime()
    return rt._actor_executors[replica._actor_id].instance._callable


def test_deleted_llm_app_stops_its_engines(ray_start_regular):
    """``serve.delete`` of the LLM app and ``serve.shutdown`` of the
    prefill/decode graph kill the replica actors (``delete`` removes an
    app's ingress deployment only, as in JAX): each server is collected
    and its engine thread ends."""
    handle = serve.run(build_llm_app(LLMConfig(max_slots=2, max_seq=64),
                                     device="cpu"))
    assert handle.remote({"prompt": "hi", "max_tokens": 2}).result(
        timeout=120)["token_ids"]
    server = _replica_callable("llama-debug")
    ref, thread = weakref.ref(server), server._thread
    del server
    serve.delete("default")
    assert _wait_gone(ref, thread, 10.0)

    handle = serve.run(build_pd_disagg_app(
        LLMConfig(max_slots=2, max_seq=64), device="cpu"), name="pd")
    assert handle.remote({"prompt": "hi", "max_tokens": 2}).result(
        timeout=120)["token_ids"]
    decode = _replica_callable("llama-debug-decode")
    ref, thread = weakref.ref(decode), decode._thread
    del decode, handle
    serve.shutdown()
    assert _wait_gone(ref, thread, 10.0)
    left = [t for t in threading.enumerate() if t.name == "llm-engine"]
    assert not left, left


# ---------------------------------------------------------------------------
# C6: JAX's LLMConfig fields
# ---------------------------------------------------------------------------

def test_llm_config_replicas_and_ongoing_requests(ray_start_regular):
    config = LLMConfig(max_slots=2, max_seq=64, num_replicas=2,
                       max_ongoing_requests=8)
    app = build_llm_app(config, device="cpu")
    assert app.deployment.num_replicas == 2
    assert app.deployment.max_ongoing_requests == 8
    handle = serve.run(app)
    assert serve.status()["llama-debug"]["num_replicas"] == 2
    outs = [handle.remote({"prompt": "hi", "max_tokens": 2})
            for _ in range(4)]
    assert all(o.result(timeout=120)["usage"]["completion_tokens"] == 2
               for o in outs)


def test_apps_need_a_device_or_the_card():
    """No fallback hides the device: with no ``device`` both builders
    resolve the card, and raise on a host without one."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    for build in (build_llm_app, build_pd_disagg_app):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build(LLMConfig())
