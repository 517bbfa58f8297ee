"""Prefill/decode disaggregation (counterpart of ``ray_tpu/llm/disagg.py``).

Reference: `llm/_internal/serve/deployments/prefill_decode_disagg/` —
prefill replicas (compute-bound) and decode replicas (memory-bandwidth-
bound) scale independently; the prompt's KV cache transfers between them
(reference: NIXL/NCCL). Here the prefill engine copies the prompt's K/V to
the host in the model dtype (``ContinuousBatchingEngine.prefill_only``),
the object store hands that over in process, and the decode server copies
it onto its own device before ``submit_prefilled`` admits it.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List

import torch

from ray_tpu_torch import serve
from ray_tpu_torch._device import DeviceLike, resolve_device
from ray_tpu_torch.llm.engine import ContinuousBatchingEngine, SamplingParams
from ray_tpu_torch.llm.serving import LLMConfig, start_engine_loop
from ray_tpu_torch.llm.tokenizer import ByteTokenizer, load_tokenizer


def _build_model(config: LLMConfig, params, device: DeviceLike):
    from ray_tpu_torch.models.llama import LlamaConfig, LlamaModel
    cfg = config.model_config or LlamaConfig.debug(
        vocab_size=512, max_seq_len=config.max_seq)
    model = LlamaModel(cfg, device=device)
    if params is None:
        params = model.init(config.seed)
    return model, params


class PrefillServer:
    """Compute-bound plane: prompt → (kv, first-token logits)."""

    def __init__(self, config: LLMConfig, params=None,
                 device: DeviceLike = None):
        model, params = _build_model(config, params, device)
        self.engine = ContinuousBatchingEngine(
            model, params, max_slots=1, max_seq=config.max_seq,
            block_size=config.block_size,
            num_blocks=config.num_blocks)
        self.tokenizer = (load_tokenizer(config.tokenizer)
                          if config.tokenizer else ByteTokenizer())
        # seconds of each prefill_only call: the prompt's forward pass and
        # the copy of its K/V to the host
        self.prefill_s: List[float] = []

    def prefill(self, prompt) -> Dict[str, Any]:
        ids = (prompt if isinstance(prompt, list)
               else self.tokenizer.encode(prompt))
        t0 = time.perf_counter()
        kv, last_logits, n = self.engine.prefill_only(ids)
        self.prefill_s.append(time.perf_counter() - t0)
        return {"kv": kv, "last_logits": last_logits, "prompt_ids": ids}

    def stats(self) -> Dict[str, Any]:
        return {**self.engine.stats, "prefill_s": list(self.prefill_s)}


class DecodeServer:
    """Bandwidth-bound plane: continues generation from transferred KV."""

    def __init__(self, config: LLMConfig, params=None,
                 device: DeviceLike = None):
        model, params = _build_model(config, params, device)
        self.engine = ContinuousBatchingEngine(
            model, params, max_slots=config.max_slots,
            max_seq=config.max_seq, block_size=config.block_size,
            num_blocks=config.num_blocks)
        self.tokenizer = (load_tokenizer(config.tokenizer)
                          if config.tokenizer else ByteTokenizer())
        # (bytes of the K/V handed over, seconds of its copy onto this
        # engine's device) per request; on a card the copy from pageable
        # host memory first waits for the work queued on the stream
        self.handoffs: List[tuple] = []
        self._stop, self._loop, self._thread = start_engine_loop(
            self.engine)

    def decode(self, prefill_out: Dict[str, Any],
               max_tokens: int = 32, temperature: float = 0.0
               ) -> Dict[str, Any]:
        sampling = SamplingParams(max_tokens=max_tokens,
                                  temperature=temperature)
        # the handoff's copy onto this device, once (submit_prefilled
        # keeps tensors already there as they are)
        t0 = time.perf_counter()
        kv = {name: torch.as_tensor(t).to(self.engine.device)
              for name, t in prefill_out["kv"].items()}
        self.handoffs.append(
            (sum(t.numel() * t.element_size() for t in kv.values()),
             time.perf_counter() - t0))
        req = None
        deadline = time.time() + 300
        while req is None and time.time() < deadline:
            req = self.engine.submit_prefilled(
                prefill_out["prompt_ids"], kv,
                prefill_out["last_logits"], sampling)
            if req is None:
                time.sleep(0.01)   # all slots busy: continuous batching
        if req is None:
            raise TimeoutError("no decode slot became free")
        req.done.wait(timeout=300)
        return {"token_ids": list(req.output),
                "text": self.tokenizer.decode(req.output),
                "finish_reason": req.finish_reason,
                "ttft_s": req.ttft_s}

    def stats(self) -> Dict[str, Any]:
        return {**self.engine.stats, "handoffs": list(self.handoffs)}

    def __del__(self):
        try:
            self._stop.set()
        except AttributeError:   # __init__ failed before the event existed
            pass


class PDOrchestrator:
    """Ingress: prefill handle → decode handle (the `1p1d`-style graph)."""

    def __init__(self, prefill_handle, decode_handle):
        self.prefill = prefill_handle
        self.decode = decode_handle

    def __call__(self, request: Dict[str, Any]) -> Dict[str, Any]:
        pre = self.prefill.prefill.remote(request["prompt"]).result()
        return self.decode.decode.remote(
            pre, request.get("max_tokens", 32),
            request.get("temperature", 0.0)).result()


def build_pd_disagg_app(config: LLMConfig, *, num_prefill: int = 1,
                        num_decode: int = 1, params=None,
                        device: DeviceLike = None) -> serve.Application:
    """`build_pd_openai_app` equivalent (reference: serve config with
    prefill_config/decode_config). ``params`` and ``device`` go to both
    servers; ``device=None`` is the card, and raises here on a host
    without one."""
    device = resolve_device(device)
    prefill_dep = serve.deployment(
        PrefillServer, name=f"{config.model_id}-prefill",
        num_replicas=num_prefill)
    decode_dep = serve.deployment(
        DecodeServer, name=f"{config.model_id}-decode",
        num_replicas=num_decode)
    orchestrator = serve.deployment(
        PDOrchestrator, name=f"{config.model_id}-pd")
    return orchestrator.bind(prefill_dep.bind(config, params, device),
                             decode_dep.bind(config, params, device))
