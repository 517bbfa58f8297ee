"""LLM serving on the port's serve (counterpart of
``ray_tpu/llm/serving.py``).

``LLMServer`` hosts one ``ContinuousBatchingEngine`` on a background thread;
requests stream through per-request queues. ``build_llm_app`` makes it one
serve deployment, each replica an engine on ``device``.
"""

from __future__ import annotations

import dataclasses
import gc
import threading
import time
from typing import Any, Dict, Optional

from ray_tpu_torch import serve
from ray_tpu_torch._device import DeviceLike, resolve_device
from ray_tpu_torch.llm.engine import ContinuousBatchingEngine, SamplingParams
from ray_tpu_torch.llm.tokenizer import ByteTokenizer, load_tokenizer


@dataclasses.dataclass
class LLMConfig:
    model_id: str = "llama-debug"
    model_config: Optional[Any] = None       # LlamaConfig; debug if None
    tokenizer: Optional[str] = None          # None -> ByteTokenizer
    max_slots: int = 8
    max_seq: int = 512
    num_replicas: int = 1
    max_ongoing_requests: int = 64
    seed: int = 0
    # paged KV pool: block granularity and total pool size;
    # num_blocks=None sizes the pool to max_slots * max_seq
    block_size: Optional[int] = None   # None -> engine default (32)
    num_blocks: Optional[int] = None


class _EngineLoop:
    """What an engine thread holds: the engine, the stop event and the
    error. Never the server: a thread bound to the server's own method
    keeps the server alive, so a dropped or killed server would never be
    collected, its ``__del__`` would never stop the engine, and the
    engine would go on stepping with its weights and KV pool allocated."""

    def __init__(self, engine: ContinuousBatchingEngine,
                 stop: threading.Event):
        self.engine = engine
        self.stop = stop
        self.error: Optional[BaseException] = None

    def run(self) -> None:
        """The engine loop. If a step raises, the error is kept in
        ``self.error`` and every request in flight finishes with reason
        ``"error"``, so no caller waits forever."""
        try:
            self.engine.run_forever(self.stop)
        except Exception as exc:   # the serving thread's boundary
            self.error = exc
            pending = [r for r in self.engine.slots if r is not None]
            pending += list(self.engine.waiting)
            for req in pending:
                req.finish_reason = "error"
                req.stream.put(None)
                req.done.set()
            raise


def join_engine_threads(timeout: float = 30.0) -> int:
    """Collect dropped servers (a server stops its engine when it is
    collected) and wait up to ``timeout`` seconds for their engine threads
    to end; returns how many are still running. A process that exits with
    an engine thread inside a step aborts in torch's teardown."""
    deadline = time.monotonic() + timeout
    while True:
        gc.collect()
        left = [t for t in threading.enumerate()
                if t.name == "llm-engine" and t.is_alive()]
        if not left or time.monotonic() > deadline:
            return len(left)
        left[0].join(0.05)


def start_engine_loop(engine: ContinuousBatchingEngine):
    """Start ``engine`` on a daemon thread; returns (stop event, loop,
    thread)."""
    stop = threading.Event()
    loop = _EngineLoop(engine, stop)
    thread = threading.Thread(target=loop.run, daemon=True,
                              name="llm-engine")
    thread.start()
    return stop, loop, thread


class LLMServer:
    """One engine on ``device`` (None = the CUDA card), driven by a
    background thread. ``params`` defaults to a random init from
    ``config.seed``; pass converted params to serve given weights."""

    def __init__(self, config: LLMConfig, params=None,
                 device: DeviceLike = None):
        from ray_tpu_torch.models.llama import LlamaConfig, LlamaModel

        self.config = config
        cfg = config.model_config or LlamaConfig.debug(
            vocab_size=512, max_seq_len=config.max_seq)
        self.model = LlamaModel(cfg, device=device)
        if params is None:
            params = self.model.init(config.seed)
        self.tokenizer = (load_tokenizer(config.tokenizer)
                          if config.tokenizer else ByteTokenizer())
        self.engine = ContinuousBatchingEngine(
            self.model, params, max_slots=config.max_slots,
            max_seq=config.max_seq, block_size=config.block_size,
            num_blocks=config.num_blocks)
        self._stop, self._loop, self._thread = start_engine_loop(
            self.engine)

    @property
    def error(self) -> Optional[BaseException]:
        """The exception that ended the engine thread, if one did."""
        return self._loop.error

    def _parse(self, request: Dict[str, Any]):
        prompt = request.get("prompt", "")
        sampling = SamplingParams(
            max_tokens=int(request.get("max_tokens", 32)),
            temperature=float(request.get("temperature", 0.0)),
            top_k=int(request.get("top_k", 0)),
            stop_token_ids=(self.tokenizer.EOS,) if isinstance(
                self.tokenizer, ByteTokenizer) else ())
        ids = (prompt if isinstance(prompt, list)
               else self.tokenizer.encode(prompt))
        return ids, sampling

    def stream(self, request: Dict[str, Any]):
        """Streaming completions: one chunk per generated token as the
        engine produces it."""
        ids, sampling = self._parse(request)
        req = self.engine.submit(ids, sampling)
        index = 0
        for tok in req.iter_tokens():
            yield {"id": f"cmpl-{req.id}", "model": self.config.model_id,
                   "delta": self.tokenizer.decode([tok]),
                   "token_id": int(tok), "index": index}
            index += 1
        yield {"id": f"cmpl-{req.id}", "model": self.config.model_id,
               "finish_reason": req.finish_reason, "done": True,
               "usage": {"prompt_tokens": len(ids),
                         "completion_tokens": len(req.output)},
               "ttft_s": req.ttft_s}

    def __call__(self, request: Dict[str, Any]):
        """OpenAI-completions-shaped request/response; ``stream: true``
        returns a generator (chunk per token)."""
        if isinstance(request, dict) and request.get("stream") is True:
            return self.stream(request)
        ids, sampling = self._parse(request)
        req = self.engine.submit(ids, sampling)
        req.done.wait(timeout=300)
        text = self.tokenizer.decode(req.output)
        return {
            "id": f"cmpl-{req.id}",
            "model": self.config.model_id,
            "text": text,
            "token_ids": list(req.output),
            "finish_reason": req.finish_reason,
            "usage": {"prompt_tokens": len(ids),
                      "completion_tokens": len(req.output)},
            "ttft_s": req.ttft_s,
        }

    def stats(self) -> Dict[str, Any]:
        return dict(self.engine.stats)

    def queue_depth(self) -> int:
        """Engine backlog beyond the decode slots: requests submitted but
        still waiting for admission."""
        return len(self.engine.waiting)

    def shutdown(self, timeout: float = 30.0) -> None:
        """Stop the engine thread and wait for it."""
        self._stop.set()
        self._thread.join(timeout)

    def __del__(self):
        try:
            self._stop.set()
        except AttributeError:   # __init__ failed before the event existed
            pass


def build_llm_app(config: LLMConfig, *, params=None,
                  device: DeviceLike = None) -> serve.Application:
    """`build_openai_app` equivalent: one autoscalable LLM deployment, each
    replica ``LLMServer(config, params, device)``. ``device=None`` is the
    card, and raises here on a host without one."""
    device = resolve_device(device)
    dep = serve.deployment(
        LLMServer, name=config.model_id,
        num_replicas=config.num_replicas,
        max_ongoing_requests=config.max_ongoing_requests)
    return dep.bind(config, params, device)
