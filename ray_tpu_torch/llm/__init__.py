"""ray_tpu_torch.llm — LLM serving on the port (counterpart of
``ray_tpu.llm``): continuous batching over a paged KV pool on the card,
served through the port's ``serve``."""

from ray_tpu_torch.llm.engine import (ContinuousBatchingEngine, Request,
                                      SamplingParams)
from ray_tpu_torch.llm.serving import LLMConfig, LLMServer, build_llm_app
from ray_tpu_torch.llm.tokenizer import ByteTokenizer, load_tokenizer

__all__ = [
    "ContinuousBatchingEngine", "SamplingParams", "Request",
    "LLMConfig", "LLMServer", "build_llm_app",
    "ByteTokenizer", "load_tokenizer",
]
