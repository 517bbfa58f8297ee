"""Tokenizers for the LLM stack.

The port's own copy of ``ray_tpu/llm/tokenizer.py``.

ByteTokenizer: dependency-free byte-level tokenizer (ids = utf-8 bytes,
+BOS/EOS) used by tests and demos. ``load_tokenizer`` returns a
HuggingFace tokenizer when `transformers` has one cached locally
(reference: ray.llm resolves tokenizers through vLLM/HF).
"""

from __future__ import annotations

from typing import List, Optional


class ByteTokenizer:
    BOS = 256
    EOS = 257

    vocab_size = 258

    def encode(self, text: str, add_bos: bool = True) -> List[int]:
        ids = list(text.encode("utf-8"))
        return ([self.BOS] + ids) if add_bos else ids

    def decode(self, ids: List[int]) -> str:
        return bytes(i for i in ids if i < 256).decode("utf-8",
                                                       errors="replace")


def load_tokenizer(name_or_path: Optional[str] = None):
    if name_or_path is None:
        return ByteTokenizer()
    from transformers import AutoTokenizer
    return AutoTokenizer.from_pretrained(name_or_path)
