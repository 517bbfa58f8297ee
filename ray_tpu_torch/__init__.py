"""ray_tpu_torch — the PyTorch/CUDA port of ``ray_tpu`` for one NVIDIA H100.

The JAX package ``ray_tpu`` stays the reference; each module here keeps the
name and layout of its counterpart there, so ``ray_tpu_torch/x/y.py`` ports
``ray_tpu/x/y.py``. The port imports ``torch`` and ``numpy`` only — never
``jax`` and nothing of ``ray_tpu``; what it needs from a JAX-free module of the
reference it carries as its own copy.

Entry points take ``device=None``, which means CUDA and raises when no card is
present; only an explicit ``device="cpu"`` runs on the CPU (the tests do).

Ported so far (the serving slice): ``ops`` (norms, rope, the paged- and
ragged-decode attention kernels in ``csrc/``), ``models.llama`` (the KV-cache
inference paths), ``llm`` (block pool, tokenizer, continuous-batching engine,
``LLMServer``).
"""
