"""ray_tpu_torch — the PyTorch/CUDA port of ``ray_tpu`` for one NVIDIA H100.

The JAX package ``ray_tpu`` stays the reference; each module here keeps the
name and layout of its counterpart there, so ``ray_tpu_torch/x/y.py`` ports
``ray_tpu/x/y.py``. The port imports ``torch`` and ``numpy`` only — never
``jax`` and nothing of ``ray_tpu``; what it needs from a JAX-free module of the
reference it carries as its own copy.

Entry points take ``device=None``, which means CUDA and raises when no card is
present; only an explicit ``device="cpu"`` runs on the CPU (the tests do).

Ported so far: the serving slice — ``ops`` (norms, rope, the paged- and
ragged-decode attention kernels in ``csrc/``), ``models.llama`` (the KV-cache
inference paths), ``llm`` (block pool, tokenizer, continuous-batching engine,
``LLMServer``) — the single-device training slice — ``ops.attention``
(reference, blockwise and flash attention, the flash forward kernel in
``csrc/``), ``models.llama`` (``apply``, ``loss``, remat), ``train``
(``make_train_step``) and ``bench`` (``run_train``) — and the other model
families, each trained by the same ``make_train_step``: ``models.mlp``,
``models.gpt2``, ``models.vit`` and ``models.moe`` (einsum dispatch, with the
router math of ``ops.moe_dispatch``), benchmarked by ``bench.run_family`` —
and the parallel layer: ``parallel`` (the named ``DeviceMesh``, JAX's
logical-axis rules as DTensor placements, process-group bring-up and the
``spawn_ranks`` gloo launcher), the sharded ``make_train_step`` on
DTensors with each family's ``param_shardings``, the vocab-parallel
embedding, flash attention on local shards, ``train.checkpoint`` and the
``examples`` that train on a mesh — and sequence, expert and pipeline
parallelism on that mesh: ``parallel.collectives`` (JAX's ppermute,
all_to_all, psum, pmean and pvary with their transposes), ring and Ulysses
attention (``ops.ring_attention``, ``ops.ulysses``), the MoE's expert
all-to-all (``ops.moe_dispatch.expert_alltoall_ffn``), the GPipe schedule
(``parallel.pipeline``), ``models.llama_pp.PipelinedLlama`` and
``dryrun.dryrun_mesh`` — and the RL learners: ``rl`` (the numpy envs,
connectors and multi-agent runner as the port's own copies; PPO, DQN,
IMPALA/APPO, SAC, BC and offline DQN taking their gradient steps in torch
on the learner's device, optax's Adam and RMSprop in ``rl.optim``, JAX
learner state carried across by ``rl.convert``, and the data-parallel
``LearnerGroup`` over the mesh's ``dp`` axis).
"""
