"""Examples of the port, the counterparts of the repo's ``examples/``:
``train_gpt2_dp`` and ``train_llama_fsdp``, which run on a mesh, and
``serve_llama``, the LLM app behind serve. They live in the package because
``examples/`` predates the port."""
