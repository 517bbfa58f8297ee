"""Examples of the port, the counterparts of the repo's ``examples/`` that
run on a mesh: ``train_gpt2_dp`` and ``train_llama_fsdp``. They live in the
package because ``examples/`` predates the port."""
