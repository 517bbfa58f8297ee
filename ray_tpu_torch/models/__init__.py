"""Model families of the port (so far Llama-3: training forward and
KV-cache inference paths); layouts match ``ray_tpu.models`` so params
convert 1:1."""

from ray_tpu_torch.models.convert import params_from_numpy
from ray_tpu_torch.models.llama import LlamaConfig, LlamaModel

__all__ = ["LlamaConfig", "LlamaModel", "params_from_numpy"]
