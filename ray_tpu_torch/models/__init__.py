"""Model families of the port, each the counterpart of its module in
``ray_tpu.models``: Llama-3 (training forward and KV-cache inference paths),
GPT-2, the MLP classifier, ViT and the MoE, and the pipeline-parallel
Llama (``PipelinedLlama``). Param layouts
match the JAX package's, so its params convert 1:1 (``params_from_numpy``),
and every family trains through ``ray_tpu_torch.train.make_train_step``."""

from ray_tpu_torch.models.convert import params_from_numpy
from ray_tpu_torch.models.gpt2 import GPT2Config, GPT2Model
from ray_tpu_torch.models.llama import LlamaConfig, LlamaModel
from ray_tpu_torch.models.llama_pp import PipelinedLlama
from ray_tpu_torch.models.mlp import MLPConfig, MLPModel
from ray_tpu_torch.models.moe import MoEConfig, MoEModel
from ray_tpu_torch.models.vit import ViTConfig, ViTModel

__all__ = ["LlamaConfig", "LlamaModel", "MLPConfig", "MLPModel",
           "GPT2Config", "GPT2Model", "ViTConfig", "ViTModel",
           "MoEConfig", "MoEModel", "PipelinedLlama", "params_from_numpy"]
