"""Neural-net ops of the port: plain PyTorch for elementwise work, hand-written
CUDA kernels (``ray_tpu_torch/csrc``) where the JAX package had Pallas ones."""

from ray_tpu_torch.ops.norms import layer_norm, rms_norm
from ray_tpu_torch.ops.rope import apply_rope, rope_frequencies

__all__ = ["rms_norm", "layer_norm", "apply_rope", "rope_frequencies"]
