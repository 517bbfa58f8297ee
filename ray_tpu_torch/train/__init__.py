"""ray_tpu_torch.train — training on the port (counterpart of
``ray_tpu.train``): the train step on one device or a mesh, and
checkpoints (``train.checkpoint``)."""

from ray_tpu_torch.train.spmd import (TrainStep, make_train_step,
                                      shard_batch)

__all__ = ["TrainStep", "make_train_step", "shard_batch"]
