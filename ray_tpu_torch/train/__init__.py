"""ray_tpu_torch.train — training on the port (counterpart of
``ray_tpu.train``): the train step on one device or a mesh, checkpoints,
and the train driver — ``JaxTrainer`` over a gang of worker actors in a
placement group, with its session, callbacks, scaling policies and
worker-group collectives."""

from ray_tpu_torch.train.checkpoint import (AsyncCheckpointer, Checkpoint,
                                            CheckpointManager)
from ray_tpu_torch.train.config import (CheckpointConfig, FailureConfig,
                                        RunConfig, ScalingConfig)
from ray_tpu_torch.train.scaling_policy import (ElasticScalingPolicy,
                                                FixedScalingPolicy,
                                                ResizeDecision, ScalingPolicy)
from ray_tpu_torch.train.session import (get_checkpoint, get_context,
                                         get_dataset_shard, report)
from ray_tpu_torch.train.spmd import TrainStep, make_train_step, shard_batch
from ray_tpu_torch.train.trainer import JaxTrainer, Result

__all__ = [
    "TrainStep", "make_train_step", "shard_batch",
    "Checkpoint", "CheckpointManager", "AsyncCheckpointer",
    "ScalingConfig", "RunConfig", "FailureConfig", "CheckpointConfig",
    "report", "get_context", "get_checkpoint", "get_dataset_shard",
    "JaxTrainer", "Result",
    "ScalingPolicy", "FixedScalingPolicy", "ElasticScalingPolicy",
    "ResizeDecision",
]
