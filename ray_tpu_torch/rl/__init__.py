"""ray_tpu_torch.rl — the RL learners of the port (counterpart of
``ray_tpu.rl``).

Envs, connectors and the multi-agent runner are the port's own numpy
copies; the learners (PPO, DQN, IMPALA/APPO, SAC, BC and offline DQN)
take their gradient steps in torch on the learner's device, rollouts stay
on the host in numpy, and ``LearnerGroup`` runs PPO's and IMPALA's step
data-parallel over the mesh's ``dp`` axis. ``rl.convert`` carries a JAX
learner's state across; ``rl.optim`` holds optax's Adam and RMSprop.

``Algorithm``/``AlgorithmConfig`` drive EnvRunner actors of the port's
runtime, and ``rl.tuned_examples`` holds JAX's tuned configs;
``offline.py``'s ``write_experiences``/``read_experiences`` keep logged
batches on parquet through ``ray_tpu_torch.data``.
"""

from ray_tpu_torch.rl.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rl.convert import (learner_state, load_learner_state,
                                      params_from_numpy)
from ray_tpu_torch.rl.dqn import DQNLearner, QPolicy, ReplayBuffer
from ray_tpu_torch.rl.env import (CartPoleEnv, EnvRunner, GridWorldEnv,
                                  MountainCarEnv, make_env, register_env)
from ray_tpu_torch.rl.impala import APPOLearner, ImpalaLearner, vtrace
from ray_tpu_torch.rl.learner_group import (LearnerGroup,
                                            wrap_learner_data_parallel)
from ray_tpu_torch.rl.multi_agent import (MultiAgentCartPole,
                                          MultiAgentEnvRunner)
from ray_tpu_torch.rl.offline import (BCLearner, OfflineDQNLearner,
                                      train_offline)
from ray_tpu_torch.rl.ppo import ActorCriticPolicy, PPOLearner, compute_gae
from ray_tpu_torch.rl.sac import SACLearner, SACPolicy

__all__ = ["Algorithm", "AlgorithmConfig", "learner_state", "load_learner_state", "params_from_numpy",
           "DQNLearner", "QPolicy", "ReplayBuffer", "CartPoleEnv",
           "EnvRunner", "GridWorldEnv", "MountainCarEnv", "make_env",
           "register_env", "APPOLearner", "ImpalaLearner", "vtrace",
           "LearnerGroup", "wrap_learner_data_parallel",
           "MultiAgentCartPole", "MultiAgentEnvRunner", "BCLearner",
           "OfflineDQNLearner", "train_offline", "ActorCriticPolicy",
           "PPOLearner", "compute_gae", "SACLearner", "SACPolicy"]
