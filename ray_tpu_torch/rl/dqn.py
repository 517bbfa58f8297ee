"""DQN learner (counterpart of ``ray_tpu/rl/dqn.py``; reference:
`rllib/algorithms/dqn/` — replay buffer, target network, epsilon-greedy).

The replay buffer is a numpy copy of JAX's: its ``default_rng(seed)``
samples the same indices in both packages. The TD step runs on the
learner's device.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from ray_tpu_torch._device import DeviceLike, resolve_device
from ray_tpu_torch.rl.convert import (assign_tree, clone_tree, host_copy,
                                      tree_map)
from ray_tpu_torch.rl.optim import adam
from ray_tpu_torch.rl.ppo import (_gradient_step, _mlp_apply, _mlp_init,
                                  _np_mlp_apply, _trainable)


class ReplayBuffer:
    def __init__(self, capacity: int, obs_dim: int, seed: int = 0):
        self.capacity = capacity
        self.obs = np.zeros((capacity, obs_dim), np.float32)
        self.next_obs = np.zeros((capacity, obs_dim), np.float32)
        self.actions = np.zeros(capacity, np.int32)
        self.rewards = np.zeros(capacity, np.float32)
        self.dones = np.zeros(capacity, np.bool_)
        self.size = 0
        self.pos = 0
        self.rng = np.random.default_rng(seed)

    def add_rollout(self, r: Dict[str, np.ndarray]) -> None:
        T = len(r["rewards"])
        obs = r["obs"]
        next_obs = np.concatenate([obs[1:], r["next_obs_last"][None]])
        # episode boundaries: next_obs after done is a reset obs — the
        # (1 - done) mask in the target makes the value irrelevant.
        for t in range(T):
            i = self.pos
            self.obs[i] = obs[t]
            self.next_obs[i] = next_obs[t]
            self.actions[i] = r["actions"][t]
            self.rewards[i] = r["rewards"][t]
            self.dones[i] = r["dones"][t]
            self.pos = (self.pos + 1) % self.capacity
            self.size = min(self.size + 1, self.capacity)

    def sample(self, batch_size: int) -> Dict[str, np.ndarray]:
        idx = self.rng.integers(0, self.size, batch_size)
        return {"obs": self.obs[idx], "next_obs": self.next_obs[idx],
                "actions": self.actions[idx],
                "rewards": self.rewards[idx], "dones": self.dones[idx]}


def _replay_batch(batch: Dict[str, np.ndarray], device: torch.device
                  ) -> Dict[str, torch.Tensor]:
    """A replay sample on the device: actions int64 (``gather``), dones
    f32 as JAX casts them."""
    out = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
    out["actions"] = out["actions"].long()
    out["dones"] = out["dones"].float()
    return out


class QPolicy:
    """Epsilon-greedy behavior policy over a Q-network."""

    def __init__(self, obs_dim: int, n_actions: int, hidden=(64, 64),
                 seed: int = 0, epsilon: float = 1.0,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.params = {"q": _mlp_init(torch.Generator().manual_seed(seed),
                                      [obs_dim, *hidden, n_actions],
                                      self.device)}
        self.n_actions = n_actions
        self.epsilon = epsilon
        self._rng = np.random.default_rng(seed)
        self._sync_np()

    def _sync_np(self):
        self._np_q = tree_map(host_copy, self.params["q"])

    def set_weights(self, payload):
        params, epsilon = payload
        assign_tree(self.params, params)
        self.epsilon = epsilon
        self._sync_np()

    def act(self, obs: np.ndarray) -> Tuple[int, float]:
        if self._rng.random() < self.epsilon:
            return int(self._rng.integers(self.n_actions)), 0.0
        return int(np.argmax(_np_mlp_apply(self._np_q, obs))), 0.0


class DQNLearner:
    def __init__(self, obs_dim: int, n_actions: int, *, hidden=(64, 64),
                 lr: float = 1e-3, gamma: float = 0.99,
                 buffer_size: int = 50_000, batch_size: int = 64,
                 target_update_every: int = 10,
                 epsilon_decay: float = 0.97, epsilon_min: float = 0.05,
                 updates_per_iter: int = 32, seed: int = 0,
                 device: DeviceLike = None):
        self.policy = QPolicy(obs_dim, n_actions, hidden, seed,
                              device=device)
        self.device = self.policy.device
        self.target_params = clone_tree(self.policy.params)
        self.buffer = ReplayBuffer(buffer_size, obs_dim, seed)
        self.optimizer = adam(_trainable(self.policy.params), lr)
        self.gamma = gamma
        self.batch_size = batch_size
        self.target_update_every = target_update_every
        self.epsilon_decay = epsilon_decay
        self.epsilon_min = epsilon_min
        self.updates_per_iter = updates_per_iter
        self._updates = 0

    def _loss(self, params, target, batch):
        q = _mlp_apply(params["q"], batch["obs"])
        q_sel = q.gather(1, batch["actions"][:, None])[:, 0]
        with torch.no_grad():    # the target is a constant of the step
            q_next = _mlp_apply(target["q"], batch["next_obs"])
            tgt = batch["rewards"] + self.gamma * q_next.amax(-1) * (
                1.0 - batch["dones"])
        return torch.mean((q_sel - tgt) ** 2)

    def _step(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        loss = self._loss(self.policy.params, self.target_params, batch)
        return _gradient_step(self.optimizer, loss,
                              {"td_loss": loss})["td_loss"]

    def update(self, rollouts: List[Dict[str, np.ndarray]]
               ) -> Dict[str, float]:
        for r in rollouts:
            self.buffer.add_rollout(r)
        if self.buffer.size < self.batch_size:
            return {"td_loss": float("nan")}
        loss = 0.0
        for _ in range(self.updates_per_iter):
            loss = self._step(_replay_batch(
                self.buffer.sample(self.batch_size), self.device))
            self._updates += 1
            if self._updates % self.target_update_every == 0:
                assign_tree(self.target_params, self.policy.params)
        self.policy.epsilon = max(self.epsilon_min,
                                  self.policy.epsilon
                                  * self.epsilon_decay)
        return {"td_loss": float(loss),
                "epsilon": self.policy.epsilon}

    def get_weights(self):
        return (clone_tree(self.policy.params), self.policy.epsilon)
