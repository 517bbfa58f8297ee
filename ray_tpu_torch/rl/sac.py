"""SAC learner, discrete actions (counterpart of ``ray_tpu/rl/sac.py``).

Reference capability: `rllib/algorithms/sac/` — soft actor-critic with
twin Q networks, target networks, and automatic temperature tuning
(Haarnoja et al. 2018; discrete variant per Christodoulou 2019: the
expectation over actions is exact — a sum weighted by the categorical
policy — no reparameterized sampling needed). Off-policy via the replay
buffer shared with DQN. One Adam steps the policy, both Q networks and
the temperature together, and the Polyak target update follows each step.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from ray_tpu_torch._device import DeviceLike, resolve_device
from ray_tpu_torch.rl.convert import (assign_tree, clone_tree, host_copy,
                                      tree_map)
from ray_tpu_torch.rl.dqn import ReplayBuffer, _replay_batch
from ray_tpu_torch.rl.optim import adam
from ray_tpu_torch.rl.ppo import (_gradient_step, _mlp_apply, _mlp_init,
                                  _softmax_act, _trainable)
from ray_tpu_torch.train.spmd import param_leaves


class SACPolicy:
    """Categorical policy for rollouts (stochastic sampling; numpy)."""

    def __init__(self, obs_dim: int, n_actions: int, hidden=(64, 64),
                 seed: int = 0, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.params = {"pi": _mlp_init(torch.Generator().manual_seed(seed),
                                       [obs_dim, *hidden, n_actions],
                                       self.device)}
        self._np_pi = None
        self._rng = np.random.default_rng(seed)
        self._sync_np()

    def _sync_np(self):
        self._np_pi = tree_map(host_copy, self.params["pi"])

    def set_weights(self, payload):
        assign_tree(self.params["pi"], payload["pi"])
        self._sync_np()

    def get_weights(self):
        return clone_tree(self.params)

    def act(self, obs: np.ndarray) -> Tuple[int, float]:
        return _softmax_act(self._np_pi, self._rng, obs)


class SACLearner:
    def __init__(self, obs_dim: int, n_actions: int, *, hidden=(64, 64),
                 lr: float = 3e-4, gamma: float = 0.99, tau: float = 0.01,
                 target_entropy_scale: float = 0.7,
                 buffer_capacity: int = 50_000, batch_size: int = 256,
                 updates_per_call: int = 16, seed: int = 0,
                 device: DeviceLike = None):
        sizes = [obs_dim, *hidden, n_actions]
        self.policy = SACPolicy(obs_dim, n_actions, hidden, seed, device)
        self.device = dev = self.policy.device
        gen = torch.Generator().manual_seed(seed)
        pi, self.q1, self.q2 = (_mlp_init(gen, sizes, dev) for _ in range(3))
        self.policy.params = {"pi": pi}
        self.policy._sync_np()
        self.q1_target = clone_tree(self.q1)
        self.q2_target = clone_tree(self.q2)
        self.log_alpha = torch.zeros((), device=dev)
        # exact-expectation discrete SAC target: a fraction of max entropy
        self.target_entropy = target_entropy_scale * float(
            np.log(n_actions))
        self.gamma = gamma
        self.tau = tau
        self.batch_size = batch_size
        self.updates_per_call = updates_per_call
        self.buffer = ReplayBuffer(buffer_capacity, obs_dim, seed=seed)
        self.opt = adam(_trainable(self._params()), lr)
        self.num_updates = 0

    def _params(self) -> Dict[str, Any]:
        """The trained tree, JAX's ``params`` of the step (live tensors)."""
        return {"pi": self.policy.params["pi"], "q1": self.q1,
                "q2": self.q2, "log_alpha": self.log_alpha}

    def _loss(self, params, targets, batch):
        obs, actions = batch["obs"], batch["actions"]
        alpha = torch.exp(params["log_alpha"])

        # target: soft state value of s' under the CURRENT policy; a
        # constant of the step (JAX stops its gradient whole)
        with torch.no_grad():
            next_obs = batch["next_obs"]
            next_logp = torch.log_softmax(
                _mlp_apply(params["pi"], next_obs), -1)
            next_pi = torch.exp(next_logp)
            minq_t = torch.minimum(_mlp_apply(targets["q1"], next_obs),
                                   _mlp_apply(targets["q2"], next_obs))
            v_next = torch.sum(next_pi * (minq_t - alpha * next_logp), -1)
            y = batch["rewards"] + self.gamma * (1.0 - batch["dones"]) \
                * v_next

        q1 = _mlp_apply(params["q1"], obs)
        q2 = _mlp_apply(params["q2"], obs)
        q1_a = q1.gather(1, actions[:, None])[:, 0]
        q2_a = q2.gather(1, actions[:, None])[:, 0]
        q_loss = 0.5 * (torch.mean((q1_a - y) ** 2)
                        + torch.mean((q2_a - y) ** 2))

        # policy: exact expectation over the categorical support
        logp = torch.log_softmax(_mlp_apply(params["pi"], obs), -1)
        pi = torch.exp(logp)
        minq = torch.minimum(q1, q2).detach()
        pi_loss = torch.mean(torch.sum(
            pi * (alpha.detach() * logp - minq), -1))

        # temperature: drive policy entropy toward the target
        entropy = -torch.sum(pi * logp, -1)
        alpha_loss = torch.mean(params["log_alpha"] * (
            entropy - self.target_entropy).detach())

        loss = q_loss + pi_loss + alpha_loss
        return loss, {"q_loss": q_loss, "pi_loss": pi_loss,
                      "alpha": alpha, "entropy": torch.mean(entropy)}

    def _step(self, batch: Dict[str, torch.Tensor]
              ) -> Dict[str, torch.Tensor]:
        loss, aux = self._loss(self._params(),
                               {"q1": self.q1_target, "q2": self.q2_target},
                               batch)
        aux["loss"] = loss
        aux = _gradient_step(self.opt, loss, aux)
        with torch.no_grad():    # Polyak: (1 - tau) * target + tau * online
            targets = param_leaves([self.q1_target, self.q2_target])
            torch._foreach_mul_(targets, 1.0 - self.tau)
            torch._foreach_add_(targets, torch._foreach_mul(
                param_leaves([self.q1, self.q2]), self.tau))
        return aux

    def update(self, rollouts: List[Dict[str, np.ndarray]]
               ) -> Dict[str, Any]:
        for r in rollouts:
            self.buffer.add_rollout(r)
        if self.buffer.size < self.batch_size:
            return {"buffer_size": self.buffer.size}
        aux = {}
        for _ in range(self.updates_per_call):
            aux = self._step(_replay_batch(
                self.buffer.sample(self.batch_size), self.device))
            self.num_updates += 1
        self.policy._sync_np()
        out = {k: float(v) for k, v in aux.items()}
        out["num_learner_updates"] = self.num_updates
        out["buffer_size"] = self.buffer.size
        return out

    def get_weights(self):
        return {"pi": clone_tree(self.policy.params["pi"])}

    def set_weights(self, payload):
        self.policy.set_weights(payload)
