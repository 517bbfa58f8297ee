"""IMPALA learner: V-trace off-policy actor-critic (counterpart of
``ray_tpu/rl/impala.py``).

Reference capability: `rllib/algorithms/impala/` — an asynchronous
actor-learner architecture where EnvRunners sample with STALE (behavior)
weights and the learner corrects the off-policyness with V-trace
(Espeholt et al. 2018). JAX's reverse ``lax.scan`` over the fragment is a
reverse loop over its T steps on the learner's device.

V-trace's inputs are gradient-stopped in JAX (``impala.py:87-90``), so its
targets are constants of the step: ``update`` computes them over the whole
fragment, with no gradient, before the step. That is also what lets
``LearnerGroup`` give each rank its share of the time-major rows: the
recursion runs along the sharded axis, and a rank alone could not run it.

The async control loop lives in the JAX package's
`rl/algorithm.py::Algorithm._train_async`, which waits for the port of the
runtime.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ray_tpu_torch._device import DeviceLike
from ray_tpu_torch.rl.optim import RMSprop
from ray_tpu_torch.rl.ppo import (ActorCriticPolicy, _gradient_step,
                                  _mlp_apply, _trainable)


def vtrace(behavior_logp, target_logp, rewards, discounts, values,
           bootstrap_value, rho_bar: float = 1.0, c_bar: float = 1.0):
    """V-trace targets + policy-gradient advantages for ONE trajectory
    fragment ([T] tensors); callers pass stopped (detached) inputs."""
    rhos = torch.exp(target_logp - behavior_logp)
    clipped_rhos = torch.clamp(rhos, max=rho_bar)
    cs = torch.clamp(rhos, max=c_bar)
    values_next = torch.cat([values[1:], bootstrap_value[None]])
    deltas = clipped_rhos * (rewards + discounts * values_next - values)
    # JAX's scan body: acc = delta + discount * c * acc
    decay = discounts * cs
    acc = torch.zeros_like(bootstrap_value)
    vs_minus_v = [acc] * len(deltas)
    for t in range(len(deltas) - 1, -1, -1):
        acc = deltas[t] + decay[t] * acc
        vs_minus_v[t] = acc
    vs = torch.stack(vs_minus_v) + values
    vs_next = torch.cat([vs[1:], bootstrap_value[None]])
    pg_adv = clipped_rhos * (rewards + discounts * vs_next - values)
    return vs, pg_adv


class ImpalaLearner:
    """Learner-group role (`rllib/core/learner/learner.py:108`) for the
    IMPALA algorithm; shares the actor-critic network with PPO."""

    def __init__(self, obs_dim: int, n_actions: int, *, hidden=(64, 64),
                 lr: float = 6e-4, gamma: float = 0.99,
                 vf_coef: float = 0.5, ent_coef: float = 0.01,
                 rho_bar: float = 1.0, c_bar: float = 1.0,
                 seed: int = 0, device: DeviceLike = None):
        self.policy = ActorCriticPolicy(obs_dim, n_actions, hidden, seed,
                                        device)
        self.device = self.policy.device
        self.optimizer = RMSprop(_trainable(self.policy.params), lr,
                                 decay=0.99, eps=0.1)
        self.gamma = gamma
        self.vf_coef = vf_coef
        self.ent_coef = ent_coef
        self.rho_bar = rho_bar
        self.c_bar = c_bar
        # the step update() calls; LearnerGroup rebinds it
        self._update = self._update_impl
        self.num_updates = 0

    def _pg_loss(self, target_logp, behavior_logp, pg_adv):
        """Policy objective on the V-trace advantages; APPO overrides
        with the clipped surrogate."""
        return -torch.mean(target_logp * pg_adv)

    def _forward(self, params, batch):
        logits = _mlp_apply(params["pi"], batch["obs"])        # [T, A]
        logp_all = torch.log_softmax(logits, -1)
        target_logp = logp_all.gather(1, batch["actions"][:, None])[:, 0]
        values = _mlp_apply(params["vf"], batch["obs"])[:, 0]
        return logp_all, target_logp, values

    @torch.no_grad()
    def _vtrace_targets(self, batch) -> Dict[str, torch.Tensor]:
        """``vs`` and ``pg_adv`` over the whole fragment."""
        params = self.policy.params
        _, target_logp, values = self._forward(params, batch)
        bootstrap = _mlp_apply(params["vf"],
                               batch["next_obs_last"][None])[0, 0]
        discounts = self.gamma * (1.0 - batch["dones"])
        vs, pg_adv = vtrace(batch["logp"], target_logp, batch["rewards"],
                            discounts, values, bootstrap,
                            rho_bar=self.rho_bar, c_bar=self.c_bar)
        return {"vs": vs, "pg_adv": pg_adv}

    def _loss(self, params, batch):
        logp_all, target_logp, values = self._forward(params, batch)
        pg_loss = self._pg_loss(target_logp, batch["logp"], batch["pg_adv"])
        vf_loss = 0.5 * torch.mean((batch["vs"] - values) ** 2)
        entropy = -torch.mean(
            torch.sum(torch.exp(logp_all) * logp_all, -1))
        loss = pg_loss + self.vf_coef * vf_loss - self.ent_coef * entropy
        return loss, {"pg_loss": pg_loss, "vf_loss": vf_loss,
                      "entropy": entropy}

    def _update_impl(self, batch: Dict[str, torch.Tensor],
                     reduce_grads: Optional[Callable] = None
                     ) -> Dict[str, torch.Tensor]:
        """One RMSprop step, each gradient element clipped to ±40 (JAX's
        ``jnp.clip`` of the global gradient, not a norm clip)."""
        loss, aux = self._loss(self.policy.params, batch)
        aux["loss"] = loss
        return _gradient_step(self.optimizer, loss, aux, reduce_grads,
                              clip=40.0)

    def update(self, rollouts: List[Dict[str, np.ndarray]]
               ) -> Dict[str, Any]:
        aux: Dict[str, torch.Tensor] = {}
        dev = self.device
        for r in rollouts:   # fragments arrive asynchronously; one pass each
            batch = {
                "obs": torch.from_numpy(r["obs"]).to(dev),
                "next_obs_last": torch.from_numpy(r["next_obs_last"]).to(dev),
                "actions": torch.from_numpy(
                    r["actions"].astype(np.int64)).to(dev),
                "rewards": torch.from_numpy(r["rewards"]).to(dev),
                "dones": torch.from_numpy(
                    r["dones"].astype(np.float32)).to(dev),
                "logp": torch.from_numpy(r["logp"]).to(dev),
            }
            batch.update(self._vtrace_targets(batch))
            aux = self._update(batch)
            self.num_updates += 1
        self.policy._sync_np()
        metrics: Dict[str, Any] = {k: float(v) for k, v in aux.items()}
        metrics["num_learner_updates"] = self.num_updates
        return metrics

    def get_weights(self):
        return self.policy.get_weights()

    def set_weights(self, params):
        self.policy.set_weights(params)


class APPOLearner(ImpalaLearner):
    """APPO (reference: ``rllib/algorithms/appo/``): the IMPALA
    architecture (async runners, V-trace target correction) with PPO's
    clipped-surrogate policy objective on the V-trace advantages —
    tolerates more policy lag than plain IMPALA's policy gradient."""

    def __init__(self, obs_dim: int, n_actions: int, *,
                 clip: float = 0.2, **kwargs):
        super().__init__(obs_dim, n_actions, **kwargs)
        self.clip = clip

    def _pg_loss(self, target_logp, behavior_logp, pg_adv):
        # PPO clip on the importance ratio vs the BEHAVIOR policy
        ratio = torch.exp(target_logp - behavior_logp)
        unclipped = ratio * pg_adv
        clipped = torch.clamp(ratio, 1 - self.clip, 1 + self.clip) * pg_adv
        return -torch.mean(torch.minimum(unclipped, clipped))
