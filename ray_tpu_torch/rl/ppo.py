"""PPO learner (counterpart of ``ray_tpu/rl/ppo.py``: clipped surrogate +
GAE; the Learner role of `rllib/core/learner/learner.py:108`).

The policy/value networks and the gradient step run in torch on the
learner's device (``device=None``: the card; ``"cpu"`` only when asked);
rollout-time action sampling runs the same network on host-side numpy
copies of the weights, as in JAX.

``_mlp_init`` draws from a seeded ``torch.Generator`` with JAX's
distribution (N(0,1)·√(2/d_in) weights, zero biases) on the CPU, so a seed
gives the same weights on every device; the values cannot match JAX's keys,
and the tests carry JAX's weights across instead (``rl.convert``).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ray_tpu_torch._device import DeviceLike, resolve_device
from ray_tpu_torch.rl.convert import (assign_tree, clone_tree, host_copy,
                                      tree_map)
from ray_tpu_torch.rl.optim import adam
from ray_tpu_torch.train.spmd import param_leaves


def _mlp_init(gen: torch.Generator, sizes, device: torch.device
              ) -> List[Dict]:
    params = []
    for din, dout in zip(sizes[:-1], sizes[1:]):
        params.append({
            "w": (torch.randn(din, dout, generator=gen)
                  * (2.0 / din) ** 0.5).to(device),
            "b": torch.zeros(dout, device=device)})
    return params


def _mlp_apply(params, x: torch.Tensor) -> torch.Tensor:
    for i, layer in enumerate(params):
        x = x @ layer["w"] + layer["b"]
        if i < len(params) - 1:
            x = torch.tanh(x)
    return x


def _trainable(tree) -> List[torch.Tensor]:
    """The leaves of ``tree``, each now requiring its gradient."""
    leaves = param_leaves(tree)
    for p in leaves:
        p.requires_grad_(True)
    return leaves


def _np_mlp_apply(layers, x: np.ndarray) -> np.ndarray:
    """``_mlp_apply`` on the host's numpy copies of the weights."""
    for i, layer in enumerate(layers):
        x = x @ layer["w"] + layer["b"]
        if i < len(layers) - 1:
            x = np.tanh(x)
    return x


def _softmax_act(np_pi, rng: np.random.Generator,
                 obs: np.ndarray) -> Tuple[int, float]:
    """Sample from the categorical policy of numpy layers ``np_pi``."""
    x = _np_mlp_apply(np_pi, obs)
    z = x - x.max()
    p = np.exp(z)
    p /= p.sum()
    a = int(rng.choice(len(p), p=p))
    return a, float(np.log(p[a] + 1e-9))


def _gradient_step(optimizer: torch.optim.Optimizer, loss: torch.Tensor,
                   metrics: Dict[str, torch.Tensor],
                   reduce_grads: Optional[Callable] = None,
                   clip: Optional[float] = None) -> Dict[str, torch.Tensor]:
    """One step of ``optimizer`` down ``loss``; returns ``metrics`` (the
    loss terms before the step) detached. ``reduce_grads`` (set by
    ``LearnerGroup``) averages the gradients and metrics over the
    data-parallel ranks in place, before the element-wise ``clip``."""
    metrics = {k: v.detach() for k, v in metrics.items()}
    optimizer.zero_grad()
    loss.backward()
    grads = [p.grad for group in optimizer.param_groups
             for p in group["params"] if p.grad is not None]
    if reduce_grads is not None:
        reduce_grads(grads + list(metrics.values()))
    if clip is not None:
        torch._foreach_clamp_min_(grads, -clip)
        torch._foreach_clamp_max_(grads, clip)
    optimizer.step()
    return metrics


class ActorCriticPolicy:
    """Shared-nothing actor/critic MLPs with numpy act() for rollouts."""

    def __init__(self, obs_dim: int, n_actions: int, hidden=(64, 64),
                 seed: int = 0, device: DeviceLike = None):
        self.device = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        self.params = {
            "pi": _mlp_init(gen, [obs_dim, *hidden, n_actions], self.device),
            "vf": _mlp_init(gen, [obs_dim, *hidden, 1], self.device),
        }
        self._np_pi = None
        self._rng = np.random.default_rng(seed)
        self._sync_np()

    def _sync_np(self):
        self._np_pi = tree_map(host_copy, self.params["pi"])

    def set_weights(self, params):
        # in place: a learner's optimizer holds these tensors
        assign_tree(self.params, params)
        self._sync_np()

    def get_weights(self):
        return clone_tree(self.params)

    def act(self, obs: np.ndarray) -> Tuple[int, float]:
        return _softmax_act(self._np_pi, self._rng, obs)


def compute_gae(rewards, dones, values, last_value, gamma=0.99,
                lam=0.95):
    """Host-side GAE over a rollout (numpy; T small)."""
    T = len(rewards)
    adv = np.zeros(T, np.float32)
    last = 0.0
    for t in range(T - 1, -1, -1):
        nonterm = 0.0 if dones[t] else 1.0
        next_v = last_value if t == T - 1 else values[t + 1]
        delta = rewards[t] + gamma * next_v * nonterm - values[t]
        last = delta + gamma * lam * nonterm * last
        adv[t] = last
    returns = adv + values
    return adv, returns


class PPOLearner:
    def __init__(self, obs_dim: int, n_actions: int, *, hidden=(64, 64),
                 lr: float = 3e-4, clip: float = 0.2, vf_coef: float = 0.5,
                 ent_coef: float = 0.01, epochs: int = 4,
                 minibatch_size: int = 128, gamma: float = 0.99,
                 gae_lambda: float = 0.95, seed: int = 0,
                 device: DeviceLike = None):
        self.policy = ActorCriticPolicy(obs_dim, n_actions, hidden, seed,
                                        device)
        self.device = self.policy.device
        self.optimizer = adam(_trainable(self.policy.params), lr)
        self.clip = clip
        self.vf_coef = vf_coef
        self.ent_coef = ent_coef
        self.epochs = epochs
        self.minibatch_size = minibatch_size
        self.gamma = gamma
        self.lam = gae_lambda
        self._rng = np.random.default_rng(seed)
        # the step update() calls; LearnerGroup rebinds it
        self._update = self._update_impl

    def _loss(self, params, batch):
        logits = _mlp_apply(params["pi"], batch["obs"])
        logp_all = torch.log_softmax(logits, -1)
        logp = logp_all.gather(1, batch["actions"][:, None])[:, 0]
        ratio = torch.exp(logp - batch["logp_old"])
        adv = batch["adv"]
        unclipped = ratio * adv
        clipped = torch.clamp(ratio, 1 - self.clip, 1 + self.clip) * adv
        # minimum, not a where: a tie splits its gradient as jnp.minimum's
        pi_loss = -torch.mean(torch.minimum(unclipped, clipped))
        v = _mlp_apply(params["vf"], batch["obs"])[:, 0]
        vf_loss = torch.mean((v - batch["returns"]) ** 2)
        ent = -torch.mean(torch.sum(torch.exp(logp_all) * logp_all, -1))
        total = pi_loss + self.vf_coef * vf_loss - self.ent_coef * ent
        return total, {"pi_loss": pi_loss, "vf_loss": vf_loss,
                       "entropy": ent}

    def _update_impl(self, batch: Dict[str, torch.Tensor],
                     reduce_grads: Optional[Callable] = None
                     ) -> Dict[str, torch.Tensor]:
        """One Adam step on a minibatch of device tensors."""
        loss, metrics = self._loss(self.policy.params, batch)
        metrics["total_loss"] = loss
        return _gradient_step(self.optimizer, loss, metrics, reduce_grads)

    @torch.no_grad()
    def _values(self, obs: np.ndarray) -> np.ndarray:
        x = torch.from_numpy(np.asarray(obs, np.float32)).to(self.device)
        return _mlp_apply(self.policy.params["vf"], x)[:, 0].cpu().numpy()

    def update(self, rollouts: List[Dict[str, np.ndarray]]
               ) -> Dict[str, float]:
        """GAE + minibatched clipped-surrogate epochs over the rollouts."""
        obs = np.concatenate([r["obs"] for r in rollouts])
        actions = np.concatenate([r["actions"] for r in rollouts])
        logp_old = np.concatenate([r["logp"] for r in rollouts])
        advs, rets = [], []
        for r in rollouts:
            values = self._values(r["obs"])
            last_v = float(self._values(r["next_obs_last"][None])[0])
            adv, ret = compute_gae(r["rewards"], r["dones"], values,
                                   last_v, self.gamma, self.lam)
            advs.append(adv)
            rets.append(ret)
        adv = np.concatenate(advs)
        ret = np.concatenate(rets)
        adv = (adv - adv.mean()) / (adv.std() + 1e-8)

        # the whole rollout goes to the device once; minibatches index it
        dev = self.device
        data = {"obs": obs, "actions": actions.astype(np.int64),
                "logp_old": logp_old, "adv": adv, "returns": ret}
        data = {k: torch.from_numpy(v).to(dev) for k, v in data.items()}
        n = len(obs)
        metrics = {}
        for _ in range(self.epochs):
            perm = torch.from_numpy(self._rng.permutation(n)).to(dev)
            for lo in range(0, n, self.minibatch_size):
                idx = perm[lo:lo + self.minibatch_size]
                metrics = self._update({k: v[idx] for k, v in data.items()})
        self.policy._sync_np()
        return {k: float(v) for k, v in metrics.items()}

    def get_weights(self):
        return self.policy.get_weights()
