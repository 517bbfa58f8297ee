"""Offline RL learners: behavior cloning and offline DQN with CQL
(counterpart of the learners of ``ray_tpu/rl/offline.py``).

Reference: ``rllib/offline/`` — offline training without an environment:

- :class:`BCLearner` — behavior cloning (cross-entropy on logged
  actions), plain SGD.
- :class:`OfflineDQNLearner` — double-DQN TD learning on logged
  transitions plus a CQL conservative penalty (logsumexp Q minus logged
  Q) so values of out-of-distribution actions stay bounded; plain SGD.
- :func:`train_offline` drives either over any object with
  ``iter_batches(batch_size=...)`` yielding dicts of numpy arrays.

JAX's dataset IO (``write_experiences``/``read_experiences``, parquet
through ``ray_tpu.data``) waits for the port of the data layer.

These learners keep JAX's own init (``offline.py:77``): N(0,1)·d_in^-½
weights, not PPO's √(2/d_in).
"""

from __future__ import annotations

from typing import Dict, Iterator

import numpy as np
import torch

from ray_tpu_torch._device import DeviceLike, resolve_device
from ray_tpu_torch.rl.convert import assign_tree, clone_tree
from ray_tpu_torch.rl.ppo import _gradient_step, _mlp_apply, _trainable


def iter_transition_batches(ds, batch_size: int = 256,
                            epochs: int = 1) -> Iterator[Dict]:
    for _ in range(epochs):
        for batch in ds.iter_batches(batch_size=batch_size):
            yield batch


def _mlp_init(gen: torch.Generator, sizes, device: torch.device):
    params = []
    for m, n in zip(sizes[:-1], sizes[1:]):
        params.append({
            "w": (torch.randn(m, n, generator=gen) * (m ** -0.5)).to(device),
            "b": torch.zeros(n, device=device)})
    return params


def _tensor(x, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x), device=device).to(dtype)


class BCLearner:
    """Behavior cloning: cross-entropy on the logged actions."""

    def __init__(self, obs_dim: int, n_actions: int, *,
                 hidden: int = 64, lr: float = 1e-3, seed: int = 0,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.n_actions = n_actions
        self.params = _mlp_init(torch.Generator().manual_seed(seed),
                                (obs_dim, hidden, hidden, n_actions),
                                self.device)
        self.optimizer = torch.optim.SGD(_trainable(self.params), lr=lr)

    def _step(self, obs: torch.Tensor, actions: torch.Tensor
              ) -> torch.Tensor:
        logp = torch.log_softmax(_mlp_apply(self.params, obs), -1)
        nll = -logp.gather(1, actions[:, None]).mean()
        return _gradient_step(self.optimizer, nll, {"nll": nll})["nll"]

    def update(self, batch: Dict[str, np.ndarray]) -> Dict[str, float]:
        loss = self._step(_tensor(batch["obs"], torch.float32, self.device),
                          _tensor(batch["actions"], torch.int64,
                                  self.device))
        return {"bc_loss": float(loss)}

    @torch.no_grad()
    def act(self, obs) -> int:
        logits = _mlp_apply(self.params,
                            _tensor(obs, torch.float32, self.device)[None])
        return int(torch.argmax(logits, -1)[0])

    @torch.no_grad()
    def evaluate_accuracy(self, batch: Dict[str, np.ndarray]) -> float:
        logits = _mlp_apply(self.params, _tensor(batch["obs"], torch.float32,
                                                 self.device))
        pred = torch.argmax(logits, -1)
        actions = _tensor(batch["actions"], torch.int64, self.device)
        return float((pred == actions).float().mean())


class OfflineDQNLearner:
    """Double-DQN TD on logged transitions + CQL penalty."""

    def __init__(self, obs_dim: int, n_actions: int, *,
                 hidden: int = 64, lr: float = 1e-3, gamma: float = 0.99,
                 cql_alpha: float = 1.0, target_update_every: int = 100,
                 seed: int = 0, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.params = _mlp_init(torch.Generator().manual_seed(seed),
                                (obs_dim, hidden, hidden, n_actions),
                                self.device)
        self.target = clone_tree(self.params)
        self.gamma = gamma
        self.cql_alpha = cql_alpha
        self.target_update_every = target_update_every
        self._updates = 0
        self.optimizer = torch.optim.SGD(_trainable(self.params), lr=lr)

    def _loss(self, obs, actions, rewards, dones, next_obs):
        q = _mlp_apply(self.params, obs)                      # [B, A]
        q_logged = q.gather(1, actions[:, None])[:, 0]
        with torch.no_grad():
            # double DQN target: online argmax, target value
            next_a = torch.argmax(_mlp_apply(self.params, next_obs), -1)
            next_q_target = _mlp_apply(self.target, next_obs).gather(
                1, next_a[:, None])[:, 0]
            td_target = rewards + self.gamma * next_q_target * (1.0 - dones)
        td = torch.mean((q_logged - td_target) ** 2)
        # CQL: push down out-of-distribution action values
        cql = torch.mean(torch.logsumexp(q, -1) - q_logged)
        return td + self.cql_alpha * cql, {"td_loss": td, "cql_penalty": cql}

    def update(self, batch: Dict[str, np.ndarray]) -> Dict[str, float]:
        f32, dev = torch.float32, self.device
        loss, aux = self._loss(
            _tensor(batch["obs"], f32, dev),
            _tensor(batch["actions"], torch.int64, dev),
            _tensor(batch["rewards"], f32, dev),
            _tensor(batch["dones"], f32, dev),
            _tensor(batch["next_obs"], f32, dev))
        aux["loss"] = loss
        aux = _gradient_step(self.optimizer, loss, aux)
        self._updates += 1
        if self._updates % self.target_update_every == 0:
            assign_tree(self.target, self.params)
        return {k: float(aux[k]) for k in ("loss", "td_loss", "cql_penalty")}

    @torch.no_grad()
    def act(self, obs) -> int:
        q = _mlp_apply(self.params,
                       _tensor(obs, torch.float32, self.device)[None])
        return int(torch.argmax(q, -1)[0])


def train_offline(ds, learner, *, batch_size: int = 256,
                  epochs: int = 1) -> Dict[str, float]:
    """Drive a learner over an experience dataset; returns last metrics."""
    metrics: Dict[str, float] = {}
    for batch in iter_transition_batches(ds, batch_size, epochs):
        metrics = learner.update(batch)
    return metrics
