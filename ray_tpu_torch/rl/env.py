"""RL environments + EnvRunner actors: the port's own copy of the
numpy-only ``ray_tpu/rl/env.py`` (same seeds, same trajectories).

Reference: RLlib `rllib/env/env_runner_group.py` (rollout worker actors),
`rllib/env/single_agent_env_runner.py`. Env API is gymnasium-shaped:
reset() -> (obs, info); step(a) -> (obs, reward, terminated, truncated,
info). CartPole ships in-tree (classic dynamics) so tests need no gym.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np


class CartPoleEnv:
    """Classic cart-pole balancing (standard physics constants)."""

    n_actions = 2
    obs_dim = 4

    def __init__(self, seed: int = 0, max_steps: int = 500):
        self.rng = np.random.default_rng(seed)
        self.max_steps = max_steps
        self.gravity = 9.8
        self.masscart, self.masspole = 1.0, 0.1
        self.length = 0.5
        self.force_mag = 10.0
        self.tau = 0.02
        self.theta_lim = 12 * 2 * np.pi / 360
        self.x_lim = 2.4
        self._steps = 0
        self.state = None

    def reset(self, seed: Optional[int] = None):
        if seed is not None:
            self.rng = np.random.default_rng(seed)
        self.state = self.rng.uniform(-0.05, 0.05, size=4)
        self._steps = 0
        return self.state.astype(np.float32), {}

    def step(self, action: int):
        x, x_dot, th, th_dot = self.state
        force = self.force_mag if action == 1 else -self.force_mag
        costh, sinth = np.cos(th), np.sin(th)
        total_mass = self.masscart + self.masspole
        pml = self.masspole * self.length
        temp = (force + pml * th_dot ** 2 * sinth) / total_mass
        th_acc = (self.gravity * sinth - costh * temp) / (
            self.length * (4.0 / 3.0 - self.masspole * costh ** 2
                           / total_mass))
        x_acc = temp - pml * th_acc * costh / total_mass
        x += self.tau * x_dot
        x_dot += self.tau * x_acc
        th += self.tau * th_dot
        th_dot += self.tau * th_acc
        self.state = np.array([x, x_dot, th, th_dot])
        self._steps += 1
        terminated = bool(abs(x) > self.x_lim or abs(th) > self.theta_lim)
        truncated = self._steps >= self.max_steps
        return (self.state.astype(np.float32), 1.0, terminated, truncated,
                {})


class GridWorldEnv:
    """N x N gridworld, sparse goal reward with a small step penalty
    (the FrozenLake/tabular-control slice of the classic suite): start
    top-left, goal bottom-right, actions = R/L/D/U. Obs is the (row,
    col) pair normalized to [0, 1] so the same MLP policies apply."""

    n_actions = 4
    obs_dim = 2

    def __init__(self, seed: int = 0, size: int = 5,
                 max_steps: int = 40):
        # dynamics are fully deterministic: no rng (the seed parameter
        # is accepted for creator-signature uniformity only)
        self.size = size
        self.max_steps = max_steps
        self.pos = (0, 0)
        self._steps = 0

    def _obs(self):
        return np.array([self.pos[0] / (self.size - 1),
                         self.pos[1] / (self.size - 1)], np.float32)

    def reset(self, seed: Optional[int] = None):
        self.pos = (0, 0)
        self._steps = 0
        return self._obs(), {}

    def step(self, action: int):
        r, c = self.pos
        dr, dc = ((0, 1), (0, -1), (1, 0), (-1, 0))[int(action)]
        self.pos = (min(max(r + dr, 0), self.size - 1),
                    min(max(c + dc, 0), self.size - 1))
        self._steps += 1
        at_goal = self.pos == (self.size - 1, self.size - 1)
        reward = 10.0 if at_goal else -0.1
        truncated = self._steps >= self.max_steps
        return self._obs(), reward, at_goal, truncated, {}


class MountainCarEnv:
    """Classic mountain car (standard dynamics), discrete actions,
    with OPTIONAL velocity-shaped reward: the raw sparse task needs
    long-horizon exploration tricks the tuned-example CI budget does
    not buy, so the shaped variant keeps the contract honest AND
    reachable (the shaping term is documented, not hidden)."""

    n_actions = 3
    obs_dim = 2

    def __init__(self, seed: int = 0, max_steps: int = 200,
                 shaped: bool = True):
        self.rng = np.random.default_rng(seed)
        self.max_steps = max_steps
        self.shaped = shaped
        self.state = None
        self._steps = 0

    def reset(self, seed: Optional[int] = None):
        if seed is not None:
            self.rng = np.random.default_rng(seed)
        self.state = np.array([self.rng.uniform(-0.6, -0.4), 0.0])
        self._steps = 0
        return self.state.astype(np.float32), {}

    def step(self, action: int):
        pos, vel = self.state
        vel += (int(action) - 1) * 0.001 + np.cos(3 * pos) * (-0.0025)
        vel = float(np.clip(vel, -0.07, 0.07))
        pos = float(np.clip(pos + vel, -1.2, 0.6))
        if pos <= -1.2:
            vel = max(vel, 0.0)
        self.state = np.array([pos, vel])
        self._steps += 1
        done = pos >= 0.5
        reward = -1.0
        if self.shaped:
            reward += 10.0 * abs(vel)        # energy-building signal
        if done:
            reward += 100.0
        truncated = self._steps >= self.max_steps
        return (self.state.astype(np.float32), reward, done, truncated,
                {})


ENV_REGISTRY: Dict[str, Callable] = {
    "CartPole-v1": CartPoleEnv,
    "GridWorld-5x5": GridWorldEnv,
    "MountainCarShaped-v0": MountainCarEnv,
}


def register_env(name: str, creator: Callable) -> None:
    ENV_REGISTRY[name] = creator


def make_env(name_or_creator, seed: int = 0):
    if callable(name_or_creator):
        return name_or_creator(seed)
    creator = ENV_REGISTRY.get(name_or_creator)
    if creator is None:
        raise KeyError(f"unknown env {name_or_creator!r} "
                       f"(register_env first)")
    return creator(seed=seed)


class EnvRunner:
    """Actor: collects rollouts with the current policy weights."""

    def __init__(self, env_spec, policy_factory, seed: int = 0,
                 env_to_module=None, module_to_env=None):
        """``env_to_module``/``module_to_env``: optional connector
        pipelines (reference: rllib/connectors/) — observations pass
        through env_to_module before the policy; actions through
        module_to_env before the env."""
        self.env = make_env(env_spec, seed=seed)
        self.policy = policy_factory()
        self.seed = seed
        self.env_to_module = env_to_module
        self.module_to_env = module_to_env
        self._obs, _ = self.env.reset(seed=seed)
        self._episode_return = 0.0
        self.completed_returns: List[float] = []

    def _pre(self, obs):
        return self.env_to_module(obs) if self.env_to_module else obs

    def _post(self, action):
        return self.module_to_env(action) if self.module_to_env else action

    def set_weights(self, weights) -> None:
        self.policy.set_weights(weights)

    def sample(self, num_steps: int) -> Dict[str, np.ndarray]:
        """Collect num_steps transitions (episodes auto-reset)."""
        obs_buf, act_buf, rew_buf, done_buf, logp_buf = [], [], [], [], []
        for _ in range(num_steps):
            module_obs = self._pre(self._obs)
            action, logp = self.policy.act(module_obs)
            nobs, rew, term, trunc, _ = self.env.step(
                self._post(action))
            obs_buf.append(module_obs)
            act_buf.append(action)
            rew_buf.append(rew)
            done_buf.append(term or trunc)
            logp_buf.append(logp)
            self._episode_return += rew
            if term or trunc:
                self.completed_returns.append(self._episode_return)
                self._episode_return = 0.0
                self._obs, _ = self.env.reset()
                if self.env_to_module is not None:
                    self.env_to_module.reset()
            else:
                self._obs = nobs
        obs_buf.append(self._pre(self._obs))   # bootstrap observation
        return {
            "obs": np.asarray(obs_buf[:-1], np.float32),
            "next_obs_last": np.asarray(obs_buf[-1], np.float32),
            "actions": np.asarray(act_buf, np.int32),
            "rewards": np.asarray(rew_buf, np.float32),
            "dones": np.asarray(done_buf, np.bool_),
            "logp": np.asarray(logp_buf, np.float32),
        }

    def episode_returns(self, clear: bool = True) -> List[float]:
        out = list(self.completed_returns)
        if clear:
            self.completed_returns = []
        return out
