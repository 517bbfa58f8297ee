"""Multi-agent RL: env API, rollout runner, per-policy training (the
port's own copy of the numpy-only ``ray_tpu/rl/multi_agent.py``).

Reference capability: RLlib multi-agent (`rllib/env/multi_agent_env.py`,
`rllib/env/multi_agent_env_runner.py`, `rllib/algorithms/algorithm_config.py`
``.multi_agent(policies=..., policy_mapping_fn=...)``). Env API is the
RLlib dict convention: ``reset() -> (obs_dict, info)``;
``step(action_dict) -> (obs, rew, terminated, truncated, info)`` dicts
keyed by agent id, with ``terminated["__all__"]`` ending the episode.

Each POLICY keeps one learner (the same PPO/DQN learners as
single-agent); the runner groups per-agent trajectory fragments by policy
via ``policy_mapping_fn``, so N agents sharing a policy just mean more
rollout rows through the same learner.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import numpy as np

from ray_tpu_torch.rl.env import CartPoleEnv, make_env


class MultiAgentCartPole:
    """N independent cart-poles, one per agent (the standard RLlib
    multi-agent test env). Agents terminate individually; the episode
    ends when every agent is done."""

    n_actions = 2
    obs_dim = 4

    def __init__(self, num_agents: int = 2, seed: int = 0,
                 max_steps: int = 200):
        self.agent_ids = [f"agent_{i}" for i in range(num_agents)]
        self._envs = {aid: CartPoleEnv(seed=seed + i, max_steps=max_steps)
                      for i, aid in enumerate(self.agent_ids)}
        self._done: Dict[str, bool] = {}

    def reset(self, seed: Optional[int] = None):
        obs = {}
        for i, (aid, env) in enumerate(self._envs.items()):
            o, _ = env.reset(None if seed is None else seed + i)
            obs[aid] = o
        self._done = {aid: False for aid in self.agent_ids}
        return obs, {}

    def step(self, action_dict: Dict[str, int]):
        obs, rew, term, trunc = {}, {}, {}, {}
        for aid, action in action_dict.items():
            if self._done.get(aid, True):
                continue
            o, r, te, tr, _ = self._envs[aid].step(action)
            rew[aid] = r
            term[aid] = te
            trunc[aid] = tr
            if te or tr:
                self._done[aid] = True
            else:
                obs[aid] = o
        all_done = all(self._done.values())
        term["__all__"] = all_done
        trunc["__all__"] = False
        return obs, rew, term, trunc, {}


class MultiAgentEnvRunner:
    """Actor: collects rollouts from a multi-agent env, grouped by
    policy. ``sample`` returns {policy_id: [per-agent fragment, ...]} in
    the exact single-agent batch format, so the per-policy learners are
    unchanged — each agent's fragment keeps its own bootstrap
    observation for GAE."""

    def __init__(self, env_spec, policy_factories: Dict[str, Callable],
                 policy_mapping_fn: Callable[[str], str], seed: int = 0):
        self.env = make_env(env_spec, seed=seed)
        self.policies = {pid: factory()
                         for pid, factory in policy_factories.items()}
        self.mapping = policy_mapping_fn
        self._obs, _ = self.env.reset(seed=seed)
        self._ep_return: Dict[str, float] = {}
        self.completed_returns: Dict[str, List[float]] = {}

    def set_weights(self, weights: Dict[str, Any]) -> None:
        for pid, w in weights.items():
            self.policies[pid].set_weights(w)

    def sample(self, num_steps: int) -> Dict[str, List[Dict]]:
        bufs: Dict[str, Dict[str, list]] = {}   # agent -> buffers

        def buf(aid):
            return bufs.setdefault(aid, {
                "obs": [], "actions": [], "rewards": [], "dones": [],
                "logp": []})

        for _ in range(num_steps):
            actions, logps = {}, {}
            for aid, o in self._obs.items():
                pid = self.mapping(aid)
                if pid not in self.policies:
                    raise ValueError(
                        f"policy_mapping_fn({aid!r}) -> {pid!r}, not in "
                        f"policies {sorted(self.policies)}")
                pol = self.policies[pid]
                a, lp = pol.act(o)
                actions[aid] = a
                logps[aid] = lp
            nobs, rew, term, trunc, _ = self.env.step(actions)
            # an env may end the EPISODE via __all__ (shared time limit,
            # one agent winning) without flagging every live agent: the
            # reset below must not let trajectories bootstrap across it
            episode_over = bool(term.get("__all__")
                                or trunc.get("__all__"))
            for aid in actions:
                b = buf(aid)
                b["obs"].append(self._obs[aid])
                b["actions"].append(actions[aid])
                b["rewards"].append(rew.get(aid, 0.0))
                done = (term.get(aid, False) or trunc.get(aid, False)
                        or episode_over)
                b["dones"].append(done)
                b["logp"].append(logps[aid])
                self._ep_return[aid] = (self._ep_return.get(aid, 0.0)
                                        + rew.get(aid, 0.0))
                # keep the agent's last obs around for the bootstrap
                # even after it leaves the obs dict
                b["last_obs"] = nobs.get(aid, self._obs[aid])
                if done:
                    self.completed_returns.setdefault(aid, []).append(
                        self._ep_return.pop(aid, 0.0))
            if episode_over:
                self._obs, _ = self.env.reset()
            else:
                # agents keep their previous obs only if still live
                self._obs = nobs

        out: Dict[str, List[Dict]] = {}
        for aid, b in bufs.items():
            if not b["obs"]:
                continue
            fragment = {
                "obs": np.asarray(b["obs"], np.float32),
                "next_obs_last": np.asarray(b["last_obs"], np.float32),
                "actions": np.asarray(b["actions"], np.int32),
                "rewards": np.asarray(b["rewards"], np.float32),
                "dones": np.asarray(b["dones"], np.bool_),
                "logp": np.asarray(b["logp"], np.float32),
            }
            out.setdefault(self.mapping(aid), []).append(fragment)
        return out

    def episode_returns(self, clear: bool = True) -> List[float]:
        out = [x for v in self.completed_returns.values() for x in v]
        if clear:
            self.completed_returns = {}
        return out
