"""Algorithm + AlgorithmConfig (counterpart of ``ray_tpu/rl/algorithm.py``).

Control loop per iteration: EnvRunner actors of the port's runtime sample in
parallel → the learner updates in torch on its device → the weights go back
to the runners through the object store (on the card they stay in its
device tier: the runners receive the learner's tensors, not a host copy).

``learner_kwargs["device"]`` places the learner and the runners' policies:
absent or ``None`` is the card, and ``device="cpu"`` runs the whole
algorithm on the CPU.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.rl.env import ENV_REGISTRY, EnvRunner, make_env


@dataclasses.dataclass
class AlgorithmConfig:
    algo: str = "PPO"
    env: Any = "CartPole-v1"
    num_env_runners: int = 2
    rollout_fragment_length: int = 256
    train_iterations_per_call: int = 1
    learner_kwargs: Dict[str, Any] = dataclasses.field(default_factory=dict)
    seed: int = 0
    # connector factories (each runner needs its own stateful pipeline)
    env_to_module_connector: Any = None
    module_to_env_connector: Any = None
    # multi-agent: policies maps policy_id -> per-policy learner_kwargs
    # override (or None); policy_mapping_fn maps agent_id -> policy_id
    policies: Optional[Dict[str, Any]] = None
    policy_mapping_fn: Optional[Callable[[str], str]] = None

    # fluent API
    def environment(self, env) -> "AlgorithmConfig":
        self.env = env
        return self

    def env_runners(self, num_env_runners: int,
                    rollout_fragment_length: Optional[int] = None
                    ) -> "AlgorithmConfig":
        self.num_env_runners = num_env_runners
        if rollout_fragment_length:
            self.rollout_fragment_length = rollout_fragment_length
        return self

    def training(self, **kwargs) -> "AlgorithmConfig":
        self.learner_kwargs.update(kwargs)
        return self

    def connectors(self, env_to_module=None, module_to_env=None
                   ) -> "AlgorithmConfig":
        """Factories returning a Connector/ConnectorPipeline per runner."""
        self.env_to_module_connector = env_to_module
        self.module_to_env_connector = module_to_env
        return self

    def multi_agent(self, policies: Dict[str, Any],
                    policy_mapping_fn: Callable[[str], str]
                    ) -> "AlgorithmConfig":
        """Train several policies against a multi-agent env. ``policies``:
        policy_id -> learner_kwargs override dict (or None for defaults)."""
        self.policies = dict(policies)
        self.policy_mapping_fn = policy_mapping_fn
        return self

    def build(self) -> "Algorithm":
        return Algorithm(self)


def _build_learner(algo: str, obs_dim: int, n_actions: int, seed: int,
                   learner_kwargs: Dict[str, Any]):
    """(learner, policy_factory) for one policy of ``algo``; the runners'
    policies live on the learner's device. The factory closes over that
    device, so the runners of a learner on the card stay in the driver
    (the process router's accelerator-plane rule), and those of a learner
    on the CPU run in worker processes."""
    algo = algo.upper()
    if algo == "PPO":
        from ray_tpu_torch.rl.ppo import ActorCriticPolicy, PPOLearner
        learner = PPOLearner(obs_dim, n_actions, seed=seed,
                             **learner_kwargs)
        policy_cls = ActorCriticPolicy
    elif algo == "DQN":
        from ray_tpu_torch.rl.dqn import DQNLearner, QPolicy
        learner = DQNLearner(obs_dim, n_actions, seed=seed,
                             **learner_kwargs)
        policy_cls = QPolicy
    elif algo in ("IMPALA", "APPO"):
        from ray_tpu_torch.rl.impala import APPOLearner, ImpalaLearner
        from ray_tpu_torch.rl.ppo import ActorCriticPolicy
        cls = APPOLearner if algo == "APPO" else ImpalaLearner
        learner = cls(obs_dim, n_actions, seed=seed, **learner_kwargs)
        policy_cls = ActorCriticPolicy
    elif algo == "SAC":
        from ray_tpu_torch.rl.sac import SACLearner, SACPolicy
        learner = SACLearner(obs_dim, n_actions, seed=seed,
                             **learner_kwargs)
        policy_cls = SACPolicy
    else:
        raise ValueError(f"unknown algo {algo!r}")
    device = learner.device
    factory = lambda: policy_cls(  # noqa: E731
        obs_dim, n_actions, seed=seed, device=device)
    return learner, factory


def _resolve_env(env_spec):
    """Resolve a string env spec against this process's registry, so the
    runners get the creator itself rather than a registry name."""
    if isinstance(env_spec, str) and env_spec in ENV_REGISTRY:
        return ENV_REGISTRY[env_spec]
    return env_spec


class Algorithm:
    def __init__(self, config: AlgorithmConfig):
        self.config = config
        if config.policies:
            self._init_multi_agent()
            return
        probe = make_env(config.env, seed=0)
        obs_dim = probe.obs_dim
        n_actions = probe.n_actions

        if config.env_to_module_connector is not None:
            # the policy sees connected observations; size it accordingly
            probe_pipeline = config.env_to_module_connector()
            obs_dim = int(np.asarray(
                probe_pipeline(probe.reset(seed=0)[0])).shape[-1])

        self.learner, policy_factory = _build_learner(
            config.algo, obs_dim, n_actions, config.seed,
            config.learner_kwargs)

        env_spec = _resolve_env(config.env)
        runner_cls = ray_tpu_torch.remote(EnvRunner)

        def _runner_kwargs(i):
            kw = {"seed": config.seed + 1 + i}
            if config.env_to_module_connector is not None:
                kw["env_to_module"] = config.env_to_module_connector()
            if config.module_to_env_connector is not None:
                kw["module_to_env"] = config.module_to_env_connector()
            return kw

        self.runners = [
            runner_cls.remote(env_spec, policy_factory,
                              **_runner_kwargs(i))
            for i in range(config.num_env_runners)]
        self._sync_weights()
        self.iteration = 0
        # IMPALA: one sample per runner stays permanently in flight (the
        # async actor-learner queue); refs survive across train() calls.
        self._in_flight: Dict[Any, Any] = {}

    # -- multi-agent -------------------------------------------------------
    def _init_multi_agent(self) -> None:
        from ray_tpu_torch.rl.multi_agent import MultiAgentEnvRunner
        cfg = self.config
        if cfg.policy_mapping_fn is None:
            raise ValueError("multi_agent() needs a policy_mapping_fn")
        if (cfg.env_to_module_connector is not None
                or cfg.module_to_env_connector is not None):
            raise ValueError(
                "connectors are not supported on the multi-agent path "
                "yet — they would be silently ignored")
        probe = make_env(cfg.env, seed=0)   # handles callables too
        obs_dim, n_actions = probe.obs_dim, probe.n_actions
        # config-time mapping validation: a bad policy_mapping_fn must fail
        # here, not as a KeyError inside a remote runner
        for aid in getattr(probe, "agent_ids", []):
            pid = cfg.policy_mapping_fn(aid)
            if pid not in cfg.policies:
                raise ValueError(
                    f"policy_mapping_fn({aid!r}) -> {pid!r}, which is "
                    f"not in policies {sorted(cfg.policies)}")
        self.learners: Dict[str, Any] = {}
        factories: Dict[str, Any] = {}
        for idx, (pid, overrides) in enumerate(cfg.policies.items()):
            kw = dict(cfg.learner_kwargs)
            kw.update(overrides or {})
            # per-policy seed offset: distinct policies must not start
            # bit-identical (self-play symmetry breaking)
            self.learners[pid], factories[pid] = _build_learner(
                cfg.algo, obs_dim, n_actions, cfg.seed + 1000 * idx, kw)
        env_spec = _resolve_env(cfg.env)
        runner_cls = ray_tpu_torch.remote(MultiAgentEnvRunner)
        self.runners = [
            runner_cls.remote(env_spec, factories, cfg.policy_mapping_fn,
                              seed=cfg.seed + 1 + i)
            for i in range(cfg.num_env_runners)]
        self.learner = None
        self._in_flight = {}
        self._sync_weights()
        self.iteration = 0

    def _train_multi_agent(self) -> Dict[str, Any]:
        cfg = self.config
        if cfg.algo.upper() in ("IMPALA", "APPO"):
            return self._train_multi_agent_async()
        metrics: Dict[str, Any] = {}
        for _ in range(cfg.train_iterations_per_call):
            sampled = ray_tpu_torch.get([
                r.sample.remote(cfg.rollout_fragment_length)
                for r in self.runners])
            by_policy: Dict[str, list] = {}
            for batch in sampled:
                for pid, frags in batch.items():
                    by_policy.setdefault(pid, []).extend(frags)
            for pid, frags in by_policy.items():
                m = self.learners[pid].update(frags)
                metrics.update({f"{pid}/{k}": v for k, v in m.items()})
            self._sync_weights()
        return self._finish_iteration(metrics)

    def _train_multi_agent_async(self) -> Dict[str, Any]:
        """Multi-agent IMPALA/APPO: each delivered batch updates every
        policy it contains; only those policies' fresh weights go back to
        the delivering runner (set_weights takes partial dicts)."""
        def consume(batch, metrics):
            payload = {}
            for pid, frags in batch.items():
                m = self.learners[pid].update(frags)
                metrics.update({f"{pid}/{k}": v for k, v in m.items()})
                payload[pid] = self.learners[pid].get_weights()
            return payload

        return self._run_async_loop(consume)

    def _run_async_loop(self, consume) -> Dict[str, Any]:
        """IMPALA-style skeleton: one sample per runner stays in flight;
        ``consume(result, metrics)`` applies the update and returns the
        weights payload for the delivering runner."""
        cfg = self.config
        if not self._in_flight:
            self._in_flight = {
                r.sample.remote(cfg.rollout_fragment_length): r
                for r in self.runners}
        metrics: Dict[str, Any] = {}
        updates = cfg.train_iterations_per_call * len(self.runners)
        for _ in range(updates):
            done, _ = ray_tpu_torch.wait(list(self._in_flight),
                                         num_returns=1)
            runner = self._in_flight.pop(done[0])
            result = ray_tpu_torch.get(done[0])
            payload = consume(result, metrics)
            runner.set_weights.remote(ray_tpu_torch.put(payload))
            self._in_flight[
                runner.sample.remote(cfg.rollout_fragment_length)] = runner
        return self._finish_iteration(metrics)

    def _finish_iteration(self, metrics: Dict[str, Any]) -> Dict[str, Any]:
        """Per-train() tail: bump the counter, fold in the episode stats
        gathered from every runner."""
        self.iteration += 1
        returns = [x for r in self.runners
                   for x in ray_tpu_torch.get(r.episode_returns.remote())]
        metrics.update({
            "training_iteration": self.iteration,
            "episode_return_mean": float(np.mean(returns))
            if returns else float("nan"),
            "num_episodes": len(returns),
        })
        return metrics

    def _sync_weights(self) -> None:
        if self.config.policies:
            w = ray_tpu_torch.put({pid: ln.get_weights()
                                   for pid, ln in self.learners.items()})
        else:
            w = ray_tpu_torch.put(self.learner.get_weights())
        ray_tpu_torch.get([r.set_weights.remote(w) for r in self.runners])

    def _train_async(self) -> Dict[str, Any]:
        """IMPALA iteration: process fragments as they land (no barrier).
        Each runner keeps one sample in flight; the learner updates per
        fragment and pushes fresh weights only to the runner that just
        delivered (samplers run on stale weights; V-trace corrects)."""
        def consume(rollout, metrics):
            metrics.update(self.learner.update([rollout]))
            return self.learner.get_weights()

        return self._run_async_loop(consume)

    def train(self) -> Dict[str, Any]:
        """One training iteration."""
        cfg = self.config
        if cfg.policies:
            return self._train_multi_agent()
        if cfg.algo.upper() in ("IMPALA", "APPO"):
            return self._train_async()
        metrics: Dict[str, Any] = {}
        for _ in range(cfg.train_iterations_per_call):
            rollouts = ray_tpu_torch.get([
                r.sample.remote(cfg.rollout_fragment_length)
                for r in self.runners])
            metrics = self.learner.update(rollouts)
            self._sync_weights()
        return self._finish_iteration(metrics)

    def stop(self) -> None:
        for r in self.runners:
            try:
                ray_tpu_torch.kill(r)
            except Exception:
                pass    # already dead, or the runtime was shut down
