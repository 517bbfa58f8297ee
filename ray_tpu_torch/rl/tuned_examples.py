"""Tuned examples: curated known-good configs per algorithm (counterpart
of ``ray_tpu/rl/tuned_examples.py``).

A registry of algorithm configs that reach a target return on a named
environment, runnable by name. Each entry is an AlgorithmConfig factory plus
its convergence contract (target return, iteration budget); ``run(name)``
trains until the target or the budget and reports whether the contract
held. The configs are JAX's; ``run``'s ``device`` places the learners
(``None``: the card).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import numpy as np

from ray_tpu_torch._device import DeviceLike
from ray_tpu_torch.rl.algorithm import AlgorithmConfig


@dataclasses.dataclass
class TunedExample:
    make_config: Callable[[], AlgorithmConfig]
    target_return: float
    max_iterations: int
    description: str = ""


def _ppo_cartpole() -> AlgorithmConfig:
    return (AlgorithmConfig(algo="PPO", seed=0)
            .environment("CartPole-v1")
            .env_runners(2, rollout_fragment_length=512)
            .training(lr=3e-4, epochs=6, minibatch_size=128,
                      ent_coef=0.01))


def _dqn_cartpole() -> AlgorithmConfig:
    return (AlgorithmConfig(algo="DQN", seed=0)
            .environment("CartPole-v1")
            .env_runners(2, rollout_fragment_length=256))


def _impala_cartpole() -> AlgorithmConfig:
    return (AlgorithmConfig(algo="IMPALA", seed=0)
            .environment("CartPole-v1")
            .env_runners(2, rollout_fragment_length=256))


def _appo_cartpole() -> AlgorithmConfig:
    return (AlgorithmConfig(algo="APPO", seed=0)
            .environment("CartPole-v1")
            .env_runners(2, rollout_fragment_length=256))


def _sac_cartpole() -> AlgorithmConfig:
    return (AlgorithmConfig(algo="SAC", seed=0)
            .environment("CartPole-v1")
            .env_runners(2, rollout_fragment_length=256))


def _ppo_multi_agent() -> AlgorithmConfig:
    from ray_tpu_torch.rl.env import register_env
    from ray_tpu_torch.rl.multi_agent import MultiAgentCartPole
    register_env("tuned/MultiCartPole-2",
                 lambda seed=0: MultiAgentCartPole(2, seed=seed,
                                                  max_steps=200))
    return (AlgorithmConfig(algo="PPO", seed=0)
            .environment("tuned/MultiCartPole-2")
            .env_runners(2, rollout_fragment_length=256)
            .training(epochs=4, minibatch_size=128)
            .multi_agent(
                policies={"p0": None, "p1": None},
                policy_mapping_fn=lambda aid: (
                    "p0" if aid.endswith("0") else "p1")))


def _ppo_gridworld() -> AlgorithmConfig:
    return (AlgorithmConfig(algo="PPO", seed=0)
            .environment("GridWorld-5x5")
            .env_runners(2, rollout_fragment_length=256)
            .training(lr=5e-4, epochs=6, minibatch_size=128,
                      ent_coef=0.02))


def _dqn_gridworld() -> AlgorithmConfig:
    return (AlgorithmConfig(algo="DQN", seed=0)
            .environment("GridWorld-5x5")
            .env_runners(2, rollout_fragment_length=128))


def _ppo_mountaincar() -> AlgorithmConfig:
    return (AlgorithmConfig(algo="PPO", seed=0)
            .environment("MountainCarShaped-v0")
            .env_runners(2, rollout_fragment_length=512)
            .training(lr=5e-4, epochs=6, minibatch_size=128,
                      ent_coef=0.01))


def _impala_gridworld() -> AlgorithmConfig:
    return (AlgorithmConfig(algo="IMPALA", seed=0)
            .environment("GridWorld-5x5")
            .env_runners(2, rollout_fragment_length=128))


TUNED: Dict[str, TunedExample] = {
    "ppo-cartpole": TunedExample(
        _ppo_cartpole, target_return=200.0, max_iterations=40,
        description="PPO reaches 200+ on CartPole within 40 iters"),
    "dqn-cartpole": TunedExample(
        _dqn_cartpole, target_return=80.0, max_iterations=40,
        description="DQN clears 80 on CartPole within 40 iters"),
    "impala-cartpole": TunedExample(
        _impala_cartpole, target_return=100.0, max_iterations=40,
        description="IMPALA (V-trace) clears 100 within 40 iters"),
    "appo-cartpole": TunedExample(
        _appo_cartpole, target_return=100.0, max_iterations=40,
        description="APPO clears 100 within 40 iters"),
    "sac-cartpole": TunedExample(
        _sac_cartpole, target_return=40.0, max_iterations=40,
        description="discrete SAC clears 40 within 40 iters"),
    "ppo-multi-agent-cartpole": TunedExample(
        _ppo_multi_agent, target_return=60.0, max_iterations=30,
        description="2-policy PPO on MultiAgentCartPole clears 60"),
    # optimal 5x5 GridWorld return = 10 - 0.1*7 ~ 9.3; random walk is
    # deeply negative, so >= 5 is a real learned-policy bar
    "ppo-gridworld": TunedExample(
        _ppo_gridworld, target_return=5.0, max_iterations=30,
        description="PPO solves sparse 5x5 GridWorld (>=5 return)"),
    "dqn-gridworld": TunedExample(
        _dqn_gridworld, target_return=5.0, max_iterations=30,
        description="DQN solves sparse 5x5 GridWorld (>=5 return)"),
    "impala-gridworld": TunedExample(
        _impala_gridworld, target_return=3.0, max_iterations=30,
        description="IMPALA clears 3 on 5x5 GridWorld"),
    # shaped mountain car: random policy stays ~-195; energy-pumping
    # policies reach the flag (bonus +100) -> >= -100 is a clear pass
    "ppo-mountaincar-shaped": TunedExample(
        _ppo_mountaincar, target_return=-100.0, max_iterations=40,
        description="PPO builds momentum on shaped MountainCar"),
}


def run(name: str, max_iterations: Optional[int] = None,
        target_return: Optional[float] = None,
        device: DeviceLike = None) -> Dict[str, Any]:
    """Train a tuned example until its target return (rolling best) or
    the iteration budget, the learners on ``device`` (None: the card);
    returns the final metrics plus ``converged``/``best_return``."""
    ex = TUNED[name]
    target = target_return if target_return is not None \
        else ex.target_return
    budget = max_iterations if max_iterations is not None \
        else ex.max_iterations
    algo = ex.make_config().training(device=device).build()
    best = float("-inf")
    metrics: Dict[str, Any] = {}
    try:
        for _ in range(budget):
            metrics = algo.train()
            ret = metrics.get("episode_return_mean", float("nan"))
            if np.isfinite(ret):
                best = max(best, float(ret))
            if best >= target:
                break
    finally:
        algo.stop()
    metrics["best_return"] = best
    metrics["converged"] = best >= target
    metrics["target_return"] = target
    return metrics
