"""The port's RL ``Algorithm`` on the port's runtime, on the CPU.

The ``Algorithm`` tests of ``tests/test_rl.py`` and
``tests/test_rl_multi_agent.py`` at JAX's bars, with ``device="cpu"`` (the
learners and the runners' policies on the CPU; the default is the card), and
one PPO ``train()`` through both packages' ``Algorithm`` from the same
learner state: rollouts bit for bit, the learner's metrics at rtol 1e-5,
atol 1e-6.
"""

import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu_torch as rt
from ray_tpu.rl import AlgorithmConfig as JaxAlgorithmConfig
from ray_tpu_torch import rl
from ray_tpu_torch.rl import AlgorithmConfig, MultiAgentCartPole

CPU = {"device": "cpu"}


@pytest.fixture
def runtime():
    """A one-node runtime of 8 CPUs per test, torch on one intra-op thread:
    the learners' 64-wide products gain nothing from more, and the test
    workers share the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    r = rt.init(num_nodes=1, resources={"CPU": 8})
    try:
        yield r
    finally:
        rt.shutdown()
        torch.set_num_threads(threads)


@pytest.fixture
def in_process_runtime(monkeypatch):
    """``runtime`` with process workers off (JAX's
    RAY_TPU_PROCESS_WORKERS=0): the runners are actors on the driver's
    threads, whose instances a test can read."""
    monkeypatch.setenv("RAY_TPU_PROCESS_WORKERS", "0")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    r = rt.init(num_nodes=1, resources={"CPU": 8})
    try:
        yield r
    finally:
        rt.shutdown()
        torch.set_num_threads(threads)


# -- tests/test_rl.py ---------------------------------------------------------

def test_ppo_improves_on_cartpole(runtime):
    algo = (AlgorithmConfig(algo="PPO")
            .environment("CartPole-v1")
            .env_runners(2, rollout_fragment_length=256)
            .training(lr=1e-3, epochs=4, minibatch_size=128, **CPU)
            .build())
    try:
        first = None
        last = None
        for i in range(12):
            m = algo.train()
            if first is None and np.isfinite(m["episode_return_mean"]):
                first = m["episode_return_mean"]
            if np.isfinite(m["episode_return_mean"]):
                last = m["episode_return_mean"]
        assert first is not None and last is not None
        assert last > first  # learning happened
        assert last > 40     # clearly better than random (~20)
    finally:
        algo.stop()


def test_dqn_runs_and_decays_epsilon(runtime):
    algo = (AlgorithmConfig(algo="DQN")
            .environment("CartPole-v1")
            .env_runners(2, rollout_fragment_length=128)
            .training(lr=1e-3, updates_per_iter=16, **CPU)
            .build())
    try:
        eps = []
        for _ in range(4):
            m = algo.train()
            eps.append(m["epsilon"])
        assert eps[-1] < eps[0]
        assert np.isfinite(m["td_loss"])
    finally:
        algo.stop()


def test_custom_env_registry(runtime):
    from ray_tpu_torch.rl import register_env

    class ConstEnv:
        n_actions = 2
        obs_dim = 2

        def __init__(self, seed=0):
            self.t = 0

        def reset(self, seed=None):
            self.t = 0
            return np.zeros(2, np.float32), {}

        def step(self, a):
            self.t += 1
            return (np.zeros(2, np.float32), float(a), False,
                    self.t >= 10, {})

    register_env("Const-v0", lambda seed=0: ConstEnv(seed))
    algo = (AlgorithmConfig(algo="PPO").environment("Const-v0")
            .env_runners(1, rollout_fragment_length=64).training(**CPU)
            .build())
    try:
        m = algo.train()
        assert m["num_episodes"] > 0
    finally:
        algo.stop()


def test_algorithm_with_connectors(runtime):
    from ray_tpu_torch.rl.connectors import (ConnectorPipeline, FrameStack,
                                             MeanStdObservationNormalizer)

    algo = (AlgorithmConfig()
            .environment("CartPole-v1")
            .env_runners(1, rollout_fragment_length=64)
            .connectors(env_to_module=lambda: ConnectorPipeline(
                [MeanStdObservationNormalizer(), FrameStack(2)]))
            .training(**CPU)
            ).build()
    metrics = algo.train()
    loss_keys = [k for k in metrics if "loss" in k]
    assert loss_keys and all(np.isfinite(metrics[k]) for k in loss_keys)
    algo.stop()


def test_impala_improves_on_cartpole(runtime):
    algo = (AlgorithmConfig(algo="IMPALA")
            .environment("CartPole-v1")
            .env_runners(2, rollout_fragment_length=256)
            .training(lr=1e-3, ent_coef=0.01, **CPU)
            .build())
    returns = []
    for _ in range(12):
        m = algo.train()
        if not np.isnan(m["episode_return_mean"]):
            returns.append(m["episode_return_mean"])
    algo.stop()
    assert returns, "no completed episodes"
    assert m["num_learner_updates"] >= 24   # async updates really ran
    trailing = float(np.mean(returns[-3:]))
    leading = float(np.mean(returns[:3]))
    assert trailing > 35, (leading, trailing, returns)
    assert trailing > leading * 0.7, (leading, trailing)


def test_sac_runs_and_tunes_temperature(runtime):
    algo = (AlgorithmConfig(algo="SAC")
            .environment("CartPole-v1")
            .env_runners(1, rollout_fragment_length=256)
            .training(batch_size=128, updates_per_call=8, **CPU)
            .build())
    metrics = {}
    for _ in range(4):
        metrics = algo.train()
    algo.stop()
    assert metrics["num_learner_updates"] >= 16
    assert np.isfinite(metrics["q_loss"])
    assert metrics["alpha"] > 0       # temperature stayed positive
    assert 0 < metrics["entropy"] <= np.log(2) + 1e-5


def test_appo_runs_async_with_clipped_vtrace(runtime):
    algo = (AlgorithmConfig(algo="APPO")
            .environment("CartPole-v1")
            .env_runners(2, rollout_fragment_length=128)
            .training(lr=1e-3, clip=0.2, **CPU)
            .build())
    m = {}
    for _ in range(3):
        m = algo.train()
    algo.stop()
    assert m["num_learner_updates"] >= 6   # async per-fragment updates
    assert np.isfinite(m["pg_loss"]) and np.isfinite(m["vf_loss"])


def test_tuned_gridworld_contract(runtime):
    from ray_tpu_torch.rl.tuned_examples import run
    m = run("ppo-gridworld", max_iterations=20, device="cpu")
    assert m["best_return"] > 0.0, m["best_return"]


# -- tests/test_rl_multi_agent.py --------------------------------------------

def test_multi_agent_ppo_trains(runtime):
    from ray_tpu_torch.rl import register_env

    register_env("MultiCartPole-2",
                 lambda seed=0: MultiAgentCartPole(2, seed=seed,
                                                  max_steps=100))
    algo = (AlgorithmConfig(algo="PPO", seed=0)
            .environment("MultiCartPole-2")
            .env_runners(2, rollout_fragment_length=128)
            .training(minibatch_size=64, epochs=2, **CPU)
            .multi_agent(
                policies={"p0": None, "p1": None},
                policy_mapping_fn=lambda aid: (
                    "p0" if aid == "agent_0" else "p1"))
            .build())
    try:
        m = None
        for _ in range(3):
            m = algo.train()
        # both policies actually updated and reported
        assert any(k.startswith("p0/") for k in m)
        assert any(k.startswith("p1/") for k in m)
        assert m["training_iteration"] == 3
        assert m["num_episodes"] > 0
        assert np.isfinite(m["episode_return_mean"])
    finally:
        algo.stop()


def test_mapping_validated_at_build(runtime):
    from ray_tpu_torch.rl import register_env

    register_env("MultiCartPole-2v",
                 lambda seed=0: MultiAgentCartPole(2, seed=seed))
    cfg = (AlgorithmConfig(algo="PPO")
           .environment("MultiCartPole-2v")
           .training(**CPU)
           .multi_agent(policies={"p0": None},
                        policy_mapping_fn=lambda aid: aid))
    with pytest.raises(ValueError, match="not in policies"):
        cfg.build()


def test_multi_agent_impala_async_path(runtime):
    from ray_tpu_torch.rl import register_env

    register_env("MultiCartPole-2a",
                 lambda seed=0: MultiAgentCartPole(2, seed=seed,
                                                  max_steps=80))
    algo = (AlgorithmConfig(algo="IMPALA", seed=0)
            .environment("MultiCartPole-2a")
            .env_runners(2, rollout_fragment_length=64)
            .training(**CPU)
            .multi_agent(
                policies={"p0": None, "p1": None},
                policy_mapping_fn=lambda aid: (
                    "p0" if aid == "agent_0" else "p1"))
            .build())
    try:
        m = None
        for _ in range(2):
            m = algo.train()
        assert any(k.startswith("p0/") for k in m)
        assert any(k.startswith("p1/") for k in m)
        assert m["training_iteration"] == 2
        assert np.isfinite(m["episode_return_mean"]) or \
            m["num_episodes"] == 0
    finally:
        algo.stop()


def test_tuned_examples_registry_builds(runtime):
    """Every tuned example's config builds and trains one iteration."""
    from ray_tpu_torch.rl.tuned_examples import TUNED
    assert len(TUNED) >= 6
    for name, ex in TUNED.items():
        algo = ex.make_config().training(**CPU).build()
        try:
            m = algo.train()
            assert m["training_iteration"] == 1, name
        finally:
            algo.stop()


def test_tuned_example_contract_runs(runtime):
    """One fast contract end-to-end: PPO improves toward its target."""
    from ray_tpu_torch.rl.tuned_examples import run
    m = run("ppo-cartpole", max_iterations=6, target_return=60.0,
            device="cpu")
    assert m["best_return"] > 20.0
    assert m["training_iteration"] >= 1


# -- the port's own ----------------------------------------------------------

def test_algorithm_defaults_to_the_card(runtime):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        AlgorithmConfig(algo="PPO").build()
    from ray_tpu_torch.rl.tuned_examples import run
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run("ppo-cartpole", max_iterations=1)


def test_runners_share_the_learners_device_and_weights(in_process_runtime):
    """The runners' policies live on the learner's device and hold its
    weights after a sync; the weights they get are the learner's copy from
    the object store, not its live parameters."""
    algo = (AlgorithmConfig(algo="PPO")
            .env_runners(2, rollout_fragment_length=32)
            .training(**CPU).build())
    try:
        algo.train()
        want = algo.learner.get_weights()
        for handle in algo.runners:
            executor = in_process_runtime._actor_executors[
                handle._ray_actor_id]
            policy = executor.instance.policy
            assert policy.device == algo.learner.device
            for part in ("pi", "vf"):
                for got, ref in zip(policy.params[part], want[part]):
                    for k in ref:
                        assert torch.equal(got[k], ref[k])
                        assert got[k].data_ptr() != ref[k].data_ptr()
    finally:
        algo.stop()


def _recording(learner, log):
    """Wrap ``learner.update`` to keep its rollouts and metrics."""
    update = learner.update

    def wrapped(rollouts):
        metrics = update(rollouts)
        log.append(([{k: np.array(v) for k, v in r.items()}
                     for r in rollouts], metrics))
        return metrics

    learner.update = wrapped


def test_ppo_train_matches_jax(runtime, monkeypatch):
    """One PPO ``train()`` through both packages' ``Algorithm``, the port's
    learner loaded with JAX's state and synced to its runners: the
    rollouts bit for bit, the learner's metrics at rtol 1e-5, atol 1e-6."""
    monkeypatch.setenv("RAY_TPU_PROCESS_WORKERS", "0")
    kw = dict(lr=1e-3, epochs=2, minibatch_size=128)
    ray_tpu.init(num_nodes=1, resources={"CPU": 8})
    try:
        jax_algo = (JaxAlgorithmConfig(algo="PPO", seed=0)
                    .environment("CartPole-v1")
                    .env_runners(2, rollout_fragment_length=256)
                    .training(**kw).build())
        port_algo = (AlgorithmConfig(algo="PPO", seed=0)
                     .environment("CartPole-v1")
                     .env_runners(2, rollout_fragment_length=256)
                     .training(**kw, **CPU).build())
        rl.load_learner_state(port_algo.learner,
                              rl.learner_state(jax_algo.learner))
        port_algo._sync_weights()
        jax_log, port_log = [], []
        _recording(jax_algo.learner, jax_log)
        _recording(port_algo.learner, port_log)
        jm, pm = jax_algo.train(), port_algo.train()
        jax_algo.stop()
        port_algo.stop()
    finally:
        ray_tpu.shutdown()
    (jr, _), (pr, _) = jax_log[0], port_log[0]
    assert len(jr) == len(pr) == 2
    for a, b in zip(jr, pr):
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(b[k], a[k], err_msg=k)
    assert pm["num_episodes"] == jm["num_episodes"] > 0
    assert pm["episode_return_mean"] == jm["episode_return_mean"]
    learner_keys = set(jax_log[0][1])
    assert learner_keys and learner_keys <= set(pm)
    for k in learner_keys:
        np.testing.assert_allclose(pm[k], jm[k], rtol=1e-5, atol=1e-6,
                                   err_msg=k)
