"""The RL learners of the PyTorch port (``ray_tpu_torch.rl``) held against
the JAX package's (``ray_tpu.rl``) on the CPU, on numpy inputs from a seed.

- Bit for bit: the env, connector, multi-agent and ``ReplayBuffer`` copies,
  ``compute_gae``, and ``EnvRunner.sample`` when both packages' policies
  hold the same numpy weights.
- ``vtrace`` at rtol 1e-6 (atol 1e-6 where outputs cancel to near 0) on
  T = 256, and JAX's on-policy identity test
  (tests/test_rl.py:165-190) copied; ``rl.optim``'s Adam and RMSprop
  against optax's over 5 steps at rtol 1e-6.
- The first gradient step of each learner from JAX's weights: loss and
  gradients at rtol 1e-5, atol 1e-6. JAX's gradients are read through an
  optax transformation that keeps them as its state (the SGD learners: as
  the derivative of their update by the learning rate).
- One ``update()`` of each learner at JAX's own bars for learner equality
  (``RL_CASES`` of chip_smoke.py, which holds the card to the CPU with the
  same cases): PPO rtol 2e-4, atol 2e-5 and a loss gap under 1e-3
  (tests/test_rl.py:259-264); IMPALA, APPO, DQN and SAC rtol 5e-4, atol
  5e-5 (:284-289); BC and OfflineDQN rtol 1e-5, atol 1e-6.
- PPO learns through the port's ``Algorithm`` at tests/test_rl.py:24-43's
  bar.

The data-parallel ``LearnerGroup`` is in tests/test_torch_rl_group.py.
"""

import chip_smoke
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_tpu.rl import connectors as jconn
from ray_tpu.rl import dqn as jdqn
from ray_tpu.rl import env as jenv
from ray_tpu.rl import impala as jimpala
from ray_tpu.rl import multi_agent as jma
from ray_tpu.rl import offline as joffline
from ray_tpu.rl import ppo as jppo
from ray_tpu.rl import sac as jsac
from ray_tpu_torch import rl
from ray_tpu_torch.rl import connectors as conn
from ray_tpu_torch.rl.dqn import _replay_batch
from ray_tpu_torch.rl.optim import RMSprop, adam
from ray_tpu_torch.train.spmd import param_leaves

JAX_LEARNERS = {"PPO": jppo.PPOLearner, "IMPALA": jimpala.ImpalaLearner,
                "APPO": jimpala.APPOLearner, "DQN": jdqn.DQNLearner,
                "SAC": jsac.SACLearner, "BC": joffline.BCLearner,
                "OfflineDQN": joffline.OfflineDQNLearner}
FIRST_STEP = dict(rtol=1e-5, atol=1e-6)


def _assert_trees(got, want, **tol):
    got, want = chip_smoke.flat_tree(got), chip_smoke.flat_tree(want)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **tol)


def _pair(name, **kw):
    """JAX's learner and the port's on the CPU, seeded with JAX's state."""
    jl = JAX_LEARNERS[name](4, 2, seed=0, **kw)
    pl = chip_smoke.make_learner(name, "cpu", **kw)
    rl.load_learner_state(pl, rl.learner_state(jl))
    return jl, pl


@pytest.fixture(scope="module")
def data():
    return chip_smoke.rl_case_data()


# ---------------------------------------------------------------------------
# the numpy copies, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["CartPole-v1", "GridWorld-5x5",
                                  "MountainCarShaped-v0"])
def test_envs_match_jaxs_bit_for_bit(name):
    for seed in (0, 3):
        envs = [jenv.make_env(name, seed), rl.make_env(name, seed)]
        actions = np.random.default_rng(seed).integers(
            0, envs[0].n_actions, 400)
        traces = []
        for env in envs:
            trace = [env.reset(seed=seed)[0]]
            for a in actions:
                obs, rew, term, trunc, _ = env.step(a)
                trace += [obs, rew, term, trunc]
                if term or trunc:
                    trace.append(env.reset()[0])
            traces.append(trace)
        assert len(traces[0]) == len(traces[1])
        for a, b in zip(*traces):
            np.testing.assert_array_equal(a, b)
    unshaped = [m.MountainCarEnv(seed=1, shaped=False) for m in (jenv, rl)]
    for env in unshaped:
        env.reset()
    assert unshaped[0].step(2)[1] == unshaped[1].step(2)[1] == -1.0


def test_registry_and_make_env():
    names = {"CartPole-v1", "GridWorld-5x5", "MountainCarShaped-v0"}
    assert names <= set(rl.env.ENV_REGISTRY) and names <= set(
        jenv.ENV_REGISTRY)
    rl.register_env("port-test/Grid-3", lambda seed=0: rl.GridWorldEnv(
        seed, size=3))
    assert rl.make_env("port-test/Grid-3").size == 3
    with pytest.raises(KeyError, match="register_env first"):
        rl.make_env("no-such-env")


def test_connectors_match_jaxs_bit_for_bit():
    def pipeline(m):
        return m.ConnectorPipeline([m.MeanStdObservationNormalizer(),
                                    m.FrameStack(3),
                                    m.ObservationClipper(-2.0, 2.0)])
    pipes = [pipeline(jconn), pipeline(conn)]
    assert pipes[0].output_multiplier == pipes[1].output_multiplier == 3
    xs = np.random.default_rng(0).normal(size=(50, 4)) * 3
    for i, x in enumerate(xs):
        if i == 20:
            for p in pipes:
                p.reset()
        np.testing.assert_array_equal(pipes[0](x), pipes[1](x))
    actions = np.random.default_rng(1).normal(size=(8, 2)) * 2
    for m in (jconn, conn):
        assert m.Connector().reset() is None
    for a in actions:
        np.testing.assert_array_equal(jconn.ClipActions(-1, 1)(a),
                                      conn.ClipActions(-1, 1)(a))
        np.testing.assert_array_equal(jconn.UnsquashActions(-2, 4)(a),
                                      conn.UnsquashActions(-2, 4)(a))


def _same_weights(jpolicy, ppolicy, key="pi"):
    """Load the JAX policy's weights into the port's (``set_weights``)."""
    payload = rl.params_from_numpy(
        jax.tree.map(np.asarray, jpolicy.params), "cpu")
    if key == "q":
        payload = (payload, jpolicy.epsilon)
    ppolicy.set_weights(payload)


@pytest.mark.parametrize("kind", ["actor-critic", "connectors", "q", "sac"])
def test_env_runner_rollouts_match_jaxs_bit_for_bit(kind):
    obs_dim = 4
    env_to_module = [None, None]
    if kind == "connectors":
        env_to_module = [m.ConnectorPipeline([
            m.MeanStdObservationNormalizer(), m.FrameStack(2)])
            for m in (jconn, conn)]
        obs_dim = 8
    make = {"actor-critic": (jppo.ActorCriticPolicy, rl.ActorCriticPolicy),
            "connectors": (jppo.ActorCriticPolicy, rl.ActorCriticPolicy),
            "q": (jdqn.QPolicy, rl.QPolicy),
            "sac": (jsac.SACPolicy, rl.SACPolicy)}[kind]
    jrunner = jenv.EnvRunner(jenv.CartPoleEnv,
                             lambda: make[0](obs_dim, 2, seed=7), seed=3,
                             env_to_module=env_to_module[0])
    prunner = rl.EnvRunner(rl.CartPoleEnv, lambda: make[1](
        obs_dim, 2, seed=7, device="cpu"), seed=3,
        env_to_module=env_to_module[1])
    if kind == "q":
        jrunner.policy.set_weights((jrunner.policy.params, 0.5))
    _same_weights(jrunner.policy, prunner.policy,
                  "q" if kind == "q" else "pi")
    for _ in range(2):
        a, b = jrunner.sample(300), prunner.sample(300)
        assert set(a) == set(b)
        for k in a:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert jrunner.episode_returns() == prunner.episode_returns() != []


def test_multi_agent_runner_matches_jaxs_bit_for_bit():
    def mapping(aid):
        return "p0" if aid.endswith("0") else "p1"

    env_spec = [lambda seed=0, m=m: m.MultiAgentCartPole(3, seed=seed,
                                                         max_steps=60)
                for m in (jma, rl)]
    jrunner = jma.MultiAgentEnvRunner(
        env_spec[0], {p: (lambda s=s: jppo.ActorCriticPolicy(4, 2, seed=s))
                      for s, p in enumerate(("p0", "p1"))}, mapping, seed=2)
    prunner = rl.MultiAgentEnvRunner(
        env_spec[1], {p: (lambda s=s: rl.ActorCriticPolicy(
            4, 2, seed=s, device="cpu")) for s, p in enumerate(("p0", "p1"))},
        mapping, seed=2)
    for pid in ("p0", "p1"):
        _same_weights(jrunner.policies[pid], prunner.policies[pid])
    a, b = jrunner.sample(150), prunner.sample(150)
    assert set(a) == set(b) == {"p0", "p1"}
    for pid in a:
        assert len(a[pid]) == len(b[pid])
        for fa, fb in zip(a[pid], b[pid]):
            for k in fa:
                np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)
    assert jrunner.episode_returns() == prunner.episode_returns() != []
    with pytest.raises(ValueError, match="not in policies"):
        rl.MultiAgentEnvRunner(env_spec[1], {"p0": lambda: rl.QPolicy(
            4, 2, device="cpu")}, mapping).sample(2)


def test_replay_buffer_and_gae_match_jaxs_bit_for_bit(data):
    bufs = [jdqn.ReplayBuffer(300, 4, seed=5), rl.ReplayBuffer(300, 4,
                                                               seed=5)]
    for buf in bufs:
        for frag in data["fragments"]:         # 512 rows wrap the ring
            buf.add_rollout(frag)
    assert bufs[0].pos == bufs[1].pos and bufs[0].size == bufs[1].size
    for _ in range(3):
        a, b = (buf.sample(64) for buf in bufs)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    rng = np.random.default_rng(0)
    frag = data["fragment"][0]
    values = rng.normal(size=256).astype(np.float32)
    for gamma, lam in ((0.99, 0.95), (0.9, 1.0)):
        got = rl.compute_gae(frag["rewards"], frag["dones"], values, 0.3,
                             gamma, lam)
        want = jppo.compute_gae(frag["rewards"], frag["dones"], values, 0.3,
                                gamma, lam)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------------------
# V-trace and the optimizers
# ---------------------------------------------------------------------------

def test_vtrace_matches_jax():
    rng = np.random.default_rng(0)
    T = 256
    for rho_bar, c_bar in ((1.0, 1.0), (2.0, 0.5)):
        inputs = [rng.normal(size=T) * 0.5, rng.normal(size=T) * 0.5,
                  rng.normal(size=T), 0.99 * (rng.random(T) > 0.05),
                  rng.normal(size=T), rng.normal(size=())]
        inputs = [np.asarray(x, np.float32) for x in inputs]
        want = jimpala.vtrace(*map(jnp.asarray, inputs), rho_bar=rho_bar,
                              c_bar=c_bar)
        got = rl.vtrace(*map(torch.from_numpy, inputs), rho_bar=rho_bar,
                        c_bar=c_bar)
        for g, w in zip(got, want):
            # atol: ~4 f32 ulps of the O(1) operands, for the few outputs
            # that cancel to near 0 (exp rounds differently in XLA)
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                       atol=1e-6)


def test_vtrace_reduces_to_gae_like_targets_on_policy():
    """With target==behavior (rho==c==1) V-trace vs equals the n-step
    lambda=1 return bootstrapped from the value trail (paper identity)."""
    T = 6
    rng = np.random.default_rng(0)
    rewards = torch.tensor(rng.normal(size=T), dtype=torch.float32)
    values = torch.tensor(rng.normal(size=T), dtype=torch.float32)
    bootstrap = torch.tensor(0.7, dtype=torch.float32)
    discounts = torch.full((T,), 0.9)
    logp = torch.zeros(T)
    vs, pg_adv = rl.vtrace(logp, logp, rewards, discounts, values, bootstrap)
    # manual on-policy recursion
    expect = np.zeros(T, np.float32)
    acc = 0.0
    vals = values.numpy()
    rews = rewards.numpy()
    for t in range(T - 1, -1, -1):
        next_v = 0.7 if t == T - 1 else vals[t + 1]
        delta = rews[t] + 0.9 * next_v - vals[t]
        acc = delta + 0.9 * acc
        expect[t] = acc + vals[t]
    np.testing.assert_allclose(vs.numpy(), expect, rtol=1e-5)
    assert np.all(np.isfinite(pg_adv.numpy()))


@pytest.mark.parametrize("which", ["adam", "rmsprop"])
def test_optimizers_match_optax(which):
    rng = np.random.default_rng(0)
    params = {"w": rng.normal(size=(4, 8)), "b": rng.normal(size=8),
              "s": rng.normal(size=())}
    params = {k: np.asarray(v, np.float32) for k, v in params.items()}
    grads = [{k: np.asarray(rng.normal(size=v.shape) * 10.0 ** rng.integers(
        -4, 2), np.float32) for k, v in params.items()} for _ in range(5)]
    if which == "adam":
        jopt, make = optax.adam(3e-4), lambda ps: adam(ps, 3e-4)
    else:
        jopt = optax.rmsprop(6e-4, decay=0.99, eps=0.1)
        make = lambda ps: RMSprop(ps, 6e-4, decay=0.99, eps=0.1)  # noqa
    jp = jax.tree.map(jnp.asarray, params)
    state = jopt.init(jp)
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    topt = make(list(tp.values()))
    for g in grads:
        updates, state = jopt.update(jax.tree.map(jnp.asarray, g), state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, t in tp.items():
            t.grad = torch.from_numpy(g[k])
        topt.step()
        _assert_trees(tp, jp, rtol=1e-6, atol=0)
    if which == "rmsprop":
        # torch's RMSprop divides by sqrt(nu) + eps: another optimizer
        tq = {k: torch.tensor(v, requires_grad=True)
              for k, v in params.items()}
        other = torch.optim.RMSprop(list(tq.values()), 6e-4, alpha=0.99,
                                    eps=0.1)
        for k, t in tq.items():
            t.grad = torch.from_numpy(grads[0][k])
        other.step()
        first = jax.tree.map(np.asarray, optax.apply_updates(
            jax.tree.map(jnp.asarray, params), jopt.update(
                jax.tree.map(jnp.asarray, grads[0]), jopt.init(params),
                params)[0]))
        assert not np.allclose(tq["w"].detach().numpy(), first["w"],
                               rtol=1e-6, atol=0)


# ---------------------------------------------------------------------------
# the first gradient step of each learner
# ---------------------------------------------------------------------------

def _capture():
    """An optax transformation whose state after ``update`` is the
    gradient it was given (and whose update is zero)."""
    return optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))


def _sgd_grads(jl, *args):
    """(loss, gradient) of an SGD learner's jitted-step body: its update
    ``p - lr * g`` differentiated by ``lr`` is ``-g``, exactly."""
    lr = jl.lr

    def step(x):
        jl.lr = x
        return jl._step_impl(jl.params, *args)

    try:
        out, tangent = jax.jvp(step, (jnp.float32(lr),), (jnp.float32(1),))
    finally:
        jl.lr = lr
    return out[1], jax.tree.map(lambda t: -t, tangent[0])


def _port_grads(tree):
    return rl.convert.tree_map(lambda t: t.grad, tree)


def _step_batch(data):
    rng = np.random.default_rng(4)
    frag = data["fragment"][0]
    return {"obs": frag["obs"][:128],
            "actions": frag["actions"][:128],
            "logp_old": frag["logp"][:128],
            "adv": rng.normal(size=128).astype(np.float32),
            "returns": rng.normal(size=128).astype(np.float32) * 5}


def test_ppo_first_step_matches_jax(data):
    jl, pl = _pair("PPO")
    batch = _step_batch(data)
    jl.optimizer = _capture()
    params = jl.policy.params
    _, grads, metrics = jl._update_impl(
        params, jl.optimizer.init(params), jax.tree.map(jnp.asarray, batch))
    pbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    pbatch["actions"] = pbatch["actions"].long()
    got = pl._update_impl(pbatch)
    _assert_trees(got, metrics, **FIRST_STEP)
    _assert_trees(_port_grads(pl.policy.params), grads, **FIRST_STEP)


@pytest.mark.parametrize("name", ["IMPALA", "APPO"])
def test_impala_first_step_matches_jax(data, name):
    jl, pl = _pair(name)
    frag = data["fragment"][0]
    batch = {"obs": frag["obs"], "next_obs_last": frag["next_obs_last"],
             "actions": frag["actions"], "rewards": frag["rewards"],
             "dones": frag["dones"].astype(np.float32), "logp": frag["logp"]}
    jl.optimizer = _capture()
    params = jl.policy.params
    _, grads, aux = jl._update_impl(params, jl.optimizer.init(params),
                                    jax.tree.map(jnp.asarray, batch))
    pbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    pbatch["actions"] = pbatch["actions"].long()
    pbatch.update(pl._vtrace_targets(pbatch))
    got = pl._update_impl(pbatch)
    _assert_trees(got, aux, **FIRST_STEP)
    _assert_trees(_port_grads(pl.policy.params), grads, **FIRST_STEP)


def test_dqn_first_step_matches_jax(data):
    jl, pl = _pair("DQN")
    jl.buffer.add_rollout(data["fragment"][0])
    batch = jl.buffer.sample(64)
    jl.optimizer = _capture()
    params = jl.policy.params
    _, grads, loss = jl._step_impl(params, jl.target_params,
                                   jl.optimizer.init(params),
                                   jax.tree.map(jnp.asarray, batch))
    got = pl._step(_replay_batch(batch, torch.device("cpu")))
    np.testing.assert_allclose(got.numpy(), np.asarray(loss), **FIRST_STEP)
    _assert_trees(_port_grads(pl.policy.params), grads, **FIRST_STEP)


def test_sac_first_step_matches_jax(data):
    jl, pl = _pair("SAC")
    jl.buffer.add_rollout(data["fragment"][0])
    batch = jl.buffer.sample(128)
    jl.opt = _capture()
    params = {"pi": jl.policy.params["pi"], "q1": jl.q1, "q2": jl.q2,
              "log_alpha": jl.log_alpha}
    jbatch = jax.tree.map(jnp.asarray, batch)
    jbatch["dones"] = jbatch["dones"].astype(jnp.float32)
    _, _, grads, aux = jl._step_impl(
        params, {"q1": jl.q1_target, "q2": jl.q2_target},
        jl.opt.init(params), jbatch)
    got = pl._step(_replay_batch(batch, torch.device("cpu")))
    _assert_trees(got, aux, **FIRST_STEP)
    _assert_trees(_port_grads(pl._params()), grads, **FIRST_STEP)


def test_offline_first_steps_match_jax(data):
    batch = data["batches"][0]
    jl, pl = _pair("BC")
    loss, grads = _sgd_grads(jl, jnp.asarray(batch["obs"]),
                             jnp.asarray(batch["actions"], jnp.int32))
    got = pl.update(batch)
    np.testing.assert_allclose(got["bc_loss"], np.asarray(loss),
                               **FIRST_STEP)
    _assert_trees(_port_grads(pl.params), grads, **FIRST_STEP)

    jl, pl = _pair("OfflineDQN")
    loss, grads = _sgd_grads(
        jl, jl.target, jnp.asarray(batch["obs"]),
        jnp.asarray(batch["actions"], jnp.int32),
        jnp.asarray(batch["rewards"]),
        jnp.asarray(batch["dones"], jnp.float32),
        jnp.asarray(batch["next_obs"]))
    got = pl.update(batch)
    np.testing.assert_allclose(got["loss"], np.asarray(loss), **FIRST_STEP)
    _assert_trees(_port_grads(pl.params), grads, **FIRST_STEP)


# ---------------------------------------------------------------------------
# one update() of each learner at JAX's bars
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(chip_smoke.RL_CASES))
def test_one_update_matches_jax(data, name):
    kw, _, bar = chip_smoke.RL_CASES[name]
    jl, pl = _pair(name, **kw)
    want = chip_smoke.rl_case_update(jl, name, data)
    got = chip_smoke.rl_case_update(pl, name, data)
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, err_msg=k, **bar)
    if name == "PPO":
        assert abs(got["total_loss"] - want["total_loss"]) < 1e-3
    _assert_trees(rl.learner_state(pl), rl.learner_state(jl), **bar)
    # the numpy act weights are copies, refreshed by the update
    policy = getattr(pl, "policy", None)
    if policy is not None and name != "DQN":
        _assert_trees(policy._np_pi, pl.policy.params["pi"], rtol=0, atol=0)
        before = policy._np_pi[0]["w"].copy()
        with torch.no_grad():
            policy.params["pi"][0]["w"].add_(1.0)
        np.testing.assert_array_equal(policy._np_pi[0]["w"], before)


def test_weights_are_copies_and_round_trip():
    def ptrs(tree):
        return {x.data_ptr() for x in param_leaves(tree)}

    for name in ("PPO", "IMPALA", "SAC", "DQN"):
        learner = chip_smoke.make_learner(name, "cpu")
        weights = learner.get_weights()
        if name == "DQN":
            weights = weights[0]
        assert not ptrs(weights) & ptrs(learner.policy.params), name
    impala = chip_smoke.make_learner("IMPALA", "cpu")
    other = chip_smoke.make_learner("IMPALA", "cpu", seed=1)
    impala.set_weights(other.get_weights())
    _assert_trees(impala.policy.params, other.policy.params, rtol=0, atol=0)
    _assert_trees(impala.policy._np_pi, other.policy.params["pi"], rtol=0,
                  atol=0)
    with pytest.raises(KeyError, match="no state"):
        rl.load_learner_state(impala, {"target": []})
    with pytest.raises(ValueError, match="expected"):
        rl.load_learner_state(impala, {"params": {"pi": [], "vf": []}})


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    for name in chip_smoke.RL_CASES:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            chip_smoke.make_learner(name, None)
    for policy in (rl.ActorCriticPolicy, rl.QPolicy, rl.SACPolicy):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            policy(4, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rl.params_from_numpy({"w": np.zeros(2)})


def test_ppo_improves_on_cartpole_in_the_local_loop():
    """tests/test_rl.py:24-43's bar, through the port's ``Algorithm`` on the
    port's runtime, as chip_smoke.py's phase 11 drives it."""
    import ray_tpu_torch
    threads = torch.get_num_threads()
    torch.set_num_threads(1)    # 64-wide products; workers share the cores
    ray_tpu_torch.init(num_nodes=1, resources={"CPU": 8})
    try:
        algo = (rl.AlgorithmConfig(algo="PPO")
                .env_runners(2, rollout_fragment_length=256)
                .training(lr=1e-3, epochs=4, minibatch_size=128,
                          device="cpu").build())
        returns = [algo.train()["episode_return_mean"] for _ in range(12)]
        algo.stop()
    finally:
        ray_tpu_torch.shutdown()
        torch.set_num_threads(threads)
    returns = [r for r in returns if np.isfinite(r)]
    assert returns[-1] > returns[0]     # learning happened
    assert returns[-1] > 40             # clearly better than random (~20)
