"""The port's data-parallel ``LearnerGroup`` (``ray_tpu_torch.rl``) held
against the JAX package's single-device learner on dp 2 and dp 4.

The port's ranks are CPU processes joined by gloo (``spawn_ranks``) running
``tests/torch_rank_bodies.py:rl_group``, which imports no JAX: each rank
builds the same learner, seeds it with the JAX learner's state
(``load_learner_state``), wraps it in a ``LearnerGroup`` over every rank
and takes one ``update`` of the same rollouts. JAX's learner takes the same
update on one device in this process. Bars, JAX's own
(tests/test_rl.py:236-316): PPO (256 rows, 1 epoch, minibatch 128) rtol
2e-4, atol 2e-5; IMPALA on a 256-step fragment and on a 250-step one
(split 125 + 125 at dp 2; ragged at dp 4, so run whole on every rank) rtol
5e-4, atol 5e-5; the loss within 1e-3.
PPO with ``ragged="truncate"`` on 250 rows (minibatches of 128 and 122):
at dp 2 it drops nothing and is held to the single-device learner; at dp 4
it cuts the second minibatch to 120 rows, as JAX's group does at dp 8, and
is held to that group. Every rank ends with the same params. The group's
refusals raise as JAX's do.
"""

import chip_smoke
import jax
import numpy as np
import pytest
from jax.sharding import Mesh

import torch_rank_bodies as bodies
from ray_tpu.parallel.mesh import MeshSpec as JMeshSpec
from ray_tpu.parallel.mesh import build_mesh as j_build_mesh
from ray_tpu.rl import impala as jimpala
from ray_tpu.rl import ppo as jppo
from ray_tpu.rl.learner_group import LearnerGroup as JLearnerGroup
from ray_tpu_torch import rl
from ray_tpu_torch.parallel import spawn_ranks

PPO_KW = dict(epochs=1, minibatch_size=128)
JAX = {"PPO": jppo.PPOLearner, "IMPALA": jimpala.ImpalaLearner}
# case -> (learner, keywords, fragment length, ragged, bar)
CASES = {
    "ppo": ("PPO", PPO_KW, 256, "replicate", dict(rtol=2e-4, atol=2e-5)),
    "impala": ("IMPALA", {}, 256, "replicate", dict(rtol=5e-4, atol=5e-5)),
    "impala-ragged": ("IMPALA", {}, 250, "replicate",
                      dict(rtol=5e-4, atol=5e-5)),
    "ppo-truncate": ("PPO", PPO_KW, 250, "truncate",
                     dict(rtol=2e-4, atol=2e-5)),
}


def _rollouts(length):
    runner = rl.EnvRunner(rl.CartPoleEnv, lambda: rl.ActorCriticPolicy(
        4, 2, seed=0, device="cpu"), seed=0)
    return [runner.sample(length)]


@pytest.fixture(scope="module")
def runs():
    """JAX's update of each case (its single-device learner; its dp-8 group
    for the truncating case), and the port's on 2 and 4 ranks."""
    inputs, want = {}, {}
    for key, (name, kw, length, ragged, _) in CASES.items():
        rollouts = _rollouts(length)
        learner = JAX[name](4, 2, seed=0, **kw)
        inputs[key] = (name, kw, rl.learner_state(learner), rollouts,
                       ragged)
        if ragged == "truncate":
            grouped = JAX[name](4, 2, seed=0, **kw)
            JLearnerGroup(grouped, num_learners=8, ragged=ragged)
            want[key + "@dp8"] = (grouped.update(rollouts),
                                  rl.learner_state(grouped))
        want[key] = (learner.update(rollouts), rl.learner_state(learner))
    got = {n: spawn_ranks(n, bodies.rl_group, inputs) for n in (2, 4)}
    return want, got


@pytest.mark.parametrize("ranks", [2, 4])
@pytest.mark.parametrize("key", list(CASES))
def test_learner_group_matches_jax(runs, key, ranks):
    want, got = runs
    bar = CASES[key][4]
    truncated = CASES[key][3] == "truncate" and ranks == 4
    jmetrics, jstate = want[key + "@dp8" if truncated else key]
    loss = "total_loss" if CASES[key][0] == "PPO" else "loss"
    per_rank = [r[key] for r in got[ranks]]
    for dp, metrics, state in per_rank:
        assert dp == ranks
        assert np.isfinite(metrics[loss])
        assert abs(metrics[loss] - jmetrics[loss]) < 1e-3
        for name, value in jmetrics.items():
            np.testing.assert_allclose(metrics[name], value, err_msg=name,
                                       **bar)
        flat, jflat = (chip_smoke.flat_tree(s) for s in (state, jstate))
        for path in jflat:
            np.testing.assert_allclose(flat[path], jflat[path],
                                       err_msg=path, **bar)
    # replicated: every rank holds the same params
    first = chip_smoke.flat_tree(per_rank[0][2])
    for _, _, state in per_rank[1:]:
        for path, value in chip_smoke.flat_tree(state).items():
            np.testing.assert_array_equal(value, first[path], err_msg=path)


@pytest.mark.parametrize("ranks", [2, 4])
def test_learner_group_refusals_match_jaxs(runs, ranks):
    refusals = runs[1][ranks][0]["refusals"]
    assert refusals["more"] == (f"ValueError: num_learners={ranks + 1} but "
                                f"only {ranks} devices")
    assert refusals["no-dp"].startswith(
        "ValueError: LearnerGroup needs a 'dp' mesh axis; mesh has ('tp',)")
    assert refusals["conflict"] == (
        f"ValueError: num_learners={2 * ranks} conflicts with the mesh's "
        f"dp={ranks}")
    # JAX's, on its 8 CPU devices
    learner = jppo.PPOLearner(4, 2, seed=0)
    with pytest.raises(ValueError, match="num_learners=9 but only 8 devices"):
        JLearnerGroup(learner, num_learners=9)
    with pytest.raises(ValueError, match="needs a 'dp' mesh axis"):
        JLearnerGroup(learner, mesh=Mesh(np.array(jax.devices()[:2]),
                                         ("tp",)))
    with pytest.raises(ValueError, match=f"num_learners={2 * ranks} "
                       f"conflicts with the mesh's dp={ranks}"):
        JLearnerGroup(learner, num_learners=2 * ranks, mesh=j_build_mesh(
            JMeshSpec(dp=ranks), jax.devices()[:ranks]))


def test_learner_group_refuses_in_one_process():
    learner = chip_smoke.make_learner("PPO", "cpu")
    with pytest.raises(ValueError, match="ragged must be 'replicate' or "
                       "'truncate', got 'drop'"):
        rl.LearnerGroup(learner, ragged="drop")
    with pytest.raises(ValueError, match="num_learners=2 but only 1 "
                       "devices"):
        rl.LearnerGroup(learner, num_learners=2)
