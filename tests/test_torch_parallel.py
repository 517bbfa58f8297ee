"""The parallel layer of the PyTorch port held against the JAX package: the
mesh and its logical-axis rules, each rank's local shards against JAX's
shards, the sharded matmul, the vocab-parallel embedding, the gloo launcher,
the process-group bring-up and the sharded checkpoints.

The JAX side runs in this process on the 8 virtual CPU devices of
tests/conftest.py; the port's ranks are CPU processes joined by gloo
(``spawn_ranks``) running the bodies of tests/torch_rank_bodies.py, which
import no JAX. Debug widths. Bars: layouts, the sharded init and the
checkpoints bit for bit; the matmul and the embedding at f32 rounding
(rtol 1e-6).
"""

import multiprocessing as mp
import os
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding

import torch_rank_bodies as bodies
from ray_tpu.models import GPT2Config as JGPT2Config
from ray_tpu.models import GPT2Model as JGPT2Model
from ray_tpu.models import LlamaConfig as JLlamaConfig
from ray_tpu.models import LlamaModel as JLlamaModel
from ray_tpu.models import MoEConfig as JMoEConfig
from ray_tpu.models import MoEModel as JMoEModel
from ray_tpu.models.gpt2 import param_logical_axes as j_gpt2_axes
from ray_tpu.models.llama import param_logical_axes as j_llama_axes
from ray_tpu.models.moe import moe_param_logical_axes as j_moe_axes
from ray_tpu.parallel import mesh as jmesh
from ray_tpu_torch.examples import train_llama_fsdp
from ray_tpu_torch.models import GPT2Config, LlamaConfig, MoEConfig
from ray_tpu_torch.models.gpt2 import param_logical_axes as gpt2_axes
from ray_tpu_torch.models.llama import param_logical_axes as llama_axes
from ray_tpu_torch.models.moe import moe_param_logical_axes as moe_axes
from ray_tpu_torch.parallel import (DEFAULT_AXIS_ORDER, DEFAULT_RULES,
                                    MeshSpec, logical_to_spec, multihost,
                                    spawn_ranks)
from ray_tpu_torch.train.checkpoint import (AsyncCheckpointer, Checkpoint,
                                            CheckpointManager)

JAX = {"llama": (JLlamaConfig.debug, JLlamaModel),
       "gpt2": (JGPT2Config.debug, JGPT2Model),
       "moe": (JMoEConfig.debug_moe, JMoEModel)}
MESHES = (dict(dp=2, tp=2), dict(fsdp=2, tp=2), dict(dp=2, fsdp=2, tp=2))


def _jax_mesh(spec):
    s = jmesh.MeshSpec(**spec)
    return jmesh.build_mesh(s, jax.devices()[:s.num_devices])


def _named(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _named(v, prefix + k + "/")
        else:
            yield prefix + k, v


@pytest.fixture(scope="module")
def jax_trees():
    return {f: jax.tree.map(np.asarray, cls(make()).init(jax.random.key(0)))
            for f, (make, cls) in JAX.items()}


# ---------------------------------------------------------------------------
# mesh and rules (tests/test_parallel.py:19-43)
# ---------------------------------------------------------------------------

def test_mesh_spec_auto():
    spec = MeshSpec.auto(8, tp=2, sp=2)
    assert spec.dp == 2 and spec.num_devices == 8
    assert spec.sizes() == jmesh.MeshSpec.auto(8, tp=2, sp=2).sizes()
    with pytest.raises(ValueError):
        MeshSpec.auto(8, tp=3)


def test_rules_and_axis_order_are_jaxs():
    assert DEFAULT_AXIS_ORDER == jmesh.DEFAULT_AXIS_ORDER
    assert DEFAULT_RULES == jmesh.DEFAULT_RULES


@pytest.mark.parametrize("name", sorted(jmesh.DEFAULT_RULES) + [None])
def test_logical_to_spec_matches_jax_for_every_rule(name):
    names = ("batch", name, "embed")
    assert logical_to_spec(names) == tuple(jmesh.logical_to_spec(names))
    override = {"embed": "tp", "batch": "dp"}
    assert logical_to_spec(names, override) == tuple(
        jmesh.logical_to_spec(names, override))
    with pytest.raises(KeyError):
        logical_to_spec(("nonexistent_axis",))


@pytest.mark.parametrize("family,ours,theirs", [
    ("llama", llama_axes, j_llama_axes), ("gpt2", gpt2_axes, j_gpt2_axes),
    ("moe", moe_axes, j_moe_axes)])
def test_param_logical_axes_are_jaxs(family, ours, theirs):
    port_cfg = {"llama": LlamaConfig, "gpt2": GPT2Config,
                "moe": MoEConfig}[family]
    cfg = (port_cfg.debug_moe() if family == "moe" else port_cfg.debug())
    jcfg = (JAX[family][0]())
    assert dict(_named(ours(cfg))) == dict(_named(theirs(jcfg)))


VOCAB, DIM = 256, 64


@pytest.fixture(scope="module")
def eight(jax_trees):
    return spawn_ranks(8, bodies.eight_ranks, jax_trees)


@pytest.fixture(scope="module")
def four(jax_trees, tmp_path_factory):
    """Every 4-rank check in one spawn (tests/torch_rank_bodies.py
    ``four_ranks``)."""
    rng = np.random.default_rng(0)
    table = rng.normal(size=(VOCAB, DIM)).astype(np.float32)
    tokens = rng.integers(0, VOCAB, (4, 8))
    tokens[0, :4] = [-1, VOCAB, VOCAB + 7, -VOCAB - 3]   # out of range
    path = str(tmp_path_factory.mktemp("ck") / "sharded")
    train_tokens = np.random.default_rng(1).integers(0, 256, (4, 32))
    ranks = spawn_ranks(4, bodies.four_ranks, table, tokens, jax_trees,
                        path, train_tokens)
    return table, tokens, ranks, path


def test_build_mesh_axes(eight):
    r = eight[3]["axes"]
    assert r["names"] == DEFAULT_AXIS_ORDER
    jm = jmesh.build_mesh(jmesh.MeshSpec.auto(8, tp=2))
    assert r["shape"] == tuple(jm.devices.shape)      # size-1 axes kept
    assert r["ranks"] == list(range(8))               # row-major, as JAX
    assert r["active"] == ("dp", "tp")                # where DTensors live
    assert r["devices"] == list(range(8)) and r["world"] == 8
    assert eight[0]["axes"]["sp"] == 2                # mesh_from_string


# ---------------------------------------------------------------------------
# layouts: each rank's shard is JAX's shard on the same device
# ---------------------------------------------------------------------------

@pytest.fixture(params=MESHES, ids=str)
def layout_run(request, eight, four):
    spec = request.param
    if len(spec) == 3:
        return spec, [r["layouts"] for r in eight]
    return spec, [r["layouts"][str(spec)] for r in four[2]]


@pytest.mark.parametrize("family", sorted(JAX))
def test_local_shards_are_jaxs_shards(layout_run, jax_trees, family):
    spec, ranks = layout_run
    mesh = _jax_mesh(spec)
    make, cls = JAX[family]
    shardings = dict(_named(cls(make(), mesh=mesh).param_shardings()))
    for name, arr in _named(jax_trees[family]):
        placed = jax.device_put(jnp.asarray(arr), shardings[name])
        by_device = {s.device: np.asarray(s.data)
                     for s in placed.addressable_shards}
        for r, out in enumerate(ranks):
            want = by_device[mesh.devices.flat[r]]
            got = out[family][name]
            assert got.shape == want.shape, (name, r, spec)
            np.testing.assert_array_equal(got, want, err_msg=f"{name} "
                                          f"rank {r} {spec}")


def test_sharded_init_draws_the_unsharded_numbers(layout_run):
    for out in layout_run[1]:
        assert out["init_dtensor"] and out["init_equal"]


# ---------------------------------------------------------------------------
# matmul, embedding, placement errors, attention guard (4 ranks)
# ---------------------------------------------------------------------------

def test_sharded_matmul_matches_unsharded(four):
    got, want = four[2][1]["matmul"]
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("spec", [dict(dp=2, tp=2), dict(fsdp=2, tp=2)],
                         ids=str)
def test_vocab_parallel_embedding_matches_jax(four, spec):
    """Against JAX's shard_map lookup on the same mesh, out-of-range ids
    included (they read zeros with tp > 1); the lookup itself moves
    nothing between ranks (no all-gather of the table, no collective at
    all: the sum over tp is left to the next constraint)."""
    table, tokens, ranks, _ = four
    mesh = _jax_mesh(spec)
    jm = JLlamaModel(JLlamaConfig(vocab_size=VOCAB, dim=DIM, n_heads=4,
                                  n_kv_heads=2, n_layers=1, ffn_dim=64,
                                  dtype=jnp.float32, remat=False), mesh=mesh)
    jtable = jax.device_put(jnp.asarray(table), NamedSharding(
        mesh, jmesh.logical_to_spec(("vocab", "embed_in"))))
    want = np.asarray(jm._embed_lookup(jtable, jnp.asarray(tokens,
                                                           jnp.int32)))
    assert not want[0, :4].any()
    for out in ranks:
        got, counts, placed = out[str(spec)]
        np.testing.assert_allclose(got, want, rtol=1e-6)
        assert counts == {}, counts
        assert "Partial" in placed


def test_placements_refuse_what_jax_refuses(four):
    err = four[2][0]["errors"]
    assert err["twice"].startswith("ValueError") and "twice" in err["twice"]
    assert err["unknown"].startswith("ValueError")
    assert err["order"].startswith("ValueError")
    assert err["divide"].startswith("ValueError") and "divisible" in \
        err["divide"]
    # dp has size 1 here: batch shards over fsdp only
    assert err["ok"] == ["Shard(dim=0)", "Shard(dim=2)"]


def test_masked_loss_on_a_mesh_matches_one_device(four):
    sharded, plain = four[2][0]["masked_loss"]
    np.testing.assert_allclose(sharded, plain, rtol=1e-6)


def test_attention_on_a_mesh_refuses_kv_heads_tp_does_not_divide(four):
    out = four[2][0]
    assert out["gqa"].startswith("ValueError") and "kv heads" in out["gqa"]
    assert out["gqa_model"].startswith("ValueError")


def test_vit_mlp_one_device_and_a7b_refusals(four):
    """ViT/MLP take the one-device path on a mesh; an sp>1 mesh refuses the
    single-device kernel (JAX's ValueError), runs "blockwise" as ring
    attention (JAX's rule) and the expert all-to-all runs on a mesh."""
    out = four[2][0]["refusals"]
    for name in ("vit", "mlp"):
        mesh, p_sh, b_sh, any_dtensor, device = out[name]
        assert (mesh, p_sh, b_sh, any_dtensor, device) == (
            None, None, None, False, "cpu")
    assert out["sp-kernel"].startswith("ValueError") and "sp>1" in \
        out["sp-kernel"]
    np.testing.assert_allclose(out["sp-blockwise"], out["sp-ring"],
                               rtol=1e-6)
    np.testing.assert_allclose(out["sp-blockwise"], out["sp-one-device"],
                               rtol=1e-4)
    # with capacity for every token the schemes route alike; the aux terms
    # are per rank (tests/test_ops.py:245-266's bar)
    alltoall, einsum = out["alltoall"]
    assert np.isfinite(alltoall)
    np.testing.assert_allclose(alltoall, einsum, rtol=5e-3)


# ---------------------------------------------------------------------------
# the launcher and the process-group bring-up
# ---------------------------------------------------------------------------

def test_spawn_ranks_raises_a_ranks_error():
    with pytest.raises(ValueError, match="spec") as info:
        spawn_ranks(2, bodies.raise_on_rank_one)
    assert any("rank 1 of 2" in n for n in info.value.__notes__)


def test_multihost_env_parsing(monkeypatch):
    """torchrun's contract resolves (coordinator, world, rank)."""
    monkeypatch.setenv("MASTER_ADDR", "host-a")
    monkeypatch.setenv("MASTER_PORT", "29511")
    monkeypatch.setenv("WORLD_SIZE", "3")
    monkeypatch.setenv("RANK", "1")
    assert multihost.pod_topology_from_env() == ("host-a:29511", 3, 1)
    monkeypatch.delenv("RANK")
    assert multihost.pod_topology_from_env() is None


def test_multihost_single_process_noop(monkeypatch):
    for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    assert multihost.initialize_multihost() is False
    assert not torch.distributed.is_initialized()
    assert multihost.process_shard(8) == (0, 8)
    with pytest.raises(ValueError):
        multihost.initialize_multihost("localhost:1")


def test_initialize_multihost_explicit_address(tmp_path):
    """Two processes joined through an explicit coordinator (a TCP store
    on a port the kernel picked)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=bodies.multihost_explicit,
                         args=(f"127.0.0.1:{port}", 2, r, str(tmp_path)))
             for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=120)
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    got = [(tmp_path / f"rank{r}").read_text().split() for r in range(2)]
    assert got == [["True", "True", "3.0", "0", "4"],
                   ["True", "True", "3.0", "4", "8"]]


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def test_checkpoint_roundtrip(tmp_path):
    tree = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "h": torch.arange(4, dtype=torch.float32).to(torch.bfloat16),
            "meta": {"step": 7, "lr": 0.1, 3: (1, None, "x")},
            "layers": [torch.ones(2, dtype=torch.int64)]}
    back = Checkpoint.from_pytree(tree, str(tmp_path / "ck")).to_pytree()
    np.testing.assert_array_equal(back["w"], np.arange(6).reshape(2, 3))
    assert back["h"].dtype == torch.bfloat16
    assert torch.equal(back["h"], tree["h"])
    assert back["meta"] == {"step": 7, "lr": 0.1, 3: (1, None, "x")}
    assert back["layers"][0].dtype == torch.int64


def test_checkpoint_manager_topk(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "run"), num_to_keep=2,
                            score_attribute="acc")
    for i, acc in enumerate([0.1, 0.9, 0.5]):
        ck = Checkpoint.from_pytree({"i": torch.tensor(i)},
                                    str(tmp_path / f"src{i}"))
        mgr.register(ck, {"acc": acc})
    kept = sorted(d for d in os.listdir(tmp_path / "run")
                  if d.startswith("checkpoint_"))
    assert len(kept) == 2
    assert int(mgr.best_checkpoint().to_pytree()["i"]) == 1  # acc=0.9
    assert CheckpointManager.find_latest(str(tmp_path / "run")).path \
        .endswith("checkpoint_000003")


def test_async_checkpointer(tmp_path):
    saver = AsyncCheckpointer()
    try:
        w = torch.arange(5, dtype=torch.float32)
        ck = saver.save({"w": w}, str(tmp_path / "a"))
        w.add_(1)              # the gather already happened
        saver.wait_until_finished(timeout=60)
        assert torch.equal(ck.result().to_pytree()["w"],
                           torch.arange(5, dtype=torch.float32))
    finally:
        saver.close()


def _assert_same(a, b, where=""):
    if isinstance(a, dict):
        assert list(a) == list(b), where
        for k in a:
            _assert_same(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, tuple) and len(a) == 2 and isinstance(a[1],
                                                             np.ndarray):
        assert a[0] == b[0], where                       # dtype
        np.testing.assert_array_equal(a[1], b[1], err_msg=where)
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{where}/{i}")
    else:
        assert a == b, where


def test_sharded_checkpoint_restores_onto_another_mesh(four):
    """Params, AdamW state and bf16 leaves saved from fsdp 2 x tp 2 come
    back on dp 2 x tp 2 bit for bit, placed there, and train on."""
    saved = four[2][0]["saved"]
    for r in four[2]:
        whole, kinds, loss = r["restored"]
        _assert_same(saved, whole)
        assert kinds["wq"] == ["Replicate()", "Shard(dim=2)"]
        assert kinds["exp_avg"] == kinds["wq"]
        assert kinds["bf16"] == "torch.bfloat16"
        assert np.isfinite(loss)


def test_sharded_checkpoint_restores_with_no_mesh(four):
    saved, path = four[2][0]["saved"], four[3]
    back = bodies._whole(Checkpoint(path).to_pytree())
    _assert_same(saved, back)
    assert back["meta"] == {"step": 1, "mesh": "fsdp=2,tp=2"}


def test_llama_fsdp_example_trains_on_four_ranks():
    """On four ranks the mesh is all dp (its fsdp 2 x tp 2 x sp 2 mesh on
    eight ranks is tests/test_torch_context.py's ring case)."""
    runs = spawn_ranks(4, train_llama_fsdp._rank, True, 2)
    assert runs[0][-1] < runs[0][0]
    assert all(r == runs[0] for r in runs)
