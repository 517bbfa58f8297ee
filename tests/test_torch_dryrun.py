"""``ray_tpu_torch.dryrun.dryrun_mesh``, the port's counterpart of the
repo's ``dryrun_multichip``: one train step of each parallel layout on 8 gloo
CPU ranks (dense Llama with ring attention and with Ulysses on
fsdp 2 x sp 2 x tp 2, ``PipelinedLlama`` on pp 2 x dp 2 x tp 2, the MoE's
einsum and all-to-all schemes on dp 2 x tp 2 x ep 2), each loss finite and
equal to the port's one-device loss of the same params and batch (f32,
rtol 1e-4)."""

import numpy as np

from ray_tpu_torch.dryrun import dryrun_mesh


def test_dryrun_mesh_eight_ranks(capsys):
    results = dryrun_mesh(8)
    assert [r["name"] for r in results] == [
        "dense", "ulysses", "pipeline", "moe[einsum]", "moe[alltoall]"]
    meshes = {r["name"]: r["mesh"] for r in results}
    assert meshes["dense"] == {"pp": 1, "dp": 1, "fsdp": 2, "sp": 2,
                               "tp": 2, "ep": 1}
    assert meshes["pipeline"]["pp"] == 2 and meshes["moe[alltoall]"]["ep"] \
        == 2
    for r in results:
        assert np.isfinite(r["loss"])
        np.testing.assert_allclose(r["loss"], r["one_device"], rtol=1e-4)
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 5 and all(line.startswith("dryrun_mesh(8): ")
                                   for line in lines)
