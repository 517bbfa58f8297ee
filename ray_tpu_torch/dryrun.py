"""One sharded train step on every parallel layout, on CPU ranks: the port's
counterpart of ``dryrun_multichip`` in the repo's ``__graft_entry__.py``.

    python -m ray_tpu_torch.dryrun [n_ranks]      # default 8

``dryrun_mesh(n)`` starts ``n`` gloo ranks on the CPU (``spawn_ranks``) and
takes one default-AdamW step of each layout JAX's dryrun takes, at its
meshes and widths (vocab 512, dim 64, 2 layers, 4/2 heads, ffn 128, seq
128; f32 here, so the sharded loss can be held to the one-device one):

- dense Llama on ``MeshSpec.auto(n, tp=2, sp=2, fsdp=2)`` (ring attention);
- the same with Ulysses attention;
- ``PipelinedLlama`` on ``MeshSpec.auto(n, pp=2, tp=2)``, 2 microbatches;
- the MoE (4 experts) on ``MeshSpec.auto(n, ep=2, tp=2)``, einsum and
  all-to-all dispatch;

each where ``n`` allows it, as in JAX (smaller ``n`` drops the sp, pp and
ep layouts). It prints one line per layout as JAX's does, its loss beside
the port's one-device loss of the same params and batch, and raises unless
every loss is finite and within rtol 1e-4 of its one-device loss. The
all-to-all scheme routes each rank's tokens with a capacity of its own, so
its one-device loss routes the same groups of tokens (``_moe_groups``).
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Dict, List

import numpy as np
import torch
import torch.distributed as dist

from ray_tpu_torch.models import (LlamaConfig, LlamaModel, MoEConfig,
                                  MoEModel, PipelinedLlama)
from ray_tpu_torch.models.llama_pp import unstack_stages
from ray_tpu_torch.parallel import MeshSpec, build_mesh, spawn_ranks
from ray_tpu_torch.train import make_train_step, shard_batch

RTOL = 1e-4


def _config(cls=LlamaConfig, **kw):
    return cls(vocab_size=512, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
               ffn_dim=128, max_seq_len=128, remat=False,
               dtype=torch.float32, **kw)


def _whole(params):
    return {k: _whole(v) if isinstance(v, dict)
            else (v.full_tensor() if hasattr(v, "full_tensor") else v)
            .detach().clone() for k, v in params.items()}


def _step(name: str, model, mesh, seed: int, tokens, one_device) -> Dict:
    """One train step of ``model`` on ``mesh`` from ``seed``; the loss of
    ``one_device(params)`` on the same params (whole) beside it."""
    ts = make_train_step(model, mesh=mesh)
    params, opt = ts.init_fn(seed)
    start = _whole(params)
    batch = (tokens, np.roll(tokens, -1, axis=1))
    _, _, metrics = ts.step_fn(params, opt, shard_batch(batch, ts))
    with torch.no_grad():
        plain = float(one_device(start, *(torch.from_numpy(b)
                                          for b in batch)))
    sizes = {n: mesh.size(i) for i, n in enumerate(mesh.mesh_dim_names)}
    return {"name": name, "mesh": sizes, "loss": float(metrics["loss"]),
            "one_device": plain}


def _moe_groups(cfg: MoEConfig, rows: int, chunks: int):
    """The one-device loss of the all-to-all scheme: the einsum scheme's
    FFN applied to each group of tokens a rank routes (``rows`` blocks of
    batch rows times ``chunks`` of the sequence) with that group's
    capacity, and the aux terms averaged over the groups, as
    ``expert_alltoall_ffn`` does."""
    plain = MoEModel(dataclasses.replace(cfg, moe_dispatch="einsum"),
                     device="cpu")
    einsum_ffn = plain._moe_ffn

    def grouped_ffn(h, layer):
        outs, auxes = [], []
        for hb in h.chunk(rows, dim=0):
            row_out = []
            for hs in hb.chunk(chunks, dim=1):
                out, aux = einsum_ffn(hs, layer)
                row_out.append(out)
                auxes.append(aux)
            outs.append(torch.cat(row_out, dim=1))
        return torch.cat(outs, dim=0), torch.stack(auxes).mean()

    plain._moe_ffn = grouped_ffn
    return plain.loss


def _rank(n: int) -> List[Dict]:
    """Every layout's step on this rank; rank 0's results are returned."""
    out = []
    if n % 8 == 0:
        spec = MeshSpec.auto(n, tp=2, sp=2, fsdp=2)
    elif n % 4 == 0:
        spec = MeshSpec.auto(n, tp=2, sp=2)
    elif n % 2 == 0:
        spec = MeshSpec.auto(n, tp=2)
    else:
        spec = MeshSpec.auto(n)
    mesh = build_mesh(spec, device="cpu")
    cfg = _config()
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab_size,
                          (max(2, spec.dp * spec.fsdp), 128))
    plain = LlamaModel(cfg, device="cpu")
    out.append(_step("dense", LlamaModel(cfg, mesh=mesh), mesh, 0, tokens,
                     plain.loss))
    if n % 4 == 0:
        ucfg = dataclasses.replace(cfg, attention_impl="ulysses")
        out.append(_step("ulysses", LlamaModel(ucfg, mesh=mesh), mesh, 2,
                         tokens, plain.loss))
    if n % 8 == 0:
        pspec = MeshSpec.auto(n, pp=2, tp=2)
        pmesh = build_mesh(pspec, device="cpu")
        ptokens = rng.integers(0, cfg.vocab_size,
                               (2 * pspec.dp * pspec.fsdp, 128))
        out.append(_step(
            "pipeline", PipelinedLlama(cfg, pmesh, num_microbatches=2),
            pmesh, 3, ptokens,
            lambda p, *b: plain.loss(unstack_stages(p), *b)))
    if n % 4 == 0:
        espec = MeshSpec.auto(n, ep=2, tp=2)
        emesh = build_mesh(espec, device="cpu")
        for dispatch in ("einsum", "alltoall"):
            ecfg = _config(MoEConfig, num_experts=4, moe_dispatch=dispatch)
            model = MoEModel(ecfg, mesh=emesh)
            one = (MoEModel(ecfg, device="cpu").loss if dispatch == "einsum"
                   else _moe_groups(ecfg, espec.dp * espec.fsdp,
                                    espec.sp * espec.ep))
            out.append(_step(f"moe[{dispatch}]", model, emesh, 1, tokens,
                             one))
    return out if dist.get_rank() == 0 else []


def dryrun_mesh(n_ranks: int = 8) -> List[Dict]:
    """One train step of each layout on ``n_ranks`` gloo CPU ranks; prints
    a line each and returns their results (loss, one-device loss, mesh).
    Raises unless every loss is finite and matches its one-device loss."""
    results = spawn_ranks(n_ranks, _rank, n_ranks, timeout=900)[0]
    for r in results:
        print(f"dryrun_mesh({n_ranks}): {r['name']} mesh={r['mesh']} "
              f"loss={r['loss']:.4f} (one device {r['one_device']:.4f})",
              flush=True)
    for r in results:
        if not np.isfinite(r["loss"]) or not np.isclose(
                r["loss"], r["one_device"], rtol=RTOL, atol=0):
            raise RuntimeError(f"dryrun_mesh: {r['name']} loss {r['loss']} "
                               f"against one device {r['one_device']}")
    return results


if __name__ == "__main__":
    dryrun_mesh(int(sys.argv[1]) if len(sys.argv) > 1 else 8)
