"""BASELINE config 1: Fashion-MNIST-style MLP, 2 workers (counterpart of
``examples/train_mnist_mlp.py``).

A ``JaxTrainer`` worker group; the train step is the port's
``make_train_step``; data ingest through ``ray_tpu_torch.data``'s
``streaming_split``. Synthetic data stands in for the dataset download.
With process workers on (the default), the dataset's tasks run in worker
processes; the trainer's ranks stay in the driver, which owns the card.

Run on the card:
  python -m ray_tpu_torch.examples.train_mnist_mlp
On the CPU: add ``--device cpu``.
"""

import argparse
from typing import Optional

import numpy as np
import torch

import ray_tpu_torch
from ray_tpu_torch import data as rdata, train
from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.models import MLPConfig, MLPModel
from ray_tpu_torch.train import JaxTrainer, RunConfig, ScalingConfig
from ray_tpu_torch.train.spmd import make_train_step


def make_dataset(n=2048, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 784)).astype(np.float32)
    w = rng.normal(size=(784, 10)).astype(np.float32)
    y = (x @ w).argmax(1).astype(np.int32)       # learnable labels
    return rdata.from_numpy(x, "x").zip(rdata.from_numpy(y, "y")) \
        .repartition(8)


def train_fn(config):
    ctx = train.get_context()
    model = MLPModel(MLPConfig(), device=config["device"])
    ts = make_train_step(model, optimizer=lambda ps: torch.optim.Adam(
        ps, lr=config["lr"]))
    params, opt = ts.init_fn(0)
    shard = train.get_dataset_shard("train")
    for epoch in range(config["epochs"]):
        last = None
        for batch in shard.iter_batches(batch_size=config["batch_size"]):
            # batches are read-only: copy them into tensors
            xb = torch.tensor(batch["x"])
            yb = torch.tensor(batch["y"]).long()
            params, opt, m = ts.step_fn(params, opt, (xb, yb))
            last = m
        train.report({"epoch": epoch, "loss": float(last["loss"]),
                      "rank": ctx.get_world_rank()})


def main(device: Optional[str] = None):
    """``device=None`` is the card (raises without one)."""
    device = str(resolve_device(device))
    ray_tpu_torch.init(num_nodes=2, resources={"CPU": 4},
                       ignore_reinit_error=True)
    result = JaxTrainer(
        train_fn,
        train_loop_config={"lr": 1e-3, "epochs": 2, "batch_size": 128,
                           "device": device},
        scaling_config=ScalingConfig(num_workers=2),
        run_config=RunConfig(name="mnist_mlp"),
        datasets={"train": make_dataset()},
    ).fit()
    print("final:", result.metrics)
    assert result.error is None
    return result


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--device", default=None,
                   help="the card by default; 'cpu' off it")
    main(p.parse_args().device)
