"""BASELINE config 4: ImageNet-style streaming into ViT training with a
device prefetch (counterpart of ``examples/data_vit_streaming.py``).

``Dataset.streaming_split`` iterators feed ``to_jax``'s prefetcher (pinned
staging, copies on a side stream) into the port's ViT train step. Synthetic
images stand in for ImageNet; a ``map_batches`` normalises them. With
process workers on (the default), the dataset's tasks, the normalisation
among them, run in worker processes; the trainer's ranks stay in the
driver, which owns the card.

Run on the card:
  python -m ray_tpu_torch.examples.data_vit_streaming
On the CPU: add ``--device cpu``.
"""

import argparse
from typing import Optional

import numpy as np
import torch

import ray_tpu_torch
from ray_tpu_torch import data as rdata, train
from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.models import ViTConfig, ViTModel
from ray_tpu_torch.train import JaxTrainer, RunConfig, ScalingConfig
from ray_tpu_torch.train.spmd import make_train_step


def normalize(batch):
    """Per-image standardisation (a data task, run in a worker process)."""
    x = batch["image"]
    mean = x.mean(axis=(1, 2, 3), keepdims=True)
    std = x.std(axis=(1, 2, 3), keepdims=True) + 1e-6
    return {"image": ((x - mean) / std).astype(np.float32),
            "label": batch["label"]}


def make_dataset(n=256, img=32, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, img, img, 3)).astype(np.float32)
    y = rng.integers(0, 10, (n,)).astype(np.int32)
    return rdata.from_numpy(x, "image").zip(
        rdata.from_numpy(y, "label")).repartition(8).map_batches(normalize)


def train_fn(config):
    model = ViTModel(ViTConfig.debug(), device=config["device"])
    ts = make_train_step(model, optimizer=lambda ps: torch.optim.Adam(
        ps, lr=1e-3))
    params, opt = ts.init_fn(0)
    shard = train.get_dataset_shard("train")
    # device double-buffering: batch N+1 copies while N computes
    last = None
    for batch in shard.to_jax(batch_size=config["batch_size"],
                              prefetch=2, drop_last=True,
                              device=config["device"]):
        params, opt, last = ts.step_fn(
            params, opt, (batch["image"], batch["label"].long()))
    train.report({"loss": float(last["loss"])})


def main(device: Optional[str] = None):
    """``device=None`` is the card (raises without one)."""
    device = str(resolve_device(device))
    ray_tpu_torch.init(num_nodes=2, resources={"CPU": 4},
                       ignore_reinit_error=True)
    result = JaxTrainer(
        train_fn, train_loop_config={"batch_size": 16, "device": device},
        scaling_config=ScalingConfig(num_workers=2),
        run_config=RunConfig(name="vit_streaming"),
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
