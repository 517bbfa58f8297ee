"""End-to-end: Data -> Train -> Tune -> Serve on one runtime (counterpart of
``examples/full_stack_pipeline.py``).

 1. ``ray_tpu_torch.data`` builds a streaming dataset of (x, noisy 3x+1)
    pairs.
 2. ``JaxTrainer`` fits a linear model with a torch train step, ingesting
    through ``iter_batches``.
 3. ``Tuner`` sweeps the learning rate with the native TPE searcher.
 4. The best weights deploy as a Serve application; predictions flow
    through the HTTP ingress.

With process workers on (the default), the Tune trials and the dataset's
tasks run in worker processes, and ``train_loop`` (a closure of ``main``)
reaches them by value; the trainer's ranks and serve's replicas are
``_in_process`` actors in the driver, as in JAX's package.

Run on the card:
  python -m ray_tpu_torch.examples.full_stack_pipeline
On the CPU: add ``--device cpu``.
"""

from __future__ import annotations

import argparse
from typing import Optional


def main(samples: int = 512, trials: int = 4,
         device: Optional[str] = None):
    """``device=None`` is the card (raises without one)."""
    import json
    import urllib.request

    import numpy as np

    import ray_tpu_torch
    from ray_tpu_torch import data, serve, train, tune
    from ray_tpu_torch._device import resolve_device
    from ray_tpu_torch.train import JaxTrainer, RunConfig, ScalingConfig
    from ray_tpu_torch.tune import TPESearcher, TuneConfig, Tuner

    device = str(resolve_device(device))
    own = not ray_tpu_torch.is_initialized()
    if own:
        ray_tpu_torch.init(num_nodes=1, resources={"CPU": 8})

    # 1. dataset: y = 3x + 1 (+ noise)
    rng = np.random.default_rng(0)
    xs = rng.uniform(-1, 1, samples).astype("float32")
    ys = 3.0 * xs + 1.0 + rng.normal(0, 0.05, samples).astype("float32")
    ds = data.from_items([{"x": float(a), "y": float(b)}
                          for a, b in zip(xs, ys)])

    # 2-3. trainer inside a Tune sweep over the learning rate
    def train_loop(config):
        import torch

        lr = config["lr"]
        dev = torch.device(config.get("device", "cpu"))
        w = [torch.zeros((), device=dev), torch.zeros((), device=dev)]

        def step(w, batch_x, batch_y):
            wb = [t.detach().requires_grad_(True) for t in w]
            loss = torch.mean((wb[0] * batch_x + wb[1] - batch_y) ** 2)
            grads = torch.autograd.grad(loss, wb)
            return ([(wb[i] - lr * grads[i]).detach() for i in range(2)],
                    loss.detach())

        shard = train.get_dataset_shard("train")
        loss = None
        for _ in range(3):
            for batch in shard.iter_batches(batch_size=64,
                                            batch_format="numpy"):
                # batches are read-only: copy them into tensors
                w, loss = step(w, torch.tensor(batch["x"], device=dev),
                               torch.tensor(batch["y"], device=dev))
        train.report({"loss": float(loss),
                      "w": float(w[0]), "b": float(w[1])})

    # the sweep's trials run in worker processes, which cannot see the
    # card: they fit on the CPU; the final fit runs on ``device``
    trainer = JaxTrainer(
        train_loop, train_loop_config={"lr": 0.1, "device": "cpu"},
        scaling_config=ScalingConfig(num_workers=1),
        datasets={"train": ds},
        run_config=RunConfig(name="fullstack"))
    results = Tuner(
        trainer,
        param_space={"train_loop_config": {
            "lr": tune.loguniform(1e-2, 1.0)}},
        tune_config=TuneConfig(metric="loss", mode="min",
                               num_samples=trials,
                               max_concurrent_trials=2,
                               search_alg=TPESearcher(n_startup=2,
                                                      seed=0))).fit()
    if results.errors:
        raise RuntimeError(f"sweep trials failed: {results.errors}")
    best = results.get_best_result()
    best_lr = best.config["lr"]    # train_loop_config is flattened
    # re-fit at the tuned lr to obtain the weights: trial metrics surface
    # the tuned objective, so the production parameters come from one
    # direct fit
    final = JaxTrainer(
        train_loop, train_loop_config={"lr": best_lr, "device": device},
        scaling_config=ScalingConfig(num_workers=1),
        datasets={"train": ds},
        run_config=RunConfig(name="fullstack-final")).fit()
    if final.error:
        raise RuntimeError(f"final fit failed: {final.error}")
    w, b = final.metrics["w"], final.metrics["b"]

    # 4. serve the tuned model over HTTP; the finally tears the proxy down
    # even when the request fails
    @serve.deployment
    def predict(payload):
        x = float(payload["x"])
        return {"y": w * x + b}

    try:
        serve.run(predict.bind())
        port = serve.start_http_proxy(port=0)
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/",
            data=json.dumps({"x": 0.5}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=30) as resp:
            served = json.loads(resp.read())["y"]
    finally:
        serve.shutdown()
        if own:
            ray_tpu_torch.shutdown()
    return {"w": w, "b": b, "loss": final.metrics["loss"],
            "best_lr": best_lr, "served_prediction": served}


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--device", default=None,
                   help="the card by default; 'cpu' off it")
    out = main(device=p.parse_args().device)
    print(out)
    assert abs(out["w"] - 3.0) < 0.5 and abs(out["b"] - 1.0) < 0.5
