"""Compiled-DAG inference pipeline over cross-process shm channels
(counterpart of ``examples/compiled_dag_pipeline.py``).

Three process-worker actors form a preprocess -> embed -> score
pipeline; after ``experimental_compile()`` every ``execute()`` flows
through pre-allocated shared-memory channels with no RPC. The pipeline is
host work only: it asks for no card.

Run: python -m ray_tpu_torch.examples.compiled_dag_pipeline
"""

from __future__ import annotations

import time


def main(rounds: int = 100):
    import numpy as np

    import ray_tpu_torch
    from ray_tpu_torch.dag import InputNode

    @ray_tpu_torch.remote
    class Preprocess:
        def run(self, text):
            return np.asarray([ord(c) % 97 for c in text], np.float32)

    @ray_tpu_torch.remote
    class Embed:
        def __init__(self, dim):
            rng = np.random.default_rng(0)
            self.table = rng.normal(size=(97, dim)).astype(np.float32)

        def run(self, ids):
            return self.table[ids.astype(np.int64) % 97].mean(axis=0)

    @ray_tpu_torch.remote
    class Score:
        def __init__(self):
            rng = np.random.default_rng(1)
            self.w = rng.normal(size=(16,)).astype(np.float32)

        def run(self, emb):
            return float(emb @ self.w)

    pre, emb, score = Preprocess.remote(), Embed.remote(16), Score.remote()
    with InputNode() as inp:
        dag = score.run.bind(emb.run.bind(pre.run.bind(inp)))
    compiled = dag.experimental_compile()
    assert compiled._proc is not None, "shm-channel mode expected"

    t0 = time.perf_counter()
    refs = [compiled.execute(f"request number {i}")
            for i in range(rounds)]
    outs = [ray_tpu_torch.get(r, timeout=60) for r in refs]
    dt = time.perf_counter() - t0
    compiled.teardown()
    print(f"{rounds} pipelined rounds in {dt:.3f}s "
          f"({rounds / dt:.0f} exec/s), sample score {outs[0]:.4f}")
    return outs


if __name__ == "__main__":
    import ray_tpu_torch

    ray_tpu_torch.init(num_nodes=1, resources={"CPU": 4})
    try:
        main()
    finally:
        ray_tpu_torch.shutdown()
