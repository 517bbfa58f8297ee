"""The port's copies of the example scripts run end to end on the CPU
(the four tests of ``tests/test_examples.py`` that the port's runtime
carries, at their sizes, with JAX's assertions), with process workers on."""

import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch._private import worker_process


@pytest.fixture
def ray_start_regular():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    rt = ray_tpu_torch.init(num_nodes=1, resources={"CPU": 8})
    yield rt
    ray_tpu_torch.shutdown()
    torch.set_num_threads(threads)


def test_mnist_mlp_example(ray_start_regular):
    from ray_tpu_torch.examples import train_mnist_mlp
    result = train_mnist_mlp.main(device="cpu")
    assert result.error is None
    epochs = {e["metrics"]["epoch"] for e in result.metrics_history}
    assert 1 in epochs  # both epochs ran


def test_vit_streaming_example(ray_start_regular):
    from ray_tpu_torch.examples import data_vit_streaming
    before = worker_process.calls_sent()
    result = data_vit_streaming.main(device="cpu")
    assert result.error is None
    # the dataset's tasks (the normalisation among them) ran in worker
    # processes
    assert worker_process.calls_sent() > before


def test_full_stack_pipeline_example(ray_start_regular):
    """Data -> Train -> Tune (TPE) -> Serve/HTTP in one runtime."""
    from ray_tpu_torch.examples import full_stack_pipeline

    out = full_stack_pipeline.main(samples=256, trials=3, device="cpu")
    assert abs(out["w"] - 3.0) < 0.5
    assert abs(out["b"] - 1.0) < 0.5
    expected = out["w"] * 0.5 + out["b"]
    assert abs(out["served_prediction"] - expected) < 1e-6



def test_compiled_dag_pipeline_example():
    """The three-actor pipeline engages the shm-channel mode on the
    port's default topology (JAX's test pins ``cluster="local"``, the
    port's default) and gives one float a round."""
    from ray_tpu_torch.examples import compiled_dag_pipeline
    ray_tpu_torch.init(num_nodes=1, resources={"CPU": 8})
    try:
        outs = compiled_dag_pipeline.main(rounds=20)
        assert len(outs) == 20
        assert all(isinstance(o, float) for o in outs)
    finally:
        ray_tpu_torch.shutdown()


def test_examples_ask_for_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    from ray_tpu_torch.examples import (data_vit_streaming,
                                        full_stack_pipeline,
                                        train_mnist_mlp)
    for main in (train_mnist_mlp.main, data_vit_streaming.main,
                 full_stack_pipeline.main):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main()
