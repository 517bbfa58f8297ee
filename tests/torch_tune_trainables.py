"""Trainables of tests/test_torch_tune.py that a subprocess imports: this
module imports the port only, never JAX (the test module does), so the
subprocess runs ``ray_tpu_torch`` alone."""

import os
import time


def _restorable_trainable(config):
    time.sleep(config.get("sleep", 0.4))
    return {"score": config["x"], "run_pid": os.getpid()}
