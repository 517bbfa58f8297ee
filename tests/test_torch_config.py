"""The port's flag table and its lint gate.

The whole flag table is held to JAX's (``ray_tpu/_private/config.py``):
every flag JAX declares is the port's, with the same name, type, default
and environment variable, with no exception. The two flags only the port
declares are the variables JAX's worker plane reads straight
from the environment.

The lint gate runs JAX's static-analysis passes (``tools/raylint``) over
``ray_tpu_torch/`` against the port's own baseline
(``tests/torch_raylint_baseline.txt``, each entry with its reason).
"""

import os
import subprocess
import sys

import pytest

from ray_tpu._private import config as jax_config
from ray_tpu_torch._private import config as port_config

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# flags only the port declares: JAX reads these variables straight from
# the environment (ray_tpu/_private/worker_process.py)
PORT_ONLY = {"process_workers": ("RAY_TPU_PROCESS_WORKERS", True),
             "fast_lane": ("RAY_TPU_FAST_LANE", True)}


@pytest.mark.parametrize("name", sorted(jax_config.FLAGS))
def test_flag_matches_jax(name):
    """Each of JAX's flags is the port's: same name, type, default and
    environment variable."""
    jax_flag = jax_config.FLAGS[name]
    flag = port_config.FLAGS[name]
    assert (flag.type, flag.default, flag.env_var) == (
        jax_flag.type, jax_flag.default, jax_flag.env_var)


def test_port_declares_no_other_flag():
    extra = set(port_config.FLAGS) - set(jax_config.FLAGS)
    assert extra == set(PORT_ONLY)
    for name, (var, default) in PORT_ONLY.items():
        flag = port_config.FLAGS[name]
        assert (flag.env_var, flag.default) == (var, default)


@pytest.mark.parametrize("name,value", [("inline_object_size", 4096),
                                        ("bench_total_deadline", 60),
                                        ("fairshare", True),
                                        ("job_default_weight", 2.0),
                                        ("admission_queue_max", 8)])
def test_jax_flags_are_accepted_by_init(name, value):
    """``init(_system_config=...)`` takes each flag JAX takes; before the
    port declared them this raised ``ValueError``."""
    import ray_tpu_torch as rt_api
    rt_api.init(num_nodes=1, resources={"CPU": 1},
                _system_config={name: value})
    try:
        assert getattr(port_config.cfg(), name) == value
        assert rt_api.get(rt_api.put(7)) == 7
    finally:
        rt_api.shutdown()


def test_raylint_is_clean_over_the_port():
    """JAX's lint passes report nothing over ``ray_tpu_torch/`` beyond
    the port's baseline (each entry carries its reason)."""
    proc = subprocess.run(
        [sys.executable, "-m", "tools.raylint", "ray_tpu_torch/",
         "--baseline", "tests/torch_raylint_baseline.txt"],
        cwd=_REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "stale" not in (proc.stdout + proc.stderr).lower()


def test_baseline_entries_carry_a_reason():
    path = os.path.join(_REPO, "tests", "torch_raylint_baseline.txt")
    with open(path) as fh:
        entries = [ln for ln in fh if ln.strip() and not ln.startswith("#")]
    assert entries
    for ln in entries:
        key, sep, why = ln.partition(" #")
        assert sep and len(why.strip()) > 20, ln
        assert key.split("|")[1].startswith("ray_tpu_torch/"), ln
