"""JobConfig on the port (a copy of ``tests/test_job_config.py`` against
``ray_tpu_torch``): the job-default runtime env and the code search path.
"""

import pytest

import ray_tpu_torch
from ray_tpu_torch.job_config import JobConfig


def test_job_default_runtime_env_and_code_search_path(tmp_path):
    mod_dir = tmp_path / "jobmods"
    mod_dir.mkdir()
    (mod_dir / "jobcfg_mod.py").write_text("VALUE = 'from-search-path'\n")

    jc = JobConfig(
        runtime_env={"env_vars": {"JOBCFG_FLAG": "on"}},
        metadata={"team": "tpu"},
        code_search_path=[str(mod_dir)])
    rt = ray_tpu_torch.init(num_nodes=1, resources={"CPU": 4}, job_config=jc)
    try:
        @ray_tpu_torch.remote
        def probe():
            import os

            import jobcfg_mod
            return os.environ.get("JOBCFG_FLAG"), jobcfg_mod.VALUE

        flag, val = ray_tpu_torch.get(probe.remote(), timeout=60)
        assert flag == "on"                 # job-default env applied
        assert val == "from-search-path"

        @ray_tpu_torch.remote(runtime_env={"env_vars": {"JOBCFG_FLAG": "own"}})
        def own_env():
            import os
            return os.environ.get("JOBCFG_FLAG")

        # a task's OWN runtime env wins over the job default
        assert ray_tpu_torch.get(own_env.remote(), timeout=60) == "own"
        assert rt.job_config.metadata == {"team": "tpu"}
    finally:
        ray_tpu_torch.shutdown()


def test_job_config_validation():
    with pytest.raises(ValueError, match="default_actor_lifetime"):
        JobConfig(default_actor_lifetime="bogus")
    with pytest.raises(ValueError):
        JobConfig(runtime_env={"not_a_field": 1})
    jc = JobConfig()
    assert jc.serialize()["metadata"] == {}
