"""Per-job configuration (counterpart of ``ray_tpu/job_config.py``).

JobConfig carries the job-level runtime env, metadata, and code search
path, serialized to the GCS at driver connect). Here it is a validated
bundle handed to ``ray_tpu_torch.init(job_config=...)``; the runtime env
becomes the job-default runtime env and metadata lands in the job
table."""

from __future__ import annotations

from typing import Any, Dict, List, Optional


class JobConfig:
    def __init__(self,
                 runtime_env: Optional[Dict[str, Any]] = None,
                 metadata: Optional[Dict[str, str]] = None,
                 code_search_path: Optional[List[str]] = None,
                 default_actor_lifetime: str = "non_detached"):
        if default_actor_lifetime not in ("non_detached", "detached"):
            raise ValueError(
                f"default_actor_lifetime must be 'non_detached' or "
                f"'detached', got {default_actor_lifetime!r}")
        if runtime_env is not None:
            from ray_tpu_torch.runtime_env import RuntimeEnv
            runtime_env = dict(RuntimeEnv(**runtime_env))  # validate
        self.runtime_env = runtime_env
        self.metadata = dict(metadata or {})
        self.code_search_path = list(code_search_path or [])
        self.default_actor_lifetime = default_actor_lifetime

    def serialize(self) -> Dict[str, Any]:
        return {"runtime_env": self.runtime_env,
                "metadata": self.metadata,
                "code_search_path": self.code_search_path,
                "default_actor_lifetime": self.default_actor_lifetime}
