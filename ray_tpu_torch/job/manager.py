"""Job manager: a supervisor actor a job, running a shell entrypoint
(counterpart of ``ray_tpu/job/manager.py``).

The entrypoint runs as a subprocess of the supervisor's worker, with the
job's ``runtime_env["env_vars"]`` in its environment; its output is kept
as the job's log, and its state changes are export events (``JOB``).
The supervisor is created in the job's tenancy context, so it and every
task its entrypoint fans out are attributed to the job's tenant.
"""

from __future__ import annotations

import dataclasses
import os
import subprocess
import threading
import time
import uuid
from typing import Any, Dict, List, Optional

import ray_tpu_torch


class JobStatus:
    PENDING = "PENDING"
    RUNNING = "RUNNING"
    SUCCEEDED = "SUCCEEDED"
    FAILED = "FAILED"
    STOPPED = "STOPPED"


@dataclasses.dataclass
class JobInfo:
    job_id: str
    entrypoint: str
    status: str
    returncode: Optional[int] = None
    start_time: Optional[float] = None
    end_time: Optional[float] = None
    metadata: Optional[Dict[str, str]] = None


class _JobSupervisor:
    """Actor: runs one job's entrypoint as a subprocess and tails it."""

    def __init__(self, job_id: str, entrypoint: str,
                 runtime_env: Optional[Dict] = None,
                 metadata: Optional[Dict] = None):
        self.info = JobInfo(job_id=job_id, entrypoint=entrypoint,
                            status=JobStatus.PENDING, metadata=metadata)
        self._logs: List[str] = []
        self._proc: Optional[subprocess.Popen] = None
        self._lock = threading.Lock()
        env = dict(os.environ)
        for k, v in (runtime_env or {}).get("env_vars", {}).items():
            env[k] = str(v)
        self._env = env
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self) -> None:
        from ray_tpu_torch._private.export_events import emit_export
        self.info.status = JobStatus.RUNNING
        emit_export("JOB", job_id=self.info.job_id, state="RUNNING",
                    entrypoint=self.info.entrypoint)
        self.info.start_time = time.time()
        try:
            self._proc = subprocess.Popen(
                self.info.entrypoint, shell=True, env=self._env,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)
            for line in self._proc.stdout:
                with self._lock:
                    self._logs.append(line)
            rc = self._proc.wait()
            self.info.returncode = rc
            if self.info.status != JobStatus.STOPPED:
                emit_export("JOB", job_id=self.info.job_id,
                            state="SUCCEEDED" if rc == 0 else "FAILED")
                self.info.status = (JobStatus.SUCCEEDED if rc == 0
                                    else JobStatus.FAILED)
        except Exception as e:
            with self._lock:
                self._logs.append(f"supervisor error: {e!r}\n")
            self.info.status = JobStatus.FAILED
        finally:
            self.info.end_time = time.time()

    def status(self) -> JobInfo:
        return self.info

    def logs(self) -> str:
        with self._lock:
            return "".join(self._logs)

    def stop(self) -> bool:
        if self._proc is not None and self._proc.poll() is None:
            self.info.status = JobStatus.STOPPED
            self._proc.terminate()
            return True
        return False


class JobSubmissionClient:
    """In-cluster job SDK (the reference's HTTP indirection elided)."""

    def __init__(self):
        self._supervisors: Dict[str, Any] = {}

    def submit_job(self, *, entrypoint: str,
                   runtime_env: Optional[Dict] = None,
                   metadata: Optional[Dict] = None,
                   submission_id: Optional[str] = None) -> str:
        job_id = submission_id or f"raysubmit_{uuid.uuid4().hex[:12]}"
        # the supervisor is spawned inside the job's tenancy scope: its
        # creation spec and every task the entrypoint fans out carry this
        # job id, so fair share and /api/jobs attribute the whole tree
        from ray_tpu_torch.tenancy import job_context
        sup_cls = ray_tpu_torch.remote(_JobSupervisor)
        with job_context(job_id):
            sup = sup_cls.options(max_concurrency=4).remote(
                job_id, entrypoint, runtime_env, metadata)
        self._supervisors[job_id] = sup
        return job_id

    def get_job_status(self, job_id: str) -> str:
        return ray_tpu_torch.get(
            self._supervisors[job_id].status.remote()).status

    def get_job_info(self, job_id: str) -> JobInfo:
        return ray_tpu_torch.get(self._supervisors[job_id].status.remote())

    def get_job_logs(self, job_id: str) -> str:
        return ray_tpu_torch.get(self._supervisors[job_id].logs.remote())

    def stop_job(self, job_id: str) -> bool:
        return ray_tpu_torch.get(self._supervisors[job_id].stop.remote())

    def list_jobs(self) -> List[JobInfo]:
        return [ray_tpu_torch.get(s.status.remote())
                for s in self._supervisors.values()]

    def wait_until_finished(self, job_id: str, timeout: float = 60.0,
                            poll_s: float = 0.2) -> str:
        deadline = time.time() + timeout
        while time.time() < deadline:
            st = self.get_job_status(job_id)
            if st in (JobStatus.SUCCEEDED, JobStatus.FAILED,
                      JobStatus.STOPPED):
                return st
            time.sleep(poll_s)
        raise TimeoutError(f"job {job_id} still {st} after {timeout}s")
