"""Job submission (counterpart of ``ray_tpu/job``): a supervisor actor a
job runs the entrypoint as a subprocess, with status and log retrieval."""

from ray_tpu_torch.job.manager import JobInfo, JobStatus, JobSubmissionClient

__all__ = ["JobSubmissionClient", "JobStatus", "JobInfo"]
