"""Multi-tenant fair share: per-job quotas, DRF admission, deficit dispatch
(counterpart of ``ray_tpu/tenancy``).

The cluster runs many jobs in one pool; this package arbitrates it
(the GCS-side role of the reference architecture). Three layers:

- :mod:`ray_tpu_torch.tenancy.quota` — per-job hard/soft caps over
  {CPU, GPU, memory, object_store_bytes};
- :mod:`ray_tpu_torch.tenancy.policy` — the fair-share ledger: weighted
  dominant-resource shares (DRF) plus deficit accounting, so node
  dispatch admits whole same-shape task groups in deficit order
  (batch-DAG scheduling per arXiv 2002.07062) instead of FIFO;
- :mod:`ray_tpu_torch.tenancy.admission` — submit-time verdicts
  (ADMITTED / QUEUED / REJECTED), bounded per-job pending queues with
  backpressure to the submitting driver, and head/daemon federation.

Everything is gated on the ``fairshare`` config flag; with it off the
dispatch hot path is untouched (``Node.tenancy`` stays ``None``).
"""

from ray_tpu_torch.tenancy.admission import (ADMITTED, QUEUED, REJECTED,
                                       TenancyManager)
from ray_tpu_torch.tenancy.context import current_job_id, job_context
from ray_tpu_torch.tenancy.policy import FairShareLedger
from ray_tpu_torch.tenancy.quota import QUOTA_RESOURCES, JobQuota

__all__ = [
    "ADMITTED", "QUEUED", "REJECTED", "TenancyManager",
    "current_job_id", "job_context",
    "FairShareLedger", "JobQuota", "QUOTA_RESOURCES",
]
