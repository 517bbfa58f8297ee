"""ray_tpu_torch.loadgen — open-loop load generation and SLO benchmarking
(counterpart of ``ray_tpu.loadgen``; the port's own copy).

Seeded Poisson or constant arrival schedules with prompt- and output-length
distributions, N concurrent client workers over serve handles or the HTTP
proxy (streaming-aware), per-request TTFT/TPOT/E2E/queue percentiles, and
goodput under an SLO::

    from ray_tpu_torch.loadgen import LoadSpec, SLO, HandleTarget, run_load
    report = run_load(HandleTarget(handle),
                      LoadSpec(rate=50, duration_s=10, clients=64,
                               slo=SLO(ttft_s=0.5, e2e_s=5.0)))

CLI: ``python -m ray_tpu_torch.loadgen --clients 64 --rate 50 --duration
10`` (``--device cpu`` off the card).
"""

from ray_tpu_torch.loadgen.arrival import (ARRIVAL_KINDS, LengthSampler,
                                           arrival_times)
from ray_tpu_torch.loadgen.recorder import (SLO, LatencyRecorder,
                                            RequestRecord, percentile)
from ray_tpu_torch.loadgen.runner import (HTTPTarget, HandleTarget, LoadSpec,
                                          build_payloads, format_multi_report,
                                          format_report, jain_fairness,
                                          run_load, run_multi_job_load)

__all__ = [
    "ARRIVAL_KINDS", "arrival_times", "LengthSampler",
    "SLO", "LatencyRecorder", "RequestRecord", "percentile",
    "LoadSpec", "HandleTarget", "HTTPTarget", "build_payloads",
    "run_load", "format_report",
    "run_multi_job_load", "format_multi_report", "jain_fairness",
]
