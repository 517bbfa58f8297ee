"""Per-request latency records and SLO-aware summaries (counterpart of
``ray_tpu/loadgen/recorder.py``, a copy of the JAX package's module).

Every timestamp is seconds from the run's t0 (one ``time.perf_counter``
anchor), so the records of every client worker share one clock. Percentiles
are nearest-rank (exact, no interpolation): ``p(q) = sorted[ceil(q/100 * n)
- 1]``.

Derived per request:
  TTFT   first_token_at - sent_at   (time to the first token or chunk)
  TPOT   (finished_at - first_token_at) / (output_tokens - 1)
         (time per output token after the first; needs >= 2 tokens)
  E2E    finished_at - sent_at
  queue  sent_at - scheduled_at     (open-loop lateness: how far behind
         the offered schedule the finite client pool fell)

Goodput under an SLO counts a request only when it completed without error
and met every bound the SLO states, so a fast median with a collapsed tail
cannot hide in an average.
"""

from __future__ import annotations

import dataclasses
import math
import threading
from typing import Any, Dict, List, Optional


@dataclasses.dataclass
class SLO:
    """Latency objective; ``None`` bounds are unconstrained."""

    ttft_s: Optional[float] = None
    e2e_s: Optional[float] = None

    def met_by(self, rec: "RequestRecord") -> bool:
        if rec.error is not None or rec.finished_at is None:
            return False
        if self.ttft_s is not None and (
                rec.ttft_s is None or rec.ttft_s > self.ttft_s):
            return False
        if self.e2e_s is not None and (
                rec.e2e_s is None or rec.e2e_s > self.e2e_s):
            return False
        return True


@dataclasses.dataclass
class RequestRecord:
    scheduled_at: float
    sent_at: float = 0.0
    first_token_at: Optional[float] = None
    finished_at: Optional[float] = None
    output_tokens: int = 0
    error: Optional[str] = None

    @property
    def ttft_s(self) -> Optional[float]:
        if self.first_token_at is None:
            return None
        return self.first_token_at - self.sent_at

    @property
    def e2e_s(self) -> Optional[float]:
        if self.finished_at is None:
            return None
        return self.finished_at - self.sent_at

    @property
    def queue_s(self) -> float:
        return max(0.0, self.sent_at - self.scheduled_at)

    @property
    def tpot_s(self) -> Optional[float]:
        if (self.finished_at is None or self.first_token_at is None
                or self.output_tokens < 2):
            return None
        return ((self.finished_at - self.first_token_at)
                / (self.output_tokens - 1))


def percentile(sorted_vals: List[float], q: float) -> float:
    """Nearest-rank percentile over an ASCENDING-sorted list."""
    if not sorted_vals:
        return 0.0
    rank = max(1, math.ceil(q / 100.0 * len(sorted_vals)))
    return float(sorted_vals[min(rank, len(sorted_vals)) - 1])


def _dist(vals: List[float]) -> Dict[str, float]:
    vals = sorted(vals)
    return {
        "p50": round(percentile(vals, 50), 6),
        "p90": round(percentile(vals, 90), 6),
        "p99": round(percentile(vals, 99), 6),
        "mean": round(sum(vals) / len(vals), 6) if vals else 0.0,
        "max": round(vals[-1], 6) if vals else 0.0,
    }


class LatencyRecorder:
    """Thread-safe sink the client workers append finished records to."""

    def __init__(self):
        self._lock = threading.Lock()
        self._records: List[RequestRecord] = []  #: guarded by self._lock

    def add(self, rec: RequestRecord) -> None:
        with self._lock:
            self._records.append(rec)

    def records(self) -> List[RequestRecord]:
        with self._lock:
            return list(self._records)

    def __len__(self) -> int:
        with self._lock:
            return len(self._records)

    def summary(self, slo: Optional[SLO] = None,
                wall_s: Optional[float] = None) -> Dict[str, Any]:
        """Machine-readable report over everything recorded so far."""
        recs = self.records()
        done = [r for r in recs
                if r.error is None and r.finished_at is not None]
        errors = [r for r in recs if r.error is not None]
        if wall_s is None:
            ends = [r.finished_at for r in done]
            wall_s = max(ends) if ends else 0.0
        out_tokens = sum(r.output_tokens for r in done)
        report: Dict[str, Any] = {
            "requests": {"total": len(recs), "completed": len(done),
                         "errors": len(errors)},
            "wall_s": round(wall_s, 4),
            "requests_per_second": round(len(done) / wall_s, 3)
            if wall_s > 0 else 0.0,
            "output_tokens": out_tokens,
            "output_tokens_per_second": round(out_tokens / wall_s, 2)
            if wall_s > 0 else 0.0,
            "ttft_s": _dist([r.ttft_s for r in done
                             if r.ttft_s is not None]),
            "tpot_s": _dist([r.tpot_s for r in done
                             if r.tpot_s is not None]),
            "e2e_s": _dist([r.e2e_s for r in done
                            if r.e2e_s is not None]),
            "queue_s": _dist([r.queue_s for r in recs]),
        }
        if errors:
            # first few error strings: enough to diagnose, bounded size
            report["error_samples"] = sorted(
                {e.error for e in errors if e.error})[:5]
        if slo is not None:
            good = [r for r in done if slo.met_by(r)]
            report["goodput"] = {
                "slo": {"ttft_s": slo.ttft_s, "e2e_s": slo.e2e_s},
                "completed_within_slo": len(good),
                "fraction": round(len(good) / len(done), 4)
                if done else 0.0,
                "requests_per_second": round(len(good) / wall_s, 3)
                if wall_s > 0 else 0.0,
            }
        return report
