"""Run callbacks: loggers and experiment-tracking integrations (counterpart
of ``ray_tpu/train/callbacks.py``, a copy of the JAX package's module).

Hooks invoked on run start, every report, every checkpoint and run end, and
the JSON and CSV file loggers. Attach via ``RunConfig(callbacks=[...])``,
which ``JaxTrainer`` honours (Tune's trials come with ROADMAP A11f). JAX's
Weights & Biases and MLflow callbacks are left out: they import packages
that the port may not (ROADMAP A11e).
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, List, Optional


class Callback:
    """Hook interface (reference: ray.tune.Callback shape, run-scoped)."""

    def on_run_start(self, run_name: str,
                     config: Optional[Dict[str, Any]] = None) -> None:
        pass

    def on_report(self, metrics: Dict[str, Any], iteration: int,
                  rank: int = 0, trial_id: str = "") -> None:
        pass

    def on_checkpoint(self, checkpoint: Any, iteration: int) -> None:
        pass

    def on_run_end(self, result: Any = None,
                   error: Optional[str] = None) -> None:
        pass


class JsonLoggerCallback(Callback):
    """Append every report to ``<dir>/result.json`` (JSON lines;
    reference: ``tune/logger/json.py``)."""

    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        self._f = None

    def on_run_start(self, run_name, config=None):
        os.makedirs(self.log_dir, exist_ok=True)
        self._f = open(os.path.join(self.log_dir, "result.json"), "a")
        if config:
            with open(os.path.join(self.log_dir, "params.json"),
                      "w") as pf:
                json.dump(config, pf, default=str)

    def on_report(self, metrics, iteration, rank=0, trial_id=""):
        if self._f is None:
            return
        record = {"iteration": iteration, "rank": rank,
                  "timestamp": time.time(), **metrics}
        if trial_id:
            record["trial_id"] = trial_id
        self._f.write(json.dumps(record, default=str) + "\n")
        self._f.flush()

    def on_run_end(self, result=None, error=None):
        if self._f is not None:
            self._f.close()
            self._f = None


class CSVLoggerCallback(Callback):
    """``<dir>/progress.csv`` (reference: ``tune/logger/csv.py``).
    Columns fixed by the first report; later extra keys are dropped.
    stdlib csv handles quoting; the header is written only when the
    file is empty (append mode across runs stays parseable)."""

    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        self._f = None
        self._writer = None
        self._columns: Optional[List[str]] = None

    def on_run_start(self, run_name, config=None):
        os.makedirs(self.log_dir, exist_ok=True)
        self._f = open(os.path.join(self.log_dir, "progress.csv"),
                       "a", newline="")

    def on_report(self, metrics, iteration, rank=0, trial_id=""):
        if self._f is None:
            return
        import csv

        row = {"iteration": iteration, **metrics}
        if self._writer is None:
            self._columns = list(row)
            self._writer = csv.DictWriter(
                self._f, fieldnames=self._columns, extrasaction="ignore")
            if self._f.tell() == 0:
                self._writer.writeheader()
        self._writer.writerow({c: row.get(c, "") for c in self._columns})
        self._f.flush()

    def on_run_end(self, result=None, error=None):
        if self._f is not None:
            self._f.close()
            self._f = None
            self._writer = None


def invoke(callbacks, hook: str, *args, **kwargs) -> None:
    """Fire one hook on every callback; a broken callback never takes
    the run down (reference semantics: logging is best-effort)."""
    for cb in callbacks or ():
        try:
            getattr(cb, hook)(*args, **kwargs)
        except Exception:
            pass
