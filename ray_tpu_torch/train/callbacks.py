"""Run callbacks: loggers and experiment-tracking integrations (counterpart
of ``ray_tpu/train/callbacks.py``, a copy of the JAX package's module).

Hooks invoked on run start, every report, every checkpoint and run end, and
the JSON and CSV file loggers. Attach via ``RunConfig(callbacks=[...])``,
which ``JaxTrainer`` and ``tune.Tuner`` (each trial's reports) honour. The
Weights & Biases and MLflow callbacks import their packages lazily, when
one is constructed; without the package the constructor raises
``ImportError`` naming it.
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


class WandbLoggerCallback(Callback):
    """Weights & Biases."""

    def __init__(self, project: str, **init_kwargs):
        try:
            import wandb  # noqa: F401
        except ImportError as e:
            raise ImportError(
                "WandbLoggerCallback requires the `wandb` package, which "
                "is not installed; use JsonLoggerCallback/"
                "CSVLoggerCallback or install wandb.") from e
        self._project = project
        self._init_kwargs = init_kwargs
        self._run = None

    def on_run_start(self, run_name, config=None):
        import wandb

        self._run = wandb.init(project=self._project, name=run_name,
                               config=config, **self._init_kwargs)

    def on_report(self, metrics, iteration, rank=0, trial_id=""):
        if self._run is not None and rank == 0:
            self._run.log(metrics, step=iteration)

    def on_run_end(self, result=None, error=None):
        if self._run is not None:
            self._run.finish()
            self._run = None


class MLflowLoggerCallback(Callback):
    """MLflow."""

    def __init__(self, tracking_uri: Optional[str] = None,
                 experiment_name: str = "ray_tpu_torch"):
        try:
            import mlflow  # noqa: F401
        except ImportError as e:
            raise ImportError(
                "MLflowLoggerCallback requires the `mlflow` package, "
                "which is not installed; use JsonLoggerCallback/"
                "CSVLoggerCallback or install mlflow.") from e
        self._tracking_uri = tracking_uri
        self._experiment_name = experiment_name

    def on_run_start(self, run_name, config=None):
        import mlflow

        if self._tracking_uri:
            mlflow.set_tracking_uri(self._tracking_uri)
        mlflow.set_experiment(self._experiment_name)
        mlflow.start_run(run_name=run_name)
        if config:
            mlflow.log_params(config)

    def on_report(self, metrics, iteration, rank=0, trial_id=""):
        import mlflow

        if rank == 0:
            mlflow.log_metrics(
                {k: v for k, v in metrics.items()
                 if isinstance(v, (int, float))}, step=iteration)

    def on_run_end(self, result=None, error=None):
        import mlflow

        mlflow.end_run()


def invoke(callbacks, hook: str, *args, **kwargs) -> None:
    """Fire one hook on every callback; a broken callback never takes
    the run down (reference semantics: logging is best-effort)."""
    for cb in callbacks or ():
        try:
            getattr(cb, hook)(*args, **kwargs)
        except Exception:
            pass
