"""Worker group: gang-scheduled train workers polled for reports (counterpart
of ``ray_tpu/train/worker_group.py``).

Each worker is a ``max_concurrency=2`` actor placed in one bundle of a
placement group: one lane runs the train function, the other answers
``poll()``. A worker that asks for ``GPU`` holds the card through its bundle
for as long as the group lives.

Shutting a group down stops its ranks before it kills them: each rank's
next ``report`` raises ``StopIteration`` (train/session.py), and the group
waits a bounded time for the train functions to return, so a rank that ran
on after another rank failed does not still hold its model when the group
re-forms.

Every rank's reports are numbered in one order, under one lock, as they are
made (the ranks are threads of the driver). The driver's drain takes a
cutoff in that order before it polls the ranks and keeps back what a rank
reported after the cutoff, so ``Result.metrics_history`` is in the order
the reports were made, not the order the polls reached them (ROADMAP C14).
"""

from __future__ import annotations

import inspect
import itertools
import threading
import traceback
from typing import Any, Callable, Dict, List, Optional, Tuple

import ray_tpu_torch
from ray_tpu_torch._private.task_spec import PlacementGroupSchedulingStrategy
from ray_tpu_torch.train.session import TrainContext, _set_context
from ray_tpu_torch.util.placement_group import (placement_group,
                                                remove_placement_group)

# how long shutdown waits for stopped ranks to return from the train function
STOP_JOIN_S = 60.0

_REPORT_LOCK = threading.Lock()
_REPORT_SEQ = itertools.count()


def report_cutoff() -> int:
    """A number in the reports' order: every report numbered below it is
    already in its rank's buffer."""
    with _REPORT_LOCK:
        return next(_REPORT_SEQ)


class _TrainWorker:
    """Actor hosting one rank of the train function."""

    def __init__(self, rank: int, world_size: int, experiment_name: str):
        self.rank = rank
        self.world_size = world_size
        self.experiment_name = experiment_name
        self._buffer: List[Tuple[int, Dict]] = []  #: guarded by _REPORT_LOCK
        self._status = "idle"
        self._error: Optional[str] = None
        self._ctx: Optional[TrainContext] = None
        self._stopped = False

    def run(self, fn: Callable, config: Optional[Dict],
            latest_checkpoint=None, dataset_shards=None) -> str:
        ctx = TrainContext(
            world_rank=self.rank, world_size=self.world_size,
            experiment_name=self.experiment_name,
            latest_checkpoint=latest_checkpoint,
            dataset_shards=dataset_shards)
        ctx._report_cb = self._append_report
        if self._stopped:
            ctx._stop_event.set()
        self._ctx = ctx
        _set_context(ctx)
        self._status = "running"
        try:
            if inspect.signature(fn).parameters:
                fn(config if config is not None else {})
            else:
                fn()
            self._status = "finished"
            return "finished"
        except StopIteration:
            self._status = "finished"
            return "stopped"
        except Exception:
            self._status = "failed"
            self._error = traceback.format_exc()
            raise
        finally:
            _set_context(None)
            self._ctx = None

    def _append_report(self, entry: Dict) -> None:
        with _REPORT_LOCK:
            self._buffer.append((next(_REPORT_SEQ), entry))

    def poll(self) -> Dict[str, Any]:
        with _REPORT_LOCK:
            drained, self._buffer = self._buffer, []
        return {"rank": self.rank, "status": self._status,
                "reports": [e for _, e in drained],
                "seqs": [n for n, _ in drained], "error": self._error}

    def stop(self) -> None:
        """End this rank at its next ``report``."""
        self._stopped = True
        ctx = self._ctx
        if ctx is not None:
            ctx._stop_event.set()

    def ping(self) -> bool:
        return True


class WorkerGroup:
    def __init__(self, num_workers: int, resources_per_worker: Dict,
                 placement_strategy: str = "PACK",
                 experiment_name: str = "",
                 placement_timeout_s: Optional[float] = None):
        self.num_workers = num_workers
        self.experiment_name = experiment_name
        self._run_refs: List = []
        self.pg = placement_group(
            [dict(resources_per_worker) for _ in range(num_workers)],
            strategy=placement_strategy)
        try:
            ray_tpu_torch.get(self.pg.ready(), timeout=placement_timeout_s)
        except Exception:
            # an unplaceable gang: release the pending request so that the
            # caller's retry (perhaps at a smaller size) starts clean
            remove_placement_group(self.pg)
            raise
        worker_cls = ray_tpu_torch.remote(_TrainWorker)
        self.workers = [
            worker_cls.options(
                _in_process=True,
                max_concurrency=2,
                num_cpus=resources_per_worker.get("CPU", 1),
                resources={k: v for k, v in resources_per_worker.items()
                           if k != "CPU"},
                scheduling_strategy=PlacementGroupSchedulingStrategy(
                    placement_group=self.pg, placement_group_bundle_index=i),
            ).remote(i, num_workers, experiment_name)
            for i in range(num_workers)]
        ray_tpu_torch.get([w.ping.remote() for w in self.workers])

    def start_run(self, fn: Callable, config: Optional[Dict],
                  latest_checkpoint=None,
                  dataset_shards: Optional[List[Dict]] = None):
        """Start the train function on every rank; returns the refs that
        complete with each rank's run."""
        self._run_refs = [
            w.run.remote(fn, config, latest_checkpoint,
                         dataset_shards[i] if dataset_shards else None)
            for i, w in enumerate(self.workers)]
        return list(self._run_refs)

    def poll(self) -> List[Dict[str, Any]]:
        out = []
        for w in self.workers:
            try:
                out.append(ray_tpu_torch.get(w.poll.remote(), timeout=30))
            except Exception as e:
                out.append({"rank": None, "status": "dead",
                            "reports": [], "seqs": [], "error": repr(e)})
        return out

    def shutdown(self) -> None:
        """Stop every rank, wait for the train functions to return (at most
        ``STOP_JOIN_S``), then kill the workers and free their bundles."""
        stops = [w.stop.remote() for w in self.workers]
        ray_tpu_torch.wait(stops, num_returns=len(stops), timeout=30)
        if self._run_refs:
            ray_tpu_torch.wait(self._run_refs,
                               num_returns=len(self._run_refs),
                               timeout=STOP_JOIN_S)
        self._run_refs = []
        for w in self.workers:
            ray_tpu_torch.kill(w)
        remove_placement_group(self.pg)
