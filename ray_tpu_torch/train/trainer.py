"""JaxTrainer: the controller loop (counterpart of
``ray_tpu/train/trainer.py``; the JAX name is kept so that one script runs
on both packages).

Start the worker group, poll it, keep rank 0's checkpoints, and on a failure
consult ``FailureConfig`` and restart the group from the latest checkpoint
at the size the scaling policy picks, until the run finishes or its failures
are spent. Each rank runs the same train function; on several processes the
driver joins the process group first (``initialize_multihost``), since the
workers are threads of the driver. JAX's export events are left out (ROADMAP
A11e).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch import exceptions as _exc
from ray_tpu_torch.train.callbacks import invoke as _cb
from ray_tpu_torch.train.checkpoint import Checkpoint, CheckpointManager
from ray_tpu_torch.train.collective import kill_rendezvous
from ray_tpu_torch.train.config import RunConfig, ScalingConfig
from ray_tpu_torch.train.scaling_policy import (ElasticScalingPolicy,
                                                resolve_policy)
from ray_tpu_torch.train.worker_group import WorkerGroup, report_cutoff


@dataclasses.dataclass
class Result:
    metrics: Dict[str, Any]
    checkpoint: Optional[Checkpoint]
    path: str
    metrics_history: List[Dict[str, Any]]
    error: Optional[str] = None


class JaxTrainer:
    """Runs ``train_loop_per_worker`` on ``scaling_config.num_workers``
    gang-scheduled workers."""

    def __init__(self, train_loop_per_worker: Callable,
                 *, train_loop_config: Optional[Dict] = None,
                 scaling_config: Optional[ScalingConfig] = None,
                 run_config: Optional[RunConfig] = None,
                 datasets: Optional[Dict[str, Any]] = None,
                 resume_from_checkpoint: Optional[Checkpoint] = None,
                 scaling_policy=None):
        self.train_loop = train_loop_per_worker
        self.train_loop_config = train_loop_config
        self.scaling = scaling_config or ScalingConfig()
        self.run_config = run_config or RunConfig()
        self.datasets = datasets or {}
        self.resume_from_checkpoint = resume_from_checkpoint
        self.scaling_policy = resolve_policy(self.scaling, scaling_policy)

    # ------------------------------------------------------------------
    def fit(self) -> Result:
        from ray_tpu_torch.parallel.multihost import initialize_multihost
        try:
            initialize_multihost()
        except Exception as e:  # a cluster environment whose rendezvous failed
            raise RuntimeError(
                f"multi-host initialization failed: {e}") from e

        name = self.run_config.name or "train_run"
        path = self.run_config.resolved_storage_path()
        callbacks = self.run_config.callbacks
        _cb(callbacks, "on_run_start", name, self.train_loop_config)
        ckpt_cfg = self.run_config.checkpoint_config
        manager = CheckpointManager(
            path, num_to_keep=ckpt_cfg.num_to_keep,
            score_attribute=ckpt_cfg.checkpoint_score_attribute,
            score_order=ckpt_cfg.checkpoint_score_order)

        latest = self.resume_from_checkpoint
        history: List[Dict[str, Any]] = []
        last_metrics: Dict[str, Any] = {}
        failures = 0
        max_failures = self.run_config.failure_config.max_failures
        error: Optional[str] = None

        placement_timeout = self.scaling.placement_timeout_s
        if placement_timeout is None and isinstance(
                self.scaling_policy, ElasticScalingPolicy):
            # elastic promises failure, not a hang, for unplaceable gangs
            placement_timeout = 120.0
        world_size = self.scaling_policy.initial_size()
        while True:
            try:
                group = WorkerGroup(
                    world_size, self.scaling.worker_resources(),
                    placement_strategy=self.scaling.placement_strategy,
                    experiment_name=name,
                    placement_timeout_s=placement_timeout)
            except _exc.GetTimeoutError as e:
                # placement timed out; anything else propagates
                failures += 1
                if max_failures >= 0 and failures > max_failures:
                    error = f"worker group unplaceable: {e!r}"
                    break
                world_size = self.scaling_policy.on_recovery(
                    world_size, self.scaling.worker_resources(),
                    failures).num_workers
                continue
            run_refs = group.start_run(
                self.train_loop, self.train_loop_config,
                latest_checkpoint=latest,
                dataset_shards=self._split_datasets(world_size))
            outcome, err = self._poll_until_done(group, run_refs, manager,
                                                 history)
            # a failed rank's error holds its frames, and so its model on
            # the card: drop the refs before the next group is formed
            del run_refs
            # rank 0's last report: another rank's can be drained after it,
            # and a failed rank's report is older than rank 0's checkpoint
            rank0 = [e for e in history if e["rank"] == 0]
            if rank0:
                last_metrics = rank0[-1]["metrics"]
            latest = manager.latest_checkpoint() or latest
            group.shutdown()
            kill_rendezvous(name)

            if outcome == "finished":
                break
            failures += 1
            if max_failures >= 0 and failures > max_failures:
                error = err or "train workers failed"
                break
            # the policy picks the next world size, and the group re-forms
            # from the latest checkpoint at that size
            world_size = self.scaling_policy.on_recovery(
                world_size, self.scaling.worker_resources(),
                failures).num_workers

        result = Result(metrics=last_metrics, checkpoint=latest, path=path,
                        metrics_history=history, error=error)
        _cb(callbacks, "on_run_end", result, error)
        return result

    # ------------------------------------------------------------------
    def _split_datasets(self, n: int):
        if not self.datasets:
            return None
        shards: List[Dict[str, Any]] = [dict() for _ in range(n)]
        for name, ds in self.datasets.items():
            if hasattr(ds, "streaming_split"):
                for i, piece in enumerate(ds.streaming_split(n)):
                    shards[i][name] = piece
            else:  # a static sequence: strided split
                for i in range(n):
                    shards[i][name] = ds[i::n]
        return shards

    def _drain(self, group, manager, history, notify: bool,
               held: List, flush: bool = False) -> None:
        """Take every rank's buffered reports into ``history`` in the order
        they were made; keep rank 0's checkpoints. A report made after this
        drain's cutoff waits in ``held`` for the next drain (a report of
        another rank made before it may not have been polled yet), unless
        ``flush``, once no rank reports any more."""
        callbacks = self.run_config.callbacks
        cutoff = report_cutoff()
        batch = list(held)
        held.clear()
        for status in group.poll():
            batch.extend(zip(status["seqs"], status["reports"]))
        batch.sort(key=lambda item: item[0])
        for seq, entry in batch:
            if seq > cutoff and not flush:
                held.append((seq, entry))
                continue
            history.append(entry)
            if notify:
                _cb(callbacks, "on_report", entry["metrics"],
                    len(history), rank=entry["rank"])
            if entry["rank"] == 0 and entry["checkpoint"] is not None:
                manager.register(entry["checkpoint"], entry["metrics"])
                if notify:
                    _cb(callbacks, "on_checkpoint", entry["checkpoint"],
                        len(history))

    def _poll_until_done(self, group, run_refs, manager, history):
        """Drain reports until every rank finishes or one fails.

        Returns ("finished" | "failed", error)."""
        pending = list(run_refs)
        held: List = []
        while True:
            # every rank has returned once pending is empty: nothing more
            # can be reported, so this drain takes all
            self._drain(group, manager, history, notify=True, held=held,
                        flush=not pending)
            if not pending:
                return "finished", None
            done, pending = ray_tpu_torch.wait(
                pending, num_returns=len(pending), timeout=0.2)
            for ref in done:
                try:
                    ray_tpu_torch.get(ref)
                except Exception as e:
                    # one dead rank fails the gang
                    self._drain(group, manager, history, notify=False,
                                held=held, flush=True)
                    return "failed", repr(e)
