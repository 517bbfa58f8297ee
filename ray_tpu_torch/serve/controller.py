"""ServeController: deploy/reconcile/autoscale (counterpart of
``ray_tpu/serve/controller.py``).

Reference: `serve/_private/controller.py:92` (ServeController actor),
`deployment_state.py` (replica reconciliation), `autoscaling_state.py:261`
+ `autoscaling_policy.py:12` (`_calculate_desired_num_replicas` targets
``target_ongoing_requests`` per replica), `proxy_state.py`.

The controller is an actor; a daemon thread runs the reconcile+autoscale
loop. Handles learn replica membership via ``get_replicas`` (versioned
pull — the long-poll equivalent).

The checkpoint is JAX's: the deployment specs (classes, init arguments,
target counts) go to the GCS KV as bytes on every deploy and delete, here
a blob of the port's by-value pickler (``_private/serialization.py``;
JAX's is ``cloudpickle``), and a restarted controller reads them back. A
spec that cannot be pickled leaves the checkpoint as it was, as in JAX.
"""

from __future__ import annotations

import math
import threading
import time
import traceback
from typing import Any, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.serve.deployment import Application, Deployment
from ray_tpu_torch.serve.replica import Replica


class _DeploymentState:
    def __init__(self, deployment: Deployment, init_args, init_kwargs):
        self.deployment = deployment
        self.init_args = init_args
        self.init_kwargs = init_kwargs
        self.target_replicas = deployment.num_replicas
        if deployment.autoscaling_config:
            self.target_replicas = max(
                deployment.autoscaling_config.min_replicas,
                min(self.target_replicas,
                    deployment.autoscaling_config.max_replicas))
        self.replicas: List[Any] = []
        self.replica_slots: List[int] = []   # parallel to replicas
        self.version = 0
        self.last_scale_ts = 0.0
        # slot -> (metrics dict, monotonic recv time): PUSHED by replica
        # reporter threads; reconcile/autoscale read this cache and never
        # block on a per-replica RPC (reference: autoscaling_state.py).
        self.metrics_cache: Dict[int, Any] = {}
        self.started_at: Dict[int, float] = {}   # slot -> start time
        # last autoscale decision inputs (status()/tests introspection)
        self.autoscale_info: Dict[str, Any] = {}
        # slot -> actor id hex of the replica the CONTROLLER placed
        # there: reports from any other incarnation (e.g. a killed
        # in-process replica whose reporter thread is still running) are
        # dropped, so a zombie heartbeat can't keep a dead slot healthy.
        self.replica_ids: Dict[int, str] = {}


_CKPT_KEY = b"serve::applications"


class ServeController:
    """Crash-recoverable: deployment specs checkpoint to the GCS on
    every deploy/delete; a restarted incarnation restores them and
    re-binds to still-live NAMED replica actors instead of leaking them
    (reference: controller recovery from GCS checkpoints,
    serve/tests/test_controller_crashes.py)."""

    def __init__(self):
        from ray_tpu_torch.serve.deployment_scheduler import DeploymentScheduler
        from ray_tpu_torch.serve.long_poll import LongPollHost
        self._state: Dict[str, _DeploymentState] = {}
        self._lock = threading.RLock()
        self._stop = threading.Event()
        self._tick_s = 0.5
        self._report_interval_s = 0.5
        # 6 missed reports before a replica becomes a ping-confirmed
        # death suspect
        self._stale_after_s = 3.0
        self._long_poll = LongPollHost()
        self._scheduler = DeploymentScheduler()
        self._compact_counter = 0
        # name -> (membership version, slot list, depth list) last
        # pushed on the depths:: long-poll key (skip republishing
        # unchanged views; gone slots get their gauge series removed)
        self._depths_published: Dict[str, Any] = {}  #: guarded by self._lock
        # federated queue-pressure signal: previous (sum, count) totals
        # and the last computed per-tick mean — loop-thread only
        self._phase_totals_prev = None
        self._queue_pressure_last = 0.0
        # this incarnation's actor id: its loop stops once the actor is
        # killed (in one process the instance's threads outlive the kill,
        # and the state they hold pins the deployments' init arguments)
        self._actor_id = ray_tpu_torch.get_runtime_context().get_actor_id()
        self._recover_from_checkpoint()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="serve-controller")
        self._thread.start()

    # -- long-poll host (push config propagation) ----------------------
    def listen_for_change(self, keys_to_versions: Dict[str, int]
                          ) -> Dict[str, Any]:
        return self._long_poll.listen(keys_to_versions)

    def _publish_replicas(self, name: str) -> None:
        with self._lock:
            st = self._state.get(name)
            if st is None:
                return
            snapshot = {"replicas": list(st.replicas),
                        "version": st.version}
        self._long_poll.publish(f"replicas::{name}", snapshot)

    # -- crash recovery -------------------------------------------------
    def _kv(self):
        from ray_tpu_torch._private import worker
        rt = worker.global_runtime()
        return rt.gcs if rt is not None else None

    def _checkpoint(self) -> None:
        from ray_tpu_torch._private import serialization
        kv = self._kv()
        if kv is None:
            return
        with self._lock:
            specs = {name: (st.deployment, st.init_args, st.init_kwargs,
                            st.target_replicas)
                     for name, st in self._state.items()}
        try:
            kv.kv_put(_CKPT_KEY, serialization.dumps(specs))
        except Exception:
            pass

    def _recover_from_checkpoint(self) -> None:
        from ray_tpu_torch._private import serialization
        kv = self._kv()
        if kv is None:
            return
        try:
            blob = kv.kv_get(_CKPT_KEY)
        except Exception:
            return
        if not blob:
            return
        try:
            specs = serialization.loads(blob)
        except Exception:
            return
        for name, (dep, args, kwargs, target) in specs.items():
            st = _DeploymentState(dep, args, kwargs)
            st.target_replicas = target
            with self._lock:
                self._state[name] = st
            self._reconcile_one(name)

    # -- deploy --------------------------------------------------------
    def deploy_application(self, app: Application,
                           route_name: Optional[str] = None) -> str:
        """Deploy an application graph depth-first; bound Application args
        become DeploymentHandles (model composition)."""
        from ray_tpu_torch.serve.router import DeploymentHandle

        name = route_name or app.deployment.name
        self._deploy_node(app)
        return name

    def _deploy_node(self, app: Application) -> str:
        from ray_tpu_torch.serve.router import DeploymentHandle

        dep = app.deployment
        args = []
        for a in app.args:
            if isinstance(a, Application):
                child = self._deploy_node(a)
                args.append(DeploymentHandle(child, self._self_handle()))
            else:
                args.append(a)
        kwargs = {}
        for k, v in app.kwargs.items():
            if isinstance(v, Application):
                child = self._deploy_node(v)
                kwargs[k] = DeploymentHandle(child, self._self_handle())
            else:
                kwargs[k] = v
        with self._lock:
            st = _DeploymentState(dep, tuple(args), kwargs)
            self._state[dep.name] = st
        self._reconcile_one(dep.name)
        self._checkpoint()
        return dep.name

    def _self_handle(self):
        return ray_tpu_torch.get_actor("serve_controller")

    # -- reconciliation ------------------------------------------------
    def _start_replica(self, st: _DeploymentState, slot: int):
        from ray_tpu_torch._private.task_spec import NodeAffinitySchedulingStrategy
        opts = dict(st.deployment.ray_actor_options or {})
        name = st.deployment.name
        # SPREAD placement across alive nodes (deployment_scheduler.py;
        # reference SPREAD default :34); soft affinity so a full node
        # doesn't block the replica.
        node_hex = self._scheduler.pick_node_for_replica(name)
        if node_hex is not None and "scheduling_strategy" not in opts:
            opts["scheduling_strategy"] = NodeAffinitySchedulingStrategy(
                node_id=node_hex, soft=True)
        replica_cls = ray_tpu_torch.remote(Replica)
        handle = replica_cls.options(
            # Replicas wrap user callables that may own device state
            # (an LLM engine's weights and KV pool on the card).
            _in_process=True,
            # Named so a restarted controller re-binds instead of leaking
            # the live replica (crash recovery).
            name=f"SERVE_REPLICA::{name}::{slot}",
            get_if_exists=True,
            max_concurrency=st.deployment.max_ongoing_requests,
            max_restarts=st.deployment.max_restarts, **opts,
        ).remote(st.deployment.func_or_class, st.init_args, st.init_kwargs,
                 st.deployment.user_config,
                 report_to="serve_controller", deployment=name, slot=slot,
                 report_interval_s=self._report_interval_s)
        ray_tpu_torch.get(handle.ping.remote())   # fail fast on ctor errors
        st.started_at[slot] = time.monotonic()
        st.replica_ids[slot] = handle._actor_id.hex()
        st.metrics_cache.pop(slot, None)   # no stale entry for a reused slot
        if node_hex is not None:
            self._scheduler.record(name, handle, node_hex)
        return handle

    def report_metrics(self, name: str, slot: int, m: Dict,
                       actor_id: Optional[str] = None) -> None:
        """Push endpoint for replica reporter threads (reference:
        autoscaling_state.py record_request_metrics_for_replica)."""
        with self._lock:
            st = self._state.get(name)
            if st is not None and (
                    actor_id is None
                    or st.replica_ids.get(slot) == actor_id):
                st.metrics_cache[slot] = (m, time.monotonic())

    def _reconcile_one(self, name: str) -> None:
        victims: List[Any] = []
        with self._lock:
            st = self._state.get(name)
            if st is None:
                return
            target = st.target_replicas
            changed = False
            while len(st.replicas) < target:
                # lowest unused slot: a mid-list removal must NOT make us
                # collide with a live higher slot via get_if_exists
                used = set(st.replica_slots)
                slot = next(i for i in range(target + len(used) + 1)
                            if i not in used)
                st.replicas.append(self._start_replica(st, slot=slot))
                st.replica_slots.append(slot)
                changed = True
            while len(st.replicas) > target:
                victim = st.replicas.pop()
                slot = st.replica_slots.pop()
                # drop the slot's bookkeeping NOW: a report from the
                # still-draining victim must not resurrect the slot
                st.metrics_cache.pop(slot, None)
                st.replica_ids.pop(slot, None)
                st.started_at.pop(slot, None)
                victims.append(victim)
                changed = True
            if changed:
                st.version += 1
            drain_timeout_s = st.deployment.graceful_shutdown_timeout_s
        if changed:
            # publish FIRST so routers stop picking the victims, then
            # drain: their in-flight requests finish instead of burning
            self._publish_replicas(name)
        for victim in victims:
            self._scheduler.forget(name, victim)
            self._drain_replica(victim, drain_timeout_s)

    def _drain_replica(self, victim, timeout_s: float) -> None:
        """Deferred kill for a downscaled replica: a background thread
        polls its reported load and kills only once ongoing+queue hit
        zero (or the graceful window expires). Routers already dropped
        it at the membership publish, so the load only drains."""
        def waiter():
            deadline = time.monotonic() + max(0.0, timeout_s)
            while time.monotonic() < deadline:
                try:
                    m = ray_tpu_torch.get(victim.metrics.remote(), timeout=2)
                except Exception:
                    break           # already dead / unreachable
                if (m.get("ongoing", 0) <= 0
                        and m.get("queue_depth", 0) <= 0):
                    break
                time.sleep(0.1)
            try:
                ray_tpu_torch.kill(victim)
            except Exception:
                pass

        threading.Thread(target=waiter, daemon=True,
                         name="serve-replica-drain").start()

    def _check_health(self, name: str) -> None:
        with self._lock:
            st = self._state.get(name)
            if st is None:
                return
            now = time.monotonic()
            changed = False
            suspects = []
            for r, slot in zip(st.replicas, st.replica_slots):
                entry = st.metrics_cache.get(slot)
                # unseen slot (e.g. re-bound after controller restart):
                # start its staleness clock at this pass
                st.started_at.setdefault(slot, now)
                age = now - entry[1] if entry is not None else \
                    now - st.started_at[slot]
                if age > self._stale_after_s:
                    # no recent push: confirm before declaring it dead
                    # (a replica whose reporter died but whose executor
                    # lives should survive a health pass)
                    suspects.append((r, slot))
        dead = []
        for r, slot in suspects:
            try:
                ray_tpu_torch.get(r.ping.remote(), timeout=5)
            except Exception:
                dead.append(slot)
        with self._lock:
            if dead and st is self._state.get(name):
                # Remove ONLY the ping-confirmed dead slots from the
                # CURRENT lists — replicas added concurrently during the
                # unlocked ping window must survive.
                keep = [(r, slot)
                        for r, slot in zip(st.replicas, st.replica_slots)
                        if slot not in dead]
                st.replicas = [r for r, _ in keep]
                st.replica_slots = [slot for _, slot in keep]
                for slot in dead:
                    st.metrics_cache.pop(slot, None)
                    st.replica_ids.pop(slot, None)
                    st.started_at.pop(slot, None)
                st.version += 1
                changed = True
        if changed:
            self._publish_replicas(name)
            self._reconcile_one(name)

    # -- replica depth snapshots (routers + autoscaler) ----------------
    def _replica_depths_locked(self, st: _DeploymentState) -> List[float]:
        """Positional depth per replica — reported ongoing + engine
        queue backlog from the pushed metrics cache. A stale/unseen
        slot scores 0 (a freshly started replica must attract traffic,
        not repel it). Call under ``self._lock``."""
        now = time.monotonic()
        depths: List[float] = []
        for slot in st.replica_slots:
            entry = st.metrics_cache.get(slot)
            if entry is not None and now - entry[1] <= self._stale_after_s:
                m = entry[0]
                depths.append(float(m.get("ongoing", 0.0))
                              + float(m.get("queue_depth", 0.0)))
            else:
                depths.append(0.0)
        return depths

    def _publish_depths(self, name: str) -> None:
        """Fan the reported depths out to every handle's router on the
        ``depths::<name>`` long-poll key (once per tick, only when the
        view changed) — P2C then scores replicas by cluster-wide load,
        not just handle-local in-flight."""
        with self._lock:
            st = self._state.get(name)
            if st is None:
                return
            depths = self._replica_depths_locked(st)
            version = st.version
            slots = list(st.replica_slots)
            prev = self._depths_published.get(name)
            if prev == (version, slots, depths):
                return
            self._depths_published[name] = (version, slots, depths)
        self._long_poll.publish(f"depths::{name}",
                                {"depths": depths, "version": version})
        try:
            from ray_tpu_torch.util.metrics import Gauge
            gauge = Gauge("ray_tpu_serve_replica_depth",
                          "reported replica depth (ongoing + engine "
                          "queue) per deployment slot")
            for slot, depth in zip(slots, depths):
                gauge.set(depth, tags={"deployment": name,
                                       "slot": str(slot)})
            # a downscaled slot's series must not report its last
            # depth forever
            for slot in set(prev[1] if prev else ()) - set(slots):
                gauge.remove(tags={"deployment": name,
                                   "slot": str(slot)})
        except Exception:
            pass

    def get_depths(self, name: str) -> Dict[str, Any]:
        """Introspection: the current depth view (tests, dashboards)."""
        with self._lock:
            st = self._state.get(name)
            if st is None:
                raise KeyError(f"no deployment named {name!r}")
            return {"version": st.version,
                    "slots": list(st.replica_slots),
                    "depths": self._replica_depths_locked(st)}

    # -- autoscaling ---------------------------------------------------
    def _cluster_queue_totals(self):
        """(sum_seconds, count) of the QUEUE phase of the federated
        ``ray_tpu_task_phase_seconds`` histogram: this process's
        registry merged with every node snapshot the head holds
        (``metrics_get``; none in the in-process topology)."""
        from ray_tpu_torch.util import metrics as _metrics
        total_sum, total_cnt = 0.0, 0.0
        parts = [({}, _metrics.export_snapshot())]
        parts += _metrics._federated_parts()
        for _extra, entries in parts:
            for e in entries or []:
                if (e.get("name") != "ray_tpu_task_phase_seconds"
                        or e.get("kind") != "histogram"):
                    continue
                for key, _counts, hsum, count in e.get("hist", []):
                    if dict((str(k), v) for k, v in key).get(
                            "phase") != "queue":
                        continue
                    total_sum += hsum
                    total_cnt += count
        return total_sum, total_cnt

    def _queue_pressure_s(self) -> float:
        """Cluster-wide mean task queue-phase seconds since the last
        tick. Best-effort: any failure (no federation, no histogram
        yet, counter reset) reads as zero pressure."""
        try:
            cur = self._cluster_queue_totals()
        except Exception:
            return 0.0
        prev, self._phase_totals_prev = self._phase_totals_prev, cur
        if prev is None:
            return 0.0
        d_sum, d_cnt = cur[0] - prev[0], cur[1] - prev[1]
        if d_cnt <= 0 or d_sum < 0:
            return 0.0
        return d_sum / d_cnt

    def _autoscale_one(self, name: str) -> None:
        with self._lock:
            st = self._state.get(name)
        if st is None or st.deployment.autoscaling_config is None:
            return
        cfg = st.deployment.autoscaling_config
        # Scale signal 1: pushed per-replica DEPTH — ongoing requests
        # plus engine queue backlog; the reconcile loop never sends a
        # per-replica RPC (reference: autoscaling_state.py keeps the
        # controller-side aggregate the same way).
        with self._lock:
            total_load = sum(self._replica_depths_locked(st))
        desired = math.ceil(total_load / cfg.target_ongoing_requests) \
            if cfg.target_ongoing_requests > 0 else cfg.min_replicas
        desired = max(cfg.min_replicas, min(cfg.max_replicas, desired))
        # Scale signal 2: the head's federated metrics — while the
        # cluster-wide queue-phase latency (ray_tpu_task_phase_seconds
        # via metrics_get) stays high, a downscale is vetoed even if
        # the depth counts momentarily dipped.
        pressure = self._queue_pressure_last
        now = time.time()
        with self._lock:
            current = st.target_replicas
            st.autoscale_info = {
                "total_load": round(total_load, 2),
                "desired": desired,
                "queue_pressure_s": round(pressure, 4),
            }
            if desired > current:
                delay = cfg.upscale_delay_s
            elif desired < current:
                # the pressure signal is CLUSTER-wide: only let it veto
                # while this deployment itself still reports load, or an
                # unrelated batch sweep pins an idle deployment at peak
                if (cfg.downscale_queue_guard_s > 0
                        and pressure > cfg.downscale_queue_guard_s
                        and total_load > 0):
                    st.autoscale_info["held"] = "queue_pressure"
                    return
                delay = cfg.downscale_delay_s
            else:
                return
            if now - st.last_scale_ts < delay:
                return
            st.target_replicas = desired
            st.last_scale_ts = now
        self._reconcile_one(name)
        try:
            from ray_tpu_torch.util.metrics import Gauge
            Gauge("ray_tpu_serve_target_replicas",
                  "autoscaler target replica count").set(
                desired, tags={"deployment": name})
        except Exception:
            pass

    def _loop(self) -> None:
        while not self._stop.wait(self._tick_s):
            # The runtime can shut down underneath this daemon thread
            # (test teardown without serve.shutdown()): stop quietly
            # instead of racing replica creation against teardown.
            from ray_tpu_torch._private import worker as _worker

            rt = _worker.global_runtime()
            if rt is None or rt._shutdown or self._killed(rt):
                return
            try:
                # one federated queue-pressure sample per tick, shared
                # by every deployment's autoscale decision
                self._queue_pressure_last = self._queue_pressure_s()
                for name in list(self._state):
                    self._check_health(name)
                    self._autoscale_one(name)
                    self._publish_depths(name)
                self._compact_counter += 1
                if self._compact_counter % 20 == 0:
                    self._maybe_compact()
            except Exception:
                if _worker.global_runtime() is None:
                    return  # teardown race, not a real failure
                traceback.print_exc()

    def _killed(self, rt) -> bool:
        """True once this incarnation's actor is dead (killed, or its
        runtime gone and a new one started)."""
        from ray_tpu_torch._private.gcs import ActorState
        from ray_tpu_torch._private.ids import ActorID
        if self._actor_id is None:
            return False
        info = rt.gcs.get_actor_info(ActorID.from_hex(self._actor_id))
        return info is None or info.state == ActorState.DEAD

    def _maybe_compact(self) -> None:
        """Migrate the least-loaded node's replicas so the node can be
        released (reference: get_node_to_compact :638). One node per
        pass; the reconcile path recreates replicas elsewhere."""
        node_hex = self._scheduler.get_node_to_compact()
        if node_hex is None:
            return
        doomed = self._scheduler.replicas_on(node_hex)
        if not doomed:
            return
        by_dep = {}
        for deployment, rid in doomed:
            by_dep.setdefault(deployment, set()).add(rid)
        # keep evicted replicas off the compacted node while they are
        # re-placed (otherwise SPREAD immediately picks the now-empty
        # node and compaction churns forever)
        self._scheduler.block_node(node_hex)
        for name, rids in by_dep.items():
            with self._lock:
                st = self._state.get(name)
                if st is None:
                    continue
                keep, evict = [], []
                keep_slots = []
                for r, slot in zip(st.replicas, st.replica_slots):
                    if id(r) in rids:
                        evict.append(r)
                    else:
                        keep.append(r)
                        keep_slots.append(slot)
                if not evict:
                    continue
                st.replicas = keep
                st.replica_slots = keep_slots
                st.version += 1
            for r in evict:
                self._scheduler.forget(name, r)
                try:
                    ray_tpu_torch.kill(r)
                except Exception:
                    pass
            self._publish_replicas(name)
            self._reconcile_one(name)

    # -- introspection (handles, status API) ---------------------------
    def get_replicas(self, name: str) -> Dict[str, Any]:
        with self._lock:
            st = self._state.get(name)
            if st is None:
                raise KeyError(f"no deployment named {name!r}")
            return {"replicas": list(st.replicas), "version": st.version}

    def status(self) -> Dict[str, Any]:
        with self._lock:
            return {
                name: {
                    "target_replicas": st.target_replicas,
                    "num_replicas": len(st.replicas),
                    "version": st.version,
                    "autoscaling": st.deployment.autoscaling_config
                    is not None,
                    # last autoscale decision inputs (depth sum, the
                    # federated queue-pressure sample, any hold)
                    "autoscale": dict(st.autoscale_info),
                    # reported per-replica depth (routing view)
                    "depths": self._replica_depths_locked(st),
                    # slots with a fresh PUSHED metrics entry (replica
                    # reporter heartbeats; the controller never polls)
                    "metrics_fresh": sum(
                        1 for slot in st.replica_slots
                        if (e := st.metrics_cache.get(slot)) is not None
                        and time.monotonic() - e[1] <= self._stale_after_s),
                }
                for name, st in self._state.items()}

    def delete_deployment(self, name: str) -> None:
        with self._lock:
            st = self._state.pop(name, None)
            published = self._depths_published.pop(name, None)
        if published:
            try:
                from ray_tpu_torch.util.metrics import Gauge
                gauge = Gauge("ray_tpu_serve_replica_depth")
                for slot in published[1]:
                    gauge.remove(tags={"deployment": name,
                                       "slot": str(slot)})
            except Exception:
                pass
        self._scheduler.forget_deployment(name)
        if st:
            for r in st.replicas:
                try:
                    ray_tpu_torch.kill(r)
                except Exception:
                    pass
        self._checkpoint()
        self._long_poll.publish(f"replicas::{name}",
                                {"replicas": [], "version": 1 << 30})

    def reconfigure_deployment(self, name: str, user_config: Dict) -> None:
        with self._lock:
            st = self._state.get(name)
            if st is None:
                raise KeyError(name)
            replicas = list(st.replicas)
            st.deployment = st.deployment.options(user_config=user_config)
        ray_tpu_torch.get([r.reconfigure.remote(user_config) for r in replicas])

    def set_target_replicas(self, name: str, n: int) -> None:
        with self._lock:
            st = self._state.get(name)
            if st is None:
                raise KeyError(name)
            st.target_replicas = n
        self._reconcile_one(name)

    def shutdown(self) -> None:
        self._stop.set()
        for name in list(self._state):
            self.delete_deployment(name)

    def ping(self) -> bool:
        return True
