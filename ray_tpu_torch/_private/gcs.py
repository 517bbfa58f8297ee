"""Global Control Service: cluster-wide state and pubsub (counterpart of
``ray_tpu/_private/gcs.py``).

Node membership, the actor directory with named actors per namespace, the
internal KV, the job table, a table of live objects (the port's own: serve's
controller checkpoint) and a pubsub bus for state changes, as an in-process
service owned by the Runtime. The KV and job tables snapshot to a file and
restore from it.
"""

from __future__ import annotations

import enum
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from ray_tpu_torch._private.ids import ActorID, JobID, NodeID


class ActorState(enum.Enum):
    PENDING = "PENDING_CREATION"
    ALIVE = "ALIVE"
    RESTARTING = "RESTARTING"
    DEAD = "DEAD"


@dataclass
class ActorInfo:
    actor_id: ActorID
    name: Optional[str]
    namespace: str
    state: ActorState = ActorState.PENDING
    node_id: Optional[NodeID] = None
    num_restarts: int = 0
    max_restarts: int = 0
    max_task_retries: int = 0
    detached: bool = False
    death_cause: Optional[str] = None
    creation_spec: Any = None  # TaskSpec for restarts
    class_name: str = ""
    method_options: Dict[str, Dict[str, Any]] = field(default_factory=dict)


@dataclass
class NodeInfo:
    node_id: NodeID
    alive: bool = True
    resources: Dict[str, float] = field(default_factory=dict)
    labels: Dict[str, str] = field(default_factory=dict)
    start_time: float = field(default_factory=time.time)


@dataclass
class JobInfo:
    job_id: JobID
    start_time: float = field(default_factory=time.time)
    metadata: Dict[str, str] = field(default_factory=dict)


class Pubsub:
    """In-process pubsub bus."""

    def __init__(self):
        self._lock = threading.Lock()
        self._subs: Dict[str, List[Callable[[Any], None]]] = {}

    def subscribe(self, channel: str, cb: Callable[[Any], None]) -> None:
        with self._lock:
            self._subs.setdefault(channel, []).append(cb)

    def publish(self, channel: str, msg: Any) -> None:
        with self._lock:
            cbs = list(self._subs.get(channel, []))
        for cb in cbs:
            try:
                cb(msg)
            except Exception:
                pass    # a subscriber's fault must not fail the publisher


class GCS:
    def __init__(self):
        self._lock = threading.RLock()
        self.nodes: Dict[NodeID, NodeInfo] = {}
        self.actors: Dict[ActorID, ActorInfo] = {}
        self._named_actors: Dict[Tuple[str, str], ActorID] = {}
        self._kv: Dict[str, Dict[bytes, bytes]] = {}
        self.jobs: Dict[JobID, JobInfo] = {}
        self.pubsub = Pubsub()

    # -- nodes -------------------------------------------------------------
    def register_node(self, info: NodeInfo) -> None:
        from ray_tpu_torch._private.export_events import emit_export
        emit_export("NODE", node_id=info.node_id.hex(), state="ALIVE",
                    resources=dict(info.resources))
        with self._lock:
            self.nodes[info.node_id] = info
        self.pubsub.publish("node", ("added", info.node_id))

    def mark_node_dead(self, node_id: NodeID) -> None:
        with self._lock:
            info = self.nodes.get(node_id)
            if info is None or not info.alive:
                return   # duplicate/unknown: no event, no publish
            info.alive = False
        from ray_tpu_torch._private.export_events import emit_export
        emit_export("NODE", node_id=node_id.hex(), state="DEAD")
        self.pubsub.publish("node", ("removed", node_id))

    def alive_nodes(self) -> List[NodeInfo]:
        with self._lock:
            return [n for n in self.nodes.values() if n.alive]

    # -- actors ------------------------------------------------------------
    def register_actor_or_get_existing(self, info: ActorInfo):
        """Atomic get_if_exists: returns existing live ActorID or registers.

        Returns (actor_id, created).
        """
        with self._lock:
            existing_id = self._live_named_actor_locked(info.namespace,
                                                        info.name)
            if existing_id is not None:
                return existing_id, False
            self._register_actor_locked(info)
            return info.actor_id, True

    def _live_named_actor_locked(self, namespace: str,
                                 name: Optional[str]):
        if not name:
            return None
        existing_id = self._named_actors.get((namespace, name))
        if existing_id is None:
            return None
        existing = self.actors.get(existing_id)
        if existing is not None and existing.state != ActorState.DEAD:
            return existing_id
        return None

    def register_actor(self, info: ActorInfo) -> None:
        with self._lock:
            self._register_actor_locked(info)

    def _register_actor_locked(self, info: ActorInfo) -> None:
        if info.name:
            if self._live_named_actor_locked(info.namespace,
                                             info.name) is not None:
                raise ValueError(
                    f"actor name {info.name!r} already taken in "
                    f"namespace {info.namespace!r}")
            self._named_actors[(info.namespace, info.name)] = info.actor_id
        self.actors[info.actor_id] = info

    def update_actor_state(self, actor_id: ActorID, state: ActorState,
                           node_id: Optional[NodeID] = None,
                           death_cause: Optional[str] = None) -> None:
        with self._lock:
            info = self.actors.get(actor_id)
            if info is None:
                return
            info.state = state
            if node_id is not None:
                info.node_id = node_id
            if death_cause is not None:
                info.death_cause = death_cause
            if state == ActorState.DEAD and info.name:
                self._named_actors.pop((info.namespace, info.name), None)
        from ray_tpu_torch._private.export_events import emit_export
        emit_export("ACTOR", actor_id=actor_id.hex(), state=str(state),
                    death_cause=death_cause)
        self.pubsub.publish("actor", (actor_id, state))

    def get_actor_info(self, actor_id: ActorID) -> Optional[ActorInfo]:
        with self._lock:
            return self.actors.get(actor_id)

    def get_named_actor(self, name: str, namespace: str) -> Optional[ActorID]:
        with self._lock:
            return self._named_actors.get((namespace, name))

    def list_named_actors(self, all_namespaces: bool = False,
                          namespace: str = "") -> List[Dict[str, str]]:
        with self._lock:
            out = []
            for (ns, name), _aid in self._named_actors.items():
                if all_namespaces or ns == namespace:
                    out.append({"name": name, "namespace": ns})
            return out

    # -- persistence: the KV and job tables to a file and back ------------
    def snapshot(self, path: str) -> str:
        """Write every namespace's KV table and the job table to ``path``,
        read under the lock: a stdlib pickle of plain data (a job is its id's
        bytes and its fields), which ``restore`` reads refusing any global,
        as the wire does."""
        from ray_tpu_torch._private.rpc import dumps_frame
        with self._lock:
            payload = {"kv": {ns: dict(t) for ns, t in self._kv.items()},
                       "jobs": {jid.binary(): {"start_time": j.start_time,
                                               "metadata": dict(j.metadata)}
                                for jid, j in self.jobs.items()}}
        with open(path, "wb") as f:
            f.write(dumps_frame(payload))
        return path

    def restore(self, path: str) -> None:
        """Load a ``snapshot``: the KV tables are replaced, the jobs merged
        into the job table."""
        from ray_tpu_torch._private.rpc import loads_frame
        with open(path, "rb") as f:
            payload = loads_frame(f.read())
        jobs = {JobID(raw): JobInfo(JobID(raw), **fields)
                for raw, fields in payload.get("jobs", {}).items()}
        with self._lock:
            self._kv = {ns: dict(t) for ns, t in payload["kv"].items()}
            self.jobs.update(jobs)

    # -- internal KV (function table, collective rendezvous) ---------------
    def kv_put(self, key: bytes, value: bytes, overwrite: bool = True,
               namespace: bytes = b"") -> bool:
        ns = namespace.decode() if isinstance(namespace, bytes) else namespace
        with self._lock:
            table = self._kv.setdefault(ns, {})
            if not overwrite and key in table:
                return False
            table[key] = value
            return True

    def kv_get(self, key: bytes, namespace: bytes = b"") -> Optional[bytes]:
        ns = namespace.decode() if isinstance(namespace, bytes) else namespace
        with self._lock:
            return self._kv.get(ns, {}).get(key)

    def kv_del(self, key: bytes, namespace: bytes = b"") -> None:
        ns = namespace.decode() if isinstance(namespace, bytes) else namespace
        with self._lock:
            self._kv.get(ns, {}).pop(key, None)

    def kv_keys(self, prefix: bytes = b"", namespace: bytes = b"") -> List[bytes]:
        ns = namespace.decode() if isinstance(namespace, bytes) else namespace
        with self._lock:
            return [k for k in self._kv.get(ns, {}) if k.startswith(prefix)]

    def kv_exists(self, key: bytes, namespace: bytes = b"") -> bool:
        return self.kv_get(key, namespace) is not None
