"""Head control-plane process, the GCS-server equivalent (counterpart of
``ray_tpu/_private/head.py``).

Spawned as its own OS process (``python -m ray_tpu_torch._private.head``);
every interaction is a typed RPC of the port's wire
(``_private/rpc.py``). The head holds cluster state only: the node
directory, health, the KV and pubsub. Object ownership, scheduling
authority and lineage stay with the single controller (the driver), and
the card's data never crosses this process.

Services:
- NodeInfo: register_node / heartbeat / list_nodes / mark_node_dead /
  drain_node; a monitor thread marks nodes dead after
  ``node_dead_after_s`` without a heartbeat and publishes a ``death``
  event on the ``node`` channel (active health checking).
  ``drain_node(node_id, deadline_s, reason)`` moves a node to the
  DRAINING state (alive, no new placements) and publishes a ``drain``
  event so drivers migrate work off it; the monitor escalates to the
  death path when the deadline expires. A node declared dead may NOT re-register
  under the same id (zombie fencing, the heartbeat ``{"dead": True}``
  contract); each registration mints a higher fencing epoch.
- InternalKV: kv_put / kv_get / kv_del / kv_keys (bytes in, bytes out).
- Pubsub: subscribe(channel, cursor) parks the request (long-poll HOLD);
  publish completes every parked subscriber with the event batch.
- Resource views: report_resources (the driver's availability) and
  report_loads_gossip (the daemons' converged peer view).

- Task events: task_events_push (the driver's flusher) and the spans a
  daemon's heartbeat carries land in one store, read by task_events_get
  (the state API's post-mortem readers, the merged timeline). A daemon's
  spans are shifted by that node's clock offset (head wall minus daemon
  wall at the beat) on ingestion, and each carries its ``clock_off``.
- Federation: each heartbeat may carry the daemon's absolute metric
  snapshot and its cumulative profile payload; the head keeps the latest
  of each per node (replace, so a re-sent beat never double-counts) for
  metrics_get and profile_get.

Fault tolerance: with ``--state-path`` the KV table, the pubsub logs, the
nodes' epochs, the drain records and the task events (capped at 100,000
rows) are written through to sqlite (rows in the wire's encoding), so a
head respawned after a SIGKILL resumes with the same KV, valid pubsub
cursors, monotonic epochs, its drains (a draining daemon that re-registers
gets its DRAINING state back with the remaining window) and its task
events. Membership and the federated snapshots are not persisted: live
daemons re-register, and re-send both, on their next heartbeats.

Tenancy: the head is the durable store of the per-job quota and weight
records the drivers' admission sets (``tenancy_set``/``tenancy_get``,
persisted like the drains), and takes each driver's per-job usage report
(``tenancy_report``, replace semantics).
"""

from __future__ import annotations

import argparse
import os
import sqlite3
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch._private import failpoints as _fp
from ray_tpu_torch._private import rpc
from ray_tpu_torch._private.lock_sanitizer import tracked_lock
from ray_tpu_torch._private.rpc import HOLD, Client, Connection, declare


def _hb_interval() -> float:
    from ray_tpu_torch._private.config import cfg
    return cfg().heartbeat_interval_s


def _dead_after() -> float:
    from ray_tpu_torch._private.config import cfg
    return cfg().node_dead_after_s


declare("register_node", "node_id", "resources", "labels", "addr")
declare("heartbeat", "node_id", "available", "epoch")
declare("list_nodes")
declare("mark_node_dead", "node_id", "reason")
declare("drain_node", "node_id", "deadline_s", "reason")
declare("kv_put", "key", "value", "overwrite", "ns")
declare("kv_get", "key", "ns")
declare("kv_del", "key", "ns")
declare("kv_keys", "prefix", "ns")
declare("subscribe", "channel", "cursor")
declare("publish", "channel", "event")
declare("report_resources", "loads")
declare("report_loads_gossip", "view")
declare("task_events_push", "events")
declare("task_events_get", "job_id", "name", "limit")
# tenancy: persisted per-job quota/weight records (the admission
# authority's durable store) and per-job accounting federation
declare("tenancy_set", "job_id", "record")
declare("tenancy_get")
declare("tenancy_report", "jobs")
declare("metrics_get")
declare("profile_get")
declare("head_stop")

# High-frequency gossip channels: never persisted, log trimmed to a window
# (the stream carries the latest views, not history).
TRANSIENT_CHANNELS = {"resources"}
TRANSIENT_WINDOW = 200


class _NodeEntry:
    __slots__ = ("node_id", "resources", "labels", "addr", "alive",
                 "last_beat", "available", "reason", "avail_gossip_ts",
                 "draining", "drain_deadline", "drain_reason", "epoch")

    def __init__(self, node_id: str, resources: Dict[str, float],
                 labels: Dict[str, str], addr: Tuple[str, int]):
        self.node_id = node_id
        self.resources = resources
        self.labels = labels
        self.addr = addr
        self.alive = True
        self.last_beat = time.monotonic()
        self.available = dict(resources)
        self.reason = ""
        self.avail_gossip_ts = 0.0   # last driver report for this node
        # graceful drain: alive + draining = no NEW placements, running
        # work may finish; past drain_deadline the monitor escalates
        self.draining = False
        self.drain_deadline = 0.0    # monotonic
        self.drain_reason = ""
        # fencing epoch minted at register_node; a frame stamped with a
        # LOWER epoch comes from a pre-death incarnation
        self.epoch = 0

    def view(self) -> Dict[str, Any]:
        return {"node_id": self.node_id, "resources": self.resources,
                "labels": self.labels, "addr": list(self.addr),
                "alive": self.alive, "available": self.available,
                "epoch": self.epoch, "reason": self.reason,
                "draining": self.draining,
                "drain_reason": self.drain_reason,
                "drain_deadline_s": (
                    max(0.0, self.drain_deadline - time.monotonic())
                    if self.draining else 0.0)}


class _HeadStore:
    """Write-through sqlite persistence for head state (rows hold the
    wire's encoding of each value)."""

    def __init__(self, path: str):
        self._db = sqlite3.connect(path, check_same_thread=False)
        self._db.execute("PRAGMA journal_mode=WAL")
        # Writes happen under the HeadService lock: per-op fsync there
        # would stall every head RPC (heartbeats too) behind disk. WAL +
        # synchronous=NORMAL keeps commits memory-speed, and the WAL still
        # survives a crash of the head process (the case replayed here).
        self._db.execute("PRAGMA synchronous=NORMAL")
        self._db.execute(
            "CREATE TABLE IF NOT EXISTS kv (key BLOB PRIMARY KEY, "
            "value BLOB)")
        self._db.execute(
            "CREATE TABLE IF NOT EXISTS events (channel TEXT, idx INTEGER, "
            "event BLOB, PRIMARY KEY(channel, idx))")
        # the task-event store: state transitions and spans buffered by
        # drivers and daemons, so the state API and the timeline outlive
        # the driver. Bounded by row count.
        self._db.execute(
            "CREATE TABLE IF NOT EXISTS task_events ("
            "seq INTEGER PRIMARY KEY AUTOINCREMENT, "
            "task_id TEXT, name TEXT, event TEXT, job_id TEXT, "
            "wall_ts REAL, payload BLOB)")
        self._db.commit()

    def append_task_events(self, events: List[Dict[str, Any]],
                           max_rows: int) -> None:
        self._db.executemany(
            "INSERT INTO task_events "
            "(task_id, name, event, job_id, wall_ts, payload) "
            "VALUES (?, ?, ?, ?, ?, ?)",
            [(ev.get("task_id", ""), ev.get("name", ""),
              ev.get("event", ""), ev.get("job_id", ""),
              ev.get("wall_ts", 0.0), rpc.dumps_frame(ev))
             for ev in events])
        # bounded: drop the oldest rows past the cap (one statement)
        self._db.execute(
            "DELETE FROM task_events WHERE seq <= ("
            "SELECT MAX(seq) FROM task_events) - ?", (max_rows,))
        self._db.commit()

    def get_task_events(self, job_id: str = "", name: str = "",
                        limit: int = 10_000) -> List[Dict[str, Any]]:
        q = "SELECT payload FROM task_events"
        cond, args = [], []
        if job_id:
            cond.append("job_id = ?")
            args.append(job_id)
        if name:
            cond.append("name = ?")
            args.append(name)
        if cond:
            q += " WHERE " + " AND ".join(cond)
        q += " ORDER BY seq DESC LIMIT ?"
        args.append(int(limit))
        out = [rpc.loads_frame(r[0])
               for r in self._db.execute(q, args).fetchall()]
        out.reverse()
        return out

    def load(self) -> Tuple[Dict[bytes, bytes], Dict[str, List[Any]]]:
        kv = {bytes(k): bytes(v) for k, v in
              self._db.execute("SELECT key, value FROM kv")}
        events: Dict[str, List[Any]] = {}
        for chan, _idx, blob in self._db.execute(
                "SELECT channel, idx, event FROM events "
                "ORDER BY channel, idx"):
            events.setdefault(chan, []).append(rpc.loads_frame(blob))
        return kv, events

    def put(self, key: bytes, value: bytes) -> None:
        self._db.execute("INSERT OR REPLACE INTO kv VALUES (?, ?)",
                         (key, value))
        self._db.commit()

    def delete(self, key: bytes) -> None:
        self._db.execute("DELETE FROM kv WHERE key = ?", (key,))
        self._db.commit()

    def append_event(self, channel: str, idx: int, event: Any) -> None:
        self._db.execute(
            "INSERT OR REPLACE INTO events VALUES (?, ?, ?)",
            (channel, idx, rpc.dumps_frame(event)))
        self._db.commit()

    def close(self) -> None:
        try:
            self._db.close()
        except sqlite3.Error:
            pass


# The clock-offset estimate is the least offset of a node's last this-many
# heartbeats (about 10 s at the 0.2 s default period).
_CLOCK_BEATS = 50

# Per-node fencing epochs persist in the kv table under this raw prefix.
# Client-visible keys are stored as ``ns + b":" + key`` and so always hold
# a colon: a colon-free prefix never collides with (or leaks into) any
# namespace's kv_get/kv_keys view. Epochs must stay monotonic across head
# restarts, or a healed pre-restart zombie could stamp frames the fence
# accepts.
_EPOCH_KEY = b"\x00epoch\x00"
# Drain records persist under the same colon-free raw-prefix scheme, each
# row a frame of the wire's encoding ({"deadline_wall", "reason"}).
_DRAIN_KEY = b"\x00drain\x00"
# Per-job tenancy records (quota/weight) persist the same way: a state
# path survives a head respawn, so quotas outlive both the head process
# and the driver that set them.
_TENANCY_KEY = b"\x00tenancy\x00"


class HeadService:
    def __init__(self, state_path: Optional[str] = None,
                 parent_pid: Optional[int] = None):
        self._lock = tracked_lock("head.state", reentrant=False)
        self._nodes: Dict[str, _NodeEntry] = {}  #: guarded by self._lock
        self._kv: Dict[bytes, bytes] = {}        #: guarded by self._lock
        # pubsub: channel -> event log, and the parked subscriber conns
        self._events: Dict[str, List[Any]] = {}  #: guarded by self._lock
        #: guarded by self._lock
        self._bases: Dict[str, int] = {}   # trimmed-channel log offsets
        #: guarded by self._lock
        self._parked: Dict[str, List[Tuple[Connection, int, int]]] = {}
        self._store: Optional[_HeadStore] = None
        self._state_path = state_path
        # the driver that spawned this head: once it is gone (reparented),
        # the session is over and the head exits, as its daemons do
        self._parent_pid = parent_pid
        # per-node load entries converged via daemon peer gossip
        # (report_loads_gossip); versioned like the daemons' own views
        self._gossip_loads: Dict[str, Dict[str, Any]] = {}  #: guarded by self._lock
        # node_id -> last minted fencing epoch (persisted)
        self._node_epochs: Dict[str, int] = {}  #: guarded by self._lock
        # node_id -> (wall-clock deadline, reason): drains survive a head
        # restart (membership does not, so a record re-attaches when the
        # draining daemon re-registers after the respawn)
        self._drains: Dict[str, Tuple[float, str]] = {}  #: guarded by self._lock
        # tenancy: job -> {"weight": .., "quota": {"hard": .., "soft": ..}}
        # (persisted), and job -> the latest reported usage row (each
        # driver's report replaces its previous one)
        self._tenancy: Dict[str, Dict[str, Any]] = {}  #: guarded by self._lock
        self._tenancy_usage: Dict[str, Dict[str, Any]] = {}  #: guarded by self._lock
        # the task-event store: sqlite with a state path, a bounded ring
        # in memory otherwise
        self._task_events_cap = 100_000
        self._task_events: Any = deque(maxlen=self._task_events_cap)  #: guarded by self._lock
        # federation: node_id -> the latest absolute metric snapshot and
        # the latest cumulative profile payload off that daemon's
        # heartbeats (replace semantics), and the node's clock offset
        # (head wall - daemon wall) estimated from the same beats
        self._node_metrics: Dict[str, List[Dict[str, Any]]] = {}  #: guarded by self._lock
        self._node_profiles: Dict[str, Dict[str, Any]] = {}  #: guarded by self._lock
        # node_id -> the raw offsets of its last beats: the applied offset
        # is their least (see handle_heartbeat)
        self._node_clock_off: Dict[str, Any] = {}  #: guarded by self._lock
        if state_path:
            self._store = _HeadStore(state_path)
            self._kv, self._events = self._store.load()
            for key in [k for k in self._kv if k.startswith(_DRAIN_KEY)]:
                blob = self._kv.pop(key)
                try:
                    rec = rpc.loads_frame(blob)
                    self._drains[key[len(_DRAIN_KEY):].decode()] = (
                        float(rec["deadline_wall"]), str(rec["reason"]))
                except Exception:
                    # a malformed record must not keep the head down
                    self._store.delete(key)
            for key in [k for k in self._kv
                        if k.startswith(_TENANCY_KEY)]:
                blob = self._kv.pop(key)
                try:
                    self._tenancy[key[len(_TENANCY_KEY):].decode()] = (
                        rpc.loads_frame(blob))
                except Exception:
                    self._store.delete(key)
            for key in [k for k in self._kv if k.startswith(_EPOCH_KEY)]:
                blob = self._kv.pop(key)
                try:
                    self._node_epochs[key[len(_EPOCH_KEY):].decode()] = (
                        int(blob))
                except ValueError:
                    self._store.delete(key)
        self._stop = threading.Event()
        self._monitor = threading.Thread(target=self._health_loop,
                                         daemon=True, name="head-health")
        self._monitor.start()

    # -- node membership / health ---------------------------------------
    def handle_register_node(self, conn, rid, msg):
        node_id = msg["node_id"]
        entry = _NodeEntry(node_id, msg["resources"],
                           msg["labels"], tuple(msg["addr"]))
        with self._lock:
            cur = self._nodes.get(node_id)
            if cur is not None and not cur.alive:
                # Zombie fencing: this node was declared dead (the death is
                # published, owners already recovered its work); a
                # re-registration would resurrect it with stale state.
                return {"ok": False, "dead": True, "reason": cur.reason}
            drain = self._drains.get(node_id)
            if drain is not None:
                # a drain survived a head restart: re-attach it with the
                # remaining wall-clock window
                entry.draining = True
                entry.drain_deadline = time.monotonic() + max(
                    0.0, drain[0] - time.time())
                entry.drain_reason = drain[1]
            # a monotonic fencing epoch for this incarnation: bumped on
            # every register, persisted so it survives a head respawn
            epoch = self._node_epochs.get(node_id, 0) + 1
            self._node_epochs[node_id] = epoch
            entry.epoch = epoch
            if self._store is not None:
                self._store.put(_EPOCH_KEY + node_id.encode(),
                                str(epoch).encode())
            self._nodes[node_id] = entry
        conn.meta["node_id"] = node_id
        conn.link("daemon", node_id)
        self._publish("node", {"kind": "added", "node": entry.view()})
        if entry.draining:
            # re-announce so a (re)subscribed driver resumes the migration
            self._publish("node", {
                "kind": "drain", "node_id": node_id,
                "deadline_s": max(0.0, entry.drain_deadline
                                  - time.monotonic()),
                "reason": entry.drain_reason})
        return {"ok": True, "draining": entry.draining,
                "epoch": entry.epoch}

    def handle_heartbeat(self, conn, rid, msg):
        node_id = msg["node_id"]
        # clock-offset estimate, applied to every span the daemon flushes
        # so the merged timeline shares one timebase: head wall - daemon
        # wall at receipt is the skew plus the beat's transit and queueing,
        # which only adds and varies beat to beat (milliseconds on a
        # loaded host, enough to reorder two phases flushed on two beats).
        # The least offset of the node's last beats is the estimate (JAX
        # applies each beat's own).
        off = 0.0
        wall = float(msg.get("wall_ts") or 0.0)
        raw = time.time() - wall if wall else 0.0
        with self._lock:
            entry = self._nodes.get(node_id)
            if entry is None:
                return {"ok": False, "unknown": True}
            ep = msg.get("epoch")
            if ep and entry.epoch and ep < entry.epoch:
                # stale-epoch beat: a newer incarnation of this node_id has
                # registered since; the zombie must exit, and its beat
                # must not refresh the live incarnation's liveness
                return {"ok": False, "dead": True, "stale_epoch": True}
            entry.last_beat = time.monotonic()
            # The daemon's heartbeat carries its STATIC resources; the
            # driver's report carries the true availability. The report
            # wins while fresh; heartbeats repopulate once the reporting
            # driver goes quiet (left or crashed).
            if time.monotonic() - entry.avail_gossip_ts > 2.0:
                entry.available = msg["available"]
            was_dead = not entry.alive
            draining = entry.draining
            if wall:
                recent = self._node_clock_off.setdefault(
                    node_id, deque(maxlen=_CLOCK_BEATS))
                recent.append(raw)
                off = min(recent)
            snapshot = msg.get("metrics")
            if snapshot is not None:
                self._node_metrics[node_id] = snapshot
            profile = msg.get("profile")
            if profile is not None:
                self._node_profiles[node_id] = profile
        if was_dead:
            # a heartbeat from a node declared dead: tell it to exit
            return {"ok": False, "dead": True}
        events = msg.get("events") or []
        if events:
            for ev in events:
                if off:
                    ev["wall_ts"] = ev.get("wall_ts", 0.0) + off
                    if "start_wall" in ev:
                        ev["start_wall"] = ev["start_wall"] + off
                ev["clock_off"] = off
                ev.setdefault("node_id", node_id)
            self._ingest_task_events(events)
        return {"ok": True, "draining": draining}

    def handle_metrics_get(self, conn, rid, msg):
        """The federated per-node metric snapshots (daemon heartbeats)."""
        with self._lock:
            return {"nodes": dict(self._node_metrics)}

    def handle_profile_get(self, conn, rid, msg):
        """The federated per-node profile payloads (daemon heartbeats) and
        the head's own continuous-sampler record."""
        with self._lock:
            nodes = dict(self._node_profiles)
        from ray_tpu_torch.util import profiling
        return {"nodes": nodes, "head": profiling.process_profile()}

    # -- task events ------------------------------------------------------
    def _ingest_task_events(self, events: List[Dict[str, Any]]) -> None:
        with self._lock:
            if self._store is not None:
                self._store.append_task_events(events,
                                               self._task_events_cap)
            else:
                self._task_events.extend(events)

    def handle_task_events_push(self, conn, rid, msg):
        events = msg["events"]
        self._ingest_task_events(events)
        return {"ok": True, "count": len(events)}

    def handle_task_events_get(self, conn, rid, msg):
        job_id = msg.get("job_id") or ""
        name = msg.get("name") or ""
        limit = int(msg.get("limit") or 10_000)
        with self._lock:
            if self._store is not None:
                out = self._store.get_task_events(job_id, name, limit)
            else:
                out = [ev for ev in self._task_events
                       if (not job_id or ev.get("job_id") == job_id)
                       and (not name or ev.get("name") == name)]
                out = out[-limit:]
        return {"events": out}

    def handle_list_nodes(self, conn, rid, msg):
        with self._lock:
            nodes = [e.view() for e in self._nodes.values()]
            for n in nodes:
                g = self._gossip_loads.get(n["node_id"])
                if g is not None:
                    n["gossip_load"] = g["load"]
                    n["gossip_version"] = g["v"]
            return {"nodes": nodes}

    def handle_drain_node(self, conn, rid, msg):
        """Graceful drain: keep the node alive but DRAINING, so running
        work can finish and drivers migrate objects and actors off it, and
        publish ``drain``; the health monitor escalates to the death path
        when ``deadline_s`` expires."""
        node_id = msg["node_id"]
        deadline_s = max(0.0, float(msg.get("deadline_s") or 0.0))
        reason = msg.get("reason") or "drain"
        with self._lock:
            entry = self._nodes.get(node_id)
            if entry is None or not entry.alive:
                return {"ok": False, "unknown": True}
            if entry.draining:
                # idempotent: the first drain's deadline stands
                return {"ok": True, "already": True}
            entry.draining = True
            entry.drain_deadline = time.monotonic() + deadline_s
            entry.drain_reason = reason
            self._drains[node_id] = (time.time() + deadline_s, reason)
            if self._store is not None:
                self._store.put(_DRAIN_KEY + node_id.encode(),
                                rpc.dumps_frame({
                                    "deadline_wall": time.time()
                                    + deadline_s,
                                    "reason": reason}))
        self._publish("node", {"kind": "drain", "node_id": node_id,
                               "deadline_s": deadline_s,
                               "reason": reason})
        return {"ok": True}

    def handle_mark_node_dead(self, conn, rid, msg):
        # the driver observed a daemon failure first-hand (an RPC error)
        # and reports it before the health window elapses
        self._mark_dead(msg["node_id"], msg["reason"])
        return {"ok": True}

    def _mark_dead(self, node_id: str, reason: str,
                   drain_expired: bool = False) -> None:
        with self._lock:
            entry = self._nodes.get(node_id)
            if entry is None or not entry.alive:
                return
            entry.alive = False
            entry.reason = reason
            was_draining = entry.draining
            entry.draining = False
            self._drains.pop(node_id, None)
            if self._store is not None:
                self._store.delete(_DRAIN_KEY + node_id.encode())
        self._publish("node", {"kind": "death", "node_id": node_id,
                               "reason": reason,
                               "was_draining": was_draining,
                               "drain_expired": drain_expired})

    def _health_loop(self) -> None:
        while not self._stop.wait(_hb_interval()):
            if (self._parent_pid is not None
                    and os.getppid() != self._parent_pid):
                self._exit_orphaned()
            now = time.monotonic()
            window = _dead_after()
            dead: List[str] = []
            expired: List[str] = []
            with self._lock:
                for entry in self._nodes.values():
                    if not entry.alive:
                        continue
                    if now - entry.last_beat > window:
                        dead.append(entry.node_id)
                    elif entry.draining and now > entry.drain_deadline:
                        expired.append(entry.node_id)
            for node_id in dead:
                self._mark_dead(node_id, "missed heartbeats")
            for node_id in expired:
                # escalation: the drain window closed with the node still
                # up; lineage covers whatever did not migrate in time
                self._mark_dead(node_id, "drain deadline expired",
                                drain_expired=True)

    def _exit_orphaned(self) -> None:
        """The driver died without head_stop: drop the state file (no
        driver is left to respawn a head on it) and exit."""
        self._stop.set()
        with self._lock:
            if self._store is not None:
                self._store.close()
            if self._state_path:
                for suffix in ("", "-wal", "-shm", "-journal"):
                    try:
                        os.unlink(self._state_path + suffix)
                    except OSError:
                        pass
                try:
                    os.rmdir(os.path.dirname(self._state_path))
                except OSError:
                    pass        # not empty: a daemon's files remain
        os._exit(0)

    def on_disconnect(self, conn: Connection) -> None:
        node_id = conn.meta.get("node_id")
        if node_id:
            self._mark_dead(node_id, "connection lost")
        # drop parked long-polls from this conn
        with self._lock:
            for parked in self._parked.values():
                parked[:] = [p for p in parked if p[0] is not conn]

    # -- tenancy: the quota store and per-job accounting federation ------
    def handle_tenancy_set(self, conn, rid, msg):
        """Upsert one job's quota/weight record (persisted)."""
        job = str(msg["job_id"])
        record = msg.get("record") or {}
        with self._lock:
            self._tenancy[job] = record
            if self._store is not None:
                self._store.put(_TENANCY_KEY + job.encode(),
                                rpc.dumps_frame(record))
        return {"ok": True}

    def handle_tenancy_get(self, conn, rid, msg):
        """All job records, with the latest federated usage merged in."""
        with self._lock:
            jobs = {j: dict(r) for j, r in self._tenancy.items()}
            for j, usage in self._tenancy_usage.items():
                jobs.setdefault(j, {})["usage"] = usage
        return {"jobs": jobs}

    def handle_tenancy_report(self, conn, rid, msg):
        """Per-job accounting federation (replace semantics per job)."""
        jobs = msg.get("jobs") or {}
        with self._lock:
            for j, row in jobs.items():
                self._tenancy_usage[str(j)] = row
        return {"ok": True, "count": len(jobs)}

    # -- internal KV -----------------------------------------------------
    def handle_kv_put(self, conn, rid, msg):
        if _fp.ENABLED:
            # crash arm = the head dies mid-put (the respawn and redial
            # drill); an error arm is a RemoteError at the caller
            _fp.fire("head.kv_put")
        key = msg["ns"] + b":" + msg["key"]
        with self._lock:
            if not msg["overwrite"] and key in self._kv:
                return {"added": False}
            self._kv[key] = msg["value"]
            if self._store is not None:
                self._store.put(key, msg["value"])
        return {"added": True}

    def handle_kv_get(self, conn, rid, msg):
        with self._lock:
            value = self._kv.get(msg["ns"] + b":" + msg["key"])
        return {"value": value}

    def handle_kv_del(self, conn, rid, msg):
        key = msg["ns"] + b":" + msg["key"]
        with self._lock:
            self._kv.pop(key, None)
            if self._store is not None:
                self._store.delete(key)
        return {"ok": True}

    def handle_kv_keys(self, conn, rid, msg):
        pre = msg["ns"] + b":" + msg["prefix"]
        nslen = len(msg["ns"]) + 1
        with self._lock:
            keys = [k[nslen:] for k in self._kv if k.startswith(pre)]
        return {"keys": keys}

    # -- long-poll pubsub -------------------------------------------------
    def handle_subscribe(self, conn, rid, msg):
        """Long-poll: reply at once if the cursor is behind, else park
        until the next publish."""
        channel, cursor = msg["channel"], msg["cursor"]
        with self._lock:
            log = self._events.setdefault(channel, [])
            base = self._bases.get(channel, 0)
            total = base + len(log)
            if cursor < total:
                start = max(0, cursor - base)  # trimmed past: skip ahead
                return {"events": log[start:], "cursor": total}
            self._parked.setdefault(channel, []).append(
                (conn, rid, cursor))
        return HOLD

    def _publish(self, channel: str, event: Any) -> None:
        if _fp.ENABLED and _fp.fire("head.pubsub_publish",
                                    channel=channel) is _fp.DROP:
            return      # event lost before the log (subscribers starve)
        with self._lock:
            log = self._events.setdefault(channel, [])
            log.append(event)
            if channel in TRANSIENT_CHANNELS:
                if len(log) > TRANSIENT_WINDOW:  # keep only the window
                    drop = len(log) - TRANSIENT_WINDOW
                    del log[:drop]
                    self._bases[channel] = \
                        self._bases.get(channel, 0) + drop
            elif self._store is not None:
                self._store.append_event(channel, len(log) - 1, event)
            parked = self._parked.pop(channel, [])
            base = self._bases.get(channel, 0)
            cursor = base + len(log)
            batches = [(conn, rid, log[max(0, start - base):])
                       for conn, rid, start in parked]
        for conn, rid, events in batches:
            conn.reply(rid, events=events, cursor=cursor)

    def handle_publish(self, conn, rid, msg):
        self._publish(msg["channel"], msg["event"])
        return {"ok": True}

    # -- resource views ---------------------------------------------------
    def handle_report_resources(self, conn, rid, msg):
        """The scheduling authority (the driver) pushes per-node
        availability; the head updates its membership view and
        re-broadcasts on the transient 'resources' channel."""
        updated = {}
        with self._lock:
            for node_hex, avail in msg["loads"].items():
                entry = self._nodes.get(node_hex)
                if entry is not None and entry.alive:
                    entry.available = dict(avail)
                    entry.avail_gossip_ts = time.monotonic()
                    updated[node_hex] = dict(avail)
        if updated:
            self._publish("resources", {"available": updated})
        return {"ok": True}

    def handle_report_loads_gossip(self, conn, rid, msg):
        """Peer-gossip ingestion: one node per gossip interval pushes the
        cluster-wide view it converged on, so the head's inbound report
        rate is O(1) in cluster size."""
        with self._lock:
            for node_hex, entry in msg["view"].items():
                cur = self._gossip_loads.get(node_hex)
                if cur is None or entry["v"] > cur["v"]:
                    self._gossip_loads[node_hex] = dict(entry)
        return {"ok": True}

    def handle_head_stop(self, conn, rid, msg):
        self._stop.set()
        threading.Thread(target=lambda: (time.sleep(0.1), os._exit(0)),
                         daemon=True).start()
        return {"ok": True}


class HeadClient:
    """Typed client for the head's services, with background subscribers.

    ``reconnect_window`` > 0 makes every call re-dial the head for up to
    that many seconds on transport failure: the driver's and the daemons'
    path across a head restart."""

    def __init__(self, addr: Tuple[str, int], reconnect_window: float = 0.0):
        self._client = rpc.connect(addr).link("head")
        self.addr = tuple(addr)
        self._reconnect_window = reconnect_window
        self._dial_lock = threading.Lock()
        self._sub_stop = threading.Event()
        self._sub_threads: List[threading.Thread] = []
        # live per-channel subscriber connections, tracked so close() can
        # close them (a parked long-poll otherwise holds its socket open)
        self._sub_clients: List[Client] = []  #: guarded by self._sub_lock
        self._sub_lock = threading.Lock()
        self._retry_policy = None   # built lazily; immutable once made

    def _redial(self) -> None:
        with self._dial_lock:
            if not self._client.dead:
                return
            # raises OSError while the head is down; the lock makes
            # concurrent callers wait for ONE reconnect
            client = rpc.connect(self.addr).link("head")  # raylint: disable=blocking-under-lock
            old, self._client = self._client, client
            old.close()

    def _call(self, method: str, timeout: Optional[float] = None, **kw):
        if self._reconnect_window <= 0:
            return self._client.call(method, timeout=timeout, **kw)
        if self._retry_policy is None:
            # built once: cfg() reads must not ride every head RPC
            from ray_tpu_torch._private.retry import RetryPolicy
            self._retry_policy = RetryPolicy.default(
                deadline_s=self._reconnect_window)

        def attempt():
            try:
                # the client may have been swapped by a redial
                return self._client.call(method, timeout=timeout, **kw)
            except rpc.RpcError:
                try:
                    self._redial()
                except OSError:
                    pass        # head still down: the next attempt retries
                raise

        return self._retry_policy.run(
            attempt, loop="head.redial", retry_on=(rpc.RpcError,))

    # node info
    def register_node(self, node_id: str, resources: Dict[str, float],
                      labels: Dict[str, str], addr: Tuple[str, int]):
        return self._call("register_node", node_id=node_id,
                          resources=resources, labels=labels,
                          addr=list(addr))

    def heartbeat(self, node_id: str, available: Dict[str, float],
                  epoch: int = 0, wall_ts: float = 0.0,
                  events: Optional[List[Dict[str, Any]]] = None,
                  metrics: Optional[List[Dict[str, Any]]] = None,
                  profile: Optional[Dict[str, Any]] = None):
        return self._call("heartbeat", node_id=node_id,
                          available=available, epoch=epoch,
                          wall_ts=wall_ts, events=events or [],
                          metrics=metrics, profile=profile, timeout=5.0)

    def metrics_get(self) -> Dict[str, List[Dict[str, Any]]]:
        """node_id -> the latest federated metric snapshot (bounded: a
        wedged head must not hang a scrape)."""
        return self._call("metrics_get", timeout=5.0)["nodes"]

    def profile_get(self) -> Dict[str, Any]:
        """{"nodes": node_id -> federated profile payload, "head": the
        head's own record or None}."""
        return self._call("profile_get", timeout=5.0)

    def task_events_push(self, events: List[Dict[str, Any]]) -> int:
        return self._call("task_events_push", events=events)["count"]

    def task_events_get(self, job_id: str = "", name: str = "",
                        limit: int = 10_000) -> List[Dict[str, Any]]:
        return self._call("task_events_get", job_id=job_id, name=name,
                          limit=limit)["events"]

    def list_nodes(self) -> List[Dict[str, Any]]:
        return self._call("list_nodes")["nodes"]

    def drain_node(self, node_id: str, deadline_s: float,
                   reason: str = "drain") -> Dict[str, Any]:
        """Ask the head to move a node into the DRAINING state."""
        return self._call("drain_node", node_id=node_id,
                          deadline_s=float(deadline_s), reason=reason)

    def mark_node_dead(self, node_id: str, reason: str) -> None:
        self._call("mark_node_dead", node_id=node_id, reason=reason)

    def report_resources(self, loads: Dict[str, Dict[str, float]]) -> None:
        """Push per-node availability views."""
        self._call("report_resources", loads=loads, timeout=5.0)

    # tenancy (the fair-share quota store and accounting federation)
    def tenancy_set(self, job_id: str, record: Dict[str, Any]) -> None:
        self._call("tenancy_set", job_id=job_id, record=record,
                   timeout=5.0)

    def tenancy_get(self) -> Dict[str, Dict[str, Any]]:
        return self._call("tenancy_get", timeout=5.0)["jobs"]

    def tenancy_report(self, jobs: Dict[str, Any]) -> None:
        self._call("tenancy_report", jobs=jobs, timeout=5.0)

    # kv
    def kv_put(self, key: bytes, value: bytes, overwrite: bool = True,
               namespace: bytes = b"") -> bool:
        return self._call("kv_put", key=key, value=value,
                          overwrite=overwrite, ns=namespace)["added"]

    def kv_get(self, key: bytes, namespace: bytes = b"") -> Optional[bytes]:
        return self._call("kv_get", key=key, ns=namespace)["value"]

    def kv_del(self, key: bytes, namespace: bytes = b"") -> None:
        self._call("kv_del", key=key, ns=namespace)

    def kv_keys(self, prefix: bytes = b"",
                namespace: bytes = b"") -> List[bytes]:
        return self._call("kv_keys", prefix=prefix, ns=namespace)["keys"]

    # pubsub
    def _sub_swap(self, old: Optional[Client],
                  new: Optional[Client]) -> None:
        """Track the live subscriber connection for close(). If close()
        already ran, the fresh client is closed on the spot (the dial won
        the race with stop)."""
        with self._sub_lock:
            if old is not None:
                try:
                    self._sub_clients.remove(old)
                except ValueError:
                    pass
            if new is not None:
                self._sub_clients.append(new)
                if self._sub_stop.is_set():
                    new.close()

    def subscribe(self, channel: str, callback) -> None:
        """Long-poll subscription on a connection of its own per channel (a
        parked poll must not block other requests' replies)."""
        def loop():
            cursor = 0
            try:
                sub = rpc.connect(self.addr, timeout=None)
            except OSError:
                return
            self._sub_swap(None, sub)
            try:
                while not self._sub_stop.is_set():
                    try:
                        out = sub.call("subscribe", channel=channel,
                                       cursor=cursor, timeout=None)
                    except rpc.RpcError:
                        if (self._sub_stop.is_set()
                                or self._reconnect_window <= 0):
                            return
                        # head restart: re-dial and resume from our cursor
                        # (the persisted event log keeps it valid)
                        from ray_tpu_torch._private.retry import RetryPolicy
                        try:
                            # a stop-interruptible backoff: close() must
                            # not wait out a redial sleep
                            new = RetryPolicy.default(
                                deadline_s=self._reconnect_window).run(
                                lambda: rpc.connect(self.addr,
                                                    timeout=None),
                                loop="head.subscribe_redial",
                                retry_on=(OSError,),
                                abort=self._sub_stop.is_set,
                                sleep=self._sub_stop.wait)
                        except OSError:
                            return
                        self._sub_swap(sub, new)
                        sub = new
                        continue
                    cursor = out["cursor"]
                    for event in out["events"]:
                        try:
                            callback(event)
                        except Exception:
                            pass
            finally:
                self._sub_swap(sub, None)
                sub.close()

        t = threading.Thread(target=loop, daemon=True,
                             name=f"head-sub-{channel}")
        t.start()
        self._sub_threads.append(t)

    def publish(self, channel: str, event: Any) -> None:
        # rides _call: with reconnect_window > 0 a publish survives a head
        # restart like every other head RPC
        self._call("publish", channel=channel, event=event)

    def stop_head(self) -> None:
        try:
            self._client.call("head_stop", timeout=2.0)
        except rpc.RpcError:
            pass

    def close(self) -> None:
        self._sub_stop.set()
        # closing the per-channel sub clients unblocks their parked
        # long-polls, so the threads exit instead of leaking sockets
        with self._sub_lock:
            subs = list(self._sub_clients)
        for sub in subs:
            sub.close()
        cur = threading.current_thread()
        for t in self._sub_threads:
            if t is not cur:        # close() from a callback thread
                t.join(timeout=2.0)
        self._client.close()


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=0)
    parser.add_argument("--state-path", default="",
                        help="sqlite file for KV/pubsub persistence")
    parser.add_argument("--announce-fd", type=int, default=-1,
                        help="write the bound port here once listening")
    parser.add_argument("--parent-pid", type=int, default=0,
                        help="exit once this process (the driver that "
                             "spawned the head) is gone; 0 = never")
    args = parser.parse_args()
    from ray_tpu_torch._private import netchaos as _nc
    _nc.set_local_role("head")
    from ray_tpu_torch._private import eventloop
    eventloop.set_proc_label("head")
    service = HeadService(state_path=args.state_path or None,
                          parent_pid=args.parent_pid or None)
    server = rpc.serve(service, host=args.host, port=args.port).start()
    from ray_tpu_torch.util import profiling
    profiling.maybe_start_from_config("head")
    if args.announce_fd >= 0:
        os.write(args.announce_fd, f"{server.addr[1]}\n".encode())
        os.close(args.announce_fd)
    threading.Event().wait()  # serve for ever


if __name__ == "__main__":
    main()
