"""Node daemon process, the raylet equivalent (counterpart of
``ray_tpu/_private/daemon.py``).

The per-node daemon: the worker-lease protocol, a pool of real worker
processes (PR 14's pool of ``_private/worker_process.py``), the placement
group's two-phase bundle commit, and the node's object plane (an arena of
``native_store.ShmObjectStore``, ``csrc/shm_store.cc``, with chunked pulls
and pushes between daemons). Spawned as its own OS process (``python -m
ray_tpu_torch._private.daemon``, with ``CUDA_VISIBLE_DEVICES=""``); all
traffic is the typed RPC of ``_private/rpc.py``.

Division of labour: the daemon executes host-plane work only. Its workers
fork from a template that never saw CUDA; the card stays with the driver,
which runs every task that wants it. The daemon never unpickles a user
payload (blobs in, blobs out): user code exists only in its worker
processes. It loads only the slim task specs (no function, no arguments)
that the driver sends beside them.

Object plane: results too big to inline live in the daemon's object table,
small ones in a dict and large ones in the shm arena, and are served by
(a) raw-bytes RPC, (b) same-host zero-copy: ``get_object`` replies
(arena name, offset, size) with a slot ref taken on the client's behalf;
the client attaches the arena by name, reads the range, and drops the ref
through its own mapping, (c) daemon-to-daemon ``pull_object`` and
``push_object`` for transfer between nodes. The daemon's workers attach
the same arena (``objectplane/arena.py``) for zero-copy gets and direct
puts.

The fast lane: the daemon hosts PR 15's native core (``CoreHandle``,
``csrc/daemon_core.cc``) on a port of its own; drivers submit plain tasks
straight to it and it routes them to dedicated lane workers with no daemon
Python per task.

Worker-initiated core ops (nested ``ray_tpu_torch.*`` calls inside tasks)
forward as blobs to the owner (the driver) over a connection of their own.

Several drivers at once: a ``--persist`` daemon keeps one record per
attached driver (its connection, owner client, job and namespace), named by
a token, its connection's ledger id. Every task, actor creation and method
call carries its driver's token to the worker: the daemon stamps it on
the classic path, the driver puts it in the lane frame. The worker binds
it to the task's thread and to the threads that task starts, sends it
back on each nested core op, which goes to that driver (a nested op that
names no driver goes to the only one attached, else fails), and marks
each change of the writing thread's driver in its log streams, so each
worker line goes to the driver whose task printed it. A line of no
driver's thread goes to every attached driver. The reference keeps one
driver slot and routes everything to the latest driver.

Lifetime: a daemon the driver spawned ends when that driver's connection
closes; one started with ``--persist`` (``ray-tpu start``) serves every
driver that joins. A departing driver's record goes, with its actors,
leases and batch records, and the other drivers' work is untouched. Once
the last driver is gone the daemon drops every lease and actor and waits
for the next.
Preemption: SIGTERM, the ``drain_notice_file`` appearing, or
``PreemptionWatcher.notify`` announce one graceful drain to the head.

A serialized actor (``max_concurrency == 1``, no concurrency groups) gets
a tag in that core: its worker joins the core as a targeted lane, and the
driver sends its method calls there, strictly FIFO, with no daemon Python
per call. A restarted actor gets a fresh tag.

The cross-language tier (``xlang_*``): functions and actor classes that
Python exported by name to the head's KV (``ray_tpu_torch.xlang``) run on
this daemon's pooled workers for a client in another language
(``csrc/cpp_client.cc``); arguments and results cross as plain values in
the wire's own frame encoding, never as a pickle of user objects.

Observability: the daemon records its dispatch and result-flush spans, and
ingests its workers' exec spans, into its own ``TaskEventBuffer``; each
heartbeat carries the new spans, an absolute snapshot of its metrics
registry (its workers' metrics merged in) and, on a slower cadence, its
cumulative profile, to the head. It tails its workers' log files to the
driver (``worker_log`` pushes), polices its workers' memory
(``start_memory_monitor``, ``set_memory_limit``, ``oom_check``), answers
``profile_burst`` for itself and its workers, and serves a per-node HTTP
agent (``start_agent``: ``/api/stats``, ``/api/profile/cpu``, ``/metrics``).

Chaos: the failpoint seams of the daemon (drain, spill, restore, pulls,
the result pump, reclamation, leases, pushes, the OOM check and the beat's
flushes), its role on the network-chaos graph, a ``PressureController``
under ``memory_pressure`` (soft spills, hard rejects new reservations and
puts, ``node_pressure`` pushes), and the ``fail_points``/``net_chaos``
hooks that arm one daemon alone.

Tenancy: the daemon mirrors the driver's per-job quota and weight table
(``tenancy_sync``, gated on the ``tenancy`` hello bit) for its metrics,
and under ``memory_pressure`` its memory monitor preempts the workers of
over-quota jobs first (``TenantAwarePolicy``).
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import shutil
import tempfile
import threading
import time
import uuid
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch._private import failpoints as _fp
from ray_tpu_torch._private import netchaos as _nc
from ray_tpu_torch._private import eventloop, rpc
from ray_tpu_torch._private import events as _events
from ray_tpu_torch._private.head import HeadClient, _hb_interval
from ray_tpu_torch._private.ids import ActorID, NodeID
from ray_tpu_torch._private.lock_sanitizer import tracked_lock
from ray_tpu_torch._private.rpc import Client, Connection, declare
from ray_tpu_torch.util import metrics as _metrics
from ray_tpu_torch.util import profiling as _profiling

INLINE_RESULT = 100 * 1024  # the reference's max_direct_call_object_size

declare("hello_driver", "owner_addr", "job_id", "namespace", "sys_path")
declare("request_worker_lease", "task_meta")
declare("return_worker", "lease_id")
declare("push_task", "spec", "fid", "args", "lease_id", "backpressure")
# coalesced submit: many tasks a frame; `fns` ships each function blob once
# per (daemon, fid); completions return batched on task_batch_done push
# frames. Retried frames dedupe by (task, attempt).
declare("push_task_batch", "tasks", "fns")
# one classic submit a task (the driver's submit_batch=False): acked at
# once, its completion rides the task_batch_done pump
declare("submit_task", "task", "attempt", "spec", "fid", "args",
        "backpressure")
declare("create_actor", "spec", "fid", "args")
declare("call_actor_method", "spec", "args")
declare("kill_actor", "actor_id", "expected")
declare("cancel_task", "task_id", "force")
declare("gen_ack", "task_id")
declare("prepare_bundle", "pg_id", "index", "resources")
declare("commit_bundle", "pg_id", "index")
declare("cancel_bundle", "pg_id", "index")
declare("put_object", "oid", "blob")
declare("get_object", "oid", "prefer_shm")
declare("object_meta", "oid")
declare("get_object_chunk", "oid", "off", "size")
declare("release_object", "oid")
declare("free_objects", "oids")
declare("pull_object", "oid", "from_addr", "priority")
# zero-copy object plane: reserve + seal let a same-host client write the
# payload straight into the arena (only metadata rides the wire);
# push_object/push_chunk are the proactive daemon-to-daemon direction
declare("create_object", "oid", "size")
declare("seal_object", "oid", "ref", "raw", "nbytes")
declare("push_object", "oid", "to_addr", "ref")
declare("profile_burst", "duration")
declare("set_memory_limit", "limit")
declare("oom_check", "task_id", "fast_lane")
declare("push_chunk", "oid", "off", "total", "blob", "ref", "raw")
declare("daemon_ping")
# fair-share federation: the driver mirrors its per-job quota and weight
# table here (gated on the "tenancy" hello bit)
declare("tenancy_sync", "jobs")
# chaos harness only: (de)activate a seeded netchaos or failpoint spec
# inside THIS daemon process, where the env form (which reaches every
# spawned process) is too blunt: one node's head link, one node's level
declare("net_chaos", "spec")
declare("fail_points", "spec")
# the cross-language tier (C++ clients): names resolve through the head's
# KV; "args" is a frame-encoded list of plain values, and results come
# back as plain values (no pickle of a user object crosses the boundary)
declare("xlang_submit", "name", "args")
declare("xlang_create_actor", "cls", "name", "args")
declare("xlang_call_actor", "name", "method", "args")
declare("daemon_stop")
declare("daemon_stats")
declare("syncer_exchange", "view")
declare("syncer_view")
declare("core_op", "call", "payload", "task")


# ---------------------------------------------------------------------------
# preemption watcher: a self-announced graceful drain
# ---------------------------------------------------------------------------

class PreemptionWatcher:
    """Funnels preemption and maintenance notices into ONE self-announced
    graceful drain at the head. Sources, all ending in :meth:`notify`:

    - SIGTERM: ``install_sigterm()`` (the daemon's ``main()`` installs it;
      the handler only sets an event, the announce RPC runs on the
      watcher's thread);
    - the notice file (``drain_notice_file``): the file appearing is the
      notice, its content the reason;
    - ``notify(reason)`` from any integration hook.

    After announcing, the daemon keeps serving: the head fences new
    placements, drivers migrate work off, and the head escalates to the
    death path at the deadline, whose heartbeat reply makes this process
    exit."""

    def __init__(self, node_id_hex: str, head_addr: Tuple[str, int],
                 deadline_s: float, notice_file: str = ""):
        self.node_id_hex = node_id_hex
        self.head_addr = head_addr
        self.deadline_s = deadline_s
        self.notice_file = notice_file
        self.announced = False
        self._reason = "preemption"
        self._event = threading.Event()

    def notify(self, reason: str = "preemption") -> None:
        self._reason = reason
        self._event.set()

    def install_sigterm(self) -> None:
        import signal

        def handler(signum, frame):
            self.notify("sigterm")

        try:
            signal.signal(signal.SIGTERM, handler)
        except ValueError:
            pass    # not the main thread (embedded use): file and hook only

    def start(self) -> None:
        threading.Thread(target=self._loop, daemon=True,
                         name="preemption-watch").start()

    def _loop(self) -> None:
        while not self._event.wait(0.2):
            if self.notice_file and os.path.exists(self.notice_file):
                try:
                    with open(self.notice_file) as fh:
                        reason = fh.read().strip() or "maintenance notice"
                except OSError:
                    reason = "maintenance notice"
                self.notify(reason)
        self._announce()

    def _announce(self) -> None:
        if self.announced:
            return
        self.announced = True
        if _fp.ENABLED:
            try:
                # drop/error arm = the notice never reaches the head (the
                # node then just dies: the crash path is the backstop); a
                # delay arm shrinks the drain window
                if _fp.fire("drain.announce",
                            node=self.node_id_hex) is _fp.DROP:
                    return
            except Exception:
                return
        try:
            head = HeadClient(self.head_addr)
            try:
                head.drain_node(self.node_id_hex, self.deadline_s,
                                self._reason)
            finally:
                head.close()
        except (OSError, rpc.RpcError):
            pass    # head unreachable: the crash path recovers the node


UNKNOWN_CLIENT = "?"


def _pid_alive(pid: int) -> bool:
    """Liveness probe for the orphan sweep (signal 0 = existence check;
    EPERM still proves the pid exists)."""
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True
    except OSError:
        return False
    return True


class ObjectTable:
    def __init__(self, arena_name: str, capacity: int,
                 sweep: bool = True, spill_dir: Optional[str] = None,
                 spill_budget: int = 0):
        self._small: Dict[bytes, bytes] = {}  #: guarded by self._lock
        self._lock = tracked_lock("daemon.object_table", reentrant=False)
        self.arena_name = arena_name
        self.capacity = capacity
        # logical ObjectID binary -> daemon store key: lets same-node
        # consumers (attached workers) resolve a ray_tpu ref without
        # the owner round trip (the node-local slice of the object
        # directory); raw-tier entries carry (dtype, shape) so views
        # need no unpickle at all
        self._by_oid: Dict[bytes, bytes] = {}   #: guarded by self._lock
        self._ref_of: Dict[bytes, bytes] = {}   #: guarded by self._lock
        self._raw: Dict[bytes, Any] = {}        #: guarded by self._lock
        # per-client grant ledger: every slot ref the owner increments
        # on a client's behalf (get_ext_meta) is charged to that
        # client's identity, so liveness-driven reclamation can drop a
        # dead client's outstanding grants without a daemon restart.
        # Clients release with SILENT local atomics, so a ledger count
        # is an UPPER BOUND on what the client still holds — reclaim
        # drops min(granted, observed_refs - other clients' ledger
        # counts) and the orphan sweep trues up the residue (see
        # reclaim_client).
        self._ext_slots: Dict[str, Dict[int, int]] = {}  #: guarded by self._lock
        # slot -> oid of the last grant (operator attribution); the
        # native lib has no slot-enumeration API, so leak observability
        # (ray_tpu_arena_slot_refs) polls ext_refs() over this set.
        self._slot_owners: Dict[int, bytes] = {}  #: guarded by self._lock
        # unsealed direct-put reservations: key -> (client_id, ts);
        # popped at seal/abort, aborted by reclaim_client and by the
        # heartbeat sweep once past the TTL.
        self._reservations: Dict[bytes, Tuple[str, float]] = {}  #: guarded by self._lock
        # -- arena spill tier --
        # The native store has no key-enumeration API, so spill
        # candidacy needs a Python-side index of SEALED arena entries:
        # key -> nbytes in LRU order (move_to_end on every read grant).
        # None spill_dir = spilling disarmed (every op short-circuits).
        self.spill_dir = spill_dir
        self.spill_budget = int(spill_budget or 0)
        self._entries: "OrderedDict[bytes, int]" = OrderedDict()  #: guarded by self._lock
        # key -> (path, nbytes) for entries currently parked on disk
        self._spilled: Dict[bytes, Tuple[str, int]] = {}  #: guarded by self._lock
        self._spill_stats = {"spills": 0, "restores": 0,
                             "spilled_bytes": 0, "restored_bytes": 0,
                             "spill_skipped_pinned": 0,
                             "restore_failed": 0}  #: guarded by self._lock
        self._spilled_total = 0     #: guarded by self._lock
        self._shm = None
        if sweep:
            # stale-segment hygiene: a SIGKILL'd predecessor daemon of
            # this node never unlinked its arena — reap it before
            # creating ours (same name => same node)
            try:
                from ray_tpu_torch.objectplane.arena import \
                    sweep_stale_segments
                sweep_stale_segments(arena_name)
            except Exception:
                pass
        try:
            from ray_tpu_torch.native_store import ShmObjectStore

            self._shm = ShmObjectStore(arena_name, capacity)
        except Exception:
            self._shm = None  # g++ missing: dict-only fallback

    def put(self, oid: bytes, blob: bytes) -> None:
        if self._shm is not None and len(blob) > INLINE_RESULT:
            if self.spill_dir is not None:
                with self._lock:
                    if oid in self._spilled:
                        return  # already stored, parked on disk
            for attempt in range(2):
                try:
                    self._shm.put(oid, blob, pin=True)
                    with self._lock:
                        self._entries[oid] = len(blob)
                        self._entries.move_to_end(oid)
                    return
                except KeyError:
                    return  # already stored (idempotent retry)
                except Exception:
                    # arena full: spill cold entries once, then retry;
                    # still full (or spilling disarmed) → dict fallback
                    if attempt or not self.spill_for(len(blob)):
                        break
        with self._lock:
            self._small[oid] = blob

    def get_blob(self, oid: bytes) -> Optional[bytes]:
        with self._lock:
            blob = self._small.get(oid)
        if blob is not None:
            return blob
        if self._shm is not None:
            if not self._maybe_restore(oid):
                # restore failed (arena still full): serve
                # the bytes straight off the spill file — a read must
                # degrade to a disk read, never to a miss
                return self._read_spilled(oid)
            try:
                view = self._shm.get_view(oid)  # increfs
                try:
                    self._touch(oid)
                    return view.tobytes()
                finally:
                    self._shm.release(oid)
            except KeyError:
                return None
        return None

    def get_shm_ref(self, oid: bytes):
        """(arena, capacity, off, size) with a held ref, or None."""
        if self._shm is None:
            return None
        self._maybe_restore(oid)
        try:
            off, size = self._shm.get_ref(oid)
        except KeyError:
            return None
        self._touch(oid)
        return (self.arena_name, self.capacity, off, size)

    def get_ext_meta(self, oid: bytes, client_id: str = UNKNOWN_CLIENT):
        """(arena, capacity, off, size, slot) with the object's
        PROCESS-SHARED slot refcount incremented on the client's behalf
        (the client reads through its own mapping and drops the ref with
        a local atomic — no release round trip), or None. The grant is
        charged to ``client_id`` in the ledger; incref + ledger entry
        commit under one lock hold so reclaim/sweep never observe a ref
        whose holder is not yet recorded."""
        if self._shm is None:
            return None
        self._maybe_restore(oid)
        with self._lock:
            try:
                off, size, slot = self._shm.get_ext(oid)
            except Exception:
                return None
            grants = self._ext_slots.setdefault(client_id, {})
            grants[slot] = grants.get(slot, 0) + 1
            self._slot_owners[slot] = oid
            if oid in self._entries:
                self._entries.move_to_end(oid)
        return (self.arena_name, self.capacity, off, size, slot)

    def ext_release(self, slot: int, client_id: Optional[str] = None
                    ) -> None:
        """Owner-side slot release (the RPC fallback path for clients
        with no local mapping). When the caller is identified, the
        ledger charge drops with the ref so reclaim never re-drops it."""
        if self._shm is None:
            return
        with self._lock:
            try:
                self._shm.ext_release(slot)
            except Exception:
                pass
            if client_id is not None:
                grants = self._ext_slots.get(client_id)
                if grants and slot in grants:
                    if grants[slot] <= 1:
                        del grants[slot]
                    else:
                        grants[slot] -= 1
                    if not grants:
                        del self._ext_slots[client_id]

    def slot_ref_stats(self, attribution: bool = False) -> Dict[str, Any]:
        """{"held": slots with outstanding external refs, "refs": total
        outstanding external refs} over every slot ever granted via
        get_ext_meta. Fully-released slots leave tracking here (their
        ledger charges are cleared too — refs hitting zero proves every
        grant was released); what remains with refs > 0 is live readers
        or a not-yet-reclaimed grant. With ``attribution`` the reply
        adds ``clients``: per-client ledger rows so operators can see
        WHO holds a slot. Zeros on the dict-only fallback."""
        if self._shm is None:
            return {"held": 0, "refs": 0, "clients": []} if attribution \
                else {"held": 0, "refs": 0}
        held = refs = 0
        with self._lock:
            tracked = set(self._slot_owners)
            for grants in self._ext_slots.values():
                tracked.update(grants)
            released = []
            for slot in tracked:
                try:
                    n = int(self._shm.ext_refs(slot))
                except Exception:
                    n = 0
                if n > 0:
                    held += 1
                    refs += n
                else:
                    released.append(slot)
            for slot in released:
                self._slot_owners.pop(slot, None)
                for cid in list(self._ext_slots):
                    grants = self._ext_slots[cid]
                    grants.pop(slot, None)
                    if not grants:
                        del self._ext_slots[cid]
            out: Dict[str, Any] = {"held": held, "refs": refs}
            if attribution:
                out["clients"] = [
                    {"client": cid,
                     "slots": len(grants),
                     "granted": sum(grants.values())}
                    for cid, grants in sorted(self._ext_slots.items())]
        return out

    def ledger_clients(self) -> list:
        """Client ids with outstanding grants or reservations (sweep
        input: the service checks each for liveness)."""
        with self._lock:
            out = set(self._ext_slots)
            out.update(cid for cid, _ts in self._reservations.values())
            return sorted(out)

    def reclaim_client(self, client_id: str) -> Tuple[int, int]:
        """Drop a dead client's outstanding state: CAS-drop its slot
        grants (bounded so a grant the client already released locally
        — or a ref another live client holds — is never stolen), abort
        its unsealed reservations, then reap so deferred deletes free
        NOW rather than at daemon restart. Returns (refs dropped,
        reservations aborted). Idempotent: a second call finds an empty
        ledger and does nothing."""
        with self._lock:
            grants = self._ext_slots.pop(client_id, None) or {}
            res_keys = [k for k, (cid, _ts) in self._reservations.items()
                        if cid == client_id]
            for k in res_keys:
                self._reservations.pop(k, None)
            dropped = 0
            if self._shm is not None and grants:
                # ledger counts of every OTHER still-registered client
                # per slot: ledgers over-count (silent local releases),
                # so observed - others is a SAFE LOWER BOUND on what the
                # dead client still holds. Residue trues up in the
                # orphan sweep once the co-holders release or die.
                others: Dict[int, int] = {}
                for grants_o in self._ext_slots.values():
                    for slot, n in grants_o.items():
                        if slot in grants:
                            others[slot] = others.get(slot, 0) + n
                for slot, granted in grants.items():
                    try:
                        observed = int(self._shm.ext_refs(slot))
                    except Exception:
                        continue
                    n = min(granted, max(0, observed - others.get(slot, 0)))
                    if n > 0:
                        try:
                            dropped += int(self._shm.ext_release_n(slot, n))
                        except Exception:
                            pass
        for k in res_keys:
            self.abort_reserve(k)
        self.reap()
        return dropped, len(res_keys)

    def stale_reservations(self, ttl: float) -> list:
        """Reservation keys older than ``ttl`` seconds (client reserved
        arena space but never sealed or aborted — dead mid-direct-put)."""
        now = time.monotonic()
        with self._lock:
            return [k for k, (_cid, ts) in self._reservations.items()
                    if now - ts > ttl]

    def sweep_orphan_slots(self) -> int:
        """True-up pass for ledger drift. Two rules, both safe because
        grants/reclaims serialize under the table lock: (a) a slot with
        outstanding refs but NO ledger holder carries only refs of
        already-reclaimed dead clients — force them to zero; (b) a slot
        whose SINGLE holder's charge exceeds observed refs had silent
        local releases — clamp the charge down (keeps ledger >= actual,
        the invariant reclaim's bound depends on). Returns refs dropped."""
        if self._shm is None:
            return 0
        dropped = 0
        with self._lock:
            holders: Dict[int, list] = {}
            for cid, grants in self._ext_slots.items():
                for slot in grants:
                    holders.setdefault(slot, []).append(cid)
            for slot in list(self._slot_owners):
                try:
                    observed = int(self._shm.ext_refs(slot))
                except Exception:
                    continue
                held_by = holders.get(slot, [])
                if observed > 0 and not held_by:
                    try:
                        dropped += int(self._shm.ext_release_n(slot,
                                                               observed))
                    except Exception:
                        pass
                elif len(held_by) == 1:
                    grants = self._ext_slots[held_by[0]]
                    if grants.get(slot, 0) > observed:
                        if observed == 0:
                            del grants[slot]
                            if not grants:
                                del self._ext_slots[held_by[0]]
                        else:
                            grants[slot] = observed
        return dropped

    def release(self, oid: bytes) -> None:
        if self._shm is not None:
            try:
                self._shm.release(oid)
            except Exception:
                pass

    # -- oid index (node-local object directory slice) -------------------
    def register_oid(self, ref: bytes, key: bytes, raw=None) -> None:
        if not ref:
            return
        with self._lock:
            self._by_oid[ref] = key
            self._ref_of[key] = ref
            if raw is not None:
                self._raw[key] = raw

    def key_for(self, ref: bytes) -> Optional[bytes]:
        with self._lock:
            return self._by_oid.get(ref)

    def raw_for(self, key: bytes):
        with self._lock:
            return self._raw.get(key)

    # -- arena spill tier -----------
    # Cold, sealed, UNPINNED entries move to disk files under occupancy
    # pressure and restore on demand on every read path. A live external
    # slot ref (the grant ledger) pins an entry unspillable — a held
    # zero-copy view must never lose its backing bytes. Disarmed
    # (spill_dir None) every hook below is a None-check no-op.

    def _touch(self, key: bytes) -> None:
        """LRU maintenance on read grants (spill picks oldest first)."""
        if self.spill_dir is None:
            return
        with self._lock:
            if key in self._entries:
                self._entries.move_to_end(key)

    def _spill_path(self, key: bytes) -> str:
        return os.path.join(self.spill_dir, key.hex() + ".spill")

    def _pinned_now(self) -> set:
        """Keys unspillable RIGHT NOW: an outstanding external slot ref
        means some process still maps the bytes as a zero-copy view.
        Caller holds self._lock (grants commit under the same lock, so
        the set cannot go stale mid-pass)."""
        pinned = set()
        for slot, oid in self._slot_owners.items():  # raylint: disable=guarded-by — caller holds self._lock
            try:
                if int(self._shm.ext_refs(slot)) > 0:
                    pinned.add(oid)
            except Exception:
                pinned.add(oid)     # unreadable slot: keep it safe
        return pinned

    def _spill_one_locked(self, key: bytes, size: int) -> bool:
        """Spill ONE sealed entry. Caller holds self._lock and has
        checked the pin set. The write goes to a temp file renamed into
        place, and arena bytes free through the native deferred-delete/
        reap path — a reader that raced past the restore check keeps a
        valid (deferred) mapping and re-reads from disk next time."""
        if key in self._spilled or key not in self._entries:  # raylint: disable=guarded-by — caller holds self._lock
            return True     # idempotent: already parked / already gone
        if _fp.ENABLED:
            # drop/error arm = this spill attempt fails; the entry stays
            # resident at tier host-shm and a later pass retries
            try:
                if _fp.fire("arena.spill", key=key.hex()[:16],
                            nbytes=size) is _fp.DROP:
                    return False
            except Exception:
                return False
        try:
            view = self._shm.get_view(key)      # increfs
            try:
                data = view.tobytes()
            finally:
                self._shm.release(key)
        except Exception:
            return False
        path = self._spill_path(key)
        try:
            os.makedirs(self.spill_dir, exist_ok=True)
            tmp = path + ".tmp"
            with open(tmp, "wb") as fh:
                fh.write(data)
            os.replace(tmp, path)   # readers never see a torn file
        except OSError:
            return False
        self._spilled[key] = (path, len(data))  # raylint: disable=guarded-by — caller holds self._lock
        self._spilled_total += len(data)  # raylint: disable=guarded-by — caller holds self._lock
        self._entries.pop(key, None)  # raylint: disable=guarded-by — caller holds self._lock
        try:
            self._shm.delete(key)   # frees now, or defers until refs drop
        except Exception:
            pass
        self._spill_stats["spills"] += 1
        self._spill_stats["spilled_bytes"] += len(data)
        from ray_tpu_torch.objectplane.tiers import count_spilled_bytes
        count_spilled_bytes(len(data))
        return True

    def _spill_pass_locked(self, need_bytes: Optional[int] = None,
                           floor_bytes: Optional[int] = None,
                           max_entries: int = 64,
                           exclude: tuple = ()) -> int:
        """Shared spill loop (caller holds self._lock): LRU-first until
        ``need_bytes`` of room exists / occupancy reaches
        ``floor_bytes`` / the per-pass entry bound or the spill-dir
        budget stops it. Returns entries spilled."""
        spilled = 0
        pinned = self._pinned_now()
        for key in list(self._entries):  # raylint: disable=guarded-by — caller holds self._lock
            if spilled >= max_entries:
                break
            used = self._shm.used_bytes()
            if need_bytes is not None and \
                    self.capacity - used >= need_bytes:
                break
            if floor_bytes is not None and used <= floor_bytes:
                break
            size = self._entries[key]  # raylint: disable=guarded-by — caller holds self._lock
            if key in exclude:
                continue
            if key in pinned:
                self._spill_stats["spill_skipped_pinned"] += 1
                continue
            if self.spill_budget and (self._spilled_total + size  # raylint: disable=guarded-by — caller holds self._lock
                                      > self.spill_budget):
                break       # disk budget exhausted: pressure goes hard
            if self._spill_one_locked(key, size):
                spilled += 1
        if spilled:
            try:
                self._shm.reap()
            except Exception:
                pass
        return spilled

    def spill_for(self, nbytes: int) -> bool:
        """Make ``nbytes`` of arena room by spilling cold entries; the
        put/reserve paths call this instead of failing over to the
        blob/dict path while cold data hogs the arena. False = spilling
        disarmed or not enough unpinned cold bytes."""
        if self.spill_dir is None or self._shm is None:
            return False
        with self._lock:
            self._spill_pass_locked(need_bytes=nbytes)
            return self.capacity - self._shm.used_bytes() >= nbytes

    def spill_to_fraction(self, target: float) -> int:
        """Proactive pressure-tick pass: bring occupancy down to the
        ``target`` fraction of capacity (soft watermark), oldest first,
        bounded per call so a tick stays short."""
        if self.spill_dir is None or self._shm is None:
            return 0
        with self._lock:
            return self._spill_pass_locked(
                floor_bytes=int(self.capacity * max(0.0, target)))

    def _maybe_restore(self, key: bytes) -> bool:
        """True when ``key`` is resident (nothing to do) or was
        restored; False when it is spilled and the restore failed —
        the caller degrades to a direct disk read."""
        if self.spill_dir is None:
            return True
        with self._lock:
            if key not in self._spilled:
                return True
        return self.restore(key)

    def restore(self, key: bytes) -> bool:
        """Bring a spilled entry back into the arena (tier spilled ->
        host-shm). Idempotent: a retried/concurrent restore finds the
        entry resident and reports success. The spill file is consumed
        only AFTER the arena copy lands — a failed attempt (arena full) leaves
        the file intact for the next try."""
        if self._shm is None or self.spill_dir is None:
            return False
        done_bytes = 0
        with self._lock:
            spilled = self._spilled.get(key)
            if spilled is None:
                return True     # already resident (idempotent)
            path, size = spilled
            if _fp.ENABLED:
                # drop/error arm = this restore attempt fails; the read
                # path serves the spill file directly and retries later
                try:
                    if _fp.fire("arena.restore", key=key.hex()[:16],
                                nbytes=size) is _fp.DROP:
                        self._spill_stats["restore_failed"] += 1
                        return False
                except Exception:
                    self._spill_stats["restore_failed"] += 1
                    return False
            try:
                with open(path, "rb") as fh:
                    data = fh.read()
            except OSError:
                self._spill_stats["restore_failed"] += 1
                return False
            try:
                self._shm.put(key, data, pin=True)
            except KeyError:
                pass    # resident already (deferred twin / lost race)
            except Exception:
                # arena full: make room off colder entries, retry once
                # BEFORE consuming the spill file (the pressure scan
                # precedes the file delete)
                self._spill_pass_locked(need_bytes=len(data),
                                        exclude=(key,))
                try:
                    self._shm.put(key, data, pin=True)
                except KeyError:
                    pass
                except Exception:
                    self._spill_stats["restore_failed"] += 1
                    return False
            self._spilled.pop(key, None)
            self._spilled_total -= size
            self._entries[key] = len(data)
            self._entries.move_to_end(key)
            self._spill_stats["restores"] += 1
            self._spill_stats["restored_bytes"] += len(data)
            done_bytes = len(data)
        try:
            os.unlink(path)
        except OSError:
            pass
        from ray_tpu_torch.objectplane.tiers import count_restored_bytes
        count_restored_bytes(done_bytes)
        return True

    def _read_spilled(self, key: bytes) -> Optional[bytes]:
        """Serve a spilled entry's bytes straight off its file (restore
        failed or lost a race with a spill pass) — reads degrade to
        disk, never to a miss."""
        with self._lock:
            spilled = self._spilled.get(key)
        if spilled is None:
            return None
        try:
            with open(spilled[0], "rb") as fh:
                return fh.read()
        except OSError:
            return None

    def spilled_bytes(self) -> int:
        with self._lock:
            return self._spilled_total

    def spill_stats(self) -> Dict[str, int]:
        with self._lock:
            out = dict(self._spill_stats)
            out["spilled_now_bytes"] = self._spilled_total
            out["spilled_now_count"] = len(self._spilled)
        return out

    # -- direct-put (reserve + client write + seal) ----------------------
    def reserve(self, key: bytes, size: int,
                client_id: str = UNKNOWN_CLIENT) -> Optional[int]:
        """Reserve arena space for a client-side write; None = no arena
        or no room (caller falls back to the blob path). Idempotent for
        a retried reserve of the same (key, size). The unsealed entry is
        charged to ``client_id`` so a writer that dies between reserve
        and seal gets its bytes reclaimed (reclaim_client or the TTL
        sweep) instead of stranding them forever."""
        if self._shm is None:
            return None
        from ray_tpu_torch.native_store import ShmStoreFull
        try:
            off = self._shm.reserve(key, size)
        except ShmStoreFull:
            # spill cold entries to make room, then retry ONCE — a
            # direct put keeps succeeding in place instead of falling
            # back to the blob path while cold data hogs the arena
            if not self.spill_for(size):
                return None
            try:
                off = self._shm.reserve(key, size)
            except (ShmStoreFull, KeyError):
                return None
        except KeyError:
            return None
        with self._lock:
            self._reservations[key] = (client_id, time.monotonic())
        return off

    def seal(self, key: bytes, ref: bytes = b"", raw=None) -> bool:
        """Seal a reserved entry (idempotent; pin matches put(pin=True)
        so this layer's refcounting owns lifetime)."""
        if self._shm is None:
            return False
        try:
            self._shm.seal(key, pin=True)
        except KeyError:
            return False
        try:
            _off, size, _sealed = self._shm.stat(key)
        except Exception:
            size = 0
        with self._lock:
            self._reservations.pop(key, None)
            self._entries[key] = size
            self._entries.move_to_end(key)
        self.register_oid(ref, key, raw=raw)
        return True

    def abort_reserve(self, key: bytes) -> None:
        """Drop a reserved-but-never-sealed entry (failed direct put)."""
        self.delete(key)

    def reap(self) -> int:
        """Free deferred-deleted entries whose external (attached-
        process) refs have dropped; external releases are silent atomic
        decrements, so the owner sweeps periodically."""
        if self._shm is None:
            return 0
        try:
            return self._shm.reap()
        except Exception:
            return 0

    def contains(self, oid: bytes) -> bool:
        with self._lock:
            if oid in self._small or oid in self._spilled:
                return True
        return self._shm is not None and self._shm.contains(oid)

    def nbytes_of(self, oid: bytes) -> Optional[int]:
        with self._lock:
            blob = self._small.get(oid)
            if blob is None:
                spilled = self._spilled.get(oid)
                if spilled is not None:
                    return spilled[1]   # size answered without restore
        if blob is not None:
            return len(blob)
        if self._shm is not None:
            try:
                off, size = self._shm.get_ref(oid)
                self._shm.release(oid)
                return size
            except KeyError:
                return None
        return None

    def read_range(self, oid: bytes, off: int, size: int
                   ) -> Optional[bytes]:
        """One chunk of the object's bytes (inter-node chunked transfer); pin
        held only per call."""
        with self._lock:
            blob = self._small.get(oid)
        if blob is not None:
            return blob[off:off + size]
        if self._shm is not None:
            if not self._maybe_restore(oid):
                # arena still full: chunk straight off the spill file
                # so outbound push/pull never depends on arena room
                blob = self._read_spilled(oid)
                return None if blob is None else blob[off:off + size]
            try:
                view = self._shm.get_view(oid)  # increfs
                try:
                    self._touch(oid)
                    return bytes(view[off:off + size])
                finally:
                    self._shm.release(oid)
            except KeyError:
                return None
        return None

    def delete(self, oid: bytes) -> None:
        spill_path = None
        with self._lock:
            self._small.pop(oid, None)
            self._raw.pop(oid, None)
            self._reservations.pop(oid, None)
            self._entries.pop(oid, None)
            spilled = self._spilled.pop(oid, None)
            if spilled is not None:
                spill_path = spilled[0]
                self._spilled_total -= spilled[1]
            ref = self._ref_of.pop(oid, None)
            if ref is not None:
                self._by_oid.pop(ref, None)
        if spill_path is not None:
            try:
                os.unlink(spill_path)
            except OSError:
                pass
        if self._shm is not None:
            try:
                # an aborted direct put leaves an UNSEALED entry whose
                # creator ref was never pinned/released — drop it first
                # or the delete defers forever
                try:
                    _off, _size, sealed = self._shm.stat(oid)
                    if not sealed:
                        self._shm.release(oid)
                except KeyError:
                    pass
                self._shm.delete(oid)
            except Exception:
                pass

    def used_bytes(self) -> int:
        with self._lock:
            small = sum(len(b) for b in self._small.values())
        return small + (self._shm.used_bytes() if self._shm else 0)

    def close(self) -> None:
        if self._shm is not None:
            self._shm.close(unlink=True)


# ---------------------------------------------------------------------------
# pull manager: chunked, deduplicated, prioritized inter-node pulls
# ---------------------------------------------------------------------------

# Priorities: an explicit get outranks wait(fetch_local), which outranks
# task-arg staging.
PULL_PRIORITY_GET = 0
PULL_PRIORITY_WAIT = 1
PULL_PRIORITY_TASK_ARGS = 2

def _pull_chunk() -> int:
    from ray_tpu_torch._private.config import cfg
    return cfg().pull_chunk


class _Pull:
    __slots__ = ("oid", "from_addr", "priority", "event", "ok", "error",
                 "missing")

    def __init__(self, oid: bytes, from_addr, priority: int):
        self.oid = oid
        self.from_addr = from_addr
        self.priority = priority
        self.event = threading.Event()
        self.ok = False
        self.missing = False
        self.error = ""


class PullManager:
    """Inter-node object transfer engine:

    - transfers move in ``PULL_CHUNK``-sized pieces assembled into one
      preallocated buffer, so a 64 MiB object never rides one RPC frame;
    - concurrent pulls of the same object deduplicate onto one in-flight
      transfer (the bytes cross the wire once);
    - queued pulls are served strictly by priority (get > wait >
      task-args), then FIFO;
    - every step feeds stats counters (surfaced by ``daemon_stats``).
    """

    def __init__(self, objects: ObjectTable, peer_fn, num_workers: int = 2,
                 chunk: Optional[int] = None):
        self.objects = objects
        self._peer = peer_fn        # addr -> rpc.Client
        self.chunk = chunk if chunk is not None else _pull_chunk()
        self._cv = threading.Condition()
        self._heap: list = []
        self._seq = 0
        self._inflight: Dict[bytes, _Pull] = {}
        self.stats = {"pulls_started": 0, "pulls_deduped": 0,
                      "pulls_failed": 0, "chunks_transferred": 0,
                      "bytes_pulled": 0}
        for i in range(num_workers):
            threading.Thread(target=self._loop, daemon=True,
                             name=f"pull-worker-{i}").start()

    def request(self, oid: bytes, from_addr, priority: int) -> _Pull:
        """Enqueue (or join) a pull; caller waits on the returned event."""
        import heapq
        with self._cv:
            existing = self._inflight.get(oid)
            if existing is not None:
                self.stats["pulls_deduped"] += 1
                return existing
            pull = _Pull(oid, from_addr, priority)
            self._inflight[oid] = pull
            self.stats["pulls_started"] += 1
            self._seq += 1
            heapq.heappush(self._heap, (priority, self._seq, pull))
            self._cv.notify()
        return pull

    def _loop(self) -> None:
        import heapq
        while True:
            with self._cv:
                while not self._heap:
                    self._cv.wait()
                _, _, pull = heapq.heappop(self._heap)
            try:
                self._transfer(pull)
                pull.ok = True
            except _PullMissing:
                pull.missing = True
                with self._cv:
                    self.stats["pulls_failed"] += 1
            except Exception as e:  # noqa: BLE001 — reported to waiter
                pull.error = repr(e)
                with self._cv:
                    self.stats["pulls_failed"] += 1
            finally:
                with self._cv:
                    self._inflight.pop(pull.oid, None)
                pull.event.set()

    def _transfer(self, pull: _Pull) -> None:
        if _fp.ENABLED:
            # an error arm fails this transfer attempt (the waiter sees
            # the error and may fall back to the owner's directory); a
            # delay arm stretches the transfer window
            _fp.fire("daemon.pull_transfer")
        if self.objects.contains(pull.oid):
            return  # a deduped predecessor already landed it
        peer = self._peer(tuple(pull.from_addr))
        meta = peer.call("object_meta", oid=pull.oid)
        if meta.get("missing"):
            raise _PullMissing()
        size = meta["size"]
        if size <= self.chunk:
            out = peer.call("get_object", oid=pull.oid, prefer_shm=False)
            if out.get("missing"):
                raise _PullMissing()
            blob = out["blob"]
            with self._cv:
                self.stats["chunks_transferred"] += 1
                self.stats["bytes_pulled"] += len(blob)
        else:
            buf = bytearray(size)  # the transfer's reassembly buffer
            for off in range(0, size, self.chunk):
                want = min(self.chunk, size - off)
                out = peer.call("get_object_chunk", oid=pull.oid,
                                off=off, size=want)
                part = out.get("blob")
                if part is None:    # evicted mid-transfer
                    raise _PullMissing()
                buf[off:off + len(part)] = part
                with self._cv:
                    self.stats["chunks_transferred"] += 1
                    self.stats["bytes_pulled"] += len(part)
            blob = bytes(buf)
        self.objects.put(pull.oid, blob)


class _PullMissing(Exception):
    pass


# ---------------------------------------------------------------------------
# batched submit plumbing (driver side: cluster._SubmitCoalescer)
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# batched submit plumbing (driver side: cluster._SubmitCoalescer)
# ---------------------------------------------------------------------------

class _BatchTaskConn:
    """Adapts one batched task's reply surface onto the shared
    ``_run_pushed_task`` machinery: final outcomes ride the coalescing
    reply pump instead of a per-rid reply frame; stream TERMINATIONS
    (task_stream_end / task_stream_crash) coalesce onto the same pump as
    tagged entries, while task_yield items pass straight through to the
    real connection (they pace the gen_ack flow). ``key`` is the (task,
    attempt) dedupe identity: attempt included because task retries
    reuse the task id and must re-execute, not replay the old outcome."""

    __slots__ = ("service", "conn", "task_hex", "key", "trace")

    def __init__(self, service: "DaemonService", conn: Connection,
                 task_hex: str, key: tuple, trace=None):
        self.service = service
        self.conn = conn
        self.task_hex = task_hex
        self.key = key
        self.trace = trace      # (name, trace id) of a traced task

    def reply(self, rid, **kw) -> None:
        out = dict(kw)
        out["task"] = self.task_hex
        # fencing stamps: the attempt this outcome belongs to and the
        # daemon's registration epoch; the driver accepts exactly the live
        # (attempt, epoch) pair
        out["att"] = self.key[1]
        out["ep"] = self.service.epoch
        if self.trace is not None:
            out["tr"] = list(self.trace)
        self.service._batch_task_done(self.conn, self.key, out)

    def reply_error(self, rid, err: str) -> None:
        self.reply(rid, e=err)

    def push(self, method: str, **kw) -> None:
        if method in ("task_stream_end", "task_stream_crash"):
            # terminations are final per task: ship them coalesced
            out = dict(kw)
            out["stream"] = method
            out["att"] = self.key[1]
            out["ep"] = self.service.epoch
            pump = self.service._batch_pump
            if pump._aloop is not None and not eventloop.on_loop():
                # the stream's last task_yield may still wait in the loop's
                # queue (conn.push hands it over with call_soon_threadsafe),
                # and a pump flush already due would ship the termination
                # ahead of it: join the same FIFO, behind the yield
                pump._aloop.call_soon_threadsafe(pump.add, self.conn, out)
            else:
                pump.add(self.conn, out)
            return
        self.conn.push(method, **kw)


class _BatchReplyPump:
    """Coalesces completed-task outcomes into ``task_batch_done`` push
    frames: one frame carries every completion that landed within the
    linger window. Final outcomes, ``stored`` results and stream
    terminations of ``push_task_batch`` tasks all ride the same frames.
    Knobs: ``result_batch_max`` (entries a frame) and
    ``result_linger_us``.

    Async core: the pump is a ``call_later`` chain on the event loop (one
    cross-thread wake per linger window, and the flush runs where the
    write batcher lives, so a chunk's push coalesces with other writes of
    the loop). Threaded core: one thread waits on a condition. A frame
    lost in transit (the ``batch.result_flush`` seam's drop or error arm)
    requeues its entries and the rest of its connection's, in order, and
    the next pass resends them after at least a 1 ms backoff; a closed
    connection's outcomes are dropped (the driver is gone). An outcome
    resent is idempotent at the driver (a final outcome pops its waiter
    slot exactly once)."""

    def __init__(self, task_events=None, node_hex: str = ""):
        from ray_tpu_torch._private.config import cfg
        self.linger_s = max(0.0, float(cfg().result_linger_us) / 1e6)
        self.max_per_frame = max(1, int(cfg().result_batch_max))
        # result_flush spans go here (the daemon's lane)
        self.task_events = task_events
        self.node_hex = node_hex
        self._cv = threading.Condition()
        # conn -> [(outcome, t_add)]: t_add is perf_counter at buffering,
        # read for traced outcomes only
        self._buf: Dict[Connection, list] = {}  #: guarded by self._cv
        self._aloop = eventloop.get_loop() if cfg().async_core else None
        self._armed = False     #: guarded by self._cv (loop mode)
        if self._aloop is None:
            threading.Thread(target=self._loop, daemon=True,
                             name="batch-reply-pump").start()

    def add(self, conn: Connection, out: Dict[str, Any]) -> None:
        t_add = time.perf_counter() if "tr" in out else 0.0
        with self._cv:
            self._buf.setdefault(conn, []).append((out, t_add))
            if self._aloop is None:
                self._cv.notify()
                return
            if self._armed:
                return      # a flush is already scheduled: coalesce
            self._armed = True
        if eventloop.on_loop():
            self._arm_flush()  # raylint: disable=loop-affinity — on_loop() guard
        else:
            self._aloop.call_soon_threadsafe(self._arm_flush)

    def _arm_flush(self, backoff: float = 0.0) -> None:  #: loop-only
        delay = max(self.linger_s, backoff)
        if delay > 0:
            self._aloop.call_later(delay, self._flush_on_loop)
        else:
            self._aloop.call_soon(self._flush_on_loop)

    def _flush_on_loop(self) -> None:  #: loop-only
        with self._cv:
            buf, self._buf = self._buf, {}
            self._armed = False
        if not self._send(buf):
            return
        with self._cv:
            re_arm = not self._armed and bool(self._buf)
            if re_arm:
                self._armed = True
        if re_arm:
            # the 1 ms floor is the threaded pump's backoff after a failed
            # pass: no busy spin at linger 0 against a failing link
            self._arm_flush(backoff=0.001)

    def _send(self, buf: Dict[Connection, list]) -> bool:
        """Push every buffered chunk; True when a chunk was lost in
        transit (it and the rest of its connection's entries are back in
        the buffer, in order)."""
        failed = False
        for conn, entries in buf.items():
            for i in range(0, len(entries), self.max_per_frame):
                if conn.closed:
                    break   # the driver is gone, its waiters with it
                chunk = entries[i:i + self.max_per_frame]
                if not self._send_chunk(conn, chunk):
                    failed = True
                    with self._cv:
                        self._buf.setdefault(conn, [])[:0] = entries[i:]
                    # the resend is a retry of this loop (counted, as the
                    # RetryPolicy loops are, in ray_tpu_retries_total)
                    from ray_tpu_torch._private.retry import record_retry
                    record_retry("batch.result_flush", 0.001)
                    break
        return failed

    def _send_chunk(self, conn: Connection, chunk) -> bool:
        if _fp.ENABLED:
            try:
                # drop/error arm = the frame is lost in transit; the
                # caller requeues and the next pass resends
                if _fp.fire("batch.result_flush",
                            n=len(chunk)) is _fp.DROP:
                    return False
            except Exception:
                return False
        now = time.perf_counter()
        conn.push("task_batch_done", outcomes=[o for o, _ in chunk])
        dwell = max((now - t for _, t in chunk if t), default=0.0)
        if dwell:
            _metrics.note_queue_dwell("daemon.reply_pump", dwell)
            self._record_flush_spans(chunk, now)
        return True

    def _record_flush_spans(self, chunk, now: float) -> None:
        """The result_flush phase: completion buffered on the pump -> its
        frame on the wire (the daemon's lane, traced outcomes only)."""
        for out, t_add in chunk:
            tr = out.get("tr")
            if not tr or not t_add:
                continue
            _events.record_phase(
                self.task_events, task_id=out.get("task", ""),
                name=tr[0], phase="result_flush",
                dur_s=max(now - t_add, 0.0), node_id=self.node_hex,
                proc=f"daemon:{self.node_hex[:8]}", trace_id=tr[1],
                start_wall=_events.wall_at(t_add), end_mono=now)

    def _loop(self) -> None:
        failed_last_pass = False
        while True:
            with self._cv:
                while not self._buf:
                    self._cv.wait()
            # short linger: completions that land together leave together.
            # After a failed pass it is the retry backoff too, floored so a
            # linger of 0 cannot busy-spin against a failing link
            linger = self.linger_s
            if failed_last_pass:
                linger = max(linger, 0.001)
            if linger:
                time.sleep(linger)
            with self._cv:
                buf, self._buf = self._buf, {}
            failed_last_pass = self._send(buf)


# completed batched-task outcomes kept for duplicate-frame resend; the cap
# bounds the inline result blobs a slow driver can pin here
_BATCH_DONE_CAP = 512


# ---------------------------------------------------------------------------
# the daemon's runtime shim (what WorkerClient and the router need)
# ---------------------------------------------------------------------------

class _NodeStub:
    __slots__ = ("node_id",)

    def __init__(self, node_id: NodeID):
        self.node_id = node_id


class DaemonRuntime:
    """Forwards worker-initiated core ops to the owner (the driver)."""

    def __init__(self, service: "DaemonService"):
        self.service = service
        # a daemon serves several drivers: a task's job rides its spec, and
        # a spec without one runs under no job (never another driver's)
        self.job_id = None
        self.namespace = None
        self._shutdown = False
        from ray_tpu_torch._private.worker_process import ProcessRouter

        self.process_router = ProcessRouter(self)

    @property
    def task_events(self):
        """The span sink of this daemon's workers (their exec spans land
        here; the heartbeat ships them to the head)."""
        return self.service.task_events

    def shm_ops(self, call: str, kw: Dict[str, Any], client=None):
        """Daemon-LOCAL object-plane ops of this daemon's workers (never
        forwarded to the owner): meta resolution for zero-copy gets,
        reserve/seal/abort for direct puts. ``client`` is the issuing
        WorkerClient: grants are charged to its (pid, generation)
        identity for crash reclamation."""
        return self.service.handle_worker_shm_op(call, kw, client)

    def forward_core_op(self, call: str, payload, key: Optional[str],
                        own: Optional[str] = None) -> Tuple[bool, bytes]:
        """A worker's nested core op, to the driver ``own`` names (the
        token its task carried)."""
        owner = self.service.driver_of(own).owner
        out = owner.call("core_op", call=call, payload=payload, task=key,
                         timeout=None)
        return out["ok"], out["value"]

    def on_actor_worker_died(self, actor_id: ActorID, cause: str) -> None:
        self.service.notify_driver(
            "actor_worker_died", self.service.actor_drivers(actor_id),
            actor_id=actor_id.hex(), cause=cause)



def _load_spec(blob: bytes):
    """The driver's slim task spec (no function, no arguments: those ride
    as blobs the daemon never loads)."""
    return pickle.loads(blob)


class _Driver:
    """One attached driver: its connection, the client its workers' nested
    core ops reach (its owner server), its job and namespace, and the token
    that names it on task frames (its connection's ledger id)."""

    __slots__ = ("conn", "owner", "job_id", "namespace", "token")

    def __init__(self, conn, owner: Client, job_id, namespace: str,
                 token: str):
        self.conn = conn
        self.owner = owner
        self.job_id = job_id
        self.namespace = namespace
        self.token = token


# ---------------------------------------------------------------------------
# service
# ---------------------------------------------------------------------------

class DaemonService:
    def __init__(self, node_id_hex: str, resources: Dict[str, float],
                 object_store_bytes: int, host: str = "127.0.0.1",
                 session_dir: Optional[str] = None, persist: bool = False):
        from ray_tpu_torch._private import log_monitor as _lm
        from ray_tpu_torch._private.config import cfg as _cfg
        # this daemon's workers write per-pid log files in a dir of its
        # own, removed with the daemon: set before the first worker spawns
        # (the pool prestarts below), since a worker takes its dir at boot
        self._own_log_dir: Optional[str] = None
        if _lm.log_to_driver_enabled() and not _cfg().log_dir:
            self._own_log_dir = tempfile.mkdtemp(
                prefix=f"ray_tpu_torch_logs_{node_id_hex[:12]}_")
            _lm.set_session_log_dir(self._own_log_dir)
        self.node_id = NodeID.from_hex(node_id_hex)
        self.resources = resources
        # persist=True (a cluster `ray-tpu start` stood up): outlive driver
        # disconnects and serve the next driver; False (a driver's own
        # session): end with the driver
        self.persist = persist
        self.preemption_watcher: Optional[PreemptionWatcher] = None
        # Spill armed only under the memory_pressure switch (off by
        # default, as in JAX): a disarmed table keeps every hook a
        # None-check. The default spill dir lives in the driver's session
        # dir, which the driver's shutdown removes.
        spill_dir = None
        # the default dir is this daemon's own and goes with it
        self._own_spill_dir: Optional[str] = None
        if _cfg().memory_pressure:
            spill_dir = _cfg().arena_spill_dir
            if not spill_dir:
                spill_dir = self._own_spill_dir = os.path.join(
                    session_dir or tempfile.gettempdir(),
                    f"spill_{node_id_hex[:12]}")
        self.objects = ObjectTable(
            f"rtpt_{node_id_hex[:12]}", object_store_bytes,
            spill_dir=spill_dir,
            spill_budget=int(_cfg().arena_spill_budget_bytes))
        # Hand the arena to every worker this daemon spawns: workers
        # attach the segment by name and resolve host-tier objects in
        # place.
        if self.objects._shm is not None and _cfg().objectplane_attach:
            from ray_tpu_torch._private import worker_process as _wp
            _wp.set_arena_info(self.objects.arena_name,
                               self.objects._shm.capacity())
        # every attached driver by connection, oldest first, and by token
        # (a --persist daemon may serve several at once)
        self._drivers: "OrderedDict[Connection, _Driver]" = OrderedDict()  #: guarded by self._lock
        self._driver_tokens: Dict[str, _Driver] = {}  #: guarded by self._lock
        # (pid, stream) -> the driver token of the worker's latest log
        # marker (the log monitor's thread only)
        self._log_owners: Dict[Tuple[int, str], str] = {}
        # fencing epoch minted by the head at register_node; stamped into
        # heartbeats, hello replies and every result/stream frame
        self.epoch = 0
        # this process's span buffer: dispatch and result-flush spans and
        # the workers' exec spans, flushed to the head on heartbeats
        self.task_events = _events.TaskEventBuffer(capacity=50_000)
        self.runtime = DaemonRuntime(self)
        self.node_stub = _NodeStub(self.node_id)
        self._lock = tracked_lock("daemon.ledger", reentrant=False)
        # lease id -> (worker client, the granting driver's connection)
        self._leases: Dict[str, Tuple[Any, Any]] = {}  #: guarded by self._lock
        self._lease_seq = 0                        #: guarded by self._lock
        # task_id hex -> (client, worker rid, the pushing driver's
        # connection) for cancel/gen_ack
        self._task_rids: Dict[str, Tuple[Any, str, Any]] = {}  #: guarded by self._lock
        # task hex -> job hex of running classic tasks: the memory
        # monitor's owner key, so the tenant-aware policy can find an
        # over-quota job's workers
        self._task_jobs: Dict[str, str] = {}       #: guarded by self._lock
        # the driver's tenancy table and its over-quota jobs (tenancy_sync)
        self._tenancy_jobs: Dict[str, Dict[str, Any]] = {}
        self._over_quota_jobs: set = set()
        # cross-language actors: name -> [actor id, seqno, call lock]
        self._xlang_actors: Dict[str, list] = {}   #: guarded by self._lock
        self._xlang_head_client = None             #: guarded by self._lock
        # batched-submit dedupe keyed (task hex, attempt): a retried frame
        # must not double-execute: running tasks are skipped, finished
        # ones get their recorded outcome resent. Each entry keeps the
        # submitting driver's connection, so its departure drops them.
        self._batch_running: Dict[tuple, Any] = {}  #: guarded by self._lock
        #: guarded by self._lock
        self._batch_done: "OrderedDict[tuple, Tuple[Any, Dict[str, Any]]]" = OrderedDict()
        self._batch_pump = _BatchReplyPump(self.task_events, node_id_hex)
        self._bundles: Dict[Tuple[str, int], Dict[str, Any]] = {}  #: guarded by self._lock
        # the node's memory-pressure level, advertised on heartbeats and
        # the syncer row and pushed to the driver on transitions; "ok"
        # for ever when cfg().memory_pressure is off
        self.pressure: Optional[Any] = None        # PressureController
        self._peers: Dict[Tuple[str, int], Client] = {}  #: guarded by self._lock
        self.head_addr = None            # set by main()
        # peer resource gossip: versioned per-node load entries, merged
        # peer to peer; the loop starts in main() once the head is known
        self._syncer_view: Dict[str, Dict[str, Any]] = {}  #: guarded by self._syncer_lock
        self._syncer_lock = tracked_lock("daemon.syncer", reentrant=False)
        self._syncer_peers_cache: Dict[str, Any] = {}
        self._syncer_peers_ts = 0.0
        self._syncer_interval_s = float(
            os.environ.get("RAY_TPU_SYNCER_INTERVAL_S", "0.5"))
        # Task bodies block on worker IPC, so the pool is sized well past
        # the core count; its cap must exceed the driver's in-flight bound
        # a node (256): a parent task blocked in get() on a child routed
        # here holds a pool thread.
        from ray_tpu_torch._private.thread_pool import DaemonThreadPool
        self._task_pool = DaemonThreadPool(1024, name="daemon-task")
        self.pulls = PullManager(self.objects, self._peer)
        from ray_tpu_torch.objectplane.push import PushManager, PushReceiver
        self.pushes = PushManager(self.objects, self._peer,
                                  locate_fn=self._locate_via_owner)
        self.push_rx = PushReceiver(self.objects,
                                    register_oid=self.objects.register_oid)
        # The native core (csrc/daemon_core.cc): the C++ event loop that
        # owns the plain-task hot path. Drivers submit straight to it, it
        # leases a dedicated worker, forwards the payload and routes the
        # outcome back. It binds where the RPC server binds: a loopback
        # daemon must not open a network-reachable task port.
        self.fast_core = None
        self.fast_port: Optional[int] = None
        self._fast_host = host
        self._fast_workers: list = []
        self._fast_tag_seq = 0        # targeted-lane (actor) tags
        self._fast_max = max(1, min(16, int(resources.get("CPU", 2) or 2)))
        if _cfg().fast_lane:
            try:
                from ray_tpu_torch._private.fast_lane import CoreHandle
                core = CoreHandle()
                port = core.start(host, 0)
                if port:
                    self.fast_core = core
                    self.fast_port = port
                    threading.Thread(target=self._fast_pool_loop,
                                     daemon=True,
                                     name="fastlane-pool").start()
            except Exception:
                self.fast_core = None
        # the monitor forwards new lines of the workers' log files to the
        # driver
        self._log_monitor = None
        if _lm.log_to_driver_enabled():
            self._log_monitor = _lm.LogMonitor(
                _lm.session_log_dir(), self._forward_worker_log,
                on_owner=self._note_log_owner)
            # a dead worker's driver is forgotten once its last lines are in
            self._forget_worker = lambda c: self._log_monitor.forget(c.pid)
            from ray_tpu_torch._private import worker_process as _wp
            _wp.DEATH_HOOKS.append(self._forget_worker)
        self.memory_monitor = None      # started by main()
        self.agent_port: Optional[int] = None
        self._agent = None
        # the continuous profiler (profiling_hz, off by default): this
        # daemon's record and its workers' ship to the head on heartbeats
        _profiling.maybe_start_from_config(f"daemon:{node_id_hex[:8]}")

    def _note_log_owner(self, pid: int, stream: str, token: str) -> None:
        """A worker's marker: its lines that follow go to ``token``'s
        driver; an empty token (no driver's thread, or the worker died)
        leaves them to every attached driver."""
        if token:
            self._log_owners[(pid, stream)] = token
        else:
            self._log_owners.pop((pid, stream), None)

    def _forward_worker_log(self, pid: int, stream: str,
                            line: str) -> None:
        """A worker's line goes to the driver whose task it ran when it
        printed it (the file's latest marker); one before any marker, to
        every attached driver; one of a departed driver's task, nowhere."""
        token = self._log_owners.get((pid, stream))
        if token is None:
            drivers = None
        else:
            with self._lock:
                drv = self._driver_tokens.get(token)
            if drv is None:
                return
            drivers = [drv]
        self.notify_driver("worker_log", drivers, pid=pid, stream=stream,
                           line=line, node=self.node_id.hex()[:8])

    # -- fast lane (native core) workers --------------------------------
    def _fast_dedicate_worker(self):
        """Spawn a worker dedicated to the native core's lane. Its pipe
        stays open for host ops (fetch_function, nested core ops); it never
        enters the idle pool."""
        from ray_tpu_torch._private import worker_process as wp

        w = wp._spawn_worker()
        w.fast_lane = True
        w.raw_outcomes = True
        w.runtime = self.runtime
        w.node = self.node_stub
        lane_host = ("127.0.0.1" if self._fast_host in ("0.0.0.0", "")
                     else self._fast_host)
        rid, pend = w._request({"op": "join_fast_lane",
                                "addr": [lane_host, self.fast_port]})
        out = w._wait_outcome(rid, pend)
        if out[0] not in ("ok", "ok_raw"):
            w.kill(expected=True)
            raise RuntimeError(f"fast-lane join failed: {out!r}")
        # a set_extra_sys_path that landed between this worker's boot and
        # now is re-sent here
        wp.ensure_sys_path(w)
        return w

    def _fast_pool_loop(self) -> None:
        """Queue-depth-driven sizing of the dedicated lane workers: at
        least one alive; grow one at a time while the core reports a
        backlog, up to the node's CPU count."""
        while True:
            try:
                from ray_tpu_torch._private import worker_process as wp
                alive = [w for w in self._fast_workers if w.alive()]
                self._fast_workers = alive
                for w in alive:
                    wp.ensure_sys_path(w)   # a no-op when current
                stats = (self.fast_core.stats()
                         if self.fast_core is not None else {})
                if (not alive
                        or (stats.get("queued", 0) > 0
                            and len(alive) < self._fast_max)):
                    self._fast_workers.append(self._fast_dedicate_worker())
                    continue   # re-check at once while backlogged
            except Exception:
                time.sleep(1.0)
            time.sleep(0.25)

    def _peer(self, addr: Tuple[str, int]) -> Client:
        # dial OUTSIDE the lock: holding it across a TCP connect would
        # stall every other peer lookup; losing a dial race just closes
        # the extra connection
        addr = tuple(addr)
        with self._lock:
            peer = self._peers.get(addr)
        if peer is not None and not peer.dead:
            return peer
        fresh = rpc.connect(addr)
        with self._lock:
            peer = self._peers.get(addr)
            if peer is None or peer.dead:
                peer = self._peers[addr] = fresh
        if peer is not fresh:
            fresh.close()
        return peer

    def _locate_via_owner(self, oid: bytes, conn=None):
        """Owner-keyed object directory: ask the object's owner which
        nodes hold a copy. The owner is the driver of ``conn`` (the driver
        whose task reads the object); without one (a push's dedupe), every
        attached driver is asked, and only the owner knows the object."""
        from ray_tpu_torch._private.fast_lane import join_parts, loads_joined
        from ray_tpu_torch._private.worker_process import _pack
        drv = conn.meta.get("driver") if conn is not None else None
        with self._lock:
            drivers = ([drv] if drv is not None
                       else list(self._drivers.values()))
        payload = bytes(join_parts(_pack({"oid": oid})))
        holders: list = []
        for d in drivers:
            try:
                out = d.owner.call("core_op", call="locate_object",
                                   payload=payload, task=None, timeout=30.0)
            except Exception:   # noqa: BLE001 - that driver left
                continue
            if out.get("ok"):
                holders.extend(loads_joined(out["value"]))
        return holders

    # -- wiring ----------------------------------------------------------
    def driver_of(self, token: Optional[str]) -> _Driver:
        """The driver a worker's task belongs to (``token`` rode the task's
        frame); a frame with none (a thread the task started) falls to the
        only attached driver. Never another driver's: a task whose driver
        left gets an error."""
        with self._lock:
            drv = self._driver_tokens.get(token) if token else None
            if drv is None and not token and len(self._drivers) == 1:
                drv = next(iter(self._drivers.values()))
            attached = len(self._drivers)
        if drv is None:
            raise RuntimeError(
                f"the driver of this task ({token or 'not named'}) is not "
                f"attached to daemon {self.node_id.hex()[:8]} "
                f"({attached} drivers are)")
        return drv

    def actor_drivers(self, actor_id: ActorID) -> List[_Driver]:
        """The attached driver that created ``actor_id`` (none if it left)."""
        with self._lock:
            return [d for d in self._drivers.values()
                    if actor_id in d.conn.meta.get("actors", ())]

    @staticmethod
    def _token_of(conn) -> Optional[str]:
        """The token of the driver whose connection ``conn`` is."""
        drv = conn.meta.get("driver")
        return drv.token if drv is not None else None

    def handle_hello_driver(self, conn, rid, msg):
        conn.link("driver")
        owner = rpc.connect(tuple(msg["owner_addr"]),
                            timeout=None).link("driver")
        drv = _Driver(conn, owner, _load_spec(msg["job_id"]),
                      msg["namespace"], self._conn_client_id(conn))
        with self._lock:
            # a persistent daemon may serve several drivers at once (more
            # joined by `init(address=)`): each keeps its own record
            old = self._drivers.pop(conn, None)
            self._drivers[conn] = drv
            self._driver_tokens[drv.token] = drv
        conn.meta["driver"] = drv
        if old is not None:     # a repeated hello on one connection
            old.owner.close()
        # the driver's import roots: future workers get them in the boot
        # frame, running ones (prestarted pool, lane) an extend op, so
        # by-reference pickles of the driver's modules resolve
        from ray_tpu_torch._private import worker_process as wp
        paths = list(msg.get("sys_path") or [])
        if paths:
            wp.set_extra_sys_path(paths)
            for w in wp.live_workers() + list(self._fast_workers):
                try:
                    wp.ensure_sys_path(w)
                except Exception:
                    pass
        # Report ready once the pool is warm: the first lease otherwise
        # pays a cold fork while racing the driver's work for the CPU.
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline:
            with wp._POOL_LOCK:
                if wp._IDLE:
                    break
            time.sleep(0.02)
        return {"ok": True, "pid": os.getpid(),
                "fast_port": self.fast_port,
                # result fencing: outcomes carry this registration epoch
                "epoch": self.epoch, "fence": True,
                # fair-share federation: this daemon takes tenancy_sync
                # job tables
                "tenancy": True,
                # which wire+dispatch core this daemon runs (frames are
                # identical either way: observational, capabilities.py)
                "async_core": self._batch_pump._aloop is not None,
                # zero-copy object plane: same-host clients attach this
                # arena by name for direct puts and slot-ref'd gets
                "objectplane": self.objects._shm is not None,
                "arena": self.objects.arena_name,
                "arena_capacity": (self.objects._shm.capacity()
                                   if self.objects._shm else 0),
                # connection-scoped grant-ledger identity: every grant or
                # reservation this connection asks for is charged here and
                # reclaimed when the connection dies. It is also this
                # driver's token, which its lane frames carry.
                "client_id": drv.token}

    def notify_driver(self, kind: str, drivers=None, **kw) -> None:
        """Push to ``drivers`` (every attached driver when None)."""
        if drivers is None:
            with self._lock:
                drivers = list(self._drivers.values())
        for drv in drivers:
            if not drv.conn.closed:
                drv.conn.push(kind, **kw)

    def on_disconnect(self, conn: Connection) -> None:
        cid = conn.meta.get("arena_client_id")
        if cid is not None:
            # connection gone (a clean close and a SIGKILL look the same
            # here): reclaim every grant and reservation charged to it
            self.reclaim_client(cid, "disconnect")
        with self._lock:
            drv = self._drivers.pop(conn, None)
            if drv is not None:
                self._driver_tokens.pop(drv.token, None)
            rest = bool(self._drivers)
        if drv is None:
            return      # not a driver's connection
        if not rest and not self.persist:
            # driver gone: this daemon's work is orphaned; exit, as a
            # raylet whose session ended
            threading.Thread(target=self._exit_soon, daemon=True).start()
            return
        # only the departed driver's record, actors, leases and batch
        # records go; the others' work is untouched
        self._drop_driver(drv)
        if not rest:
            # a shared cluster (`ray-tpu start`) whose last driver left:
            # the next one starts clean
            self._reset_for_new_driver()

    def _kill_actors(self, actor_ids) -> None:
        router = self.runtime.process_router
        with router._lock:
            clients = [router._actor_workers.pop(aid, None)
                       for aid in list(actor_ids)]
        for client in clients:
            if client is not None:
                try:
                    client.kill(expected=True)
                except Exception:
                    pass

    def _drop_driver(self, drv: _Driver) -> None:
        """A departed driver's state, with the others' still attached: its
        owner client, the leases it holds (leased mid-task: state unknown,
        killed), its batch dedupe records and task entries, its actors.
        Its tasks still running finish; a nested op of theirs fails, as
        ``driver_of`` finds no driver."""
        try:
            drv.owner.close()
        except OSError:
            pass
        conn = drv.conn
        with self._lock:
            leases = [self._leases.pop(lid)[0]
                      for lid, (_c, lc) in list(self._leases.items())
                      if lc is conn]
            for key in [k for k, c in self._batch_running.items()
                        if c is conn]:
                del self._batch_running[key]
            for key in [k for k, (c, _o) in self._batch_done.items()
                        if c is conn]:
                del self._batch_done[key]
            for task in [t for t, e in self._task_rids.items()
                         if e[2] is conn]:
                del self._task_rids[task]
        for client in leases:
            try:
                client.kill(expected=True)
            except Exception:
                pass
        self._kill_actors(conn.meta.get("actors", ()))

    def _reset_for_new_driver(self) -> None:
        """After the last driver's ``_drop_driver``: what no driver holds
        goes too (bundles, leases and actors of other connections), so the
        next driver starts clean (its objects stay until arena pressure: a
        cross-driver growth bounded by the arena's capacity)."""
        with self._lock:
            leases = [c for c, _conn in self._leases.values()]
            self._leases.clear()
            self._task_rids.clear()
            self._bundles.clear()
            self._batch_running.clear()
            self._batch_done.clear()
        for client in leases:   # leased mid-task: state unknown, kill
            try:
                client.kill(expected=True)
            except Exception:
                pass
        router = self.runtime.process_router
        with router._lock:
            actors = list(router._actor_workers)
        self._kill_actors(actors)

    def _exit_soon(self) -> None:
        time.sleep(0.2)
        self._teardown()
        os._exit(0)

    def _teardown(self) -> None:
        """Kill this daemon's workers and unlink its arena (the exit paths:
        daemon_stop and the driver's disconnect)."""
        from ray_tpu_torch._private import worker_process as wp
        self.runtime._shutdown = True
        if self.memory_monitor is not None:
            self.memory_monitor.stop()
        if self._log_monitor is not None:
            self._log_monitor.stop()
            if self._forget_worker in wp.DEATH_HOOKS:
                wp.DEATH_HOOKS.remove(self._forget_worker)
        if self._own_log_dir is not None:
            shutil.rmtree(self._own_log_dir, ignore_errors=True)
        if self._agent is not None:
            self._agent.shutdown()
            self._agent.server_close()
        _profiling.stop_process_sampler()
        try:
            for w in list(self._fast_workers):
                w.kill(expected=True)
            if self.fast_core is not None:
                self.fast_core.stop()
            wp.stop_worker_plane(timeout=2.0)
        except Exception:
            pass
        self.objects.close()
        if self._own_spill_dir is not None:
            shutil.rmtree(self._own_spill_dir, ignore_errors=True)

    # -- object-plane crash reclamation ----------------------------------
    def reclaim_client(self, client_id: str, reason: str
                       ) -> Tuple[int, int]:
        """One funnel for every death signal (worker pipe EOF, RPC
        connection close, the sweep) that drops the dead client's grants,
        aborts its reservations and reaps, so deferred deletes free now
        instead of at daemon restart. Returns (refs dropped, reservations
        aborted); idempotent per client."""
        if _fp.ENABLED:
            try:
                # drop/error arm = the event-path reclaim is LOST (the
                # death signal raced a daemon hiccup); the heartbeat
                # orphan sweep is the backstop and must still converge
                if _fp.fire("arena.grant_reclaim", client=client_id,
                            reason=reason) is _fp.DROP:
                    return (0, 0)
            except Exception:
                return (0, 0)
        try:
            dropped, aborted = self.objects.reclaim_client(client_id)
        except Exception:
            return (0, 0)   # reclamation must never take the daemon down
        if dropped or aborted:
            from ray_tpu_torch.objectplane import tiers as _tiers
            _tiers.count_grants_reclaimed(dropped, reason)
        return dropped, aborted

    def sweep_object_plane(self) -> None:
        """Heartbeat orphan sweep: the backstop for what the event-path
        reclaim missed: reservations stale past the TTL (the writer died
        between reserve and seal), grants charged to worker pids that no
        longer exist, and ledger drift from silent local releases."""
        obj = self.objects
        if _fp.ENABLED:
            try:
                # drop/error arm = this sweep pass is skipped whole (a
                # later beat retries); a delay arm stretches the pass
                if _fp.fire("arena.reservation_sweep") is _fp.DROP:
                    return
            except Exception:
                return
        try:
            ttl = float(os.environ.get("RAY_TPU_ARENA_RESERVE_TTL_S",
                                       "30"))
        except ValueError:
            ttl = 30.0
        stale = obj.stale_reservations(ttl)
        for key in stale:
            try:
                obj.abort_reserve(key)
            except Exception:
                pass
        if stale:
            from ray_tpu_torch.objectplane import tiers as _tiers
            _tiers.count_stale_reservations(len(stale))
        for cid in obj.ledger_clients():
            if not cid.startswith("w:"):
                continue    # connection ids reclaim via on_disconnect
            try:
                pid = int(cid.split(":")[1])
            except (IndexError, ValueError):
                continue
            if pid > 0 and not _pid_alive(pid):
                self.reclaim_client(cid, "sweep")
        dropped = obj.sweep_orphan_slots()
        if dropped:
            from ray_tpu_torch.objectplane import tiers as _tiers
            _tiers.count_grants_reclaimed(dropped, "sweep")
        obj.reap()

    def slot_ref_attribution(self) -> Dict[str, Any]:
        """slot_ref_stats plus liveness: each ledger client row gains its
        parsed pid (worker identities only) and whether it is alive."""
        stats = self.objects.slot_ref_stats(attribution=True)
        for row in stats.get("clients", ()):
            pid = None
            cid = row.get("client", "")
            if cid.startswith("w:"):
                try:
                    pid = int(cid.split(":")[1])
                except (IndexError, ValueError):
                    pid = None
            row["pid"] = pid
            row["alive"] = _pid_alive(pid) if pid else None
        return stats

    # -- worker lease protocol ------------------------------------------
    def _checkout(self):
        from ray_tpu_torch._private import worker_process as wp
        client = wp.acquire_worker()
        client.raw_outcomes = True
        client.runtime = self.runtime
        client.node = self.node_stub
        wp.ensure_sys_path(client)
        return client

    def handle_request_worker_lease(self, conn, rid, msg):
        """Grant a pooled worker (the raylet's RequestWorkerLease)."""
        if _fp.ENABLED:
            # delay arm = a slow lease grant; error arm = the lease is
            # denied (a RemoteError at the driver)
            _fp.fire("daemon.lease")
        client = self._checkout()
        with self._lock:
            self._lease_seq += 1
            lease_id = f"l{self._lease_seq}"
            self._leases[lease_id] = (client, conn)
        return {"lease_id": lease_id, "worker_pid": client.pid}

    def handle_return_worker(self, conn, rid, msg):
        from ray_tpu_torch._private import worker_process as wp

        with self._lock:
            client, _conn = self._leases.pop(msg["lease_id"], (None, None))
        if client is not None and client.actor_id is None:
            wp.release_worker(client)
        return {"ok": True}

    def _leased(self, lease_id: str):
        with self._lock:
            client, _conn = self._leases.get(lease_id, (None, None))
        if client is None:
            raise KeyError(f"unknown lease {lease_id!r}")
        return client

    # -- task execution --------------------------------------------------
    def _pump_outcome(self, conn, rid, client, spec, outcome,
                      on_done=None) -> None:
        """Shared reply/stream pump of push_task and call_actor_method:
        an inline or stored result, generator stream pushes, worker-crash
        reporting. ``on_done(crashed)`` runs when the interaction (any
        stream included) is over."""
        from ray_tpu_torch._private.worker_process import WorkerCrashed

        task_hex = spec.task_id.hex()
        if outcome[0] == "gen":
            conn.reply(rid, outcome="gen")
            crashed = False
            try:
                # ep: the fencing epoch rides every stream push
                for kind, blob in outcome[1]:
                    if kind == "yield_raw":
                        conn.push("task_yield", task=task_hex,
                                  blob=blob, ep=self.epoch)
                    else:
                        conn.push("task_stream_end", task=task_hex,
                                  ok=False, blob=blob, ep=self.epoch)
                        break
                else:
                    conn.push("task_stream_end", task=task_hex,
                              ok=True, blob=b"", ep=self.epoch)
            except WorkerCrashed as e:
                crashed = True
                client.kill(expected=False)
                conn.push("task_stream_crash", task=task_hex,
                          error=str(e), ep=self.epoch)
            finally:
                with self._lock:
                    self._task_rids.pop(task_hex, None)
                if on_done is not None:
                    on_done(crashed)
            return
        with self._lock:
            self._task_rids.pop(task_hex, None)
        try:
            ok = outcome[0] == "ok_raw"
            blob = outcome[1]
            if ok and len(blob) > INLINE_RESULT:
                oid = b"res:" + spec.task_id.binary()
                self.objects.put(oid, blob)
                n = spec.num_returns
                if spec.return_ids and (n == 1 or not isinstance(n, int)):
                    # node-local oid index: same-node attached workers
                    # resolve this result without the owner round trip.
                    # A multi-return blob holds the WHOLE tuple (the driver
                    # fetches once and splits); indexing ref0 here would
                    # hand consumers the tuple as ref0's value.
                    self.objects.register_oid(
                        spec.return_ids[0].binary(), oid)
                conn.reply(rid, outcome="stored", oid=oid,
                           nbytes=len(blob))
            else:
                conn.reply(rid, outcome="ok" if ok else "err", blob=blob)
        finally:
            if on_done is not None:
                on_done(False)

    @rpc.loop_safe
    def handle_push_task_batch(self, conn, rid, msg):
        """Coalesced submit: N tasks on one frame. Each leases a pooled
        worker, runs and releases it, but the frame is acked once and completions return
        batched on task_batch_done push frames. Idempotent by (task,
        attempt): a retried frame skips tasks already running and resends
        the recorded outcome of tasks already finished."""
        from ray_tpu_torch._private import worker_process as wp
        for _fid, blob in (msg.get("fns") or {}).items():
            # content-addressed (fid == sha1(blob)): workers resolve
            # fetch_function here with no driver round trip
            wp.register_function_blob(blob)
        resend = []
        starts = []
        t0 = time.perf_counter()    # frame arrival: the dispatch span's start
        for entry in msg["tasks"]:
            entry["_t0"] = t0
            key = (entry["task"], entry.get("attempt", 0))
            with self._lock:
                if key in self._batch_running:
                    continue        # duplicate of an in-flight task
                done = self._batch_done.get(key)
                if done is not None:
                    resend.append(done[1])
                    continue
                self._batch_running[key] = conn
            starts.append(self._start_batch_task(conn, entry, key))
        if len(starts) == 1 or not eventloop.on_loop():
            for start in starts:
                self._task_pool.submit(start)
        elif starts:
            # on the loop: ONE pool job fans the starts out, so the pool's
            # thread spawns stay off the loop
            def _fan_out():
                for start in starts:
                    self._task_pool.submit(start)
            self._task_pool.submit(_fan_out)
        for out in resend:
            self._batch_pump.add(conn, out)
        return {"ok": True, "accepted": len(msg["tasks"])}

    def handle_submit_task(self, conn, rid, msg):
        """One classic submit (a driver with ``submit_batch=False``): the
        reply is an immediate ack and the completion returns on the
        task_batch_done pump, deduplicated by (task, attempt) in the batch
        tables, so a resent submit never runs twice."""
        from ray_tpu_torch._private import worker_process as wp
        for _fid, blob in (msg.get("fns") or {}).items():
            wp.register_function_blob(blob)
        key = (msg["task"], msg.get("attempt", 0))
        msg["_t0"] = time.perf_counter()    # the dispatch span's start
        with self._lock:
            if key in self._batch_running:
                return {"outcome": "pump"}  # a duplicate of one in flight
            resend = self._batch_done.get(key)
            if resend is None:
                self._batch_running[key] = conn
        if resend is not None:
            self._batch_pump.add(conn, resend[1])
        else:
            self._task_pool.submit(self._start_batch_task(conn, msg, key))
        return {"outcome": "pump"}

    def _start_batch_task(self, conn, entry, key: tuple):
        """The start closure of one batched task, to run on the task pool
        (it acquires a pooled worker, which may cold-spawn a process, and
        runs the shared pushed-task machinery with the batch reply
        adapter)."""
        trace = ((entry.get("name", ""), entry["trace"])
                 if entry.get("trace") else None)
        bconn = _BatchTaskConn(self, conn, entry["task"], key, trace=trace)

        def start():
            from ray_tpu_torch._private import worker_process as wp

            try:
                client = self._checkout()
            except BaseException as e:  # noqa: BLE001 - shipped back
                bconn.reply_error(None, f"{type(e).__name__}: {e}")
                return
            try:
                self._run_pushed_task(bconn, None, entry, client,
                                      lease_id=None)
            except BaseException as e:  # noqa: BLE001 - e.g. an
                # unloadable spec: release the checkout and fail just this
                # task, not the whole batch
                wp.release_worker(client)
                bconn.reply_error(None, f"{type(e).__name__}: {e}")

        return start

    def _batch_task_done(self, conn, key: tuple,
                         out: Dict[str, Any]) -> None:
        with self._lock:
            self._batch_running.pop(key, None)
            if conn.meta.get("driver") is None or conn in self._drivers:
                # a departed driver's outcomes are not kept for a resend
                self._batch_done[key] = (conn, out)
            while len(self._batch_done) > _BATCH_DONE_CAP:
                self._batch_done.popitem(last=False)
        self._batch_pump.add(conn, out)

    def handle_push_task(self, conn, rid, msg):
        """Execute on the leased worker; replies with the outcome."""
        client = self._leased(msg["lease_id"])
        return self._run_pushed_task(conn, rid, msg, client,
                                     lease_id=msg["lease_id"])

    def _run_pushed_task(self, conn, rid, msg, client, lease_id):
        from ray_tpu_torch._private.fast_lane import split_joined
        spec = _load_spec(msg["spec"])
        spec.backpressure_num_objects = msg["backpressure"]
        task_hex = spec.task_id.hex()
        # the pushing driver: its token rides to the worker, and its
        # departure drops this task's entry
        root = conn.conn if isinstance(conn, _BatchTaskConn) else conn
        own = self._token_of(root)

        def release_lease(crashed: bool) -> None:
            from ray_tpu_torch._private import worker_process as wp

            if lease_id is not None:
                with self._lock:
                    self._leases.pop(lease_id, None)
            # a crash path already killed the worker; release reaps dead
            # ones itself
            if client.actor_id is None and not crashed:
                wp.release_worker(client)

        def run():
            from ray_tpu_torch._private.worker_process import WorkerCrashed

            try:
                if _fp.ENABLED:
                    # a crash arm kills the DAEMON mid-push (node death);
                    # an error arm fails just this task's push
                    _fp.fire("daemon.push_task", task=task_hex)
                t0 = msg.get("_t0")
                if t0 is not None and spec.trace_sampled:
                    # the dispatch phase: frame arrival -> the exec request
                    # to the worker (the daemon's queue wait and checkout)
                    now = time.perf_counter()
                    _events.record_phase(
                        self.task_events, task_id=task_hex,
                        name=spec.name, phase="dispatch", dur_s=now - t0,
                        node_id=self.node_id.hex(),
                        proc=f"daemon:{self.node_id.hex()[:8]}",
                        trace_id=spec.trace_id,
                        start_wall=_events.wall_at(t0), end_mono=now)
                wrid, pend = client._request({
                    "op": "execute_task", "fn_id": msg["fid"],
                    "ctx": client._ctx_fields(spec, self.node_stub,
                                              self.runtime),
                    "runtime_env": spec.runtime_env,
                    "backpressure": msg["backpressure"],
                    "own": own,
                }, split_joined(msg["args"]))
                with self._lock:
                    self._task_rids[task_hex] = (client, wrid, root)
                    if spec.job_id is not None:
                        self._task_jobs[task_hex] = spec.job_id.hex()
                outcome = client._wait_outcome(wrid, pend)
            except WorkerCrashed as e:
                client.kill(expected=False)
                with self._lock:
                    self._task_rids.pop(task_hex, None)
                release_lease(True)
                conn.reply(rid, outcome="crashed", error=str(e))
                return
            except BaseException as e:  # noqa: BLE001 - must answer HOLD
                with self._lock:
                    self._task_rids.pop(task_hex, None)
                release_lease(False)
                conn.reply_error(rid, f"{type(e).__name__}: {e}")
                return
            self._pump_outcome(conn, rid, client, spec, outcome,
                               on_done=release_lease)

        self._task_pool.submit(run)
        return rpc.HOLD

    def handle_cancel_task(self, conn, rid, msg):
        with self._lock:
            entry = self._task_rids.get(msg["task_id"])
        if entry is None:
            return {"found": False}
        client, wrid, _conn = entry
        if msg["force"]:
            client.expected_death = False
            client.proc.terminate()
        else:
            client.cancel_request(wrid)
        return {"found": True}

    def handle_gen_ack(self, conn, rid, msg):
        with self._lock:
            entry = self._task_rids.get(msg["task_id"])
        if entry is not None:
            client, wrid, _conn = entry
            try:
                client._send({"op": "gen_ack", "target": wrid})
            except Exception:
                pass
        return {"ok": True}

    # -- actors ----------------------------------------------------------
    def handle_create_actor(self, conn, rid, msg):
        from ray_tpu_torch._private.fast_lane import split_joined
        spec = _load_spec(msg["spec"])

        def run():
            from ray_tpu_torch._private import worker_process as wp

            client = self._checkout()
            client.actor_id = spec.actor_id
            try:
                kind, blob = client.create_actor_instance(
                    spec, self.node_stub, msg["fid"],
                    split_joined(msg["args"]), own=self._token_of(conn))
            except wp.WorkerCrashed as e:
                client.kill(expected=False)
                conn.reply(rid, outcome="crashed", error=str(e))
                return
            if kind == "err_raw":
                client.actor_id = None
                wp.release_worker(client)
                conn.reply(rid, outcome="err", blob=blob)
                return
            router = self.runtime.process_router
            with router._lock:
                router._actor_workers[spec.actor_id] = client
            # the creating driver's actors end when it leaves, and their
            # deaths are reported to it
            actors = conn.meta.setdefault("actors", set())
            actors.add(spec.actor_id)

            def died(c, aid=spec.actor_id):
                router._actor_worker_died(aid, c)
                actors.discard(aid)

            client.add_death_callback(died)
            conn.reply(rid, outcome="ok", worker_pid=client.pid,
                       fast_tag=self._grant_fast_tag(client, spec))

        self._task_pool.submit(run)
        return rpc.HOLD

    def _grant_fast_tag(self, client, spec) -> Optional[int]:
        """Bind a serialized actor's worker to the native core under a
        fresh tag, so its method calls skip this daemon's Python; None
        keeps the actor on the classic path (a concurrent actor, a
        concurrency group, no core, or a join that failed)."""
        if (self.fast_core is None or spec.max_concurrency != 1
                or spec.concurrency_groups):
            return None
        with self._lock:
            self._fast_tag_seq += 1
            tag = self._fast_tag_seq
        lane_host = ("127.0.0.1" if self._fast_host in ("0.0.0.0", "")
                     else self._fast_host)
        try:
            trid, tpend = client._request({
                "op": "join_fast_lane",
                "addr": [lane_host, self.fast_port], "tag": tag})
            out = client._wait_outcome(trid, tpend)
        except Exception:
            return None
        if out[0] not in ("ok", "ok_raw"):
            return None
        client.lane_tag = tag
        return tag

    def handle_call_actor_method(self, conn, rid, msg):
        from ray_tpu_torch._private.fast_lane import split_joined
        spec = _load_spec(msg["spec"])
        router = self.runtime.process_router
        with router._lock:
            client = router._actor_workers.get(spec.actor_id)
        if client is None or client.dead:
            conn.reply(rid, outcome="dead")
            return rpc.HOLD
        task_hex = spec.task_id.hex()

        def run():
            from ray_tpu_torch._private.worker_process import WorkerCrashed

            try:
                wrid, pend = client._request({
                    "op": "call_method", "method": spec.method_name,
                    "ctx": client._ctx_fields(spec, self.node_stub,
                                              self.runtime),
                    "runtime_env": spec.runtime_env,
                    "own": self._token_of(conn),
                }, split_joined(msg["args"]))
                with self._lock:
                    self._task_rids[task_hex] = (client, wrid, conn)
                    if spec.job_id is not None:
                        self._task_jobs[task_hex] = spec.job_id.hex()
                outcome = client._wait_outcome(wrid, pend)
            except WorkerCrashed as e:
                with self._lock:
                    self._task_rids.pop(task_hex, None)
                conn.reply(rid, outcome="crashed", error=str(e))
                return
            self._pump_outcome(conn, rid, client, spec, outcome)

        self._task_pool.submit(run)
        return rpc.HOLD

    def handle_kill_actor(self, conn, rid, msg):
        actor_id = ActorID.from_hex(msg["actor_id"])
        self.runtime.process_router.discard_actor(
            actor_id, expected=msg["expected"])
        return {"ok": True}

    # -- placement group bundles: two-phase commit -----------------------
    def handle_prepare_bundle(self, conn, rid, msg):
        """Phase 1: reserve (an advisory ledger: placement authority is the
        single controller; the two phases match the raylet's wire
        contract, PrepareBundleResources / CommitBundleResources)."""
        key = (msg["pg_id"], msg["index"])
        with self._lock:
            self._bundles[key] = {"resources": msg["resources"],
                                  "state": "PREPARED"}
        return {"ok": True}

    def handle_commit_bundle(self, conn, rid, msg):
        key = (msg["pg_id"], msg["index"])
        with self._lock:
            entry = self._bundles.get(key)
            if entry is None:
                return {"ok": False}
            entry["state"] = "COMMITTED"
        return {"ok": True}

    def handle_cancel_bundle(self, conn, rid, msg):
        with self._lock:
            self._bundles.pop((msg["pg_id"], msg["index"]), None)
        return {"ok": True}

    # -- object plane -----------------------------------------------------
    def _worker_client_id(self, client) -> str:
        """Ledger identity of a pool worker, ``w:<pid>:<generation>``. The
        first grant arms the crash hook: the pipe-EOF death callback fans
        into reclaim_client (exit, crash and SIGKILL alike)."""
        if client is None:
            return UNKNOWN_CLIENT
        cid = getattr(client, "arena_client_id", None)
        if cid is None:
            cid = f"w:{client.pid}:{getattr(client, 'gen', 0)}"
            client.arena_client_id = cid
            client.add_death_callback(
                lambda _c, cid=cid: self.reclaim_client(cid, "death"))
        return cid

    def handle_worker_shm_op(self, call: str, kw: Dict[str, Any],
                             client=None):
        """Object-plane ops of this daemon's OWN workers, served over the
        worker pipe without the owner (the zero-copy protocol's metadata
        leg: payloads never ride the pipe)."""
        obj = self.objects
        if call == "shm_get_meta":
            cid = self._worker_client_id(client)
            out = []
            for oid in kw["oids"]:
                entry = None
                key = obj.key_for(oid)
                if key is not None:
                    meta = obj.get_ext_meta(key, cid)  # increfs ext slot
                    if meta is not None:
                        arena, cap, off, size, slot = meta
                        entry = {"arena": arena, "capacity": cap,
                                 "off": off, "size": size, "slot": slot,
                                 "raw": obj.raw_for(key)}
                out.append(entry)
            return out
        if call == "shm_release":
            cid = self._worker_client_id(client)
            for slot in kw.get("slots", ()):
                obj.ext_release(slot, cid)
            return True
        if call == "shm_put_reserve":
            if self.pressure_level() == "hard":
                # shed NEW arena writes while hard-pressured; the worker
                # falls back to its classic put (a payload round trip,
                # never an error)
                return {"full": True, "backpressure": True}
            off = obj.reserve(kw["key"], int(kw["size"]),
                              self._worker_client_id(client))
            if off is None:
                return {"full": True}
            return {"off": off}
        if call == "shm_put_seal":
            return {"ok": obj.seal(kw["key"], ref=kw.get("ref") or b"",
                                   raw=kw.get("raw"))}
        if call == "shm_put_abort":
            obj.abort_reserve(kw["key"])
            return {"ok": True}
        raise ValueError(f"unknown shm op {call!r}")

    def handle_put_object(self, conn, rid, msg):
        if self.pressure_level() == "hard":
            # typed retriable backpressure: the driver raises
            # MemoryPressureError and rides RetryPolicy until relief
            return {"backpressure": True, "level": "hard"}
        self.objects.put(msg["oid"], msg["blob"])
        key = msg["oid"]
        if key.startswith(b"put:"):
            # driver puts key by logical oid: index it so same-node
            # attached workers resolve the ref without the owner
            self.objects.register_oid(key[4:], key)
        return {"ok": True}

    def _conn_client_id(self, conn) -> str:
        """Ledger identity of an RPC client (driver or external
        attacher): connection-scoped, so on_disconnect reclaims all."""
        if conn is None:
            return UNKNOWN_CLIENT
        return conn.meta.setdefault("arena_client_id",
                                    f"c:{uuid.uuid4().hex[:12]}")

    def handle_create_object(self, conn, rid, msg):
        """Reserve arena space for a same-host client's direct put (the
        client writes through its own mapping, then seal_object).
        Idempotent for a retried (oid, size)."""
        if self.pressure_level() == "hard":
            return {"full": True, "backpressure": True}
        off = self.objects.reserve(msg["oid"], int(msg["size"]),
                                   self._conn_client_id(conn))
        if off is None:
            return {"full": True}
        return {"ok": True, "off": off, "arena": self.objects.arena_name,
                "capacity": (self.objects._shm.capacity()
                             if self.objects._shm else 0)}

    def handle_seal_object(self, conn, rid, msg):
        """Seal a direct-put entry (idempotent). ``ref``/``raw`` feed the
        node-local oid index so attached workers resolve it zero-copy."""
        raw = msg.get("raw")
        ok = self.objects.seal(msg["oid"], ref=msg.get("ref") or b"",
                               raw=tuple(raw) if raw else None)
        return {"ok": ok}

    def handle_get_object(self, conn, rid, msg):
        if msg["prefer_shm"]:
            # slot grants only to callers that advertise the slot protocol
            meta = (self.objects.get_ext_meta(msg["oid"],
                                              self._conn_client_id(conn))
                    if msg.get("slot_ok") else None)
            if meta is not None:
                arena, cap, off, size, slot = meta
                return {"shm": arena, "capacity": cap, "off": off,
                        "size": size, "slot": slot}
            ref = self.objects.get_shm_ref(msg["oid"])
            if ref is not None:
                arena, cap, off, size = ref
                return {"shm": arena, "capacity": cap, "off": off,
                        "size": size}
        blob = self.objects.get_blob(msg["oid"])
        if blob is None:
            return {"missing": True}
        return {"blob": blob}

    def handle_release_object(self, conn, rid, msg):
        if msg.get("slot") is not None:
            # ext-slot release fallback (the client could not attach)
            self.objects.ext_release(int(msg["slot"]),
                                     self._conn_client_id(conn))
            return {"ok": True}
        self.objects.release(msg["oid"])
        return {"ok": True}

    def handle_free_objects(self, conn, rid, msg):
        for oid in msg["oids"]:
            self.objects.delete(oid)
        return {"ok": True}

    @rpc.concurrent
    def handle_pull_object(self, conn, rid, msg):
        """Transfer between nodes: fetch from a peer daemon into the local
        table via the PullManager (chunked, deduplicated, prioritised).
        ``from_addr`` is a hint; without one (or a stale one) the owner's
        object directory is asked. An optional ``ref`` (the logical
        ObjectID, with ``raw``, the raw tier's dtype and shape) indexes the
        landed copy so this node's attached workers resolve it zero-copy,
        as a push's ``ref`` does (JAX's pull takes none)."""
        oid = msg["oid"]
        ref = msg.get("ref") or b""
        raw = msg.get("raw")
        if ref:
            self.objects.register_oid(ref, oid,
                                      raw=tuple(raw) if raw else None)
        if self.objects.contains(oid):
            return {"ok": True, "already": True}
        priority = int(msg.get("priority", PULL_PRIORITY_TASK_ARGS))
        hint = [tuple(msg["from_addr"])] if msg["from_addr"] else []
        last: Dict[str, Any] = {}
        tried = set()
        for phase in range(2):
            candidates = hint if phase == 0 else [
                tuple(a) for a in self._locate_via_owner(oid, conn)]
            for addr in candidates:
                if addr in tried:
                    continue
                tried.add(addr)
                pull = self.pulls.request(oid, addr, priority)
                if not pull.event.wait(timeout=120.0):
                    return {"ok": False, "error": "pull timed out"}
                if pull.ok:
                    return {"ok": True}
                last = ({"ok": False, "missing": True} if pull.missing
                        else {"ok": False, "error": pull.error})
        return last or {"ok": False, "missing": True}

    @rpc.concurrent
    def handle_push_object(self, conn, rid, msg):
        """Driver-directed push of a local object to a peer daemon (dep
        prefetch). Dedupes in flight and against copies the destination
        holds; ``ref`` carries the logical ObjectID for the receiver's
        node-local index."""
        push = self.pushes.request(msg["oid"], tuple(msg["to_addr"]),
                                   ref=msg.get("ref") or b"")
        if not push.event.wait(timeout=120.0):
            return {"ok": False, "error": "push timed out"}
        if push.ok:
            return {"ok": True, "skipped": push.skipped}
        return {"ok": False, "error": push.error}

    def handle_push_chunk(self, conn, rid, msg):
        """Receiver side of a push: chunks assemble into one buffer;
        ``have`` tells the sender to stop (a pull landed it)."""
        return self.push_rx.chunk(msg["oid"], int(msg["off"]),
                                  int(msg["total"]), msg["blob"],
                                  ref=msg.get("ref") or b"",
                                  raw=msg.get("raw"))

    def handle_object_meta(self, conn, rid, msg):
        size = self.objects.nbytes_of(msg["oid"])
        if size is None:
            return {"missing": True}
        return {"size": size}

    # -- the cross-language tier (C++ API) ------------------------------
    # Functions and classes are exported by name to the head's KV from
    # Python (ray_tpu_torch.xlang); a C++ client submits by name with plain
    # arguments; execution happens on this daemon's pooled workers.

    def _xlang_head(self):
        with self._lock:
            if self._xlang_head_client is None:
                if self.head_addr is None:
                    raise RuntimeError("daemon has no head address")
                self._xlang_head_client = HeadClient(self.head_addr)
            return self._xlang_head_client

    @staticmethod
    def _xlang_plain(value):
        """A result crossing the language boundary, as plain values."""
        import numpy as np
        if isinstance(value, np.integer):
            return int(value)
        if isinstance(value, np.floating):
            return float(value)
        if isinstance(value, np.ndarray):
            return value.tolist()
        if isinstance(value, (list, tuple)):
            return [DaemonService._xlang_plain(v) for v in value]
        if isinstance(value, dict):
            return {str(k): DaemonService._xlang_plain(v)
                    for k, v in value.items()}
        if value is None or isinstance(value, (bool, int, float, str,
                                               bytes)):
            return value
        raise TypeError(
            f"xlang result of type {type(value).__name__} cannot cross "
            f"the language boundary; return plain values")

    def _xlang_kv_blob(self, kind: str, name: str):
        return self._xlang_head().kv_get(f"xlang:{kind}:{name}".encode())

    @staticmethod
    def _xlang_args(blob) -> list:
        """The caller's arguments: a frame-encoded list of plain values
        (the unpickler refuses any global)."""
        args = rpc.loads_frame(blob)
        if not isinstance(args, (list, tuple)):
            raise TypeError(f"xlang args are a list, not "
                            f"{type(args).__name__}")
        return list(args)

    def handle_xlang_submit(self, conn, rid, msg):
        """One cross-language task on a pooled worker."""
        def run():
            from ray_tpu_torch._private import worker_process as wp
            from ray_tpu_torch._private.ids import TaskID
            from ray_tpu_torch._private.task_spec import TaskKind, TaskSpec
            client = None
            streaming = False
            try:
                blob = self._xlang_kv_blob("fn", msg["name"])
                if blob is None:
                    conn.reply(rid, outcome="err",
                               error=f"no exported xlang function "
                                     f"{msg['name']!r}")
                    return
                fid = wp.register_function_blob(blob)
                spec = TaskSpec(
                    task_id=TaskID.from_random(), kind=TaskKind.NORMAL,
                    name=f"xlang:{msg['name']}", func=None)
                parts = wp._pack((tuple(self._xlang_args(msg["args"])), {}))
                client = self._checkout()
                client.raw_outcomes = False     # decoded here
                outcome = client.execute_task(spec, self.node_stub, fid,
                                              parts)
                if outcome[0] == "ok":
                    conn.reply(rid, outcome="ok",
                               result=self._xlang_plain(outcome[1]))
                elif outcome[0] == "gen":
                    # mid-stream: the worker must not go back to the pool
                    streaming = True
                    conn.reply(rid, outcome="err",
                               error="xlang tasks cannot stream")
                else:
                    conn.reply(rid, outcome="err", error=repr(outcome[1]))
            except BaseException as e:  # noqa: BLE001 - shipped back
                conn.reply(rid, outcome="err", error=repr(e))
            finally:
                if client is not None:
                    if streaming:
                        client.kill(expected=True)
                    wp.release_worker(client)   # reaps a killed worker

        self._task_pool.submit(run)
        return rpc.HOLD

    def handle_xlang_create_actor(self, conn, rid, msg):
        """Create a Python actor of a class exported by name on a pooled
        worker, addressable by ``msg['name']`` for xlang_call_actor."""
        def run():
            from ray_tpu_torch._private import worker_process as wp
            from ray_tpu_torch._private.ids import TaskID
            from ray_tpu_torch._private.task_spec import TaskKind, TaskSpec
            taken = f"xlang actor name {msg['name']!r} already taken"
            try:
                with self._lock:
                    exists = msg["name"] in self._xlang_actors
                if exists:
                    conn.reply(rid, outcome="err", error=taken)
                    return
                blob = self._xlang_kv_blob("actor", msg["cls"])
                if blob is None:
                    conn.reply(rid, outcome="err",
                               error=f"no exported xlang actor class "
                                     f"{msg['cls']!r}")
                    return
                fid = wp.register_function_blob(blob)
                spec = TaskSpec(
                    task_id=TaskID.from_random(),
                    kind=TaskKind.ACTOR_CREATION,
                    name=f"xlang:{msg['cls']}", func=None,
                    actor_id=ActorID.from_random(),
                    actor_name=msg["name"])
                parts = wp._pack((tuple(self._xlang_args(msg["args"])), {}))
                router = self.runtime.process_router
                router.create_actor(spec, self.node_stub, (fid, parts))
                with self._lock:
                    lost_race = msg["name"] in self._xlang_actors
                    if not lost_race:
                        self._xlang_actors[msg["name"]] = [
                            spec.actor_id, 0, threading.Lock()]
                if lost_race:
                    # a concurrent create won the name: end ours (outside
                    # the ledger lock)
                    router.discard_actor(spec.actor_id, expected=True)
                    conn.reply(rid, outcome="err", error=taken)
                    return
                conn.reply(rid, outcome="ok", actor_id=spec.actor_id.hex())
            except BaseException as e:  # noqa: BLE001 - shipped back
                conn.reply(rid, outcome="err", error=repr(e))

        self._task_pool.submit(run)
        return rpc.HOLD

    def handle_xlang_call_actor(self, conn, rid, msg):
        with self._lock:
            entry = self._xlang_actors.get(msg["name"])
        if entry is None:
            return {"outcome": "err",
                    "error": f"no xlang actor named {msg['name']!r}"}
        actor_id = entry[0]
        router = self.runtime.process_router
        with router._lock:
            client = router._actor_workers.get(actor_id)
        if client is None or client.dead:
            return {"outcome": "err", "error": "actor is dead"}

        def run():
            from ray_tpu_torch._private import worker_process as wp
            from ray_tpu_torch._private.ids import TaskID
            from ray_tpu_torch._private.task_spec import TaskKind, TaskSpec
            try:
                # the actor's calls run one at a time in arrival order: two
                # clients calling one named actor hold its lock across the
                # seqno and the call
                with entry[2]:
                    with self._lock:
                        entry[1] += 1
                        seqno = entry[1]
                    spec = TaskSpec(
                        task_id=TaskID.from_random(),
                        kind=TaskKind.ACTOR_TASK,
                        name=f"xlang:{msg['name']}.{msg['method']}",
                        func=msg["method"], actor_id=actor_id,
                        method_name=msg["method"], seqno=seqno)
                    parts = wp._pack(
                        (tuple(self._xlang_args(msg["args"])), {}))
                    outcome = client.call_method(spec, self.node_stub,
                                                 parts)
                if outcome[0] == "ok":
                    conn.reply(rid, outcome="ok",
                               result=self._xlang_plain(outcome[1]))
                elif outcome[0] == "err":
                    conn.reply(rid, outcome="err", error=repr(outcome[1]))
                else:
                    conn.reply(rid, outcome="err",
                               error=f"unsupported outcome {outcome[0]}")
            except BaseException as e:  # noqa: BLE001 - shipped back
                conn.reply(rid, outcome="err", error=repr(e))

        self._task_pool.submit(run)
        return rpc.HOLD

    def handle_get_object_chunk(self, conn, rid, msg):
        blob = self.objects.read_range(msg["oid"], msg["off"], msg["size"])
        if blob is None:
            return {"missing": True}
        return {"blob": blob}

    # -- resource syncer: peer-to-peer load gossip ----------------------
    def _syncer_self_entry(self) -> Dict[str, Any]:
        with self._lock:
            running = len(self._task_rids)
        fast = (self.fast_core.stats()
                if self.fast_core is not None else {})
        return {
            "running": running + fast.get("inflight", 0)
            + fast.get("queued", 0),
            "store_used": self.objects.used_bytes(),
            "fast_queued": fast.get("queued", 0),
            # the pressure level rides the load view, so a driver's
            # pick_node soft-excludes a hard node even when it never heard
            # the node_pressure push
            "pressure": self.pressure_level(),
        }

    def _syncer_tick(self) -> None:
        """One anti-entropy round: refresh the self entry, exchange full
        views with up to 2 random peers (merge by version), and now and
        then push the merged view to the head: O(1) head reports an
        interval whatever the node count."""
        import random as _random

        me = self.node_id.hex()
        # build the self entry BEFORE taking the syncer lock: it reads the
        # ledger and the store's accounting
        load = self._syncer_self_entry()
        with self._syncer_lock:
            mine = self._syncer_view.get(me)
            version = (mine["v"] + 1) if mine else 1
            self._syncer_view[me] = {"v": version, "load": load,
                                     "ts": time.time()}
            view = {k: dict(v) for k, v in self._syncer_view.items()}
        peers = [(hex_id, tuple(addr))
                 for hex_id, addr in self._syncer_peers().items()
                 if hex_id != me]
        for _hex_id, addr in _random.sample(peers, min(2, len(peers))):
            try:
                out = self._peer(addr).call("syncer_exchange",
                                            view=view, timeout=5.0)
                self._syncer_merge(out.get("view", {}))
            except (rpc.RpcError, OSError):
                continue
        # head push: probabilistic, so about one node an interval reports
        if _random.random() < 1.0 / max(1, len(peers)):
            self._syncer_push_head()

    def _syncer_peers(self) -> Dict[str, Any]:
        """node hex -> daemon addr, from the head's membership (cached)."""
        now = time.monotonic()
        if now - self._syncer_peers_ts < 5.0:
            return self._syncer_peers_cache
        try:
            head = HeadClient(self.head_addr)
            try:
                nodes = head.list_nodes()
            finally:
                head.close()
            self._syncer_peers_cache = {
                n["node_id"]: tuple(n["addr"]) for n in nodes
                if n.get("alive") and n.get("addr")}
            self._syncer_peers_ts = now
        except (OSError, rpc.RpcError):
            pass
        return self._syncer_peers_cache

    def _syncer_merge(self, view: Dict[str, Any]) -> None:
        with self._syncer_lock:
            for hex_id, entry in view.items():
                cur = self._syncer_view.get(hex_id)
                if cur is None or entry["v"] > cur["v"]:
                    self._syncer_view[hex_id] = dict(entry)

    def _syncer_push_head(self) -> None:
        try:
            head = HeadClient(self.head_addr)
            try:
                with self._syncer_lock:
                    view = {k: dict(v)
                            for k, v in self._syncer_view.items()}
                head._call("report_loads_gossip", view=view)
            finally:
                head.close()
        except (OSError, rpc.RpcError):
            pass

    def _syncer_loop(self) -> None:
        while True:
            try:
                self._syncer_tick()
            except Exception:
                pass
            time.sleep(self._syncer_interval_s)

    def handle_syncer_exchange(self, conn, rid, msg):
        self._syncer_merge(msg["view"])
        with self._syncer_lock:
            return {"view": {k: dict(v)
                             for k, v in self._syncer_view.items()}}

    def handle_syncer_view(self, conn, rid, msg):
        with self._syncer_lock:
            return {"view": {k: dict(v)
                             for k, v in self._syncer_view.items()}}

    # -- control ----------------------------------------------------------
    def handle_daemon_ping(self, conn, rid, msg):
        return {"pid": os.getpid(), "node_id": self.node_id.hex()}

    def handle_net_chaos(self, conn, rid, msg):
        """Chaos harness hook: install (or clear, with an empty spec) a
        seeded netchaos registry in THIS daemon process, for a schedule
        that must degrade one daemon's link only."""
        spec = msg.get("spec") or ""
        if not spec:
            _nc.reset()
            return {"ok": True, "active": False}
        seed = msg.get("seed")
        _nc.activate(spec, seed=int(seed) if seed is not None else None)
        return {"ok": True, "active": True, "links": _nc.describe()}

    def handle_fail_points(self, conn, rid, msg):
        """The failpoint twin of ``net_chaos``: arm (or clear) a seeded
        failpoint registry in THIS daemon process, e.g. a
        ``pressure.level=return(hard)`` on one node."""
        spec = msg.get("spec") or ""
        if not spec:
            _fp.reset()
            return {"ok": True, "active": False}
        seed = msg.get("seed")
        _fp.activate(spec, seed=int(seed) if seed is not None else None)
        return {"ok": True, "active": True, "arms": _fp.describe()}

    def handle_tenancy_sync(self, conn, rid, msg):
        """Adopt the driver's per-job quota and weight table. The daemon is
        not the admission authority (dispatch gating runs in the driver);
        it mirrors the table so its own metrics export the cluster's quota
        configuration and its memory monitor knows the over-quota jobs."""
        jobs = msg.get("jobs") or {}
        self._tenancy_jobs = {str(j): dict(r) for j, r in jobs.items()}
        self._over_quota_jobs = {str(j)
                                 for j in (msg.get("over_quota") or ())}
        for job, rec in self._tenancy_jobs.items():
            for res, cap in (rec.get("quota") or {}).get(
                    "hard", {}).items():
                _metrics.Gauge(
                    "ray_tpu_job_quota_bytes",
                    "configured hard quota caps per job and resource "
                    "axis", ("job_id", "resource")).set(
                    float(cap), tags={"job_id": job, "resource": res})
        return {"ok": True, "count": len(jobs)}

    def handle_daemon_stats(self, conn, rid, msg):
        with self._lock:
            leases = len(self._leases)
            running = len(self._task_rids)
            bundles = {f"{k[0]}:{k[1]}": v["state"]
                       for k, v in self._bundles.items()}
            # one row per attached driver, oldest first
            drivers = [{"token": d.token,
                        "job_id": d.job_id.hex() if d.job_id else None,
                        "namespace": d.namespace,
                        "leases": sum(1 for _c, lc in self._leases.values()
                                      if lc is d.conn),
                        "actors": len(d.conn.meta.get("actors", ()))}
                       for d in self._drivers.values()]
        fast = (self.fast_core.stats()
                if self.fast_core is not None else {})
        # "running" covers both planes: classic tasks and lane tasks in
        # the native core (queued or executing)
        running += fast.get("inflight", 0) + fast.get("queued", 0)
        return {"leases": leases, "running": running,
                "store_used": self.objects.used_bytes(),
                "pull_stats": dict(self.pulls.stats),
                "push_stats": dict(self.pushes.stats),
                "push_rx_stats": dict(self.push_rx.stats),
                "arena": self.objects.arena_name,
                "slot_refs": self.slot_ref_attribution(),
                "fast_lane": fast,
                "pressure": self.pressure_level(),
                "spill": self.objects.spill_stats(),
                "bundles": bundles,
                "agent_port": self.agent_port,
                "drivers": drivers,
                "actors": len(
                    self.runtime.process_router._actor_workers)}

    # -- the node's OOM defense (the raylet's memory monitor) -------------
    def _memory_candidates(self):
        """This node's killable worker processes: running classic tasks
        (by task id hex, what the driver's oom_check sends), actor workers
        and dedicated lane workers."""
        from ray_tpu_torch._private.memory_monitor import _Candidate
        out = []
        with self._lock:
            running = dict(self._task_rids)
            # prune finished tasks' job attributions here, the one
            # periodic scan, instead of at every pop site
            for gone in set(self._task_jobs) - set(running):
                self._task_jobs.pop(gone, None)
            jobs = dict(self._task_jobs)
        router = self.runtime.process_router
        with router._lock:
            actors = dict(router._actor_workers)
        actor_pids = {c.proc.pid for c in actors.values()}
        for task_hex, (client, _rid, _conn) in running.items():
            if client.alive() and client.proc.pid not in actor_pids:
                out.append(_Candidate(client.proc.pid, "task",
                                      task_id=task_hex, retriable=True,
                                      owner_key=jobs.get(task_hex, "")))
        for actor_id, client in actors.items():
            if client.alive():
                out.append(_Candidate(client.proc.pid, "actor",
                                      actor_id=actor_id, retriable=True))
        for w in list(self._fast_workers):
            if w.alive():
                out.append(_Candidate(w.proc.pid, "task", retriable=True,
                                      owner_key="fast-lane"))
        return out

    def start_memory_monitor(self) -> None:
        from ray_tpu_torch._private.config import cfg
        from ray_tpu_torch._private.memory_monitor import (MemoryMonitor,
                                                           TenantAwarePolicy)
        if cfg().memory_monitor:
            self.memory_monitor = MemoryMonitor(
                None, candidates_fn=self._memory_candidates)
            if cfg().memory_pressure:
                # the degradation order under pressure: the workers of
                # over-quota tenants (the driver ledger's verdict, synced)
                # die first
                self.memory_monitor.policy = TenantAwarePolicy(
                    self.memory_monitor.policy,
                    lambda: self._over_quota_jobs)
            self.memory_monitor.start()
        if cfg().memory_pressure and cfg().pressure_tick_s > 0:
            from ray_tpu_torch._private.pressure import PressureController
            self.pressure = PressureController(
                self.objects, monitor=self.memory_monitor,
                on_level=self._on_pressure_level)
            self.pressure.start()

    def pressure_level(self) -> str:
        return self.pressure.level if self.pressure is not None else "ok"

    def _on_pressure_level(self, old: str, new: str) -> None:
        """A pressure transition: tell the driver at once (placement
        reacts now, not at the next gossip round), on the push lane
        DRAINING uses; heartbeats and gossip carry it to everyone else."""
        self.notify_driver("node_pressure", level=new)

    def handle_set_memory_limit(self, conn, rid, msg):
        """The driver's cluster-wide limit; starts this node's monitor if
        the flag left it off."""
        from ray_tpu_torch._private.memory_monitor import MemoryMonitor
        mon = self.memory_monitor
        if mon is None:
            mon = self.memory_monitor = MemoryMonitor(
                None, candidates_fn=self._memory_candidates,
                interval_s=0.25)
            mon.start()
        mon.limit = int(msg["limit"])
        return {"ok": True}

    def handle_oom_check(self, conn, rid, msg):
        """Did this node's monitor OOM-kill the worker running
        ``task_id`` (or, for lane crashes only, any worker very recently:
        lane tasks' ids live in the native core)?"""
        if _fp.ENABLED:
            _fp.fire("daemon.oom_check", task=msg.get("task_id", ""))
        mon = self.memory_monitor
        if mon is None:
            return {"oom": False, "kills": 0}
        if msg.get("task_id") and msg["task_id"] in mon.oom_killed_tasks:
            return {"oom": True, "kills": mon.kills}
        if not msg.get("fast_lane"):
            return {"oom": False, "kills": mon.kills}
        # consumes the entry: one kill explains one crash
        return {"oom": mon.consume_unattributed_kill(), "kills": mon.kills}

    # -- the per-node agent (the reference's dashboard agent) -------------
    def start_agent(self, host: str = "127.0.0.1") -> Optional[int]:
        """This node's observability HTTP endpoint, served from the daemon
        process: ``/api/stats`` (daemon stats as JSON),
        ``/api/profile/cpu?duration=N`` (a stack-sample burst) and
        ``/metrics`` (this process's exposition). Binds a free port and
        returns it (advertised in daemon_stats)."""
        import json as _json
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
        from urllib.parse import parse_qsl

        service = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _send(self, body: bytes, ctype: str,
                      code: int = 200) -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                try:
                    path = self.path.split("?")[0].rstrip("/")
                    if path == "/api/stats":
                        with service._lock:
                            stats = {"node_id": service.node_id.hex(),
                                     "pid": os.getpid(),
                                     "leases": len(service._leases),
                                     "running": len(service._task_rids)}
                        stats["store_used"] = service.objects.used_bytes()
                        if service.fast_core is not None:
                            stats["fast_lane"] = service.fast_core.stats()
                        self._send(_json.dumps(stats).encode(),
                                   "application/json")
                    elif path == "/api/profile/cpu":
                        q = dict(parse_qsl(self.path.partition("?")[2]))
                        dur = min(float(q.get("duration", 2)), 30.0)
                        self._send(_json.dumps(
                            _profiling.sample_cpu_profile(
                                duration_s=dur)).encode(),
                            "application/json")
                    elif path == "/metrics":
                        self._send(_metrics.prometheus_text().encode(),
                                   "text/plain; version=0.0.4")
                    else:
                        self._send(b'{"error": "unknown path"}',
                                   "application/json", 404)
                except Exception as e:  # noqa: BLE001 - to the client
                    self._send(_json.dumps({"error": repr(e)}).encode(),
                               "application/json", 500)

        try:
            server = ThreadingHTTPServer((host, 0), Handler)
        except OSError:
            return None
        server.daemon_threads = True
        threading.Thread(target=server.serve_forever, daemon=True,
                         name="node-agent").start()
        self._agent = server
        self.agent_port = server.server_address[1]
        return self.agent_port

    @rpc.concurrent
    def handle_profile_burst(self, conn, rid, msg):
        """An on-demand stack-sampling burst of this daemon and every live
        pooled worker, one record a process. Blocks about ``duration``
        (``@concurrent``: off the connection's lane)."""
        duration = max(0.1, min(float(msg.get("duration") or 2.0), 30.0))
        from ray_tpu_torch._private import worker_process as wp
        procs: Dict[str, Dict[str, Any]] = {}
        threads = []
        for w in wp.live_workers():
            def burst_one(w=w):
                rec = w.profile_burst(duration)
                if isinstance(rec, dict) and rec.get("proc"):
                    procs[rec["proc"]] = rec
            t = threading.Thread(target=burst_one, daemon=True,
                                 name="profile-burst-worker")
            t.start()
            threads.append(t)
        own = _profiling.burst_record(f"daemon:{self.node_id.hex()[:8]}",
                                      duration_s=duration)
        for t in threads:
            t.join(timeout=duration + 10.0)
        procs[own["proc"]] = own
        # continuous records (own sampler, result-frame ingests) ride along
        for rec in (_profiling.node_profile() or {}).get("procs", []):
            procs.setdefault(rec.get("proc", "?"), rec)
        return {"procs": list(procs.values())}

    def handle_daemon_stop(self, conn, rid, msg):
        threading.Thread(target=self._exit_soon, daemon=True).start()
        return {"ok": True}


# profile-flush cadence: cumulative snapshots, so a lower rate than spans
# costs nothing but staleness
_PROFILE_PUSH_S = 2.0


def _gate_profile_flush(last_push: float, now: Optional[float] = None,
                        period: float = _PROFILE_PUSH_S):
    """The heartbeat's profile payload, or None (off cadence, nothing
    sampled, or lost to the ``profile.flush`` seam). Records are
    cumulative and the head replaces on receipt, so the caller advances
    its cadence stamp only on an acknowledged beat: a lost payload is
    re-sent, fresher, on the next one."""
    now = time.monotonic() if now is None else now
    if now - last_push < period:
        return None
    try:
        payload = _profiling.node_profile()
    except Exception:
        return None
    if payload is not None and _fp.ENABLED:
        try:
            if _fp.fire("profile.flush",
                        procs=len(payload.get("procs", []))) is _fp.DROP:
                payload = None
        except Exception:
            payload = None
    return payload


def _publish_object_plane_metrics(service: DaemonService) -> None:
    """The leak and transfer gauges, refreshed each beat so they ride the
    metrics snapshot to the head: arena slot grants still referenced and
    the push engine's counters."""
    slots = service.slot_ref_attribution()
    g = _metrics.Gauge("ray_tpu_arena_slot_refs",
                       "external arena slot grants: slots still referenced "
                       "('held') and total outstanding refs ('refs')",
                       tag_keys=("state",))
    g.set(float(slots["held"]), tags={"state": "held"})
    g.set(float(slots["refs"]), tags={"state": "refs"})
    push = _metrics.Gauge("ray_tpu_push_stats",
                          "object-plane push engine counters (cumulative), "
                          "tx = PushManager, rx = PushReceiver",
                          tag_keys=("side", "stat"))
    for stat, v in service.pushes.stats.items():
        push.set(float(v), tags={"side": "tx", "stat": stat})
    for stat, v in service.push_rx.stats.items():
        push.set(float(v), tags={"side": "rx", "stat": stat})
    _metrics.Gauge("ray_tpu_push_inflight",
                   "pushes queued or transferring right now").set(
        float(service.pushes.inflight_count()))


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--head", required=True,
                        help="host:port of the head process")
    parser.add_argument("--node-id", required=True)
    parser.add_argument("--resources", default="{}",
                        help="JSON resource map")
    parser.add_argument("--labels", default="{}")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--object-store-bytes", type=int,
                        default=256 * 1024 * 1024)
    parser.add_argument("--announce-fd", type=int, default=-1)
    parser.add_argument("--session-dir", default="",
                        help="the driver's session dir (spill files)")
    parser.add_argument("--persist", action="store_true",
                        help="survive driver disconnects (shared cluster)")
    args = parser.parse_args()

    # the daemon and its workers never own the card
    from ray_tpu_torch._private.platform import pin_cpu_env
    pin_cpu_env()
    resources = json.loads(args.resources)
    _nc.set_local_role("daemon")
    service = DaemonService(args.node_id, resources,
                            args.object_store_bytes, host=args.host,
                            session_dir=args.session_dir or None,
                            persist=args.persist)
    eventloop.set_proc_label(f"daemon:{args.node_id[:8]}")
    server = rpc.serve(service, host=args.host, port=0).start()
    if args.announce_fd >= 0:
        os.write(args.announce_fd, f"{server.addr[1]}\n".encode())
        os.close(args.announce_fd)

    head_host, head_port = args.head.rsplit(":", 1)
    head_addr = (head_host, int(head_port))
    service.head_addr = head_addr
    threading.Thread(target=service._syncer_loop, daemon=True,
                     name="syncer-gossip").start()
    labels = json.loads(args.labels)
    head = HeadClient(head_addr)
    out = head.register_node(args.node_id, resources, labels, server.addr)
    if out.get("dead"):
        os._exit(0)     # fenced: this node_id was declared dead
    service.epoch = int(out.get("epoch") or 0)

    # Head restart: on transport failure keep re-dialing the head for a
    # grace window and re-register; only a head that stays down, or one
    # that declares this node dead, ends the session.
    from ray_tpu_torch._private.config import cfg
    grace = cfg().head_grace_s

    # SIGTERM or the maintenance-notice file announce a graceful drain
    # (the head then fences placements, drivers migrate, and the deadline
    # escalates to node death)
    watcher = PreemptionWatcher(args.node_id, head_addr,
                                cfg().drain_deadline_s,
                                cfg().drain_notice_file)
    watcher.install_sigterm()
    watcher.start()
    service.preemption_watcher = watcher
    service.start_memory_monitor()
    service.start_agent(args.host)

    def reconnect() -> "HeadClient | None":
        from ray_tpu_torch._private.retry import RetryPolicy

        if grace <= 0:
            # head restarts disabled: the window is already over
            # (RetryPolicy reads deadline_s=0 as "no deadline", which
            # would dial the dead head for ever)
            return None

        def attempt() -> HeadClient:
            client = HeadClient(head_addr)
            try:
                rep = client.register_node(args.node_id, resources,
                                           labels, server.addr)
            except BaseException:
                client.close()
                raise
            if rep.get("dead"):
                client.close()
                os._exit(0)     # fenced out during the head outage
            service.epoch = int(rep.get("epoch") or service.epoch)
            return client

        try:
            return RetryPolicy.default(deadline_s=grace).run(
                attempt, loop="daemon.head_reconnect",
                retry_on=(OSError, rpc.RpcError))
        except (OSError, rpc.RpcError):
            return None     # the head stayed down past the grace window

    from ray_tpu_torch.objectplane import tiers as _tiers

    # What rides the beats: new spans past a cursor into the span buffer
    # (advanced only on an acknowledged beat, so a lost frame re-sends),
    # and absolute metric snapshots and cumulative profiles on cadences of
    # their own (a re-send replaces, never double-counts).
    trace_cursor = 0
    last_trace_push = last_metrics_push = last_profile_push = 0.0
    trace_push_s, metrics_push_s, trace_batch_max = 0.5, 1.0, 2000

    while True:  # heartbeat loop; exit if the head declared us dead
        time.sleep(_hb_interval())
        try:
            # object-plane housekeeping: the orphan sweep (reaps deferred
            # deletes whose attached-process refs dropped), abandoned push
            # buffers, and the host-tier occupancy gauges
            service.sweep_object_plane()
            service.push_rx.sweep()
            _tiers.publish_tier_bytes(_tiers.TIER_HOST,
                                      service.objects.used_bytes())
            _tiers.publish_tier_bytes(_tiers.TIER_SPILLED,
                                      service.objects.spilled_bytes())
            _publish_object_plane_metrics(service)
        except Exception:
            pass
        spans = []
        if time.monotonic() - last_trace_push >= trace_push_s:
            spans = service.task_events.events_after(
                trace_cursor)[:trace_batch_max]
        if spans and _fp.ENABLED:
            try:
                # drop/error arm = this flush is lost in transit; the
                # unadvanced cursor re-sends the batch next beat
                if _fp.fire("trace.flush", n=len(spans)) is _fp.DROP:
                    spans = []
            except Exception:
                spans = []
        snapshot = None
        if time.monotonic() - last_metrics_push >= metrics_push_s:
            snapshot = _metrics.export_snapshot()
        profile = _gate_profile_flush(last_profile_push)
        try:
            out = head.heartbeat(args.node_id, resources,
                                 epoch=service.epoch, wall_ts=time.time(),
                                 events=spans, metrics=snapshot,
                                 profile=profile)
            if out.get("ok"):
                # an "unknown" reply (a restarted head before the
                # re-register) ingested nothing: keep the cursor
                if spans:
                    trace_cursor = spans[-1]["seq"]
                    last_trace_push = time.monotonic()
                if snapshot is not None:
                    last_metrics_push = time.monotonic()
                if profile is not None:
                    last_profile_push = time.monotonic()
        except rpc.RpcError:
            head.close()
            new_head = reconnect()
            if new_head is None:
                service._teardown()
                os._exit(0)  # the head stayed down: the session is over
            head = new_head
            continue
        if out.get("dead"):
            service._teardown()
            os._exit(0)
        if out.get("unknown"):
            # a restarted head with empty membership: re-register
            try:
                out2 = head.register_node(args.node_id, resources,
                                          labels, server.addr)
            except rpc.RpcError:
                continue
            if out2.get("dead"):
                service._teardown()
                os._exit(0)     # fenced out: never rejoin as a zombie
            service.epoch = int(out2.get("epoch") or service.epoch)


if __name__ == "__main__":
    main()
