"""Deterministic network chaos: seeded per-link degradation policies
(counterpart of ``ray_tpu/_private/netchaos.py``).

Reference capability: the C++ runtime's chaos/netem release suites
(`ray-project/ray` release tests run `tc netem`-style loss/latency/
partition schedules against the GCS and raylet RPC channels). On real
TPU fleets the hardest control-plane failures are *transport-level
partial failures* — links that are slow, lossy, one-way, or flapping
while every process stays alive — so this module makes every
control-plane byte stream degradable **deterministically**, below the
frame layer, without touching kernel qdiscs.

A :class:`LinkPolicy` describes one directed (src-role, dst-role,
link-id) edge:

========= ===============================================================
knob      effect per frame while the policy window is active
========= ===============================================================
``lat``   fixed latency, milliseconds
``jitter``extra uniform(0..jitter) ms drawn from the policy's seeded RNG
``bw``    bandwidth cap in bytes/sec (sleep ``nbytes / bw``)
``drop``  drop probability (the frame vanishes; framing stays intact
          because the WHOLE frame is suppressed, never a byte prefix)
``dup``   duplicate-delivery probability (the frame is sent twice)
``partition`` drop everything (a hard one-way partition)
``sym``   also install the mirrored ``dst>src`` policy
``start`` window start, ms after the link's first consult
``dur``   window length ms (0 = open-ended)
``flap``  ``on/off`` ms pair: within the window the impairment cycles
========= ===============================================================

Send-side hooks see frames leaving this process toward ``dst``;
recv-side hooks see frames arriving from ``src``. Because both ends of
a cluster inherit the driver's environment, one env spec degrades a
link consistently from whichever process touches it — and a policy for
the *reverse* direction activated in only one process yields a true
one-way partition (requests leave, replies never arrive, or vice
versa).

Windows are measured from the policy's **first consult** on the link
(not from process start), so an env-armed daemon can boot, register,
and heartbeat before its partition opens — deterministic
partition-then-heal schedules inside subprocesses with no driver RPC
needed.

Activation mirrors ``failpoints.py`` exactly:

- env var ``RAY_TPU_NET_CHAOS`` (parsed at import; spawned daemons /
  head / workers inherit it) with ``RAY_TPU_NET_CHAOS_SEED``;
- config flags ``net_chaos`` / ``net_chaos_seed`` at ``ray_tpu_torch.init``;
- programmatically: :func:`activate` / :func:`configure` /
  :func:`reset`.

Spec grammar (``;``-separated)::

    src>dst[@link]=mod[:mod...]
    mod := lat=<ms> | jitter=<ms> | bw=<bytes_per_s> | drop=<p>
         | dup=<p> | partition | sym | start=<ms> | dur=<ms>
         | flap=<on_ms>/<off_ms>

e.g. ``RAY_TPU_NET_CHAOS='driver>daemon=drop=0.3;``
``daemon>head=partition:start=500:dur=2000'``. ``*`` wildcards any
role / link id.

Fast path: when nothing is configured the wire helpers pay ONE
module-global boolean check (``if netchaos.ENABLED:``) — the disarmed
send/recv path is the pre-existing code path, no policy object is ever
consulted (tier-1 asserts this).

Failpoint seams (observable by chaos schedules / assertions):
``net.link_drop`` fires for every chaos-dropped frame;
``net.partition_heal`` fires when a policy's impairment window closes
(partition healed / flap flipped off).
"""

from __future__ import annotations

import os
import random
import threading
import time
import weakref
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch._private import failpoints as _fp

__all__ = [
    "ENABLED", "DROP_FRAME", "DUP_FRAME", "LinkPolicy",
    "activate", "configure", "reset", "set_local_role", "local_role",
    "register_link", "on_send", "on_recv",
    "hit_log", "injected_count", "describe",
]

# Module-global guard rebound by activate()/reset(). Wire helpers read
# it as `netchaos.ENABLED` — a single module-dict lookup — before
# paying anything else.
ENABLED = False


class _Verdict:
    __slots__ = ("_name",)

    def __init__(self, name: str):
        self._name = name

    def __repr__(self) -> str:  # pragma: no cover - repr only
        return f"<netchaos.{self._name}>"


DROP_FRAME = _Verdict("DROP_FRAME")
DUP_FRAME = _Verdict("DUP_FRAME")

# this process's role on the cluster graph ("driver" | "head" |
# "daemon" | "worker"); set once at boot by the respective main
_LOCAL_ROLE = ""

# socket -> (peer_role, link_id, local_role_override). socket.socket
# defines __slots__, so identity is kept OUTSIDE the object; weak keys
# mean a closed+collected socket cannot pin its link entry.
_LINKS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def set_local_role(role: str) -> None:
    global _LOCAL_ROLE
    _LOCAL_ROLE = role


def local_role() -> str:
    return _LOCAL_ROLE


def register_link(sock, peer_role: str, link_id: str = "",
                  local_role: Optional[str] = None) -> None:
    """Tag a socket with the identity of the peer it reaches. Cold
    path (once per connection); safe to call whether or not chaos is
    armed so late programmatic activation still finds every link."""
    try:
        _LINKS[sock] = (peer_role, link_id, local_role)
    except TypeError:       # pragma: no cover - non-weakrefable stub
        pass


class LinkPolicy:
    """One directed link's degradation schedule. Deterministic: the
    per-policy RNG is seeded from (registry seed, src>dst@link), so
    the same seed and the same frame sequence replay the same drop /
    dup / jitter schedule regardless of other policies."""

    __slots__ = ("src", "dst", "link", "lat_ms", "jitter_ms", "bw_bps",
                 "drop_p", "dup_p", "partition", "start_ms", "dur_ms",
                 "flap_on_ms", "flap_off_ms", "rng", "first_use",
                 "consults", "drops", "dups", "delays", "_impairing")

    def __init__(self, src: str = "*", dst: str = "*", link: str = "*",
                 lat_ms: float = 0.0, jitter_ms: float = 0.0,
                 bw_bps: float = 0.0, drop_p: float = 0.0,
                 dup_p: float = 0.0, partition: bool = False,
                 start_ms: float = 0.0, dur_ms: float = 0.0,
                 flap_on_ms: float = 0.0, flap_off_ms: float = 0.0):
        self.src = src or "*"
        self.dst = dst or "*"
        self.link = link or "*"
        self.lat_ms = float(lat_ms)
        self.jitter_ms = float(jitter_ms)
        self.bw_bps = float(bw_bps)
        self.drop_p = float(drop_p)
        self.dup_p = float(dup_p)
        self.partition = bool(partition)
        self.start_ms = float(start_ms)
        self.dur_ms = float(dur_ms)
        self.flap_on_ms = float(flap_on_ms)
        self.flap_off_ms = float(flap_off_ms)
        self.rng = random.Random()      # re-seeded on install
        self.first_use: Optional[float] = None
        self.consults = 0
        self.drops = 0
        self.dups = 0
        self.delays = 0
        self._impairing = False

    @property
    def key(self) -> str:
        return f"{self.src}>{self.dst}@{self.link}"

    def matches(self, src: str, dst: str, link: str) -> bool:
        return ((self.src == "*" or self.src == src)
                and (self.dst == "*" or self.dst == dst)
                and (self.link == "*" or self.link == link))

    def _window_open(self, now: float) -> bool:
        if self.first_use is None:
            self.first_use = now
        elapsed_ms = (now - self.first_use) * 1000.0
        if elapsed_ms < self.start_ms:
            return False
        if self.dur_ms and elapsed_ms >= self.start_ms + self.dur_ms:
            return False
        if self.flap_on_ms:
            period = self.flap_on_ms + self.flap_off_ms
            phase = (elapsed_ms - self.start_ms) % period
            return phase < self.flap_on_ms
        return True

    def decide(self, nbytes: int,
               now: Optional[float] = None) -> Tuple[Optional[str],
                                                     float, bool]:
        """One frame's fate: (effect, delay_s, healed). ``effect`` in
        {"drop", "dup", None}; ``healed`` is True exactly once per
        impaired->clear window transition (partition heal / flap-off).
        Pure decision — the caller sleeps / drops / duplicates."""
        self.consults += 1
        open_ = self._window_open(time.monotonic()
                                  if now is None else now)
        healed = False
        if not open_:
            if self._impairing:
                self._impairing = False
                healed = True
            return None, 0.0, healed
        self._impairing = True
        if self.partition or (self.drop_p
                              and self.rng.random() < self.drop_p):
            self.drops += 1
            return "drop", 0.0, False
        delay_s = self.lat_ms / 1000.0
        if self.jitter_ms:
            delay_s += self.rng.random() * self.jitter_ms / 1000.0
        if self.bw_bps:
            delay_s += nbytes / self.bw_bps
        if delay_s:
            self.delays += 1
        if self.dup_p and self.rng.random() < self.dup_p:
            self.dups += 1
            return "dup", delay_s, False
        return None, delay_s, False


class Registry:
    """Seeded per-link policy registry with a thread-safe hit log."""

    def __init__(self, seed: Optional[int] = None):
        self._policies: List[LinkPolicy] = []
        self._log: List[Dict[str, Any]] = []
        self._lock = threading.Lock()
        self.seed = seed

    def install(self, pol: LinkPolicy) -> None:
        # per-policy RNG derived from (seed, key): one link's draws
        # cannot perturb another's — the same seed replays the same
        # per-link schedule even when traffic interleaves differently
        if self.seed is not None:
            pol.rng = random.Random(f"{self.seed}:{pol.key}")
        with self._lock:
            self._policies.append(pol)

    def active(self) -> bool:
        with self._lock:
            return bool(self._policies)

    def apply(self, src: str, dst: str, link: str, nbytes: int,
              defer: bool = False):
        """Consult policies for one frame. With ``defer=False`` (the
        threaded wire) latency/bandwidth delays are slept here and the
        verdict alone is returned. With ``defer=True`` (the asyncio
        wire, which must never sleep on the loop) the return is a
        ``(verdict, delay_s)`` pair and the CALLER owes the delay —
        typically a per-connection ``call_later`` chain so delayed
        frames still serialize per link but not across links."""
        pol = None
        with self._lock:
            for p in self._policies:    # first match wins
                if p.matches(src, dst, link):
                    pol = p
                    break
            if pol is None:
                return (None, 0.0) if defer else None
            effect, delay_s, healed = pol.decide(nbytes)
            if effect is not None or delay_s:
                _COUNTS[effect or "delay"] = \
                    _COUNTS.get(effect or "delay", 0) + 1
                self._log.append({
                    "src": src, "dst": dst, "link": link,
                    "policy": pol.key, "effect": effect or "delay",
                    "nbytes": nbytes, "ts": time.time()})
        # seam fires and sleeps run OUTSIDE the lock: a delayed frame
        # must not serialize every other link behind it
        if healed and _fp.ENABLED:
            _fp.fire("net.partition_heal", src=src, dst=dst, link=link)
        if delay_s > 0 and not defer:
            time.sleep(delay_s)
        if effect == "drop":
            if _fp.ENABLED:
                _fp.fire("net.link_drop", src=src, dst=dst, link=link)
            return (DROP_FRAME, delay_s) if defer else DROP_FRAME
        if effect == "dup":
            return (DUP_FRAME, delay_s) if defer else DUP_FRAME
        return (None, delay_s) if defer else None

    def log(self, key: Optional[str] = None) -> List[Dict[str, Any]]:
        with self._lock:
            if key is None:
                return list(self._log)
            return [e for e in self._log if e["policy"] == key]

    def describe(self) -> Dict[str, Dict[str, Any]]:
        with self._lock:
            return {p.key: {"lat": p.lat_ms, "jitter": p.jitter_ms,
                            "bw": p.bw_bps, "drop": p.drop_p,
                            "dup": p.dup_p, "partition": p.partition,
                            "start": p.start_ms, "dur": p.dur_ms,
                            "flap": (p.flap_on_ms, p.flap_off_ms),
                            "consults": p.consults, "drops": p.drops,
                            "dups": p.dups, "delays": p.delays}
                    for p in self._policies}


# injected-effect counters: plain dict adds (same lossy-tolerant
# discipline as rpc._WIRE); surfaced as
# ray_tpu_link_chaos_injected_total{effect} via chaos_metric_entries()
_COUNTS: Dict[str, int] = {}

_registry = Registry()


def _split_name(name: str) -> Tuple[str, str, str]:
    """``src>dst[@link]`` -> (src, dst, link)."""
    if ">" not in name:
        raise ValueError(f"malformed link {name!r} "
                         f"(expected src>dst[@link])")
    src, _, rest = name.partition(">")
    dst, _, link = rest.partition("@")
    return src.strip(), dst.strip(), link.strip() or "*"


def parse_spec(spec: str) -> List[LinkPolicy]:
    policies: List[LinkPolicy] = []
    for part in spec.split(";"):
        part = part.strip()
        if not part:
            continue
        name, sep, rhs = part.partition("=")
        if not sep:
            raise ValueError(f"malformed link policy {part!r} "
                             f"(expected src>dst[@link]=mods)")
        src, dst, link = _split_name(name)
        kw: Dict[str, Any] = {}
        sym = False
        for mod in rhs.split(":"):
            mod = mod.strip()
            if not mod:
                continue
            k, _, v = mod.partition("=")
            k = k.strip()
            if k == "lat":
                kw["lat_ms"] = float(v)
            elif k == "jitter":
                kw["jitter_ms"] = float(v)
            elif k == "bw":
                kw["bw_bps"] = float(v)
            elif k == "drop":
                kw["drop_p"] = float(v)
            elif k == "dup":
                kw["dup_p"] = float(v)
            elif k == "partition":
                kw["partition"] = True
            elif k == "sym":
                sym = True
            elif k == "start":
                kw["start_ms"] = float(v)
            elif k == "dur":
                kw["dur_ms"] = float(v)
            elif k == "flap":
                on_ms, _, off_ms = v.partition("/")
                kw["flap_on_ms"] = float(on_ms)
                kw["flap_off_ms"] = float(off_ms or on_ms)
            else:
                raise ValueError(f"unknown net-chaos modifier {k!r}")
        policies.append(LinkPolicy(src, dst, link, **kw))
        if sym:
            policies.append(LinkPolicy(dst, src, link, **kw))
    return policies


def activate(spec: str = "", seed: Optional[int] = None) -> Registry:
    """Install a fresh registry from ``spec`` and enable the hooks. An
    empty spec still enables the registry (policies can be added with
    :func:`configure`)."""
    global _registry, ENABLED
    reg = Registry(seed)
    for pol in parse_spec(spec):
        reg.install(pol)
    _registry = reg
    ENABLED = True
    return reg


def configure(pol: LinkPolicy) -> LinkPolicy:
    """Add one policy programmatically (enables the registry)."""
    global ENABLED
    _registry.install(pol)
    ENABLED = True
    return pol


def reset() -> None:
    """Disarm: the wire helpers go back to the one-boolean no-op path.
    Also clears the env form so later-spawned processes start clean."""
    global _registry, ENABLED
    ENABLED = False
    _registry = Registry()
    _COUNTS.clear()
    os.environ.pop("RAY_TPU_NET_CHAOS", None)
    os.environ.pop("RAY_TPU_NET_CHAOS_SEED", None)


def _edge(sock, outbound: bool) -> Tuple[str, str, str]:
    link = _LINKS.get(sock)
    if link is None:
        peer, lid, local = "", "", None
    else:
        peer, lid, local = link
    me = local if local is not None else _LOCAL_ROLE
    if outbound:
        return me, peer, lid or "*"
    return peer, me, lid or "*"


def on_send(sock, nbytes: int) -> Optional[_Verdict]:
    """Frame leaving this process. Returns None, DROP_FRAME, or
    DUP_FRAME — after applying latency / bandwidth sleeps. Call sites
    guard with ``if netchaos.ENABLED:`` so the disarmed path stays
    the pre-existing code path."""
    src, dst, lid = _edge(sock, outbound=True)
    return _registry.apply(src, dst, lid, nbytes)


def on_recv(sock, nbytes: int) -> Optional[_Verdict]:
    """Frame arriving at this process (matched against the REVERSE
    direction: peer -> local). DUP is a send-side effect; recv returns
    None or DROP_FRAME."""
    src, dst, lid = _edge(sock, outbound=False)
    v = _registry.apply(src, dst, lid, nbytes)
    return DROP_FRAME if v is DROP_FRAME else None


def on_send_decide(sock, nbytes: int) -> Tuple[Optional[_Verdict], float]:
    """``on_send`` for the asyncio wire: returns (verdict, delay_s)
    WITHOUT sleeping — the event loop owes the delay via call_later."""
    src, dst, lid = _edge(sock, outbound=True)
    return _registry.apply(src, dst, lid, nbytes, defer=True)


def on_recv_decide(sock, nbytes: int) -> Tuple[Optional[_Verdict], float]:
    """``on_recv`` for the asyncio wire: no sleep, dup suppressed (dup
    is a send-side effect, matching the threaded path)."""
    src, dst, lid = _edge(sock, outbound=False)
    v, delay_s = _registry.apply(src, dst, lid, nbytes, defer=True)
    return (DROP_FRAME if v is DROP_FRAME else None), delay_s


# -- introspection (test assertions) ----------------------------------
def hit_log(key: Optional[str] = None) -> List[Dict[str, Any]]:
    return _registry.log(key)


def injected_count(effect: Optional[str] = None) -> int:
    if effect is not None:
        return _COUNTS.get(effect, 0)
    return sum(_COUNTS.values())


def describe() -> Dict[str, Dict[str, Any]]:
    return _registry.describe()


def chaos_metric_entries() -> list:
    """Injected-effect counters in the export_snapshot wire-entry
    format (merged into the exposition via rpc.wire_metric_entries)."""
    if not _COUNTS:
        return []
    return [{
        "name": "ray_tpu_link_chaos_injected_total", "kind": "counter",
        "description": "network-chaos effects injected on control-plane "
                       "links, by effect",
        "samples": [[[["effect", e]], v]
                    for e, v in sorted(_COUNTS.items())],
    }]


def maybe_activate_from_config(cfg) -> None:
    """``ray_tpu_torch.init`` hook: the ``net_chaos`` flag activates the
    registry for this process AND exports the env form so processes
    spawned later (daemons, head, workers) replay the same spec."""
    spec = getattr(cfg, "net_chaos", "")
    if not spec or ENABLED:
        return
    seed = int(getattr(cfg, "net_chaos_seed", 0) or 0)
    os.environ["RAY_TPU_NET_CHAOS"] = spec
    if seed:
        os.environ["RAY_TPU_NET_CHAOS_SEED"] = str(seed)
    activate(spec, seed=seed or None)


# env activation: daemons/head/workers are spawned with the driver's
# environment, so one export degrades the whole cluster's links
# deterministically
_env_spec = os.environ.get("RAY_TPU_NET_CHAOS", "")
if _env_spec:
    activate(_env_spec,
             seed=int(os.environ.get("RAY_TPU_NET_CHAOS_SEED", "0")
                      or 0) or None)
del _env_spec
