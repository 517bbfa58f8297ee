"""Deterministic fault injection: named failpoints on control-plane seams
(counterpart of ``ray_tpu/_private/failpoints.py``).

Reference capability: the C++ runtime's testing failpoints / chaos hooks
(``RAY_testing_*`` fault-injection flags and the release chaos suites)
— on real TPU fleets preemption and transient RPC loss are the norm, so
every failure path must be drivable deterministically instead of via
ad-hoc monkeypatching.

A *failpoint* is a named seam in the runtime (``"rpc.client.send"``,
``"daemon.push_task"``, ...) that calls :func:`fire` when the registry
is active. Seams cut REACTIONS as well as actions: the object-plane
reclamation seams (``"arena.grant_reclaim"``,
``"arena.reservation_sweep"``) suppress the daemon's *response* to a
client death so chaos runs can prove the backstop (heartbeat sweep,
event-path retry) still converges. An *arm* configured for that name
decides what happens:

=========== ==============================================================
action      effect at the seam
=========== ==============================================================
``crash``   ``os._exit(17)`` — the process dies (worker/daemon/head kill)
``delay``   sleep ``arg`` milliseconds, then continue
``drop``    :func:`fire` returns :data:`DROP`; the seam swallows the
            frame/message (request vanishes; the peer sees a timeout)
``error``   raise ``arg`` (an exception class; default
            :class:`FailpointError`)
``return``  :func:`fire` returns ``Return(arg)``; the seam short-circuits
            with that value
=========== ==============================================================

Each arm carries firing controls: ``p`` (probability, drawn from the
registry's seeded RNG — the same seed replays the same schedule),
``every`` (fire on every Nth hit), ``after`` (skip the first N hits) and
``max`` (stop after M fires). Every *fire* is appended to a thread-safe
hit log so tests assert exact fault counts.

Activation (all processes of a cluster see the same spec because daemon
and head processes inherit the driver's environment):

- env var ``RAY_TPU_FAILPOINTS`` (parsed at import), with
  ``RAY_TPU_FAILPOINTS_SEED`` for the RNG seed;
- the ``failpoints`` / ``failpoints_seed`` config flags (applied at
  ``ray_tpu_torch.init``);
- programmatically: :func:`activate` / :func:`configure` / :func:`reset`.

Spec grammar (``;``-separated)::

    name=action[:mod[:mod...]]
    action  := crash | delay(<ms>) | drop | error[(<ExcName>)]
             | return[(<literal>)]
    mod     := p=<float> | every=<int> | after=<int> | max=<int>

e.g. ``RAY_TPU_FAILPOINTS='rpc.client.send=drop:every=3:max=2;``
``daemon.push_task=delay(50):p=0.2'``.

Fast path: when nothing is configured, call sites pay ONE module-global
boolean check (``if failpoints.ENABLED: ...``) — no dict lookups, no
function call.
"""

from __future__ import annotations

import ast
import os
import random
import threading
import time
from typing import Any, Dict, List, Optional

__all__ = [
    "ENABLED", "DROP", "Return", "FailpointError",
    "activate", "configure", "reset", "fire",
    "hit_count", "fire_count", "hit_log", "describe",
]

# Module-global guard rebound by activate()/reset(). Call sites read it
# as `failpoints.ENABLED` — a single module-dict lookup — before paying
# anything else.
ENABLED = False


class FailpointError(Exception):
    """Default exception injected by an ``error`` arm."""


class _Drop:
    def __repr__(self) -> str:  # pragma: no cover - repr only
        return "<failpoints.DROP>"


DROP = _Drop()


class Return:
    """``return`` action outcome: the seam short-circuits with .value."""

    __slots__ = ("value",)

    def __init__(self, value: Any = None):
        self.value = value

    def __repr__(self) -> str:  # pragma: no cover - repr only
        return f"Return({self.value!r})"


_ACTIONS = ("crash", "delay", "drop", "error", "return")


class _Arm:
    __slots__ = ("name", "action", "arg", "p", "every", "after",
                 "max_fires", "hits", "fires", "rng")

    def __init__(self, name: str, action: str, arg: Any = None,
                 p: float = 1.0, every: int = 1, after: int = 0,
                 max_fires: int = 0):
        if action not in _ACTIONS:
            raise ValueError(f"unknown failpoint action {action!r}; "
                             f"expected one of {_ACTIONS}")
        self.name = name
        self.action = action
        self.arg = arg
        self.p = float(p)
        self.every = max(1, int(every))
        self.after = max(0, int(after))
        self.max_fires = max(0, int(max_fires))
        self.hits = 0       # times fire() reached this arm
        self.fires = 0      # times the action actually ran
        self.rng = random.Random()    # re-seeded per-arm on install


def _resolve_exc(name: str):
    """Resolve an exception class by name: builtins, then the runtime's
    own error types (RpcError, FastLaneError, ...). Called at FIRE time,
    never at parse time — env activation runs during this module's own
    import, when rpc.py/fast_lane.py (which import failpoints first) are
    only partially initialized and their error classes don't exist yet."""
    import builtins
    cls = getattr(builtins, name, None)
    if isinstance(cls, type) and issubclass(cls, BaseException):
        return cls
    for mod_name in ("ray_tpu_torch._private.rpc",
                     "ray_tpu_torch._private.fast_lane",
                     "ray_tpu_torch.exceptions"):
        try:
            import importlib
            mod = importlib.import_module(mod_name)
        except Exception:       # pragma: no cover - import cycles only
            continue
        cls = getattr(mod, name, None)
        if isinstance(cls, type) and issubclass(cls, BaseException):
            return cls
    raise ValueError(f"failpoint error({name}): unknown exception class")


def _parse_action(text: str):
    """``delay(50)`` -> ("delay", 50.0); ``error(OSError)`` ->
    ("error", OSError); ``drop`` -> ("drop", None)."""
    text = text.strip()
    if "(" in text:
        head, _, rest = text.partition("(")
        inner = rest.rstrip()
        if not inner.endswith(")"):
            raise ValueError(f"malformed failpoint action {text!r}")
        inner = inner[:-1].strip()
    else:
        head, inner = text, ""
    head = head.strip()
    if head == "delay":
        return head, float(inner or 0.0)
    if head == "error":
        # keep the NAME; resolution happens lazily at fire() time (see
        # _resolve_exc) — an unknown name then raises ValueError at the
        # seam, loudly
        return head, (inner or None)
    if head == "return":
        if not inner:
            return head, None
        try:
            return head, ast.literal_eval(inner)
        except (ValueError, SyntaxError):
            return head, inner      # bare word: return it as a string
    if head in ("crash", "drop"):
        return head, None
    raise ValueError(f"unknown failpoint action {head!r}")


def parse_spec(spec: str) -> List[_Arm]:
    arms: List[_Arm] = []
    for part in spec.split(";"):
        part = part.strip()
        if not part:
            continue
        name, sep, rhs = part.partition("=")
        if not sep:
            raise ValueError(f"malformed failpoint {part!r} "
                             f"(expected name=action[:mods])")
        # split modifiers on ':' outside parentheses (a literal in
        # return(...) may contain anything)
        pieces: List[str] = []
        depth = 0
        cur = ""
        for ch in rhs:
            if ch == ":" and depth == 0:
                pieces.append(cur)
                cur = ""
                continue
            if ch == "(":
                depth += 1
            elif ch == ")":
                depth -= 1
            cur += ch
        pieces.append(cur)
        action, arg = _parse_action(pieces[0])
        kw: Dict[str, Any] = {}
        for mod in pieces[1:]:
            k, _, v = mod.partition("=")
            k = k.strip()
            if k == "p":
                kw["p"] = float(v)
            elif k == "every":
                kw["every"] = int(v)
            elif k == "after":
                kw["after"] = int(v)
            elif k == "max":
                kw["max_fires"] = int(v)
            else:
                raise ValueError(f"unknown failpoint modifier {k!r}")
        arms.append(_Arm(name.strip(), action, arg, **kw))
    return arms


class Registry:
    """Seed-driven failpoint registry with a thread-safe hit log."""

    def __init__(self, seed: Optional[int] = None):
        self._arms: Dict[str, _Arm] = {}
        self._log: List[Dict[str, Any]] = []
        self._lock = threading.Lock()
        self.seed = seed

    def install(self, arm: _Arm) -> None:
        # per-arm RNG derived from (seed, name): probability draws of
        # one arm can't perturb another's, so the same seed replays the
        # same per-seam schedule even when hits from different seams
        # (or threads on other seams) interleave differently
        if self.seed is not None:
            arm.rng = random.Random(f"{self.seed}:{arm.name}")
        with self._lock:
            self._arms[arm.name] = arm

    def remove(self, name: str) -> None:
        with self._lock:
            self._arms.pop(name, None)

    def active(self) -> bool:
        with self._lock:
            return bool(self._arms)

    def fire(self, name: str, **ctx) -> Any:
        arm = self._arms.get(name)
        if arm is None:
            return None
        with self._lock:
            arm.hits += 1
            if arm.hits <= arm.after:
                return None
            if (arm.hits - arm.after) % arm.every != 0:
                return None
            if arm.max_fires and arm.fires >= arm.max_fires:
                return None
            if arm.p < 1.0 and arm.rng.random() >= arm.p:
                return None
            arm.fires += 1
            action, arg = arm.action, arm.arg
            entry = {"name": name, "action": action, "hit": arm.hits,
                     "fire": arm.fires, "ts": time.time()}
            if ctx:
                entry.update(ctx)
            self._log.append(entry)
        # effects run OUTSIDE the lock: delay must not serialize every
        # other failpoint behind it, and error/crash must not leak a
        # held lock into the unwound stack
        if action == "delay":
            time.sleep(arg / 1000.0)
            return None
        if action == "crash":
            os._exit(17)
        if action == "error":
            if arg is None:
                exc_cls = FailpointError
            elif isinstance(arg, str):
                exc_cls = _resolve_exc(arg)
                with self._lock:    # cache the resolved class
                    arm.arg = exc_cls
            else:
                exc_cls = arg
            raise exc_cls(f"injected by failpoint {name!r}")
        if action == "drop":
            return DROP
        if action == "return":
            return Return(arg)
        return None     # pragma: no cover - _ACTIONS is exhaustive

    # -- introspection (test assertions) --------------------------------
    def hit_count(self, name: str) -> int:
        with self._lock:
            arm = self._arms.get(name)
            return arm.hits if arm is not None else 0

    def fire_count(self, name: str) -> int:
        with self._lock:
            arm = self._arms.get(name)
            return arm.fires if arm is not None else 0

    def log(self, name: Optional[str] = None) -> List[Dict[str, Any]]:
        with self._lock:
            if name is None:
                return list(self._log)
            return [e for e in self._log if e["name"] == name]

    def describe(self) -> Dict[str, Dict[str, Any]]:
        with self._lock:
            return {n: {"action": a.action, "arg": a.arg, "p": a.p,
                        "every": a.every, "after": a.after,
                        "max": a.max_fires, "hits": a.hits,
                        "fires": a.fires}
                    for n, a in self._arms.items()}


_registry = Registry()


def activate(spec: str = "", seed: Optional[int] = None) -> Registry:
    """Install a fresh registry from ``spec`` and enable firing. An
    empty spec still enables the registry (arms can be added with
    :func:`configure`)."""
    global _registry, ENABLED
    reg = Registry(seed)
    for arm in parse_spec(spec):
        reg.install(arm)
    _registry = reg
    ENABLED = True
    return reg


def configure(name: str, action: str, arg: Any = None, p: float = 1.0,
              every: int = 1, after: int = 0, max_fires: int = 0) -> None:
    """Add/replace one failpoint arm programmatically (enables the
    registry if needed)."""
    global ENABLED
    _registry.install(_Arm(name, action, arg, p=p, every=every,
                           after=after, max_fires=max_fires))
    ENABLED = True


def remove(name: str) -> None:
    _registry.remove(name)


def reset() -> None:
    """Deactivate: every seam goes back to the one-boolean no-op path.
    Also clears the env form so later-spawned processes start clean."""
    global _registry, ENABLED
    ENABLED = False
    _registry = Registry()
    os.environ.pop("RAY_TPU_FAILPOINTS", None)
    os.environ.pop("RAY_TPU_FAILPOINTS_SEED", None)


def fire(name: str, **ctx) -> Any:
    """Evaluate the failpoint ``name``. Returns None (no-op), DROP, or a
    Return — after applying crash/delay/error effects. Call sites guard
    with ``if failpoints.ENABLED:`` so the inactive path stays free."""
    return _registry.fire(name, **ctx)


def hit_count(name: str) -> int:
    return _registry.hit_count(name)


def fire_count(name: str) -> int:
    return _registry.fire_count(name)


def hit_log(name: Optional[str] = None) -> List[Dict[str, Any]]:
    return _registry.log(name)


def describe() -> Dict[str, Dict[str, Any]]:
    return _registry.describe()


def maybe_activate_from_config(cfg) -> None:
    """``ray_tpu_torch.init`` hook: the ``failpoints`` flag activates the
    registry for this process AND exports the env form so processes
    spawned later (daemons, head, workers — ``_spawn`` copies
    ``os.environ``) replay the same spec; without the export, the
    daemon/head seams would silently never fire."""
    spec = getattr(cfg, "failpoints", "")
    if not spec or ENABLED:
        return
    seed = int(getattr(cfg, "failpoints_seed", 0) or 0)
    os.environ["RAY_TPU_FAILPOINTS"] = spec
    if seed:
        os.environ["RAY_TPU_FAILPOINTS_SEED"] = str(seed)
    activate(spec, seed=seed or None)


# env activation: daemons/head/workers are spawned with the driver's
# environment, so one export drives the whole cluster deterministically
_env_spec = os.environ.get("RAY_TPU_FAILPOINTS", "")
if _env_spec:
    activate(_env_spec,
             seed=int(os.environ.get("RAY_TPU_FAILPOINTS_SEED", "0")
                      or 0) or None)
del _env_spec
