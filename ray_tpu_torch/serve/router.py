"""DeploymentHandle + request router (counterpart of
``ray_tpu/serve/router.py``).

Reference: `serve/_private/router.py:341,365,676` (AsyncioRouter),
`serve/_private/request_router/pow_2_router.py:27` (power-of-two-choices on
queue length), `serve/_private/long_poll.py` (membership push). Replica
membership is PUSHED: each handle keeps a long-poll listen open against
the controller (serve/long_poll.py) and applies snapshots the moment a
deploy/scale/death publishes — no periodic-poll staleness window. Routing
is P2C over REPORTED replica depth (ongoing + engine queue, pushed by
replica reporters through the controller and fanned out on the
``depths::<name>`` long-poll key) plus the handle's own in-flight
delta — so independent client processes see each other's load instead
of only their own (reference: pow_2_router.py routes on replica queue
length, not handle-local counts).
"""

from __future__ import annotations

import os
import random
import threading
from typing import Any, Dict, List, Optional

import ray_tpu_torch


class DeploymentResponse:
    """Future-like response (reference: DeploymentResponse)."""

    def __init__(self, ref):
        self._ref = ref

    def result(self, timeout: Optional[float] = None) -> Any:
        return ray_tpu_torch.get(self._ref, timeout=timeout)

    @property
    def ref(self):
        return self._ref


class DeploymentResponseGenerator:
    """Iterator over a streaming deployment response (reference:
    DeploymentResponseGenerator): yields each chunk as the replica
    produces it — chunk 1 arrives before the handler returns."""

    def __init__(self, ref_gen, on_done=None):
        self._ref_gen = ref_gen
        self._on_done = on_done
        self._finished = False

    def __iter__(self):
        return self

    def __next__(self) -> Any:
        return self.next()

    def next(self, timeout: Optional[float] = None) -> Any:
        """``next(gen)`` with a per-chunk deadline: raises
        ``GetTimeoutError`` when the replica produces no chunk within
        ``timeout`` seconds (the response is finished locally — an
        abandoning client must not leak router in-flight counts)."""
        try:
            if timeout is not None and hasattr(self._ref_gen, "next"):
                ref = self._ref_gen.next(timeout=timeout)
            else:
                ref = next(self._ref_gen)
        except StopIteration:
            self._finish()
            raise
        except Exception:
            self._finish()
            raise
        try:
            return ray_tpu_torch.get(ref, timeout=timeout)
        except Exception:
            self._finish()
            raise

    def _finish(self) -> None:
        if not self._finished:
            self._finished = True
            if self._on_done is not None:
                self._on_done()

    def __del__(self):
        try:
            self._finish()
        except Exception:
            pass


class _HandleState:
    """Router state SHARED by a handle and all its method views: one
    replica set, one in-flight table, and at most ONE long-poll listener
    per deployment handle family (method composition must not multiply
    listener threads or parked controller listens)."""

    def __init__(self, deployment_name: str, controller,
                 seed: Optional[int] = None):
        self.deployment_name = deployment_name
        self.controller = controller
        self.lock = threading.Lock()
        self.replicas: List = []                 #: guarded by self.lock
        self.version = -1                        #: guarded by self.lock
        self.inflight: Dict[int, int] = {}       #: guarded by self.lock
        # reported depth per replica index (controller-published view of
        # ongoing + engine queue), valid for depths_version only
        self.depths: List[float] = []            #: guarded by self.lock
        self.depths_version = -1                 #: guarded by self.lock
        # urandom-seeded: a FIXED seed marched every client process
        # through identical P2C pairs in lockstep under many-client
        # load (the herd all picks the same victim); ``seed=`` keeps
        # tests deterministic.
        self.rng = random.Random(
            os.urandom(16) if seed is None else seed)
        self.long_poll = None

    def ensure_long_poll(self) -> None:
        with self.lock:
            if self.long_poll is not None:
                return
            self.long_poll = True  # claim under the lock; replaced below
        import weakref

        from ray_tpu_torch.serve.long_poll import LongPollClient

        ref = weakref.ref(self)

        def on_update(snapshot, version):
            state = ref()
            if state is None:
                return
            with state.lock:
                state.replicas = snapshot["replicas"]
                state.version = snapshot.get("version", version)
                state.inflight = {i: 0
                                  for i in range(len(state.replicas))}
                # indexing changed: drop depths until a matching
                # snapshot arrives (next controller tick)
                if state.depths_version != state.version:
                    state.depths = []

        def on_depths(snapshot, version):
            state = ref()
            if state is None or not isinstance(snapshot, dict):
                return
            with state.lock:
                # depths are positional over the replica list of ONE
                # membership version; a mismatched snapshot (router
                # ahead or behind) would mis-score replicas
                if snapshot.get("version") == state.version:
                    state.depths = list(snapshot.get("depths") or [])
                    state.depths_version = snapshot["version"]

        try:
            client = LongPollClient(
                self.controller,
                {f"replicas::{self.deployment_name}": on_update,
                 f"depths::{self.deployment_name}": on_depths})
        except Exception:
            with self.lock:
                self.long_poll = None   # release the claim: retry later
            raise
        self.long_poll = client
        # stop the listener thread when the handle family is collected
        weakref.finalize(self, LongPollClient.stop, client)


class DeploymentHandle:
    def __init__(self, deployment_name: str, controller,
                 method_name: str = "__call__", _state=None,
                 _stream: bool = False):
        self.deployment_name = deployment_name
        self._controller = controller
        self._method_name = method_name
        self._stream = _stream
        self._state = _state or _HandleState(deployment_name, controller)
        self._children: Dict[str, "DeploymentHandle"] = {}

    # back-compat views onto the shared state
    @property
    def _lock(self):
        return self._state.lock

    @property
    def _replicas(self):
        return self._state.replicas

    @property
    def _version(self):
        return self._state.version

    @property
    def _inflight(self):
        return self._state.inflight

    def __getstate__(self):
        return {"deployment_name": self.deployment_name,
                "_controller": self._controller,
                "_method_name": self._method_name,
                "_stream": self._stream}

    def __setstate__(self, d):
        self.deployment_name = d["deployment_name"]
        self._controller = d["_controller"]
        self._method_name = d["_method_name"]
        self._stream = d.get("_stream", False)
        self._state = _HandleState(self.deployment_name, self._controller)
        self._children = {}

    # composition: handle.other_method.remote(...) — cached, sharing
    # the router state (one listener for the whole family)
    def __getattr__(self, name: str) -> "DeploymentHandle":
        if name.startswith("_") or name in ("deployment_name",):
            raise AttributeError(name)
        cached = self._children.get(name)
        if cached is None:
            cached = DeploymentHandle(self.deployment_name,
                                      self._controller, name,
                                      _state=self._state,
                                      _stream=self._stream)
            self._children[name] = cached
        return cached

    def options(self, method_name: Optional[str] = None, *,
                stream: Optional[bool] = None) -> "DeploymentHandle":
        """``stream=True`` makes ``remote()`` return a
        DeploymentResponseGenerator yielding chunks as the replica
        produces them (reference: handle.options(stream=True))."""
        out = self.__getattr__(method_name) if method_name else self
        if stream is None or stream == out._stream:
            return out
        return DeploymentHandle(out.deployment_name, out._controller,
                                out._method_name, _state=out._state,
                                _stream=stream)

    def _refresh(self, force: bool = False) -> None:
        state = self._state
        with state.lock:
            stale = force or not state.replicas
        if not stale:
            return
        info = ray_tpu_torch.get(self._controller.get_replicas.remote(
            self.deployment_name))
        with state.lock:
            state.replicas = info["replicas"]
            state.version = info["version"]
            state.inflight = {i: 0 for i in range(len(state.replicas))}
            if state.depths_version != state.version:
                state.depths = []   # positional depths no longer valid

    def _score(self, idx: int) -> float:
        """Load estimate for one replica: the controller-reported depth
        (ongoing + engine queue across ALL clients, <=1 tick stale)
        plus this handle's own in-flight count (the not-yet-reported
        delta). Called under ``state.lock``."""
        state = self._state
        reported = (state.depths[idx]
                    if idx < len(state.depths) else 0.0)
        return reported + state.inflight.get(idx, 0)

    def _pick(self) -> int:
        """Power-of-two-choices on reported depth + local in-flight."""
        state = self._state
        n = len(state.replicas)
        if n == 1:
            return 0
        a, b = state.rng.sample(range(n), 2)
        return a if self._score(a) <= self._score(b) else b

    def remote(self, *args, **kwargs) -> DeploymentResponse:
        state = self._state
        state.ensure_long_poll()
        self._refresh()  # fallback for the gap before the first push
        last_err = None
        for _ in range(3):
            with state.lock:
                if not state.replicas:
                    raise RuntimeError(
                        f"no replicas for {self.deployment_name}")
                idx = self._pick()
                replica = state.replicas[idx]
                state.inflight[idx] = state.inflight.get(idx, 0) + 1
            try:
                if self._stream:
                    ref_gen = replica.handle_request_streaming.options(
                        num_returns="streaming").remote(
                        self._method_name, args, kwargs)

                    def decrement(i=idx):
                        with state.lock:
                            state.inflight[i] = max(
                                0, state.inflight.get(i, 0) - 1)

                    return DeploymentResponseGenerator(
                        iter(ref_gen), on_done=decrement)
                ref = replica.handle_request.remote(
                    self._method_name, args, kwargs)
                resp = DeploymentResponse(ref)
                self._attach_decrement(resp, idx)
                return resp
            except Exception as e:       # replica died: refresh + retry
                last_err = e
                self._refresh(force=True)
        raise RuntimeError(
            f"routing to {self.deployment_name} failed: {last_err!r}")

    def _attach_decrement(self, resp: DeploymentResponse, idx: int) -> None:
        state = self._state

        def waiter():
            try:
                ray_tpu_torch.get(resp._ref)
            except Exception:
                pass
            with state.lock:
                state.inflight[idx] = max(
                    0, state.inflight.get(idx, 0) - 1)
        threading.Thread(target=waiter, daemon=True).start()

    def __repr__(self):
        return (f"DeploymentHandle({self.deployment_name!r}, "
                f"method={self._method_name!r})")
