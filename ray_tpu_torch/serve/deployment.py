"""Deployment API (counterpart of ``ray_tpu/serve/deployment.py``): a
deployment wraps a user class/function with replica-count / autoscaling /
batching options; ``.bind()`` builds an application graph for model
composition via handles."""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple, Union


@dataclasses.dataclass
class AutoscalingConfig:
    """Reference: `serve/config.py` AutoscalingConfig +
    `serve/autoscaling_policy.py:12` target-ongoing-requests policy."""

    min_replicas: int = 1
    max_replicas: int = 4
    target_ongoing_requests: float = 2.0
    upscale_delay_s: float = 0.0
    downscale_delay_s: float = 2.0
    # Queue-pressure downscale guard: while the mean task QUEUE-phase
    # latency over the last controller tick (the registry's
    # ray_tpu_task_phase_seconds histogram) exceeds this,
    # downscale is deferred — depth counts can read low mid-burst while
    # queueing latency says the cluster is still behind. Only applies
    # while the deployment itself reports load (the signal is cluster-
    # wide; unrelated work must not pin an IDLE deployment at peak).
    # <=0 disables.
    downscale_queue_guard_s: float = 0.5


@dataclasses.dataclass
class Deployment:
    func_or_class: Union[type, Callable]
    name: str
    num_replicas: int = 1
    autoscaling_config: Optional[AutoscalingConfig] = None
    max_ongoing_requests: int = 16
    user_config: Optional[Dict[str, Any]] = None
    ray_actor_options: Optional[Dict[str, Any]] = None
    max_restarts: int = 3
    # Downscaled replicas DRAIN: routers stop picking them at the
    # membership publish, then the controller waits up to this long for
    # reported ongoing+queue to hit zero before the kill — in-flight
    # requests complete instead of burning (reference:
    # graceful_shutdown_timeout_s on the deployment config).
    graceful_shutdown_timeout_s: float = 10.0

    def options(self, **kwargs) -> "Deployment":
        return dataclasses.replace(self, **kwargs)

    def bind(self, *args, **kwargs) -> "Application":
        return Application(self, args, kwargs)


class Application:
    """A bound deployment DAG node. Bound Application arguments become
    DeploymentHandles at replica init (model composition)."""

    def __init__(self, deployment: Deployment, args: Tuple, kwargs: Dict):
        self.deployment = deployment
        self.args = args
        self.kwargs = kwargs

    def dependencies(self) -> List["Application"]:
        out = []
        for a in list(self.args) + list(self.kwargs.values()):
            if isinstance(a, Application):
                out.append(a)
        return out


def deployment(_func_or_class=None, *, name: Optional[str] = None,
               num_replicas: Optional[int] = None,
               autoscaling_config: Optional[Union[Dict,
                                                  AutoscalingConfig]] = None,
               max_ongoing_requests: int = 16,
               user_config: Optional[Dict] = None,
               ray_actor_options: Optional[Dict] = None,
               graceful_shutdown_timeout_s: float = 10.0):
    """``@serve.deployment`` decorator."""
    def wrap(fc):
        asc = autoscaling_config
        if isinstance(asc, dict):
            asc = AutoscalingConfig(**asc)
        return Deployment(
            fc, name=name or fc.__name__,
            num_replicas=num_replicas or 1,
            autoscaling_config=asc,
            max_ongoing_requests=max_ongoing_requests,
            user_config=user_config,
            ray_actor_options=ray_actor_options,
            graceful_shutdown_timeout_s=graceful_shutdown_timeout_s)
    if _func_or_class is not None:
        return wrap(_func_or_class)
    return wrap
