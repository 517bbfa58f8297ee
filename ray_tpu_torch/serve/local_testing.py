"""Local testing mode (counterpart of ``ray_tpu/serve/local_testing.py``;
reference: `serve/_private/local_testing_mode.py` —
run an application graph fully in-process, no cluster/actors, for unit
tests of deployment logic)."""

from __future__ import annotations

import concurrent.futures
import inspect
from typing import Any

from ray_tpu_torch.serve.deployment import Application


class LocalDeploymentResponse:
    def __init__(self, future):
        self._future = future

    def result(self, timeout=None) -> Any:
        return self._future.result(timeout)


class LocalHandle:
    """Same surface as DeploymentHandle, backed by the in-process
    callable; calls run on a small thread pool so concurrent requests and
    @serve.batch still behave."""

    _pool = concurrent.futures.ThreadPoolExecutor(max_workers=16)

    def __init__(self, instance, method_name: str = "__call__"):
        self._instance = instance
        self._method_name = method_name

    def __getattr__(self, name: str) -> "LocalHandle":
        if name.startswith("_"):
            raise AttributeError(name)
        return LocalHandle(self._instance, name)

    def options(self, method_name: str) -> "LocalHandle":
        return LocalHandle(self._instance, method_name)

    def remote(self, *args, **kwargs) -> LocalDeploymentResponse:
        if self._method_name == "__call__":
            target = self._instance
        else:
            target = getattr(self._instance, self._method_name)
        return LocalDeploymentResponse(
            self._pool.submit(target, *args, **kwargs))


def run_local(app: Application) -> LocalHandle:
    """Build the application graph in-process; bound sub-apps become
    LocalHandles (model composition works unchanged)."""
    dep = app.deployment
    args = [run_local(a) if isinstance(a, Application) else a
            for a in app.args]
    kwargs = {k: run_local(v) if isinstance(v, Application) else v
              for k, v in app.kwargs.items()}
    fc = dep.func_or_class
    if inspect.isclass(fc):
        instance = fc(*args, **kwargs)
        if dep.user_config is not None and hasattr(instance,
                                                   "reconfigure"):
            instance.reconfigure(dep.user_config)
    else:
        instance = fc
    return LocalHandle(instance)
