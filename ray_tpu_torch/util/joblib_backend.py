"""joblib backend (counterpart of ``ray_tpu/util/joblib_backend.py``):
``register_ray()`` lets ``Parallel(backend="ray_tpu")`` fan each batch out
as a task of the runtime.

JAX's module subclasses joblib's ``ThreadingBackend`` when it is imported;
the card's machine has no ``joblib``, so the port imports it inside
:func:`register_ray` and builds the class there.
"""

from __future__ import annotations

import ray_tpu_torch


def _run_batch(batch):
    return batch()


def _backend_class():
    from joblib._parallel_backends import ThreadingBackend

    class RayTpuBackend(ThreadingBackend):
        """Each joblib batch executes as a cluster task."""

        supports_timeout = True

        def configure(self, n_jobs=1, parallel=None, **kwargs):
            if not ray_tpu_torch.is_initialized():
                ray_tpu_torch.init()
            self._fn = ray_tpu_torch.remote(_run_batch)
            return super().configure(n_jobs=n_jobs, parallel=parallel,
                                     **kwargs)

        def apply_async(self, func, callback=None):
            ref = self._fn.remote(func)

            class _Future:
                def get(self, timeout=None):
                    result = ray_tpu_torch.get(ref, timeout=timeout)
                    if callback:
                        callback(result)
                    return result
            return _Future()

        def effective_n_jobs(self, n_jobs):
            if n_jobs == -1 or n_jobs is None:
                return max(1, int(ray_tpu_torch.cluster_resources().get(
                    "CPU", 1)))
            return super().effective_n_jobs(n_jobs)

    return RayTpuBackend


def register_ray() -> None:
    from joblib.parallel import register_parallel_backend
    register_parallel_backend("ray_tpu", _backend_class())
