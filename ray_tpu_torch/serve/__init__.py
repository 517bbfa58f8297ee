"""ray_tpu_torch.serve — model serving (counterpart of ``ray_tpu.serve``).

Reference: Ray Serve (`python/ray/serve`): three
planes — controller actor (deploy/reconcile/autoscale), proxies
(HTTP → handle), replicas (user callables) — plus P2C request routing,
dynamic batching and model composition via deployment handles. Every
replica is an actor of the port's in-process runtime; the gRPC proxy
comes with the daemon topology.
"""

from ray_tpu_torch.serve.api import (delete, get_app_handle,
                               get_deployment_handle, run, shutdown,
                               start_http_proxy, status)
from ray_tpu_torch.serve.batching import batch
from ray_tpu_torch.serve.multiplex import (get_multiplexed_model_id, multiplexed)
from ray_tpu_torch.serve.deployment import (Application, AutoscalingConfig,
                                      Deployment, deployment)
from ray_tpu_torch.serve.router import DeploymentHandle, DeploymentResponse
from ray_tpu_torch.serve.schema import run_config

__all__ = [
    "deployment", "Deployment", "Application", "AutoscalingConfig",
    "run", "shutdown", "status", "delete", "get_deployment_handle",
    "get_app_handle", "start_http_proxy",
    "batch", "DeploymentHandle", "DeploymentResponse",
    "multiplexed", "get_multiplexed_model_id", "run_config",
]
