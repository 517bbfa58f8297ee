"""The remote driver over a socket, Ray Client's role (counterpart of
``ray_tpu/util/client``): a thin client proxies API calls to a server that
runs inside the cluster's driver. The wire is a length-prefixed frame of
the port's by-value pickle (``device_objects.wire_dumps``); the proxy
covers put, get, wait, remote functions and actors, kill and the cluster's
resources.
"""

from ray_tpu_torch.util.client.client import ClusterClient, connect
from ray_tpu_torch.util.client.server import ClientServer, serve_cluster

__all__ = ["ClientServer", "serve_cluster", "ClusterClient", "connect"]
