"""Dashboard HTTP server (counterpart of ``ray_tpu/dashboard/server.py``).

Endpoints:
  GET /api/nodes              cluster nodes + resources
  GET /api/tasks              task table
  GET /api/actors             actor table
  GET /api/placement_groups   placement groups
  GET /api/objects            object table
  GET /api/cluster_status     resources + runtime stats summary
  GET /api/timeline           MERGED chrome-trace JSON: driver, daemon,
                              and worker lanes (head-store spans with
                              clock correction applied)
  GET /api/config             resolved flag table + provenance
  GET /api/jobs               per-tenant fair-share state: this driver's
                              ledger view with the head's persisted
                              quota/weight records overlaid
  GET /api/profile            cluster-wide stack profile as speedscope
                              JSON (burst fan-out + head aggregates;
                              ?duration=N seconds, clamped to 30)
  GET /api/metrics            cluster-wide metric samples as JSON
  GET /metrics                CLUSTER-WIDE Prometheus exposition: this
                              process's registry merged with every
                              daemon's heartbeat-federated snapshot,
                              node_id-labeled (the metrics-agent role)
  GET /api/serve, /api/train, /api/data   the libraries' state
  GET /api/profile/cpu, /api/profile/memory   this process's stacks and
                              tracemalloc's top allocations
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Tuple


class _DashboardHandler(BaseHTTPRequestHandler):
    def log_message(self, *args):
        pass

    def _json(self, payload, code: int = 200) -> None:
        body = json.dumps(payload, default=str).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _text(self, text: str, code: int = 200) -> None:
        body = text.encode()
        self.send_response(code)
        self.send_header("Content-Type", "text/plain; version=0.0.4")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        from ray_tpu_torch._private import worker as _worker
        from ray_tpu_torch.util import state as state_api
        from ray_tpu_torch.util.metrics import (cluster_metrics_json,
                                          cluster_prometheus_text)

        path = self.path.split("?")[0].rstrip("/")
        query = {}
        if "?" in self.path:
            from urllib.parse import parse_qsl
            query = dict(parse_qsl(self.path.split("?", 1)[1]))
        try:
            if path in ("", "/"):
                from ray_tpu_torch.dashboard.ui import INDEX_HTML
                body = INDEX_HTML.encode()
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/html; charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            elif path == "/api/profile":
                # cluster-wide stack profile: burst fan-out to every
                # process + the head's federated continuous aggregates,
                # as a speedscope document (one lane per process)
                out = state_api.cluster_profile(
                    duration_s=min(float(query.get("duration", 2)), 30))
                self._json(out["speedscope"])
            elif path == "/api/profile/cpu":
                from ray_tpu_torch.util.profiling import sample_cpu_profile
                self._json(sample_cpu_profile(
                    duration_s=min(float(query.get("duration", 5)), 30)))
            elif path == "/api/profile/memory":
                from ray_tpu_torch.util.profiling import memory_snapshot
                self._json(memory_snapshot())
            elif path == "/metrics":
                self._text(cluster_prometheus_text())
            elif path == "/api/metrics":
                self._json(cluster_metrics_json())
            elif path == "/api/nodes":
                self._json(state_api.list_nodes())
            elif path == "/api/tasks":
                self._json(state_api.list_tasks())
            elif path == "/api/actors":
                self._json(state_api.list_actors())
            elif path == "/api/placement_groups":
                self._json(state_api.list_placement_groups())
            elif path == "/api/objects":
                self._json(state_api.list_objects())
            elif path == "/api/timeline":
                self._json(state_api.cluster_timeline())
            elif path == "/api/config":
                # the resolved flag table with provenance (the
                # ray_config_def.h surface, observable)
                from ray_tpu_torch._private.config import cfg
                self._json(cfg().describe())
            elif path == "/api/jobs":
                # per-tenant fair-share state: this driver's live ledger
                # view, overlaid with the quota/weight records persisted
                # at the head (other drivers' jobs appear through it)
                rt = _worker.global_runtime()
                ten = getattr(rt, "tenancy", None)
                jobs = ten.jobs_view() if ten is not None else {}
                backend = getattr(rt, "cluster_backend", None)
                head = getattr(backend, "head", None)
                if head is not None:
                    try:
                        for job, rec in (head.tenancy_get() or {}).items():
                            row = jobs.setdefault(str(job), {})
                            for k, v in dict(rec).items():
                                row.setdefault(k, v)
                    except Exception:
                        pass  # head unreachable: the local view only
                self._json({
                    "fairshare_enabled": bool(
                        ten is not None and ten.enabled),
                    "jobs": jobs,
                })
            elif path == "/api/cluster_status":
                rt = _worker.global_runtime()
                import ray_tpu_torch
                self._json({
                    "cluster_resources": ray_tpu_torch.cluster_resources(),
                    "available_resources": ray_tpu_torch.available_resources(),
                    "stats": dict(rt.stats),
                    "task_summary": state_api.summarize_tasks(),
                })
            elif path == "/api/serve":
                # library observability (reference: dashboard serve
                # module): live application/deployment state. ONLY a
                # missing controller maps to the empty state — a
                # failing controller surfaces as the usual 500.
                from ray_tpu_torch.serve.api import _get_controller
                try:
                    controller = _get_controller(create=False)
                except Exception:
                    self._json({"applications": {}})
                else:
                    import ray_tpu_torch
                    self._json(ray_tpu_torch.get(controller.status.remote(),
                                           timeout=10))
            elif path == "/api/train":
                # train-run lifecycle (reference: dashboard train
                # module over export_train_state.proto): export events
                # when the FLAG enables emission, else a hint — and no
                # side-effectful logger creation when disabled
                from ray_tpu_torch._private.export_events import (
                    export_enabled, get_export_logger)
                enabled = export_enabled()
                events = []
                if enabled:
                    logger = get_export_logger()
                    if logger is not None:
                        events = logger.read("TRAIN_RUN")
                self._json({"train_runs": events,
                            "export_events_enabled": enabled})
            elif path == "/api/data":
                # per-dataset operator metrics (reference: dashboard
                # data module over StatsManager)
                from ray_tpu_torch.data.context import DatasetStats
                self._json({"datasets": DatasetStats.recent()})
            elif path == "/api":
                self._json({"endpoints": [
                    "/api/nodes", "/api/tasks", "/api/actors",
                    "/api/placement_groups", "/api/objects",
                    "/api/cluster_status", "/api/timeline", "/api/config",
                    "/api/jobs",
                    "/api/serve", "/api/train", "/api/data",
                    "/api/profile", "/api/profile/cpu",
                    "/api/profile/memory",
                    "/api/metrics", "/metrics", "/"]})
            else:
                self._json({"error": f"unknown path {path}"}, 404)
        except Exception as e:
            self._json({"error": repr(e)}, 500)


_server: Optional[ThreadingHTTPServer] = None


def start_dashboard(port: int = 8265, host: str = "127.0.0.1"
                    ) -> Tuple[str, int]:
    """Start (or return the running) dashboard; returns (host, port)."""
    global _server
    if _server is not None:
        return _server.server_address
    _server = ThreadingHTTPServer((host, port), _DashboardHandler)
    _server.daemon_threads = True
    threading.Thread(target=_server.serve_forever, daemon=True,
                     name="dashboard").start()
    return _server.server_address


def stop_dashboard() -> None:
    """Stop serving and close the listening socket (JAX's leaves the port
    bound until the process exits)."""
    global _server
    if _server is not None:
        _server.shutdown()
        _server.server_close()
        _server = None
