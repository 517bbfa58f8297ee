"""Declarative Serve app config (counterpart of
``ray_tpu/serve/schema.py``; reference: ``serve/schema.py``
ServeDeploySchema — the YAML the `serve deploy` CLI consumes).

Shape (YAML or JSON, or the equivalent dict):

    applications:
      - name: default                # app name (route key on the proxy)
        import_path: my_pkg.app:app  # module:attr — an Application, or
                                     # a builder callable(args) -> app
        args: {model: tiny}          # passed to a builder callable
        deployments:                 # per-deployment OVERRIDES by name
          - name: Model
            num_replicas: 2
            max_ongoing_requests: 8
            user_config: {threshold: 0.5}
            autoscaling_config: {min_replicas: 1, max_replicas: 4}

``serve.run_config(path_or_dict)`` imports each application, applies the
overrides, and deploys it. A ``.yaml``/``.yml`` file needs the ``yaml``
package, imported only for such a file, as in the reference.
"""

from __future__ import annotations

import importlib
import json
from typing import Any, Dict, List

from ray_tpu_torch.serve.deployment import Application, AutoscalingConfig


def load_config_file(path: str) -> Dict[str, Any]:
    with open(path) as f:
        raw = f.read()
    if path.endswith((".yaml", ".yml")):
        import yaml

        return yaml.safe_load(raw)
    return json.loads(raw)


def _import_attr(import_path: str) -> Any:
    if ":" not in import_path:
        raise ValueError(
            f"import_path must be 'module:attr', got {import_path!r}")
    module_name, attr = import_path.split(":", 1)
    module = importlib.import_module(module_name)
    obj = module
    for part in attr.split("."):
        obj = getattr(obj, part)
    return obj


# options a config may override; internal fields (func_or_class) are not
# part of the declarative surface
OVERRIDABLE_OPTIONS = {"num_replicas", "autoscaling_config",
                       "max_ongoing_requests", "user_config",
                       "ray_actor_options", "max_restarts",
                       "graceful_shutdown_timeout_s"}


def _apply_overrides(app: Application,
                     overrides: List[Dict[str, Any]]) -> Application:
    """Rebuild the application graph with per-deployment option
    overrides matched by deployment name (reference: deployment_schema
    fields layered over the code's decorator defaults)."""
    by_name: Dict[str, Dict[str, Any]] = {}
    for o in overrides or []:
        if "name" not in o:
            raise ValueError(
                f"deployment override entry missing 'name': {o!r}")
        by_name[o["name"]] = dict(o)
    consumed: set = set()

    def rebuild(node: Application) -> Application:
        dep = node.deployment
        opts = by_name.get(dep.name)
        if opts:
            consumed.add(dep.name)
            opts = {k: v for k, v in opts.items() if k != "name"}
            unknown = set(opts) - OVERRIDABLE_OPTIONS
            if unknown:
                raise ValueError(
                    f"unknown deployment option(s) for "
                    f"{dep.name!r}: {sorted(unknown)} "
                    f"(overridable: {sorted(OVERRIDABLE_OPTIONS)})")
            asc = opts.get("autoscaling_config")
            if isinstance(asc, dict):
                opts["autoscaling_config"] = AutoscalingConfig(**asc)
            dep = dep.options(**opts)
        args = tuple(rebuild(a) if isinstance(a, Application) else a
                     for a in node.args)
        kwargs = {k: rebuild(v) if isinstance(v, Application) else v
                  for k, v in node.kwargs.items()}
        return Application(dep, args, kwargs)

    out = rebuild(app)
    dangling = set(by_name) - consumed
    if dangling:
        raise ValueError(
            f"deployment override(s) match no deployment in the "
            f"application: {sorted(dangling)} (a typo'd name would be "
            f"silently ignored otherwise)")
    return out


def build_app_from_config(app_config: Dict[str, Any]) -> Application:
    """One application entry -> a bound, override-applied Application."""
    target = _import_attr(app_config["import_path"])
    if isinstance(target, Application):
        app = target
        if app_config.get("args"):
            raise ValueError(
                f"{app_config['import_path']} is a bound Application; "
                "'args' requires a builder callable")
    elif callable(target):
        app = target(app_config.get("args") or {})
        if not isinstance(app, Application):
            raise TypeError(
                f"builder {app_config['import_path']} returned "
                f"{type(app).__name__}, expected a bound Application")
    else:
        raise TypeError(
            f"{app_config['import_path']} is neither an Application "
            "nor a builder callable")
    return _apply_overrides(app, app_config.get("deployments"))


def run_config(config: Any) -> Dict[str, Any]:
    """Deploy every application in a config file/dict (the `serve
    deploy` role). Returns {app_name: ingress handle}."""
    from ray_tpu_torch.serve import api as serve_api

    if isinstance(config, str):
        # strings are always paths: a typo'd filename must raise
        # FileNotFoundError, not a confusing schema error
        config = load_config_file(config)
    if not isinstance(config, dict) or "applications" not in config:
        raise ValueError("serve config needs an 'applications' list")
    names = [a.get("name", "default") for a in config["applications"]]
    dupes = {n for n in names if names.count(n) > 1}
    if dupes:
        raise ValueError(
            f"duplicate application name(s) {sorted(dupes)}: a later "
            f"app would silently shadow the earlier one's route")
    handles: Dict[str, Any] = {}
    for app_config in config["applications"]:
        name = app_config.get("name", "default")
        app = build_app_from_config(app_config)
        handles[name] = serve_api.run(app, name=name)
    return handles
