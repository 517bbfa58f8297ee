"""Central config/flag table (counterpart of ``ray_tpu/_private/config.py``).

Every tunable the port's runtime reads lives in one declared table.
Resolution order per flag (highest wins):

1. ``_system_config={...}`` passed to ``ray_tpu_torch.init``
2. ``RAY_TPU_<NAME>`` environment variable
3. the declared default

An unknown ``_system_config`` key raises, as in the reference. The table
holds only the flags the port's runtime reads (the core and its process
workers); the reference's others belong to parts of its runtime the port
does not have yet.
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

_PREFIX = "RAY_TPU_"


def _parse_bool(raw: str) -> bool:
    return raw.strip().lower() not in ("0", "false", "no", "off", "")


@dataclass(frozen=True)
class Flag:
    name: str               # lower_snake; env var is RAY_TPU_<UPPER>
    type: Callable
    default: Any
    doc: str

    @property
    def env_var(self) -> str:
        return _PREFIX + self.name.upper()


FLAG_DEFS = [
    Flag("exec_pool_size", int, 0, "worker threads in each node's task "
         "execution pool (the dispatch loop feeds admitted tasks to "
         "this sized pool instead of spawning per task); 0 = the "
         "node's max_worker_threads (256)"),
    Flag("process_workers", bool, True, "run tasks and actors that do not "
         "want the card in worker processes (0 = every task and actor "
         "runs on the driver's threads)"),
    Flag("process_pool_size", int, 0, "idle worker processes kept ready "
         "(0 = auto: min(4, max(2, cpus//2)))"),
    Flag("process_pool_max", int, 32, "most idle worker processes a "
         "finished task leaves for reuse"),
    Flag("fast_lane", bool, True, "plain tasks go through the native core's "
         "lane (csrc/daemon_core.cc, hosted in the driver) to dedicated "
         "worker processes (0 = every process task takes the pipe)"),
    Flag("native_store", bool, True, "each node's object store parks "
         "contiguous numpy arrays of 64 KiB or more in a shared-memory "
         "arena (csrc/shm_store.cc) and hands out zero-copy views"),
]

FLAGS: Dict[str, Flag] = {f.name: f for f in FLAG_DEFS}


class Config:
    """Resolved flag values; refreshed when _system_config changes."""

    def __init__(self, system_config: Optional[Dict[str, Any]] = None):
        self._system = dict(system_config or {})
        unknown = set(self._system) - set(FLAGS)
        if unknown:
            raise ValueError(
                f"unknown _system_config keys: {sorted(unknown)}; "
                f"known flags: {sorted(FLAGS)}")
        self._values: Dict[str, Any] = {}
        self._provenance: Dict[str, str] = {}
        for flag in FLAG_DEFS:
            if flag.name in self._system:
                raw: Any = self._system[flag.name]
                source = "_system_config"
            elif flag.env_var in os.environ:
                raw = os.environ[flag.env_var]
                source = f"env:{flag.env_var}"
            else:
                raw = flag.default
                source = "default"
            if flag.type is bool and isinstance(raw, str):
                value: Any = _parse_bool(raw)
            else:
                value = flag.type(raw)
            self._values[flag.name] = value
            self._provenance[flag.name] = source

    def __getattr__(self, name: str) -> Any:
        try:
            return self._values[name]
        except KeyError:
            raise AttributeError(f"no flag named {name!r}") from None

    def describe(self) -> Dict[str, Dict[str, Any]]:
        return {name: {"value": self._values[name],
                       "source": self._provenance[name],
                       "doc": FLAGS[name].doc}
                for name in self._values}


_lock = threading.Lock()
_config: Optional[Config] = None


def cfg() -> Config:
    global _config
    with _lock:
        if _config is None:
            _config = Config()
        return _config


def apply_system_config(system_config: Optional[Dict[str, Any]]) -> Config:
    """Install the per-init overrides (called from ray_tpu_torch.init)."""
    global _config
    with _lock:
        _config = Config(system_config)
        return _config


def reset() -> None:
    """Drop cached values (shutdown path; env changes re-resolve)."""
    global _config
    with _lock:
        _config = None
