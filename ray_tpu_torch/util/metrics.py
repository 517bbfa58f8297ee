"""User and system metrics (counterpart of ``ray_tpu/util/metrics.py``).

The in-process registry: ``Counter``, ``Gauge`` and ``Histogram``,
get-or-create by name, with a snapshot and a Prometheus exposition of this
process. The parts that federate other processes (the delta drain and merge
of worker processes, the head's per-node snapshots) and the wire, lock and
queue-dwell meters the reference merges into its snapshot come with the
daemon topology and the runtime's observability hooks: until then
``_federated_parts`` is empty.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

_REGISTRY: Dict[str, "Metric"] = {}
_REG_LOCK = threading.Lock()


def _labels_key(labels: Optional[Dict[str, str]]) -> Tuple:
    return tuple(sorted((labels or {}).items()))


class Metric:
    kind = "untyped"

    def __new__(cls, name: str, *args, **kwargs):
        # get-or-create by name: re-declaring a metric (Counter("x").inc()
        # per call) returns the live instance, not a fresh zeroed one
        with _REG_LOCK:
            existing = _REGISTRY.get(name)
            if existing is not None and type(existing) is cls:
                return existing
        return super().__new__(cls)

    def __init__(self, name: str, description: str = "",
                 tag_keys: Sequence[str] = ()):
        if getattr(self, "_initialized", False):
            return                      # live instance from __new__
        self.name = name
        self.description = description
        self.tag_keys = tuple(tag_keys)
        self._values: Dict[Tuple, float] = {}
        self._lock = threading.Lock()
        self._initialized = True
        with _REG_LOCK:
            _REGISTRY[name] = self

    def _reattach(self) -> None:
        # clear_registry() empties the name table while holders of a
        # metric keep writing to it: re-attach on write so a live metric
        # always reaches the exposition
        if _REGISTRY.get(self.name) is not self:
            with _REG_LOCK:
                _REGISTRY.setdefault(self.name, self)

    def _set(self, key: Tuple, value: float) -> None:
        self._reattach()
        with self._lock:
            self._values[key] = value

    def _add(self, key: Tuple, delta: float) -> None:
        self._reattach()
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + delta

    def samples(self) -> List[Tuple[Tuple, float]]:
        with self._lock:
            return list(self._values.items())


class Counter(Metric):
    kind = "counter"

    def inc(self, value: float = 1.0,
            tags: Optional[Dict[str, str]] = None) -> None:
        self._add(_labels_key(tags), value)


class Gauge(Metric):
    kind = "gauge"

    def set(self, value: float,
            tags: Optional[Dict[str, str]] = None) -> None:
        self._set(_labels_key(tags), value)

    def remove(self, tags: Optional[Dict[str, str]] = None) -> None:
        """Drop one label series (e.g. a downscaled replica slot) so
        the exposition stops reporting its last value forever."""
        with self._lock:
            self._values.pop(_labels_key(tags), None)


class Histogram(Metric):
    kind = "histogram"

    def __init__(self, name: str, description: str = "",
                 boundaries: Sequence[float] = (0.01, 0.1, 1, 10, 100),
                 tag_keys: Sequence[str] = ()):
        if getattr(self, "_initialized", False):
            return                      # live instance from __new__
        super().__init__(name, description, tag_keys)
        self.boundaries = tuple(boundaries)
        self._counts: Dict[Tuple, List[int]] = {}
        self._sums: Dict[Tuple, float] = {}
        self._totals: Dict[Tuple, int] = {}

    def observe(self, value: float,
                tags: Optional[Dict[str, str]] = None) -> None:
        self._reattach()
        key = _labels_key(tags)
        with self._lock:
            counts = self._counts.setdefault(
                key, [0] * (len(self.boundaries) + 1))
            i = 0
            while i < len(self.boundaries) and value > self.boundaries[i]:
                i += 1
            counts[i] += 1
            self._sums[key] = self._sums.get(key, 0.0) + value
            self._totals[key] = self._totals.get(key, 0) + 1


def registry() -> Dict[str, Metric]:
    with _REG_LOCK:
        return dict(_REGISTRY)


def clear_registry() -> None:
    with _REG_LOCK:
        _REGISTRY.clear()


def _esc_label(value: Any) -> str:
    """Escape a label value per the Prometheus exposition format:
    backslash, double quote and newline."""
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _esc_help(text: str) -> str:
    """HELP text escaping: backslash and newline only."""
    return str(text).replace("\\", "\\\\").replace("\n", "\\n")


def _fmt_labels(key: Tuple) -> str:
    if not key:
        return ""
    inner = ",".join(f'{k}="{_esc_label(v)}"' for k, v in key)
    return "{" + inner + "}"


def export_snapshot() -> List[Dict]:
    """Absolute (idempotent) snapshot of every registered metric as plain
    entries, label keys as [[k, v], ...] pair lists."""
    out: List[Dict] = []
    for name, m in registry().items():
        if m.kind == "histogram":
            with m._lock:
                hist = [[[list(p) for p in key], list(counts),
                         m._sums.get(key, 0.0), m._totals.get(key, 0)]
                        for key, counts in m._counts.items()]
            if hist:
                out.append({"name": name, "kind": "histogram",
                            "description": m.description,
                            "boundaries": list(m.boundaries),
                            "hist": hist})
            continue
        samples = [[[list(p) for p in key], v] for key, v in m.samples()]
        if samples:
            out.append({"name": name, "kind": m.kind,
                        "description": m.description,
                        "samples": samples})
    return out


def _inject(key, extra: Dict[str, str]) -> Tuple:
    """Label key (pair list or tuple) + per-source labels (a source's own
    label of the same name wins)."""
    pairs = {str(k): v for k, v in key}
    for k, v in (extra or {}).items():
        pairs.setdefault(k, v)
    return tuple(sorted(pairs.items()))


def render_prometheus(parts: List[Tuple[Dict[str, str], List[Dict]]]
                      ) -> str:
    """Render one exposition from many snapshots: one HELP/TYPE block per
    metric name, every sample labeled with its source's extra labels."""
    merged: Dict[str, Dict[str, Any]] = {}
    for extra, entries in parts:
        for e in entries or []:
            slot = merged.setdefault(e["name"], {
                "kind": e["kind"], "description": e.get("description", ""),
                "boundaries": tuple(e.get("boundaries", ())),
                "scalars": [], "hists": []})
            if e["kind"] != slot["kind"]:
                continue        # conflicting registration: first wins
            if e["kind"] == "histogram":
                if tuple(e.get("boundaries", ())) != slot["boundaries"]:
                    continue    # a truncated merge would corrupt buckets
                for key, counts, hsum, total in e.get("hist", []):
                    slot["hists"].append(
                        (_inject(key, extra), counts, hsum, total))
            else:
                for key, value in e.get("samples", []):
                    slot["scalars"].append((_inject(key, extra), value))
    lines: List[str] = []
    for name in sorted(merged):
        slot = merged[name]
        lines.append(f"# HELP {name} {_esc_help(slot['description'])}")
        lines.append(f"# TYPE {name} {slot['kind']}")
        if slot["kind"] == "histogram":
            for key, counts, hsum, total in slot["hists"]:
                cum = 0
                for bound, c in zip(slot["boundaries"], counts):
                    cum += c
                    lk = _inject(key, {"le": str(bound)})
                    lines.append(f"{name}_bucket{_fmt_labels(lk)} {cum}")
                lk = _inject(key, {"le": "+Inf"})
                lines.append(f"{name}_bucket{_fmt_labels(lk)} {total}")
                lines.append(f"{name}_sum{_fmt_labels(key)} {hsum}")
                lines.append(f"{name}_count{_fmt_labels(key)} {total}")
        else:
            for key, value in slot["scalars"]:
                lines.append(f"{name}{_fmt_labels(key)} {value}")
    return "\n".join(lines)


def _system_stats_lines() -> List[str]:
    from ray_tpu_torch._private import worker as _worker
    rt = _worker.global_runtime()
    if rt is None:
        return []
    return ["# TYPE ray_tpu_nodes_alive gauge",
            f"ray_tpu_nodes_alive {len(rt.alive_nodes())}"]


def _federated_parts() -> List[Tuple[Dict[str, str], List[Dict]]]:
    """Per-node snapshots of other processes: none in the in-process
    topology, the only one the port has."""
    return []


def prometheus_text() -> str:
    """Prometheus exposition for this process's registry, plus the
    runtime's node count as a gauge."""
    lines = [render_prometheus([({}, export_snapshot())])]
    lines.extend(_system_stats_lines())
    return "\n".join(line for line in lines if line) + "\n"
