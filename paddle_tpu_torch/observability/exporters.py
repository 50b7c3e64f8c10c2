"""Exporters (port of ``paddle_tpu/observability/exporters.py``):
Prometheus text format and JSONL snapshots.

Two consumers, one :meth:`Registry.snapshot` shape:

* :func:`to_prometheus` — the text exposition format.  Histograms export as
  Prometheus *summaries* (``_count`` / ``_sum`` + ``quantile=`` series):
  the registry already computes p50/p95/p99 from its fixed log buckets, and
  a summary line per quantile beats shipping 256 cumulative ``le=`` buckets
  per histogram over every scrape.
* :class:`JsonlExporter` — appends ``{"ts": ..., "metrics": snapshot}``
  lines, the shape the JAX package's ``python -m
  paddle_tpu.observability`` CLI reads.

The JAX package's third exporter, the profiler metric marks, reads its
host profiler, which the port does not have.
"""
from __future__ import annotations

import json
import re
from typing import Optional

from . import registry as _registry

__all__ = ["to_prometheus", "JsonlExporter", "snapshot_line"]

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def _prom_name(name: str) -> str:
    return _NAME_RE.sub("_", name)


def _prom_labels(labels: dict) -> str:
    if not labels:
        return ""
    inner = ",".join('%s="%s"' % (_prom_name(k),
                                  str(v).replace("\\", "\\\\")
                                  .replace('"', '\\"').replace("\n", "\\n"))
                     for k, v in sorted(labels.items()))
    return "{%s}" % inner


def to_prometheus(reg: Optional["_registry.Registry"] = None,
                  snapshot: Optional[dict] = None) -> str:
    """Render a registry (or a pre-taken snapshot) as Prometheus text."""
    if snapshot is None:
        snapshot = (reg or _registry.default_registry()).snapshot()
    lines = []
    for name, entry in snapshot.items():
        pname = _prom_name(name)
        kind = entry["type"]
        prom_type = {"counter": "counter", "gauge": "gauge",
                     "histogram": "summary"}[kind]
        lines.append("# TYPE %s %s" % (pname, prom_type))
        for series in entry["series"]:
            labels = series.get("labels", {})
            if kind == "histogram":
                for q in ("p50", "p95", "p99"):
                    ql = dict(labels)
                    ql["quantile"] = "0.%s" % q[1:]
                    lines.append("%s%s %s"
                                 % (pname, _prom_labels(ql), series[q]))
                lines.append("%s_count%s %s"
                             % (pname, _prom_labels(labels),
                                series["count"]))
                lines.append("%s_sum%s %s"
                             % (pname, _prom_labels(labels), series["sum"]))
            else:
                lines.append("%s%s %s"
                             % (pname, _prom_labels(labels),
                                series["value"]))
    return "\n".join(lines) + ("\n" if lines else "")


def snapshot_line(reg: Optional["_registry.Registry"] = None) -> str:
    """One JSONL line: ``{"ts": <unix seconds>, "metrics": snapshot}``."""
    reg = reg or _registry.default_registry()
    return json.dumps({"ts": _registry.now(), "metrics": reg.snapshot()},
                      sort_keys=True)


class JsonlExporter:
    """Append-only JSONL snapshot writer (one line per :meth:`write`)."""

    def __init__(self, path: str):
        self.path = path

    def write(self, reg: Optional["_registry.Registry"] = None) -> str:
        line = snapshot_line(reg)
        with open(self.path, "a") as f:
            f.write(line + "\n")
        return line


def inject_profiler_marks(reg: Optional["_registry.Registry"] = None,
                          ts_ns: Optional[int] = None) -> int:
    """Push every counter/gauge value (and histogram counts) into the host
    profiler's metric-mark buffer as chrome-trace counter events; returns
    how many marks were written.  Called by ``Profiler.stop()`` so every
    trace export carries the metric state alongside the spans."""
    import time

    from .. import profiler as _prof

    reg = reg or _registry.default_registry()
    if not reg.enabled:
        return 0
    if ts_ns is None:
        ts_ns = time.perf_counter_ns()
    n = 0
    for name, entry in reg.snapshot().items():
        for series in entry["series"]:
            labels = series.get("labels", {})
            suffix = ("{%s}" % ",".join("%s=%s" % kv
                                        for kv in sorted(labels.items()))
                      if labels else "")
            value = (series["count"] if entry["type"] == "histogram"
                     else series["value"])
            _prof._metric_marks.append((name + suffix, ts_ns, float(value)))
            n += 1
    # backstop: keep only the newest _MARKS_CAP marks if nothing drains
    del _prof._metric_marks[:-_prof._MARKS_CAP]
    return n
