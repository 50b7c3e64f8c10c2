"""Cross-host telemetry (port of ``paddle_tpu/observability/aggregate.py``):
each host publishes a snapshot, and host 0 merges the cluster view with
straggler attribution.

The registry, tracing, flight recorder and liveness beacons are each one
host's.  A lopsided fleet (one host's step time far over the median) or a
host that silently stopped publishing shows in no single host's metrics.
Two halves:

* :class:`HostPublisher` — every host publishes one JSON **telemetry
  snapshot** (the whole registry snapshot, liveness beacon ages, and
  step-time summaries from the step histograms) to the TCP store under
  ``paddle_tpu/telemetry/<host>``.  The store client retries transient
  resets itself; a publish that still fails is logged and skipped.
* :func:`merge_cluster` (host 0) — fetches every host's newest snapshot
  and merges the **cluster view** (each host's step p50 and p95, stalled
  beacons, staleness, missing hosts) with straggler detection: a host
  whose step-time p50 exceeds the cluster median by more than ``pct``
  percent (default 25, ``PADDLE_TPU_STRAGGLER_PCT``) is flagged, and the
  ``liveness.straggler{host=}`` gauge is set for each host (1 flagged, 0
  not).  A host that never published is a row of its own: "missing" is
  the signal of a wedged worker.

The documents are the JAX package's, key for key, so the two packages'
hosts read each other's snapshots.  ``python -m
paddle_tpu_torch.observability cluster`` renders the merged view.
"""
from __future__ import annotations

import json
import os
import statistics
import sys
import threading
import time
from typing import Dict, List, Optional, Tuple

from . import liveness as _liveness
from . import registry as _registry
from .liveness import _env_float

__all__ = [
    "KEY_PREFIX", "STEP_TIME_METRICS", "host_snapshot", "HostPublisher",
    "fetch_cluster", "merge_docs", "merge_cluster", "format_cluster",
    "straggler_pct_default",
]

#: store key prefix; one key per host, newest snapshot wins (set()
#: overwrites — the view is "current state", not a history)
KEY_PREFIX = "paddle_tpu/telemetry/"

#: step-time sources for straggler attribution, in preference order:
#: the first histogram with samples on a host names that host's pace
STEP_TIME_METRICS = ("train.step_seconds", "train.batch_seconds",
                     "serving.decode_step_seconds")

_FORMAT = "paddle_tpu-telemetry-v1"


def straggler_pct_default() -> float:
    # degrade-loudly parse (liveness._env_float): a typo'd knob must
    # never crash host-0's merge loop or the cluster CLI
    v = _env_float("PADDLE_TPU_STRAGGLER_PCT")
    return v if v is not None else 25.0


def _host_id(host: Optional[int]) -> int:
    if host is not None:
        return int(host)
    return int(os.environ.get("PADDLE_TRAINER_ID", "0"))


def _step_summaries(metrics: dict) -> Dict[str, dict]:
    """{metric: {count, sum, p50, p95, p99}} for every step-time
    histogram with samples in a registry snapshot."""
    out = {}
    for name in STEP_TIME_METRICS:
        entry = metrics.get(name)
        if not entry or entry.get("type") != "histogram":
            continue
        for series in entry.get("series", ()):
            if series.get("count"):
                out[name] = {k: series[k] for k in
                             ("count", "sum", "p50", "p95", "p99")}
                break
    return out


def _stall_counts(metrics: dict) -> Dict[str, float]:
    entry = metrics.get("liveness.stalls")
    if not entry:
        return {}
    return {s.get("labels", {}).get("beacon", "?"): s.get("value", 0.0)
            for s in entry.get("series", ()) if s.get("value")}


def host_snapshot(host: Optional[int] = None) -> dict:
    """This host's publishable telemetry document: the full registry
    snapshot plus the derived views the merger needs (step-time
    summaries, beacon ages, stall counts)."""
    metrics = _registry.default_registry().snapshot()
    return {
        "format": _FORMAT,
        "host": _host_id(host),
        "pid": os.getpid(),
        "wall_ts": time.time(),
        "beacons": _liveness.state(),
        "step_times": _step_summaries(metrics),
        "stalls": _stall_counts(metrics),
        "metrics": metrics,
    }


class HostPublisher:
    """Periodic snapshot publisher.  ``publish_once()`` is the unit the
    thread loops over (tests call it directly); the store's own retry
    policy covers transient link failures, and a publish that still
    fails is logged and skipped — telemetry must never kill training."""

    def __init__(self, store, host: Optional[int] = None,
                 interval: Optional[float] = None):
        self.store = store
        self.host = _host_id(host)
        if interval is None:
            # degrade-loudly parse: a typo'd interval must not crash
            # worker startup on every host ("telemetry never takes
            # down training")
            v = _env_float("PADDLE_TPU_TELEMETRY_INTERVAL")
            interval = v if v is not None else 10.0
        self.interval = float(interval)
        self.published = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # guards `published`: publish_once runs on the loop thread AND
        # on whatever thread calls it directly (tests, stop(final=True))
        self._publish_lock = threading.Lock()

    @property
    def key(self) -> str:
        return KEY_PREFIX + str(self.host)

    def publish_once(self) -> str:
        doc = host_snapshot(self.host)
        self.store.set(self.key, json.dumps(doc, sort_keys=True).encode())
        with self._publish_lock:
            self.published += 1
        return self.key

    def start(self) -> "HostPublisher":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._run, name="telemetry-publisher", daemon=True)
            self._thread.start()
        return self

    def stop(self, timeout: float = 5.0, final: bool = True):
        """Stop the loop; ``final=True`` publishes one last snapshot so
        the cluster view holds this host's exit state."""
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout)
            if t.is_alive():
                # the loop is wedged inside a store op: publishing the
                # final snapshot NOW would race it on the same key, and
                # waiting for it would block shutdown indefinitely —
                # skip the final publish, keep stop() bounded
                sys.stderr.write("[telemetry] publisher still busy after "
                                 "%.1fs; skipping final publish\n"
                                 % timeout)
                self._thread = None
                return
        self._thread = None
        if final:
            try:
                self.publish_once()
            except Exception as e:
                sys.stderr.write("[telemetry] final publish failed: %r\n"
                                 % (e,))

    def _run(self):
        while not self._stop.wait(self.interval):
            try:
                self.publish_once()
            except Exception as e:
                # RetryError after the store policy gave up, or a torn
                # store: drop THIS snapshot, keep the loop alive
                sys.stderr.write("[telemetry] publish failed "
                                 "(skipping this interval): %r\n" % (e,))


# ---------------------------------------------------------------------------
# host-0 merge + straggler detection
# ---------------------------------------------------------------------------

def fetch_cluster(store, world_size: int
                  ) -> Tuple[Dict[int, dict], List[int]]:
    """Every host's newest snapshot from the store; hosts that never
    published (or published garbage) land in ``missing``."""
    docs: Dict[int, dict] = {}
    missing: List[int] = []
    for h in range(int(world_size)):
        try:
            raw = store.get(KEY_PREFIX + str(h), wait=False)
            doc = json.loads(raw.decode("utf-8"))
            if doc.get("format") != _FORMAT:
                raise ValueError("unknown telemetry format %r"
                                 % doc.get("format"))
            docs[h] = doc
        except KeyError:
            missing.append(h)
        except (ValueError, UnicodeDecodeError):
            missing.append(h)
    return docs, missing


def merge_docs(docs: Dict[int, dict], world_size: int,
               pct: Optional[float] = None,
               set_gauges: bool = True) -> dict:
    """Merge per-host snapshots into the cluster view and flag
    stragglers: hosts whose step-time p50 exceeds the cluster median by
    more than ``pct`` percent.  With ``set_gauges`` (host-0 usage) the
    ``liveness.straggler{host=}`` gauge is set 1/0 per published host
    so a scraper can alarm without parsing the table."""
    if pct is None:
        pct = straggler_pct_default()
    now = time.time()
    hosts: Dict[int, dict] = {}
    paced: List[Tuple[int, float]] = []
    for h, doc in sorted(docs.items()):
        step_metric, p50, p95, count = None, None, None, 0
        for name in STEP_TIME_METRICS:
            s = doc.get("step_times", {}).get(name)
            if s:
                step_metric = name
                p50, p95 = s["p50"], s["p95"]
                count = s["count"]
                break
        beacons = doc.get("beacons", {})
        hosts[h] = {
            "wall_ts": doc.get("wall_ts"),
            "staleness_s": round(max(now - doc.get("wall_ts", now), 0.0),
                                 3),
            "step_metric": step_metric,
            "step_p50_s": p50,
            "step_p95_s": p95,
            "step_count": count,
            "stalled_beacons": sorted(
                n for n, b in beacons.items() if b.get("stalled")),
            "stalls": doc.get("stalls", {}),
        }
        if p50 is not None and count > 0:
            paced.append((h, float(p50)))
    median = statistics.median([p for _h, p in paced]) if paced else None
    stragglers = []
    if median is not None and len(paced) >= 2 and median > 0:
        threshold = median * (1.0 + pct / 100.0)
        stragglers = sorted(h for h, p in paced if p > threshold)
    for h in hosts:
        hosts[h]["straggler"] = h in stragglers
    if set_gauges:
        g = _registry.gauge("liveness.straggler", ("host",))
        for h in hosts:
            g.labels(host=str(h)).set(1.0 if h in stragglers else 0.0)
    return {
        "format": "paddle_tpu-cluster-v1",
        "wall_ts": now,
        "world_size": int(world_size),
        "hosts": hosts,
        "missing": sorted(set(range(int(world_size))) - set(docs)),
        "median_step_s": median,
        "straggler_pct": pct,
        "stragglers": stragglers,
    }


def merge_cluster(store, world_size: int, pct: Optional[float] = None,
                  set_gauges: bool = True) -> dict:
    docs, _missing = fetch_cluster(store, world_size)
    return merge_docs(docs, world_size, pct=pct, set_gauges=set_gauges)


def format_cluster(doc: dict) -> str:
    """The human table the ``cluster`` CLI prints."""
    lines = []
    med = doc.get("median_step_s")
    lines.append(
        "cluster view: %d/%d hosts published, median step %s, "
        "straggler threshold +%.0f%%"
        % (len(doc["hosts"]), doc["world_size"],
           ("%.4fs" % med) if med is not None else "n/a",
           doc["straggler_pct"]))
    header = ("host", "step p50", "p95", "steps", "vs median",
              "stale", "stalled beacons", "flags")
    rows = [header]
    for h in sorted(doc["hosts"]):
        info = doc["hosts"][h]
        p50 = info["step_p50_s"]
        vs = ("%+.0f%%" % ((p50 / med - 1.0) * 100.0)
              if p50 is not None and med else "-")
        flags = []
        if info.get("straggler"):
            flags.append("STRAGGLER")
        if info.get("stalled_beacons"):
            flags.append("STALLED")
        rows.append((
            str(h),
            ("%.4fs" % p50) if p50 is not None else "-",
            ("%.4fs" % info["step_p95_s"])
            if info["step_p95_s"] is not None else "-",
            str(info["step_count"]),
            vs,
            "%.0fs" % info["staleness_s"],
            ",".join(info["stalled_beacons"]) or "-",
            ",".join(flags) or "-",
        ))
    for h in doc["missing"]:
        rows.append((str(h), "-", "-", "-", "-", "-", "-", "MISSING"))
    widths = [max(len(r[i]) for r in rows) for i in range(len(header))]
    lines.extend("  ".join(c.ljust(w) for c, w in zip(r, widths)).rstrip()
                 for r in rows)
    if doc["stragglers"]:
        lines.append("stragglers: %s"
                     % ", ".join("host %d" % h for h in doc["stragglers"]))
    if doc["missing"]:
        lines.append("MISSING (never published — wedged or dead?): %s"
                     % ", ".join("host %d" % h for h in doc["missing"]))
    return "\n".join(lines)
