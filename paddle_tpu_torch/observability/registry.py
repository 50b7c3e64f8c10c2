"""The process-wide metrics registry (port of
``paddle_tpu/observability/registry.py``): Counter / Gauge / Histogram.

Design constraints:

* **Host values only.**  Every ``inc``/``set``/``observe`` converts its
  argument with ``float()`` up front, and refuses a ``torch.Tensor``
  outright with a ``TypeError``: ``float()`` of a CUDA tensor is a
  hidden host sync, and one on the serving path would stall the
  overlapped loop on every step.  Metrics read host state (length
  mirrors, allocator counts, wall clocks), never the device.
* **Near-zero cost when disabled.**  A disabled registry hands out the
  module-level no-op singletons (:data:`NOOP_COUNTER` & co. — assertable by
  object identity), whose methods are empty: instrumented hot loops that
  fetched their handles once pay a single attribute load + no-op call per
  event and allocate nothing.  Metrics fetched while enabled keep working
  after a later ``disable()`` via one boolean attribute check.
* **Thread-safe.**  One lock per metric; snapshots lock per metric, not
  globally, so a slow exporter never stalls the serving hot path.
* **Fixed log-spaced histogram buckets.**  ``HIST_START * HIST_GROWTH**i``
  (12 buckets per decade over [1e-9, ~1e12]) — percentile readout
  (p50/p95/p99) linearly interpolates within one bucket, so relative error
  is bounded by the ~21% bucket width at any magnitude, for seconds and
  bytes alike, with no per-metric configuration and no unbounded sample
  storage.  The geometry and the readout are the JAX package's, so the
  same observations give the same snapshot in both.

The default registry (:func:`default_registry`) is **catalog-strict**:
every metric name must be declared in :mod:`.catalog`.  Private
registries (``Registry(catalog=None)``) are free-form.

Env knobs (the JAX package's names): ``PADDLE_TPU_METRICS=0`` disables
the default registry; ``PADDLE_TPU_METRICS_FILE=<path>`` appends one
JSONL snapshot at interpreter exit (and on every explicit :func:`flush`).
"""
from __future__ import annotations

import math
import os
import threading
import time
from typing import Dict, Iterable, Optional, Tuple

import torch

__all__ = [
    "Counter", "Gauge", "Histogram", "Registry",
    "NoopCounter", "NoopGauge", "NoopHistogram",
    "NOOP_COUNTER", "NOOP_GAUGE", "NOOP_HISTOGRAM",
    "default_registry", "counter", "gauge", "histogram", "flush",
    "HIST_START", "HIST_GROWTH", "HIST_NBUCKETS", "bucket_bounds",
]

# -- histogram geometry (shared by every Histogram: fixed, log-spaced) ------

HIST_START = 1e-9                 # lower bound of bucket 0's upper edge
HIST_GROWTH = 10.0 ** (1.0 / 12)  # 12 buckets per decade (~21% wide)
HIST_NBUCKETS = 256               # spans ~21 decades: 1e-9 .. ~1.4e12

_LOG_GROWTH = math.log(HIST_GROWTH)


def bucket_bounds() -> Tuple[float, ...]:
    """Upper bound of each bucket (the last bucket is the +Inf overflow)."""
    return tuple(HIST_START * HIST_GROWTH ** i for i in range(HIST_NBUCKETS))


def _bucket_index(v: float) -> int:
    if v <= HIST_START:
        return 0
    i = int(math.ceil(math.log(v / HIST_START) / _LOG_GROWTH))
    return i if i < HIST_NBUCKETS else HIST_NBUCKETS - 1


def _to_float(metric, value) -> float:
    """The host-value guard: a tensor is refused before ``float()`` would
    sync the device for it; anything else without a concrete float value
    raises too."""
    if isinstance(value, torch.Tensor):
        raise TypeError(
            "metric %r observed a torch.Tensor (%s on %s) — metrics take "
            "host values only: float() of a device tensor is a hidden "
            "sync; record the host-side value instead"
            % (metric, value.dtype, value.device))
    try:
        return float(value)
    except Exception as e:
        raise RuntimeError(
            "metric %r observed a value with no concrete float() (%r) — "
            "metrics take host values only" % (metric, type(value).__name__)
        ) from e


# -- no-op fast path --------------------------------------------------------

class NoopCounter:
    """The disabled-path Counter: every method is a constant no-op."""
    __slots__ = ()

    def inc(self, n=1):
        pass

    def labels(self, **kv):
        return self

    @property
    def value(self):
        return 0.0


class NoopGauge:
    __slots__ = ()

    def set(self, v):
        pass

    def inc(self, n=1):
        pass

    def dec(self, n=1):
        pass

    def labels(self, **kv):
        return self

    @property
    def value(self):
        return 0.0


class NoopHistogram:
    __slots__ = ()

    def observe(self, v):
        pass

    def labels(self, **kv):
        return self

    def percentile(self, q):
        return 0.0

    @property
    def count(self):
        return 0

    @property
    def sum(self):
        return 0.0


#: the singletons a disabled registry hands out — instrumented code can
#: assert the fast path by identity (tests/test_observability.py does).
NOOP_COUNTER = NoopCounter()
NOOP_GAUGE = NoopGauge()
NOOP_HISTOGRAM = NoopHistogram()


# -- live metrics -----------------------------------------------------------

class _Metric:
    """Shared labeled-child machinery.  A metric created with declared
    label names is a *parent*: ``.labels(site="x")`` returns (creating on
    first use) the child keyed by the label values; unlabeled metrics are
    their own sole time series."""

    def __init__(self, name: str, registry: "Registry",
                 label_names: Tuple[str, ...] = (),
                 label_values: Tuple[str, ...] = ()):
        self.name = name
        self._registry = registry
        self._label_names = tuple(label_names)
        self._label_values = tuple(label_values)
        self._children: Dict[Tuple[str, ...], "_Metric"] = {}
        self._lock = threading.Lock()

    def labels(self, **kv):
        if set(kv) != set(self._label_names):
            raise ValueError(
                "metric %r takes labels %r, got %r"
                % (self.name, self._label_names, tuple(sorted(kv))))
        key = tuple(str(kv[k]) for k in self._label_names)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = type(self)(self.name, self._registry,
                                   self._label_names, key)
                self._children[key] = child
        return child

    def _series(self):
        """(label_values_tuple -> leaf metric) for self + children."""
        if self._label_names and not self._label_values:
            with self._lock:
                return dict(self._children)
        return {(): self}

    @property
    def label_names(self):
        return self._label_names

    @property
    def label_values(self):
        return self._label_values

    def _reset_values(self):
        """Zero this leaf and every labeled child in place (handles stay
        live — see :meth:`Registry.reset`)."""
        self._zero()
        with self._lock:
            children = list(self._children.values())
        for c in children:
            c._reset_values()

    def _zero(self):
        raise NotImplementedError


class Counter(_Metric):
    """Monotonically increasing count (events, tokens, retries)."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self._value = 0.0

    def inc(self, n=1):
        if not self._registry._enabled:
            return
        n = _to_float(self.name, n)
        if n < 0:
            raise ValueError("counter %r cannot decrease" % self.name)
        with self._lock:
            self._value += n

    def _zero(self):
        with self._lock:
            self._value = 0.0

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Gauge(_Metric):
    """A value that goes up and down (occupancy, loss, queue depth)."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self._value = 0.0

    def set(self, v):
        if not self._registry._enabled:
            return
        v = _to_float(self.name, v)
        with self._lock:
            self._value = v

    def inc(self, n=1):
        if not self._registry._enabled:
            return
        n = _to_float(self.name, n)
        with self._lock:
            self._value += n

    def dec(self, n=1):
        self.inc(-_to_float(self.name, n))

    def _zero(self):
        with self._lock:
            self._value = 0.0

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Histogram(_Metric):
    """Fixed log-spaced buckets + exact count/sum/min/max; p50/p95/p99 by
    in-bucket linear interpolation (error bounded by the ~21% bucket)."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self._buckets = [0] * HIST_NBUCKETS
        self._count = 0
        self._sum = 0.0
        self._min = math.inf
        self._max = -math.inf

    def observe(self, v):
        if not self._registry._enabled:
            return
        v = _to_float(self.name, v)
        i = _bucket_index(v)
        with self._lock:
            self._buckets[i] += 1
            self._count += 1
            self._sum += v
            if v < self._min:
                self._min = v
            if v > self._max:
                self._max = v

    def _zero(self):
        with self._lock:
            self._buckets = [0] * HIST_NBUCKETS
            self._count = 0
            self._sum = 0.0
            self._min = math.inf
            self._max = -math.inf

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def percentile(self, q: float) -> float:
        """The value at quantile ``q`` in [0, 1] (0.0 when empty)."""
        if not 0.0 <= q <= 1.0:
            raise ValueError("quantile must be in [0, 1], got %r" % (q,))
        with self._lock:
            count = self._count
            if count == 0:
                return 0.0
            target = q * count
            seen = 0.0
            for i, n in enumerate(self._buckets):
                if n == 0:
                    continue
                if seen + n >= target:
                    if i == HIST_NBUCKETS - 1:
                        # the overflow bucket is open above: its only
                        # honest point estimate is the observed max
                        return self._max
                    lo = HIST_START * HIST_GROWTH ** (i - 1) if i else 0.0
                    hi = HIST_START * HIST_GROWTH ** i
                    frac = (target - seen) / n
                    est = lo + (hi - lo) * max(0.0, min(1.0, frac))
                    # never report outside the observed range: the first
                    # bucket is open below
                    return max(self._min, min(self._max, est))
                seen += n
            return self._max

    def snapshot_quantiles(self) -> Dict[str, float]:
        return {"p50": self.percentile(0.50),
                "p95": self.percentile(0.95),
                "p99": self.percentile(0.99)}


_TYPES = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}
_NOOPS = {"counter": NOOP_COUNTER, "gauge": NOOP_GAUGE,
          "histogram": NOOP_HISTOGRAM}


class Registry:
    """A named set of metrics.  ``catalog`` (a {name: spec} dict, see
    :mod:`.catalog`) makes the registry strict: undeclared names, wrong
    kinds, or undeclared label sets raise at fetch time."""

    def __init__(self, catalog: Optional[dict] = None,
                 enabled: bool = True):
        self._catalog = catalog
        self._enabled = bool(enabled)
        self._metrics: Dict[str, _Metric] = {}
        self._lock = threading.Lock()

    # -- lifecycle ---------------------------------------------------------

    @property
    def enabled(self) -> bool:
        return self._enabled

    def enable(self):
        """Re-enable recording.  Only affects live handles (fetched while
        enabled): a fetch made while disabled returned a shared no-op
        singleton, which stays a no-op forever — that identity IS the
        zero-cost disabled path.  To instrument a component built in a
        disabled window, rebuild it (or re-fetch its handles) after
        enable()."""
        self._enabled = True

    def disable(self):
        """Subsequent fetches return the no-op singletons AND already-
        handed-out live metrics stop recording (one bool check)."""
        self._enabled = False

    def reset(self):
        """Zero every recorded value IN PLACE (benches call this after
        warmup).  The metric objects survive: components fetch their
        handles once at construction (the no-alloc hot-path contract), so
        dropping the objects would silently orphan every live handle —
        they would keep recording into metrics no exporter can see."""
        with self._lock:
            metrics = list(self._metrics.values())
        for m in metrics:
            m._reset_values()

    # -- fetch/create ------------------------------------------------------

    def _get(self, kind: str, name: str, labels: Iterable[str] = ()):
        # catalog validation runs even when disabled: fetches happen at
        # component construction (not the hot path), and a typo'd metric
        # name should fail in a metrics-off deployment too, not only
        # explode later under metrics-on.
        labels = tuple(labels)
        if self._catalog is not None:
            spec = self._catalog.get(name)
            if spec is None:
                raise ValueError(
                    "metric %r is not declared in the observability "
                    "catalog (paddle_tpu_torch/observability/catalog.py) — "
                    "declare it (name, type, labels, help) or use a "
                    "private Registry(catalog=None)" % name)
            if spec["type"] != kind:
                raise ValueError(
                    "metric %r is declared as a %s, fetched as a %s"
                    % (name, spec["type"], kind))
            declared = tuple(spec.get("labels", ()))
            if labels and labels != declared:
                raise ValueError(
                    "metric %r declares labels %r, fetched with %r"
                    % (name, declared, labels))
            labels = declared
        if not self._enabled:
            return _NOOPS[kind]
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = _TYPES[kind](name, self, labels)
                self._metrics[name] = m
            elif not isinstance(m, _TYPES[kind]):
                raise ValueError("metric %r already exists as %s"
                                 % (name, type(m).__name__))
        return m

    def counter(self, name: str, labels: Iterable[str] = ()) -> Counter:
        return self._get("counter", name, labels)

    def gauge(self, name: str, labels: Iterable[str] = ()) -> Gauge:
        return self._get("gauge", name, labels)

    def histogram(self, name: str, labels: Iterable[str] = ()) -> Histogram:
        return self._get("histogram", name, labels)

    # -- readout -----------------------------------------------------------

    def snapshot(self) -> dict:
        """One JSON-ready dict of every live series:
        ``{name: {"type", "labels": [...], "series": [{"labels": {...},
        "value"| "count"/"sum"/"min"/"max"/"p50"/"p95"/"p99"}, ...]}}``."""
        with self._lock:
            metrics = dict(self._metrics)
        out = {}
        for name, m in sorted(metrics.items()):
            kind = ("counter" if isinstance(m, Counter) else
                    "gauge" if isinstance(m, Gauge) else "histogram")
            series = []
            for values, leaf in sorted(m._series().items()):
                entry = {"labels": dict(zip(m.label_names, values))}
                if kind == "histogram":
                    with leaf._lock:
                        entry.update(count=leaf._count,
                                     sum=leaf._sum,
                                     min=(leaf._min if leaf._count else 0.0),
                                     max=(leaf._max if leaf._count else 0.0))
                    entry.update(leaf.snapshot_quantiles())
                else:
                    entry["value"] = leaf.value
                series.append(entry)
            out[name] = {"type": kind, "labels": list(m.label_names),
                         "series": series}
        return out


# -- the default (catalog-strict) registry ----------------------------------

_DEFAULT: Optional[Registry] = None
_DEFAULT_LOCK = threading.Lock()


def default_registry() -> Registry:
    global _DEFAULT
    if _DEFAULT is None:
        with _DEFAULT_LOCK:
            if _DEFAULT is None:
                from .catalog import CATALOG
                enabled = os.environ.get("PADDLE_TPU_METRICS", "1") not in (
                    "0", "false", "off")
                reg = Registry(catalog=CATALOG, enabled=enabled)
                _DEFAULT = reg
                if os.environ.get("PADDLE_TPU_METRICS_FILE"):
                    import atexit
                    atexit.register(flush)
    return _DEFAULT


def counter(name: str, labels: Iterable[str] = ()) -> Counter:
    return default_registry().counter(name, labels)


def gauge(name: str, labels: Iterable[str] = ()) -> Gauge:
    return default_registry().gauge(name, labels)


def histogram(name: str, labels: Iterable[str] = ()) -> Histogram:
    return default_registry().histogram(name, labels)


def flush(path: Optional[str] = None) -> Optional[str]:
    """Append one JSONL snapshot of the default registry to ``path`` (or
    ``$PADDLE_TPU_METRICS_FILE``); returns the path written, or None when
    no destination is configured."""
    path = path or os.environ.get("PADDLE_TPU_METRICS_FILE")
    if not path:
        return None
    from .exporters import JsonlExporter
    JsonlExporter(path).write(default_registry())
    return path


def now() -> float:
    """The one timestamp source exporters share (wall clock, seconds)."""
    return time.time()
