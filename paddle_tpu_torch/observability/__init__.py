"""paddle_tpu_torch.observability — runtime telemetry (port of
``paddle_tpu.observability``), host-side and stdlib-plus-torch only:

* :mod:`.registry` — process-wide Counter / Gauge / Histogram registry:
  thread-safe, host values only (a ``torch.Tensor`` is refused with a
  ``TypeError``), no-op singletons when disabled, fixed log-spaced
  histogram buckets with p50/p95/p99 readout.
* :mod:`.catalog` — the declared metric names (the default registry
  rejects undeclared ones; a test keeps catalog and emission in sync,
  both ways).
* :mod:`.exporters` — Prometheus text and JSONL snapshots.
* :mod:`.tracing` — request-scoped span tracing: a trace_id per serving
  request, spans with parent links over queue / prefill-chunk / decode /
  verify / preemption phases, chrome-trace + JSONL export, and the
  per-request report.  Disabled by default (``PADDLE_TPU_TRACING=1``
  arms it).
* :mod:`.flight` — the black-box flight recorder: a bounded ring of
  recent events plus metrics and engine-state snapshots, dumped to a
  file on faultpoint-raised crashes, preemption-guard fires, liveness
  stalls and dying worker threads (``PADDLE_TPU_FLIGHT=1`` arms it).
* :mod:`.liveness` — named progress beacons watched by a monitor thread
  with per-beacon deadlines; a stall dumps all-thread stacks into a
  ``"stall"`` flight dump and counts ``liveness.stalls{beacon=}``
  (``PADDLE_TPU_LIVENESS=1`` arms it).

The env knobs are the JAX package's.  Not ported yet (ROADMAP.md §A6):
the compile watchdog (the port captures graphs instead of compiling;
engines count their captures), cost reports, the HBM ledger, cross-host
aggregation and the CLI.
"""
from __future__ import annotations

from . import flight, liveness
from .catalog import CATALOG
from .registry import (NOOP_COUNTER, NOOP_GAUGE, NOOP_HISTOGRAM, Counter,
                       Gauge, Histogram, Registry, counter, default_registry,
                       flush, gauge, histogram)
from .tracing import NOOP_SPAN, NOOP_TRACER, Tracer, default_tracer

__all__ = [
    "CATALOG", "Counter", "Gauge", "Histogram", "Registry",
    "NOOP_COUNTER", "NOOP_GAUGE", "NOOP_HISTOGRAM",
    "counter", "gauge", "histogram", "default_registry", "flush",
    "Tracer", "NOOP_TRACER", "NOOP_SPAN", "default_tracer", "flight",
    "liveness",
]
