"""The live HBM ledger (port of ``paddle_tpu/observability/hbm.py``) —
who holds device memory, sampled where it's safe.

An OOM post-mortem (or a Perfetto timeline) needs three numbers the
metrics registry didn't carry: **live device bytes** per card, **KV-pool
bytes** (the serving engines' dominant allocation — paged or slotted,
int8-aware via the engines' own ``kv_row_bytes()`` accounting), and
**checkpoint-restore transients** (the host-side deserialized tree that
exists between read and device placement).  This module owns all three
as catalog'd gauges:

* ``hbm.live_bytes{device=}`` — what PyTorch's caching allocator holds
  for tensors on each initialized card, ``torch.cuda.memory_allocated(d)``
  read at a host boundary (the JAX package sums ``jax.live_arrays()``;
  the allocator's count is the same quantity without a walk, and its
  cached-but-free blocks are left out, as JAX's are).  Device keys are
  ``"cuda:<index>"``; a process with no card samples no device;
* ``hbm.kv_pool_bytes`` — summed ``kv_pool_bytes()`` over live
  registered engines;
* ``hbm.restore_transient_bytes`` — set for the duration of a
  checkpoint restore, zero otherwise.

**Sampling discipline** (the registry's): the ledger is OFF by default —
:func:`maybe_sample` is one module-global ``None`` check
(test-asserted), so the scheduler's per-iteration call and hapi fit's
per-batch call cost nothing unless armed via ``PADDLE_TPU_HBM=1`` or
:func:`enable`.  Samples run at step/iteration boundaries on the host,
never inside a captured step: at a boundary the count means "what the
process holds between steps".  ``PADDLE_TPU_HBM_EVERY=N``
thins armed sampling to every N-th boundary.

Every sample also appends **counter marks** ``(name, perf_ns, value)``
to a bounded ring; :func:`paddle_tpu_torch.observability.tracing
.write_chrome` merges them as chrome-trace ``"C"`` events (the HBM
lanes), so Perfetto shows occupancy time-aligned with the request lanes
and profiler spans.  Flight-recorder dumps call :func:`ledger_state`
(works armed or not) to embed the per-device totals plus a **top-arrays
breakdown**: the live tensors of a device type aggregated by shape and
dtype.  It finds them by walking the objects Python's garbage collector
tracks (``gc.get_objects()``) for ``torch.Tensor`` instances on that
device type, each storage counted once, under the first tensor of it the
walk meets (so a view and its base, or a parameter repointed into a
flat buffer, count as one).  It misses what only C++ holds: tensors
autograd saved for a backward, a captured CUDA graph's pool, the
allocator's cached blocks and kernels' scratch — so its total may be
below ``hbm.live_bytes``.
"""
from __future__ import annotations

import gc
import os
import threading
import time
import warnings
import weakref
from collections import deque
from typing import Any, Dict, List, Optional

from . import registry as _registry

__all__ = [
    "HbmLedger", "enable", "disable", "active", "maybe_sample", "sample",
    "register_engine", "note_restore", "clear_restore", "ledger_state",
    "counter_marks", "MARKS_CAP", "TOP_ARRAYS",
]

#: bound on buffered chrome counter marks (drop-oldest past it)
MARKS_CAP = 4096

#: entries in the dump-time largest-live-arrays breakdown
TOP_ARRAYS = 15

#: live engines whose KV pools the ledger prices; module-level weakset so
#: engines built before enable() are covered (flight-recorder pattern)
_ENGINES: "weakref.WeakSet" = weakref.WeakSet()

_ACTIVE: Optional["HbmLedger"] = None
_LOCK = threading.Lock()


def _live_per_device() -> Dict[str, float]:
    """{"cuda:<i>": bytes the caching allocator holds for tensors} over the
    cards this process has initialized; {} without one."""
    import torch
    if not torch.cuda.is_available() or not torch.cuda.is_initialized():
        return {}
    return {"cuda:%d" % d: float(torch.cuda.memory_allocated(d))
            for d in range(torch.cuda.device_count())}


def _top_arrays(n: int = TOP_ARRAYS, device_type: str = "cuda"
                ) -> List[Dict[str, Any]]:
    """The largest live tensors on ``device_type`` aggregated by (shape,
    dtype), each storage once — the post-mortem's "what held the memory"
    table (the module docstring says what the walk cannot see)."""
    import torch
    agg: Dict[tuple, List[float]] = {}
    seen = set()
    with warnings.catch_warnings():
        # isinstance() on a deprecated module proxy the walk meets warns
        warnings.simplefilter("ignore")
        objs = [o for o in gc.get_objects() if isinstance(o, torch.Tensor)]
    for obj in objs:
        try:
            if obj.device.type != device_type:
                continue
            storage = obj.untyped_storage()
            ptr = (obj.device.index, storage.data_ptr())
            if ptr in seen or storage.nbytes() == 0:
                continue
            seen.add(ptr)
            key = (str(tuple(obj.shape)), str(obj.dtype).replace(
                "torch.", ""))
            nb = float(storage.nbytes())
        except Exception:
            continue    # a torn or meta tensor must not kill the dump
        ent = agg.setdefault(key, [0.0, 0])
        ent[0] += nb
        ent[1] += 1
    rows = sorted(((b, c, k) for k, (b, c) in agg.items()), reverse=True)
    return [{"shape": k[0], "dtype": k[1], "nbytes": int(b), "count": c}
            for b, c, k in rows[:n]]


def _kv_pool_total() -> float:
    total = 0.0
    for e in list(_ENGINES):
        try:
            total += float(e.kv_pool_bytes())
        except Exception:
            continue
    return total


def _kv_host_total() -> float:
    """Summed host-RAM KV tier occupancy of live serving engines — the
    ledger's host-side row next to the device pool's, so one flight dump
    shows where every cached KV byte lives."""
    total = 0.0
    for e in list(_ENGINES):
        try:
            total += float(e.kv_host_bytes_used())
        except Exception:
            continue
    return total


class HbmLedger:
    """The armed ledger: gauges + the chrome counter-mark ring."""

    def __init__(self, sample_every: Optional[int] = None):
        every = (sample_every if sample_every is not None
                 else int(os.environ.get("PADDLE_TPU_HBM_EVERY", "1")))
        self.sample_every = max(int(every), 1)
        self._n = 0
        self._lock = threading.Lock()
        self._marks: deque = deque(maxlen=MARKS_CAP)
        self._g_live = _registry.gauge("hbm.live_bytes", ("device",))
        self._g_kv = _registry.gauge("hbm.kv_pool_bytes")
        self._seen_devices: set = set()
        self.last: Dict[str, Any] = {}

    def _mark(self, name: str, ts_ns: int, value: float):
        with self._lock:
            self._marks.append((name, ts_ns, float(value)))

    def sample(self, tag: str = "") -> Dict[str, Any]:
        """One full collection: set the gauges, append counter marks,
        remember the sample.  Host-side only — call at step/iteration
        boundaries."""
        ts_ns = time.perf_counter_ns()
        per = _live_per_device()
        # a device that dropped out of the collection must read 0, not
        # its last value — a stale gauge would contradict ledger_state()
        for dev in self._seen_devices - set(per):
            self._g_live.labels(device=dev).set(0.0)
            self._mark("hbm.live_bytes{device=%s}" % dev, ts_ns, 0.0)
        self._seen_devices = set(per)
        for dev, nbytes in per.items():
            self._g_live.labels(device=dev).set(nbytes)
            self._mark("hbm.live_bytes{device=%s}" % dev, ts_ns, nbytes)
        kv = _kv_pool_total()
        self._g_kv.set(kv)
        self._mark("hbm.kv_pool_bytes", ts_ns, kv)
        self.last = {"ts_ns": ts_ns, "tag": tag, "devices": per,
                     "kv_pool_bytes": kv,
                     "live_bytes_total": sum(per.values())}
        return self.last

    def maybe_sample(self, tag: str = ""):
        self._n += 1
        if self._n % self.sample_every:
            return None
        return self.sample(tag)

    def marks(self) -> List[tuple]:
        with self._lock:
            return list(self._marks)


# ---------------------------------------------------------------------------
# module-level API (what the instrumented subsystems call)
# ---------------------------------------------------------------------------

def enable(sample_every: Optional[int] = None) -> HbmLedger:
    """Arm (or re-arm) the process-wide ledger."""
    global _ACTIVE
    with _LOCK:
        _ACTIVE = HbmLedger(sample_every=sample_every)
        return _ACTIVE


def disable():
    global _ACTIVE
    with _LOCK:
        _ACTIVE = None


def active() -> Optional[HbmLedger]:
    return _ACTIVE


def maybe_sample(tag: str = ""):
    """Per-boundary hook: ONE module-global ``None`` check when the
    ledger is disarmed (the default) — the scheduler/fit hot loops pay
    nothing (test-asserted)."""
    led = _ACTIVE
    if led is None:
        return None
    return led.maybe_sample(tag)


def sample(tag: str = ""):
    led = _ACTIVE
    if led is None:
        return None
    return led.sample(tag)


def register_engine(engine):
    """Track a serving engine (weakref) whose ``kv_pool_bytes()`` the
    ledger prices.  Always cheap; engines register at construction."""
    _ENGINES.add(engine)


def counter_marks() -> List[tuple]:
    """Buffered ``(name, perf_ns, value)`` marks for the chrome-trace
    exporter's HBM counter lanes; [] while disarmed."""
    led = _ACTIVE
    return led.marks() if led is not None else []


def note_restore(nbytes: int):
    """Checkpoint restore began: record the transient host-side tree
    size.  Sets the gauge regardless of arming (restores are cold path;
    the gauge no-ops itself when metrics are off)."""
    _registry.gauge("hbm.restore_transient_bytes").set(float(nbytes))
    led = _ACTIVE
    if led is not None:
        led._mark("hbm.restore_transient_bytes",
                  time.perf_counter_ns(), float(nbytes))


def clear_restore():
    _registry.gauge("hbm.restore_transient_bytes").set(0.0)
    led = _ACTIVE
    if led is not None:
        led._mark("hbm.restore_transient_bytes",
                  time.perf_counter_ns(), 0.0)


def ledger_state(top_n: int = TOP_ARRAYS) -> Dict[str, Any]:
    """JSON-ready ledger snapshot for flight dumps: a FRESH collection
    (works armed or not — the dump moment is exactly when an unarmed
    process wants one) plus the last periodic sample when armed.  Never
    raises — a broken collection must not mask the fault being dumped."""
    out: Dict[str, Any] = {"armed": _ACTIVE is not None}
    try:
        per = _live_per_device()
        out["devices"] = per
        out["live_bytes_total"] = sum(per.values())
        out["top_arrays"] = _top_arrays(top_n)
        out["kv_pool_bytes"] = _kv_pool_total()
        out["kv_host_bytes"] = _kv_host_total()
    except Exception as e:
        out["error"] = repr(e)
    led = _ACTIVE
    if led is not None and led.last:
        out["last_sample"] = dict(led.last)
    return out


# env opt-in: PADDLE_TPU_HBM=1 arms the ledger at import time (the
# registry's env-knob discipline; PADDLE_TPU_HBM_EVERY thins sampling)
if os.environ.get("PADDLE_TPU_HBM", "0") not in ("0", "", "false", "off"):
    enable()
