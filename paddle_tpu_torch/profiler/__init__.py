"""Profiler (port of ``paddle_tpu/profiler/__init__.py``; reference surface:
python/paddle/profiler/ — the Profiler context manager with scheduler
windows, RecordEvent spans, the ips timer).

Host spans are recorded by the module's own recorder, as in the JAX
package, and exported as chrome://tracing JSON.  Device activity comes
from ``torch.profiler`` (the JAX package's ``jax.profiler``): unless
``timer_only``, the Profiler runs a ``torch.profiler.profile`` whose
schedule is the Profiler's own (``READY`` is its warm-up, ``RECORD`` /
``RECORD_AND_RETURN`` record, the window closes after the
``RECORD_AND_RETURN`` step), over the CPU and, where there is one, the
card (``targets``: ``ProfilerTarget.CPU`` / ``GPU``).  Each
:class:`RecordEvent` span is also a ``torch.profiler.record_function``
range, so it shows in the device trace beside the kernels it launched.

When a recording window closes, the Profiler takes the torch trace's
events (kernels, memcopies, ATen ops, the spans), moves them onto the
host recorder's ``perf_counter_ns`` clock by the offset at which the
window's RecordEvent spans appear in both (unshifted when the window
held none), notes the window's device seconds (``device_seconds()``:
the summed kernel, memcopy and memset time over the steps recorded, a
step), and calls ``on_trace_ready``.  ``stop()`` calls it again unless
stopping closed a window itself, as the JAX Profiler calls it at stop.
The JAX Profiler calls it at the step that enters
``RECORD_AND_RETURN``; here the window's last step has to run first.
:func:`export_chrome_tracing` writes the host spans, the torch events,
the metric marks (:func:`..observability.exporters
.inject_profiler_marks`) and the HBM ledger's counter marks (the HBM
lanes, ``"C"`` events; the JAX package puts those in
``tracing.write_chrome`` only).

On a trace of the H100 machine the records of the first kernels a
process's profiler sees can go missing (``chip_smoke.traced_after_mark``):
give a window a ``READY`` step before it records.
"""
from __future__ import annotations

import contextlib
import json
import os
import tempfile
import threading
import time
from enum import Enum

import torch

__all__ = ["ProfilerTarget", "ProfilerState", "make_scheduler",
           "RecordEvent", "export_chrome_tracing", "Profiler", "TimerHub",
           "profiler_guard", "load_profiler_result"]


class ProfilerTarget(Enum):
    CPU = 0
    GPU = 1
    TPU = 2
    CUSTOM_DEVICE = 3


class ProfilerState(Enum):
    CLOSED = 0
    READY = 1
    RECORD = 2
    RECORD_AND_RETURN = 3


def make_scheduler(closed: int, ready: int, record: int, repeat: int = 0,
                   skip_first: int = 0):
    """reference parity: profiler.py:67 make_scheduler — step-state machine."""
    period = closed + ready + record

    def scheduler(step: int) -> ProfilerState:
        if step < skip_first:
            return ProfilerState.CLOSED
        s = step - skip_first
        if repeat and s >= repeat * period:
            return ProfilerState.CLOSED
        pos = s % period
        if pos < closed:
            return ProfilerState.CLOSED
        if pos < closed + ready:
            return ProfilerState.READY
        if pos == period - 1:
            return ProfilerState.RECORD_AND_RETURN
        return ProfilerState.RECORD

    return scheduler


class _HostEventRecorder:
    """Per-thread span buffers merged at export
    (reference: host_event_recorder.h)."""

    def __init__(self):
        self._events = []
        self._lock = threading.Lock()

    def add(self, name, ts, dur, tid):
        with self._lock:
            self._events.append((name, ts, dur, tid))

    def drain(self):
        with self._lock:
            ev, self._events = self._events, []
        return ev


_recorder = _HostEventRecorder()

#: chrome-trace counter marks injected by paddle_tpu_torch.observability:
#: (name, ts_ns, value) triples, exported as "ph": "C" events so metric
#: tracks render time-aligned under the host spans.
_metric_marks = []

#: backstop bound on the mark buffer: export_chrome_tracing drains it, but
#: a custom on_trace_ready callback may not — keep only the newest marks
#: so an undrained buffer can never grow for the life of the process.
_MARKS_CAP = 100_000

#: the trace categories whose durations are device time
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _inject_metric_marks():
    """Snapshot the default metrics registry into the mark buffer (no-op
    when observability is disabled)."""
    from ..observability.exporters import inject_profiler_marks
    inject_profiler_marks()


class RecordEvent:
    """Span instrumentation (reference: platform::RecordEvent); also a
    ``torch.profiler.record_function`` range."""

    def __init__(self, name: str, event_type=None):
        self.name = name
        self._begin = None
        self._range = None

    def begin(self):
        self._range = torch.profiler.record_function(self.name)
        self._range.__enter__()
        self._begin = time.perf_counter_ns()

    def end(self):
        if self._begin is None:
            return
        now = time.perf_counter_ns()
        _recorder.add(self.name, self._begin, now - self._begin,
                      threading.get_ident())
        self._begin = None
        rng, self._range = self._range, None
        rng.__exit__(None, None, None)

    def __enter__(self):
        self.begin()
        return self

    def __exit__(self, *exc):
        self.end()
        return False


def export_chrome_tracing(dir_name: str, worker_name: str = None):
    """Returns an on_trace_ready callback writing chrome://tracing JSON
    (reference: profiler.py:154)."""

    def handler(prof):
        from ..observability import hbm as _hbm
        from ..observability.tracing import hbm_counter_events
        os.makedirs(dir_name, exist_ok=True)
        stem = os.path.join(
            dir_name, f"{worker_name or 'worker'}_{os.getpid()}"
            f"_{int(time.time() * 1000)}")
        fname, n = stem + ".pt.trace.json", 0
        while os.path.exists(fname):    # two exports in one millisecond
            n += 1
            fname = "%s_%d.pt.trace.json" % (stem, n)
        pid = os.getpid()
        events = [{
            "name": name, "ph": "X", "ts": ts / 1000.0, "dur": dur / 1000.0,
            "pid": pid, "tid": tid, "cat": "host",
        } for name, ts, dur, tid in prof._drained_events]
        events.extend(prof._torch_events)
        marks, _metric_marks[:] = list(_metric_marks), []
        events.extend({
            "name": name, "ph": "C", "ts": ts / 1000.0,
            "pid": pid, "cat": "metric", "args": {"value": value},
        } for name, ts, value in marks)
        events.extend(hbm_counter_events(_hbm.counter_marks(), pid))
        with open(fname, "w") as f:
            json.dump({"traceEvents": events}, f)
        prof._last_export = fname

    return handler


def _torch_trace_events(tprof):
    """The chrome-trace events of a finished ``torch.profiler`` window."""
    fd, path = tempfile.mkstemp(suffix=".pt.trace.json")
    os.close(fd)
    try:
        tprof.export_chrome_trace(path)
        with open(path) as f:
            doc = json.load(f)
    finally:
        os.unlink(path)
    return [e for e in doc.get("traceEvents", []) if isinstance(e, dict)]


def _host_offset_us(torch_events, host_spans):
    """How far (us) the torch trace's clock runs ahead of the host
    recorder's, from the spans that are in both (the median of the
    differences of their starts); None when there is none."""
    starts = {}
    for name, ts, _dur, _tid in host_spans:
        starts.setdefault(name, []).append(ts / 1000.0)
    diffs = []
    for e in torch_events:
        if e.get("ph") == "X" and e.get("cat") == "user_annotation" \
                and e.get("name") in starts:
            host = starts[e["name"]]
            diffs.append(min((e["ts"] - h for h in host), key=abs))
    if not diffs:
        return None
    diffs.sort()
    return diffs[len(diffs) // 2]


class Profiler:
    """reference parity: python/paddle/profiler/profiler.py:264.
    ``trace_dir`` (the JAX Profiler's ``jax.profiler`` directory) is
    accepted and unused: the device trace reaches ``on_trace_ready``."""

    def __init__(self, targets=None, scheduler=None, on_trace_ready=None,
                 record_shapes=False, profile_memory=False, timer_only=False,
                 trace_dir=None):
        if isinstance(scheduler, tuple):
            start, end = scheduler
            scheduler = make_scheduler(closed=max(start, 0), ready=0,
                                       record=end - start, repeat=1)
        self._scheduler = scheduler
        self._on_trace_ready = on_trace_ready
        self._step = 0
        self._state = ProfilerState.RECORD if scheduler is None else \
            ProfilerState.CLOSED
        self._drained_events = []
        self._torch_events = []
        self._last_export = None
        self._timer_only = timer_only
        self._targets = targets
        self._record_shapes = record_shapes
        self._profile_memory = profile_memory
        self._tprof = None
        self._window_steps = 0
        self._fired = False
        self._device_seconds = None
        self.benchmark = TimerHub()

    def _activities(self):
        from torch.profiler import ProfilerActivity
        targets = self._targets
        if targets is None:
            targets = [ProfilerTarget.CPU] + (
                [ProfilerTarget.GPU] if torch.cuda.is_available() else [])
        out = []
        if ProfilerTarget.CPU in targets:
            out.append(ProfilerActivity.CPU)
        if ProfilerTarget.GPU in targets and torch.cuda.is_available():
            out.append(ProfilerActivity.CUDA)
        return out

    def _torch_schedule(self):
        from torch.profiler import ProfilerAction
        action = {ProfilerState.CLOSED: ProfilerAction.NONE,
                  ProfilerState.READY: ProfilerAction.WARMUP,
                  ProfilerState.RECORD: ProfilerAction.RECORD,
                  ProfilerState.RECORD_AND_RETURN:
                      ProfilerAction.RECORD_AND_SAVE}
        sched = self._scheduler
        return lambda step: action[sched(step)]

    def _recording(self, step: int) -> bool:
        if self._scheduler is None:
            return True
        return self._scheduler(step) in (ProfilerState.RECORD,
                                         ProfilerState.RECORD_AND_RETURN)

    def start(self):
        self.benchmark.begin()
        if not self._timer_only:
            self._tprof = torch.profiler.profile(
                activities=self._activities(),
                schedule=(self._torch_schedule() if self._scheduler
                          else None),
                on_trace_ready=self._window_closed,
                record_shapes=self._record_shapes,
                profile_memory=self._profile_memory)
            self._tprof.start()
        return self

    def _window_closed(self, tprof):
        """torch's trace-ready hook: take the window's events, then call
        ``on_trace_ready``."""
        events = _torch_trace_events(tprof)
        self._drained_events.extend(_recorder.drain())
        shift = _host_offset_us(events, self._drained_events)
        if shift is not None:
            for e in events:
                if "ts" in e:
                    e["ts"] = e["ts"] - shift
        self._torch_events = events
        steps = max(self._window_steps, 1)
        self._device_seconds = sum(
            float(e.get("dur", 0.0)) for e in events
            if e.get("ph") == "X" and e.get("cat") in _DEVICE_CATS
        ) / 1e6 / steps
        self._window_steps = 0
        self._fired = True
        if self._on_trace_ready:
            _inject_metric_marks()
            self._on_trace_ready(self)

    def device_seconds(self):
        """Device seconds a step of the last closed window: its kernels',
        memcopies' and memsets' durations summed over the steps it
        recorded, divided by them; None before a window closed."""
        return self._device_seconds

    def stop(self):
        self._fired = False
        if self._tprof is not None:
            if self._scheduler is not None and self._recording(self._step):
                self._window_steps += 1     # the window's unfinished step
            self._tprof.stop()
            self._tprof = None
        if not self._fired:
            self._drained_events.extend(_recorder.drain())
            if self._on_trace_ready:
                # marks exist solely for the trace-export stream:
                # injecting with no consumer would strand them
                _inject_metric_marks()
                self._on_trace_ready(self)

    def step(self, num_samples=None):
        self.benchmark.step(num_samples)
        if self._tprof is not None and self._recording(self._step):
            self._window_steps += 1
        self._step += 1
        if self._scheduler:
            self._state = self._scheduler(self._step)
        if self._tprof is not None:
            self._tprof.step()
        elif self._scheduler and \
                self._state == ProfilerState.RECORD_AND_RETURN:
            self._drained_events.extend(_recorder.drain())
            if self._on_trace_ready:
                _inject_metric_marks()
                self._on_trace_ready(self)

    def step_info(self, unit="samples"):
        return self.benchmark.step_info(unit)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False

    def summary(self, sorted_by=None, op_detail=True, thread_sep=False,
                time_unit="ms"):
        by_name = {}
        for name, ts, dur, tid in self._drained_events:
            agg = by_name.setdefault(name, [0, 0.0])
            agg[0] += 1
            agg[1] += dur / 1e6
        lines = [f"{'name':40s} {'calls':>8s} {'total_ms':>12s}"]
        for name, (calls, total) in sorted(by_name.items(),
                                           key=lambda kv: -kv[1][1]):
            lines.append(f"{name[:40]:40s} {calls:8d} {total:12.3f}")
        return "\n".join(lines)


class TimerHub:
    """Throughput (ips) timer — reference: python/paddle/profiler/timer.py."""

    def __init__(self):
        self.reset()

    def reset(self):
        self._start = None
        self._last = None
        self._steps = 0
        self._samples = 0
        self._window = []

    def begin(self):
        self._start = self._last = time.perf_counter()

    def step(self, num_samples=None):
        now = time.perf_counter()
        if self._last is not None:
            self._window.append(now - self._last)
            if len(self._window) > 100:
                self._window.pop(0)
        self._last = now
        self._steps += 1
        if num_samples:
            self._samples += num_samples

    def step_info(self, unit="samples"):
        if not self._window:
            return "no steps recorded"
        avg = sum(self._window) / len(self._window)
        ips = (self._samples / max(self._steps, 1)) / avg if self._samples \
            else 1.0 / avg
        return (f"avg_step_time: {avg * 1000:.3f} ms, "
                f"ips: {ips:.2f} {unit}/s")


@contextlib.contextmanager
def profiler_guard(**kwargs):
    p = Profiler(**kwargs)
    p.start()
    try:
        yield p
    finally:
        p.stop()


def load_profiler_result(path):
    with open(path) as f:
        return json.load(f)
