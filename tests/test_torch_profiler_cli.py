"""paddle_tpu_torch.profiler and the observability CLI against paddle_tpu's
on the CPU: the scheduler's states step by step, RecordEvent spans and the
chrome export (host spans, the torch trace's events moved onto the host
clock, metric marks), the timer, and each CLI subcommand (``dump``,
``tail``, ``serve``, ``trace-report``, ``cluster``) on the same snapshot,
trace and store as the JAX CLI; ``programs`` exits 2 naming ROADMAP.md
§A8."""
import contextlib
import glob
import io
import json
import os
import urllib.request

import pytest
import torch

import _torch_pair as P
import paddle_tpu.observability.__main__ as jcli
import paddle_tpu.profiler as jprof
import paddle_tpu_torch.observability.__main__ as tcli
from paddle_tpu_torch import profiler as tprof
from paddle_tpu_torch.distributed.store import TCPStore
from paddle_tpu_torch.observability import (aggregate, exporters, registry,
                                            tracing)
from paddle_tpu_torch.serving import ContinuousBatchingScheduler, \
    DecodeEngine, Request

SCHEDULES = [dict(closed=1, ready=1, record=3),
             dict(closed=0, ready=2, record=2, repeat=2),
             dict(closed=2, ready=0, record=1, skip_first=3)]


@pytest.mark.parametrize("kw", SCHEDULES)
def test_scheduler_states_equal_jax(kw):
    t, j = tprof.make_scheduler(**kw), jprof.make_scheduler(**kw)
    assert [t(i).name for i in range(24)] == [j(i).name for i in range(24)]


def _profile(mod, tmp, timer_only, steps=5):
    prof = mod.Profiler(scheduler=mod.make_scheduler(closed=1, ready=1,
                                                     record=3),
                        on_trace_ready=mod.export_chrome_tracing(str(tmp)),
                        **({"timer_only": True} if timer_only else {}))
    states = []
    x = torch.randn(32, 32)
    prof.start()
    for i in range(steps):
        with mod.RecordEvent("step.%d" % i):
            with mod.RecordEvent("inner"):
                x = x @ x / 32
        prof.step(num_samples=4)
        states.append(prof._state.name)
    prof.stop()
    files = sorted(glob.glob(os.path.join(str(tmp), "*.json")),
                   key=os.path.getmtime)
    docs = [mod.load_profiler_result(f)["traceEvents"] for f in files]
    return prof, states, docs


def _host_spans(events):
    return sorted(e["name"] for e in events if e.get("cat") == "host")


def test_timer_only_profiler_exports_as_jax_does(tmp_path):
    """Without the torch trace the Profiler is the JAX one: the same
    states, an export at the RECORD_AND_RETURN step and one at stop, each
    with the same host spans."""
    _p, jstates, jdocs = _profile(jprof, tmp_path / "j", False)
    tp, tstates, tdocs = _profile(tprof, tmp_path / "t", True)
    assert tstates == jstates
    assert len(tdocs) == len(jdocs) == 2
    for t, j in zip(tdocs, jdocs):
        assert _host_spans(t) == _host_spans(j)
    assert "avg_step_time" in tp.step_info() and "ips" in tp.step_info()


def test_profiler_window_holds_spans_ops_and_marks(tmp_path):
    registry.counter("train.steps").inc()
    prof, states, docs = _profile(tprof, tmp_path, False)
    assert states == ["READY", "RECORD", "RECORD", "RECORD_AND_RETURN",
                      "CLOSED"]
    # the window closes after its last step, and stop exports again
    assert len(docs) == 2
    first = docs[0]
    assert _host_spans(first) == sorted(["inner"] * 5 + [
        "step.%d" % i for i in range(5)])
    ann = [e for e in first if e.get("cat") == "user_annotation"
           and e["name"].startswith("step.")]
    # the torch trace recorded steps 2-4 (the READY step is its warm-up)
    assert sorted(e["name"] for e in ann) == ["step.2", "step.3", "step.4"]
    host = {e["name"]: e for e in first if e.get("cat") == "host"}
    for e in ann:    # moved onto the host recorder's clock
        assert abs(e["ts"] - host[e["name"]]["ts"]) < 50.0
    assert any(e.get("cat") == "cpu_op" and "mm" in e["name"]
               for e in first)
    marks = [e for e in first if e.get("cat") == "metric"]
    assert any(e["name"] == "train.steps" and e["ph"] == "C"
               for e in marks)
    assert prof.device_seconds() == 0.0       # no card
    assert "step.0" in prof.summary()


def test_guard_and_record_event_without_a_profiler(tmp_path):
    tprof._recorder.drain()
    with tprof.RecordEvent("alone"):
        pass
    with tprof.profiler_guard(timer_only=True) as p:
        p.step()
    assert [n for n, *_ in p._drained_events] == ["alone"]


def test_inject_profiler_marks_equals_jax_layout():
    registry.gauge("train.loss").set(1.5)
    tprof._metric_marks.clear()
    n = exporters.inject_profiler_marks(ts_ns=7)
    assert n == len(tprof._metric_marks) > 0
    assert ("train.loss", 7, 1.5) in tprof._metric_marks
    tprof._metric_marks.clear()


@pytest.fixture(scope="module")
def snapshot_file(tmp_path_factory):
    """Two JSONL snapshots of a registry that saw a small serving run."""
    path = str(tmp_path_factory.mktemp("snap") / "m.jsonl")
    _jm, tm = P.pair()
    eng = DecodeEngine(tm, num_slots=2, max_len=64, page_size=8,
                       device="cpu")
    P.drive(ContinuousBatchingScheduler(eng), Request, P.prompts(2),
            max_new=3)
    exp = exporters.JsonlExporter(path)
    exp.write()
    registry.counter("train.steps").inc()
    exp.write()
    return path


def _cli(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


@pytest.mark.parametrize("argv", [["dump", "--format", "prom"],
                                  ["dump", "--format", "json"],
                                  ["tail"]])
def test_dump_and_tail_equal_jax(snapshot_file, argv):
    argv = argv[:1] + ["--file", snapshot_file] + argv[1:]
    t, j = _cli(tcli.main, argv), _cli(jcli.main, argv)
    assert t[0] == j[0] == 0
    assert t[1] == j[1] and t[1]


def test_dump_of_a_missing_file_fails_like_jax(tmp_path):
    argv = ["dump", "--file", str(tmp_path / "none.jsonl")]
    t, j = _cli(tcli.main, argv), _cli(jcli.main, argv)
    assert t[0] == j[0] == 1 and t[2] == j[2]


def test_serve_equals_jax(snapshot_file):
    bodies = []
    for mod in (tcli, jcli):
        srv = mod.make_server(snapshot_file, port=0)
        import threading
        th = threading.Thread(target=srv.handle_request, daemon=True)
        th.start()
        with urllib.request.urlopen("http://127.0.0.1:%d/metrics"
                                    % srv.server_address[1],
                                    timeout=30) as r:
            bodies.append(r.read())
        th.join(30)
        srv.server_close()
    assert bodies[0] == bodies[1] and bodies[0]


def test_trace_report_equals_jax(tmp_path):
    _jm, tm = P.pair()
    tracer = tracing.Tracer()
    eng = DecodeEngine(tm, num_slots=2, max_len=64, page_size=8,
                       device="cpu", tracer=tracer)
    P.drive(ContinuousBatchingScheduler(eng, tracer=tracer), Request,
            P.prompts(3), max_new=4)
    path = str(tmp_path / "t.jsonl")
    tracer.export_jsonl(path)
    for fmt in (["--format", "json"], ["--sli"]):
        argv = ["trace-report", "--file", path] + fmt
        t, j = _cli(tcli.main, argv), _cli(jcli.main, argv)
        assert t[0] == j[0] == 0 and t[1] == j[1]
    argv = ["trace-report", "--file", path, "--chrome",
            str(tmp_path / "c.json")]
    assert _cli(tcli.main, argv)[0] == 0
    with open(tmp_path / "c.json") as f:
        assert json.load(f)["traceEvents"]
    empty = str(tmp_path / "e.jsonl")
    open(empty, "w").close()
    t = _cli(tcli.main, ["trace-report", "--file", empty])
    j = _cli(jcli.main, ["trace-report", "--file", empty])
    assert t[0] == j[0] == 2


def test_cluster_equals_jax():
    master = TCPStore("127.0.0.1", 0, is_master=True, world_size=2)
    addr = "127.0.0.1:%d" % master.port
    argv = ["cluster", "--master", addr, "--world", "2", "--timeout", "5"]
    t, j = _cli(tcli.main, argv), _cli(jcli.main, argv)
    assert t[0] == j[0] == 2 and "NO host" in t[2]
    aggregate.HostPublisher(TCPStore("127.0.0.1", master.port), host=0,
                            interval=999.0).publish_once()
    for fmt in (["--format", "json"], []):
        t, j = _cli(tcli.main, argv + fmt), _cli(jcli.main, argv + fmt)
        assert t[0] == j[0] == 1          # host 1 never published
        if fmt:
            td, jd = json.loads(t[1]), json.loads(j[1])
            for doc in (td, jd):    # read at two moments
                for row in doc["hosts"].values():
                    row.pop("staleness_s")
            assert td["hosts"] == jd["hosts"] and td["missing"] == [1]
        assert t[2] == j[2]


def test_programs_exits_nonzero_naming_a8():
    rc, out, err = _cli(tcli.main, ["programs"])
    assert rc == 2 and out == "" and "§A8" in err
