"""CLI over the JSONL metric-snapshot stream and span-trace files (port
of ``paddle_tpu/observability/__main__.py``).

    python -m paddle_tpu_torch.observability dump  [--file P] [--format prom|json]
    python -m paddle_tpu_torch.observability tail  [--file P] [--follow] [--interval S]
    python -m paddle_tpu_torch.observability serve [--file P] [--port N]
    python -m paddle_tpu_torch.observability trace-report --file T \\
        [--format table|json] [--chrome OUT] [--allow-empty] [--sli]
    python -m paddle_tpu_torch.observability programs [patterns]
    python -m paddle_tpu_torch.observability cluster [--master host:port] \\
        [--world N] [--pct P] [--format table|json]

``trace-report`` reconstructs per-request timelines from a
span trace (the JSONL a :class:`~.tracing.Tracer` exports — see
``Tracer.flush``) and prints TTFT/TPOT attribution
(queue vs prefill vs decode vs preemption-rework share) per request;
``--chrome OUT`` additionally writes the chrome://tracing JSON with one
lane per request; ``--sli`` adds the per-finish-reason p50/p99
TTFT/TPOT rollup (cross-checked in tests against the scheduler's histograms
on the same run).  Exit 2 when the file holds no request traces (unless
``--allow-empty``), exit 1 when any request's span tree is
disconnected — CI uses both as hard gates.

``programs`` prices the JAX package's canonical program registry
(``paddle_tpu/analysis/``), which the port does not have yet: it exits 2
with a message naming ROADMAP.md §A8 and never prints an empty table.
A single step is priced by ``TrainStep.cost_report`` /
``DecodeEngine.cost_reports`` (:mod:`.costs`).

``cluster`` renders the merged cross-host view: it connects
a client to the distributed store every host publishes its telemetry
snapshot through (:mod:`.aggregate`), fetches all ``world`` hosts'
newest snapshots, and prints the per-host step-time table with
straggler flags (> ``--pct`` percent over the cluster median) and
stalled-beacon columns.  Exit 2 when NO host has published (never
silent green), exit 1 when some hosts are missing — a wedged worker
that stopped publishing is the loudest row in the table.

``--file`` defaults to ``$PADDLE_TPU_METRICS_FILE``.  ``dump`` renders the
newest snapshot (Prometheus text by default); with no file configured it
renders the current in-process default registry (useful after ``python -c
"import workload; ..."``-style drivers).  ``tail`` prints one compact line
per snapshot (and keeps following with ``--follow``).  ``serve`` exposes
the newest snapshot at ``/metrics`` in Prometheus text format — point a
scraper at a training/serving host without linking any client library.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

from . import exporters, registry


def _latest_snapshot(path):
    """(ts, metrics) from the last well-formed line of a JSONL file."""
    last = None
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                last = line
    if last is None:
        return None, None
    doc = json.loads(last)
    return doc.get("ts"), doc.get("metrics", {})


def _render(metrics, fmt):
    if fmt == "json":
        return json.dumps(metrics, indent=1, sort_keys=True)
    return exporters.to_prometheus(snapshot=metrics)


def _summarize(doc) -> str:
    """One compact human line per snapshot for ``tail``."""
    metrics = doc.get("metrics", {})
    parts = []
    for name, entry in sorted(metrics.items()):
        for series in entry["series"]:
            labels = series.get("labels", {})
            key = name + ("{%s}" % ",".join("%s=%s" % kv for kv in
                                            sorted(labels.items()))
                          if labels else "")
            if entry["type"] == "histogram":
                parts.append("%s: n=%d p50=%.4g p99=%.4g"
                             % (key, series["count"], series["p50"],
                                series["p99"]))
            else:
                parts.append("%s=%.6g" % (key, series["value"]))
    ts = doc.get("ts")
    stamp = time.strftime("%H:%M:%S", time.localtime(ts)) if ts else "-"
    return "[%s] %s" % (stamp, "  ".join(parts) or "(empty)")


def cmd_dump(args) -> int:
    if args.file:
        try:
            _ts, metrics = _latest_snapshot(args.file)
        except FileNotFoundError:
            print("no snapshots in %s (file does not exist)" % args.file,
                  file=sys.stderr)
            return 1
        if metrics is None:
            print("no snapshots in %s" % args.file, file=sys.stderr)
            return 1
        print(_render(metrics, args.format), end="")
    else:
        print(_render(registry.default_registry().snapshot(), args.format),
              end="")
    return 0


def cmd_tail(args) -> int:
    if not args.file:
        print("tail needs --file or PADDLE_TPU_METRICS_FILE",
              file=sys.stderr)
        return 2
    pos = 0
    try:
        while True:
            if os.path.exists(args.file):
                with open(args.file) as f:
                    f.seek(pos)
                    while True:
                        line = f.readline()
                        if not line.endswith("\n"):
                            break  # torn tail line: re-read next round
                        pos = f.tell()
                        if not line.strip():
                            continue
                        try:
                            print(_summarize(json.loads(line)))
                        except json.JSONDecodeError:
                            pass  # malformed line: skip, keep following
            if not args.follow:
                return 0
            time.sleep(args.interval)
    except KeyboardInterrupt:
        return 0


def make_server(path, port=0, in_process=False):
    """The ``serve`` HTTP server (returned unstarted so tests can drive it
    on an ephemeral port).  ``GET /metrics`` -> Prometheus text of the
    newest snapshot (or the live in-process registry)."""
    from http.server import BaseHTTPRequestHandler, HTTPServer

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):
            if self.path.split("?")[0] not in ("/", "/metrics"):
                self.send_error(404)
                return
            try:
                if in_process or not path:
                    body = exporters.to_prometheus(
                        registry.default_registry())
                else:
                    _ts, metrics = _latest_snapshot(path)
                    body = _render(metrics or {}, "prom")
            except FileNotFoundError:
                body = ""
            data = body.encode()
            self.send_response(200)
            self.send_header("Content-Type",
                             "text/plain; version=0.0.4; charset=utf-8")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def log_message(self, fmt, *a):
            pass  # no per-request stderr spam

    return HTTPServer(("127.0.0.1", port), Handler)


def cmd_trace_report(args) -> int:
    from . import tracing
    if not args.file:
        print("trace-report needs --file (a Tracer JSONL export) or "
              "PADDLE_TPU_TRACE_FILE", file=sys.stderr)
        return 2
    try:
        spans, events, _metas = tracing.load_trace(args.file)
    except FileNotFoundError:
        print("no trace at %s" % args.file, file=sys.stderr)
        return 2
    report = tracing.build_report(spans, events)
    if args.chrome:
        tracing.write_chrome(args.chrome, spans, events,
                             include_profiler=False)
        print("chrome trace written to %s" % args.chrome,
              file=sys.stderr)
    if not report["requests"] and not args.allow_empty:
        print("no request traces in %s (0 spans with a 'request' root)"
              % args.file, file=sys.stderr)
        return 2
    if args.sli:
        report["sli"] = tracing.build_sli(report)
    if args.format == "json":
        print(json.dumps(report, indent=1, sort_keys=True))
    else:
        print(tracing.format_report(report))
        if args.sli:
            print()
            print(tracing.format_sli(report["sli"]))
    if not report["totals"]["connected"]:
        print("trace-report: DISCONNECTED span tree(s) — a span's "
              "parent link does not reach its request root",
              file=sys.stderr)
        return 1
    return 0


def cmd_programs(args) -> int:
    """The JAX CLI prices its canonical program registry; the port has
    none yet, and an empty table must never look green."""
    print("programs: the canonical program registry (the JAX package's "
          "analysis/ tiers) is not ported yet — ROADMAP.md §A8; price one "
          "step with TrainStep.cost_report or DecodeEngine.cost_reports",
          file=sys.stderr)
    return 2


def cmd_cluster(args) -> int:
    """The merged cross-host telemetry table (``--trace`` CLI
    discipline: an empty cluster exits 2, partial publication exits 1,
    both loud)."""
    from . import aggregate
    if not args.master:
        print("cluster needs --master host:port (or PADDLE_MASTER)",
              file=sys.stderr)
        return 2
    host, _, port = args.master.rpartition(":")
    if not host or not port.isdigit():
        print("cluster: malformed --master %r (want host:port)"
              % args.master, file=sys.stderr)
        return 2
    from ..distributed.store import TCPStore
    try:
        store = TCPStore(host, int(port), is_master=False,
                         world_size=args.world, timeout=args.timeout)
        docs, missing = aggregate.fetch_cluster(store, args.world)
    except (ConnectionError, OSError, RuntimeError) as e:
        # a dead/unreachable master is the exit-2 case (nothing could
        # be fetched), NOT exit 1 ("some hosts missing") — an operator
        # script keying on the rc must be able to tell them apart
        print("cluster: cannot reach the store at %s: %s"
              % (args.master, e), file=sys.stderr)
        return 2
    if not docs:
        print("cluster: NO host has published telemetry (of %d) — "
              "publishers not started, wrong --master, or the whole "
              "fleet is wedged" % args.world, file=sys.stderr)
        return 2
    doc = aggregate.merge_docs(docs, args.world, pct=args.pct,
                               set_gauges=False)
    if args.format == "json":
        print(json.dumps(doc, indent=1, sort_keys=True))
    else:
        print(aggregate.format_cluster(doc))
    if missing:
        print("cluster: %d host(s) missing: %s" % (len(missing), missing),
              file=sys.stderr)
        return 1
    return 0


def cmd_serve(args) -> int:
    srv = make_server(args.file, args.port)
    print("serving /metrics on http://127.0.0.1:%d (source: %s)"
          % (srv.server_address[1], args.file or "in-process registry"))
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.observability")
    sub = p.add_subparsers(dest="cmd", required=True)
    default_file = os.environ.get("PADDLE_TPU_METRICS_FILE")

    d = sub.add_parser("dump", help="print the newest snapshot")
    d.add_argument("--file", default=default_file)
    d.add_argument("--format", choices=("prom", "json"), default="prom")
    d.set_defaults(fn=cmd_dump)

    t = sub.add_parser("tail", help="print one line per snapshot")
    t.add_argument("--file", default=default_file)
    t.add_argument("--follow", action="store_true")
    t.add_argument("--interval", type=float, default=1.0)
    t.set_defaults(fn=cmd_tail)

    s = sub.add_parser("serve", help="HTTP /metrics endpoint")
    s.add_argument("--file", default=default_file)
    s.add_argument("--port", type=int, default=9464)
    s.set_defaults(fn=cmd_serve)

    r = sub.add_parser("trace-report",
                       help="per-request timeline + TTFT/TPOT "
                            "attribution from a span trace file")
    r.add_argument("--file",
                   default=os.environ.get("PADDLE_TPU_TRACE_FILE"))
    r.add_argument("--format", choices=("table", "json"),
                   default="table")
    r.add_argument("--chrome", default=None, metavar="OUT",
                   help="also write chrome://tracing JSON (one lane per "
                        "request) to OUT")
    r.add_argument("--allow-empty", action="store_true",
                   help="exit 0 even when the file holds no request "
                        "traces")
    r.add_argument("--sli", action="store_true",
                   help="add the per-finish-reason p50/p99 TTFT/TPOT "
                        "rollup (table mode prints it after the "
                        "per-request table; json mode adds an 'sli' key)")
    r.set_defaults(fn=cmd_trace_report)

    g = sub.add_parser("programs",
                       help="the JAX package's program-registry report "
                            "(not ported: ROADMAP.md §A8)")
    g.add_argument("patterns", nargs="*")
    g.add_argument("--format", choices=("table", "json"),
                   default="table")
    g.set_defaults(fn=cmd_programs)

    c = sub.add_parser("cluster",
                       help="merged cross-host telemetry view from the "
                            "distributed store (per-host step times, "
                            "straggler flags, stalled beacons, missing "
                            "hosts)")
    c.add_argument("--master", default=os.environ.get("PADDLE_MASTER"),
                   help="the distributed store endpoint host:port "
                        "(default: $PADDLE_MASTER)")
    c.add_argument("--world", type=int,
                   default=int(os.environ.get("PADDLE_TRAINERS_NUM",
                                              "1")),
                   help="hosts expected to publish (default: "
                        "$PADDLE_TRAINERS_NUM)")
    c.add_argument("--timeout", type=float, default=10.0,
                   help="seconds to keep dialing an unreachable store "
                        "before exiting 2")
    c.add_argument("--pct", type=float, default=None,
                   help="straggler threshold: flag hosts whose step p50 "
                        "exceeds the median by more than this percent "
                        "(default 25, or $PADDLE_TPU_STRAGGLER_PCT)")
    c.add_argument("--format", choices=("table", "json"),
                   default="table")
    c.set_defaults(fn=cmd_cluster)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
