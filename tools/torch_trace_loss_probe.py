"""Which kernel records does a ``torch.profiler`` trace lose, and does
``chip_smoke.traced_after_mark`` read whole steps all the same?

A small CUDA graph (60 x (matmul, relu, mul) on 256 x 256 f32) is
replayed five times a trace, each replay followed by a host
sync and a 10 ms sleep, so that the trace's kernels split into replays at
the gaps.  At each age of the process (seconds since start) it prints one
JSON line: the kernels of each replay in unmarked traces, and the
kernels after the mark in traces laid out as ``decode_profile`` lays
them (one lead-in replay, the mark, five counted replays).

    python3 tools/torch_trace_loss_probe.py [--ages 8,60,120] [--traces 6]

Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ages", default="8,60,120")
    ap.add_argument("--traces", type=int, default=6)
    args = ap.parse_args()
    import torch
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import TRACE_MARK_CYCLES, traced_after_mark
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    t0 = time.time()
    x = torch.randn(256, 256, device="cuda")

    def body():
        y = x
        for _ in range(60):
            y = torch.relu(y @ x) * 0.01
        return y

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            body()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        body()
    torch.cuda.synchronize()
    gap_s, replays = 0.01, 5

    def replay_all():
        for _ in range(replays):
            graph.replay()
            torch.cuda.synchronize()
            time.sleep(gap_s)

    def device_events(prof):
        return [e for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA]

    def unmarked():
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            replay_all()
        groups, last = [], None
        for e in sorted(device_events(prof), key=lambda e: e.time_range.start):
            if last is None or e.time_range.start - last > gap_s * 1e6 / 2:
                groups.append(0)
            groups[-1] += 1
            last = e.time_range.end
        return groups

    def marked():
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            graph.replay()
            torch.cuda.synchronize()
            torch.cuda._sleep(TRACE_MARK_CYCLES)
            replay_all()
        ran = traced_after_mark(torch, prof)
        return None if ran is None else len(ran)

    for age in (float(a) for a in args.ages.split(",")):
        while time.time() - t0 < age:
            time.sleep(0.2)
        plain = [unmarked() for _ in range(args.traces)]
        print(json.dumps({
            "age_s": round(time.time() - t0, 1),
            "unmarked_kernels_a_replay": plain,
            "marked_kernels_after_mark": [marked()
                                          for _ in range(args.traces)],
            "want_after_mark": replays * max(max(g, default=0)
                                             for g in plain)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
