#!/usr/bin/env python3
"""chip_smoke.py's two LayerNorm checks on one NVIDIA card, for one or
more checkouts in turn.

    python3 tools/torch_ln_bench.py [--ptxas] ROOT [ROOT ...]

Each ROOT is a checkout of this repository (its ``chip_smoke.py`` and
``paddle_tpu_torch/``).  For each ROOT, in the order given, a fresh
process builds that checkout's CUDA kernels and runs that checkout's
``check_layer_norm`` (kernel B, bf16 x with f32 gamma / beta at 8, 128,
8192 and 16384 rows of 1024; fp16 x at 8192) and
``check_layer_norm_bwd`` (kernel D at 8192, 16384 and 128 rows; fp16 at
8192): each held against its plain version, with the kernel's, the plain
version's and ``F.layer_norm``'s CUDA-event and profiler times, the
bound, and D's split into its launches.  One JSON line per check and
ROOT; ``--ptxas`` builds with ``-Xptxas -v`` and first prints ptxas's
lines for the LayerNorm kernels (registers, spills).  Then the card's
name and power limit.  Naming the parent and the change as ``parent
change change parent`` compares them in turns on one card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys


def ptxas_lines(log, pattern="layer_norm"):
    """ptxas's report (entry line, registers, spills) of every kernel
    whose mangled name holds ``pattern``."""
    keep, out = False, []
    for line in log.splitlines():
        if "Compiling entry function" in line:
            keep = pattern in line
        if keep and ("ptxas" in line or "spill" in line):
            out.append(line.strip())
    return out


def one(root, ptxas):
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs
    from paddle_tpu_torch.kernels import _build, norm_cuda
    if not torch.cuda.is_available():
        raise SystemExit("torch_ln_bench: no CUDA device available")
    torch.backends.cuda.matmul.allow_tf32 = False
    _path, log = _build.build(ptxas_info=ptxas)
    _build.library()
    if ptxas:
        print(json.dumps({"root": root, "ptxas": ptxas_lines(log)}),
              flush=True)
    kind = torch.cuda.get_device_name(0)
    for name, fn, kw in (
            ("layer_norm_fwd", cs.check_layer_norm,
             {"sizes": (8, 128, 8192, 16384)}),
            ("layer_norm_fwd_fp16", cs.check_layer_norm,
             {"dtype": torch.float16, "sizes": (8192,)}),
            ("layer_norm_bwd", cs.check_layer_norm_bwd,
             {"sizes": (8192, 16384, 128)}),
            ("layer_norm_bwd_fp16", cs.check_layer_norm_bwd,
             {"dtype": torch.float16, "sizes": (8192,)})):
        rows, err = fn(torch, norm_cuda, **kw)
        print(json.dumps({"root": root, "check": name, "max_abs_err": err,
                          "rows": rows, "kind": kind}), flush=True)


def main(argv):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--ptxas", action="store_true",
                        help="build with -Xptxas -v and print the "
                             "LayerNorm kernels' registers and spills")
    parser.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    parser.add_argument("roots", nargs="+", metavar="ROOT")
    args = parser.parse_args(argv)
    if args.one:
        one(args.roots[0], args.ptxas)
        return 0
    for root in args.roots:
        subprocess.run([sys.executable, os.path.abspath(__file__), "--one",
                        *(["--ptxas"] if args.ptxas else []), root],
                       check=True, timeout=900)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
