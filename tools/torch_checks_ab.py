#!/usr/bin/env python3
"""Named checks of chip_smoke.py on one NVIDIA card, for one or more
checkouts in turn.

    python3 tools/torch_checks_ab.py [--ptxas PATTERN] [--sass PATTERN]
        [--smoke FILE] --checks LIST ROOT ...

Each ROOT is a checkout of this repository (its ``chip_smoke.py`` and
``paddle_tpu_torch/``).  For each ROOT, in the order given, a fresh
process builds that checkout's CUDA kernels and runs the named check
functions of that checkout's ``chip_smoke.py`` (or, with ``--smoke``, of
the one ``chip_smoke.py`` named, on each checkout's kernels: a check that
a later checkout added, timed on an earlier one's kernels), printing one
JSON line per check with what it returned.  LIST is comma-separated;
each entry is a function name with optional keyword arguments after
colons, e.g.

    check_pipelined,check_flash_bwd,check_flash_long
    check_pipelined_repeats:repeats=20
    check_layer_norm:sizes=8/128/8192/16384
    check_layer_norm_bwd:dtype=float16:sizes=8192

A value is a torch dtype when it names one, ``a/b/c`` a tuple of ints,
else an int, a float, ``true`` / ``false`` or the string.  A check's
leading arguments are given by their names: ``torch``, ``fac`` (the
flash kernels), ``at`` (the autotuner), ``lib`` (the built library),
``norm_cuda``, ``ce_cuda`` and ``flags``.  ``--ptxas PATTERN`` builds with
``-Xptxas -v`` and first prints the registers and spills of every kernel
whose name holds PATTERN; ``--sass PATTERN`` prints, for each such
kernel, its instruction count and the count of each opcode in the built
library's SASS (``cuobjdump -sass``).  Then the card's name and power
limit.  Naming the parent and the change as ``parent change change
parent`` compares them in turns on one card.
"""
from __future__ import annotations

import argparse
import collections
import importlib.util
import inspect
import json
import os
import re
import subprocess
import sys


def parse_value(torch, text):
    if isinstance(getattr(torch, text, None), torch.dtype):
        return getattr(torch, text)
    if "/" in text:
        return tuple(int(x) for x in text.split("/"))
    for kind in (int, float):
        try:
            return kind(text)
        except ValueError:
            pass
    return {"true": True, "false": False}.get(text.lower(), text)


def parse_check(torch, spec):
    """``name:key=value:...`` -> (name, keyword arguments)."""
    name, *pairs = spec.split(":")
    kwargs = {}
    for pair in pairs:
        key, _, value = pair.partition("=")
        kwargs[key] = parse_value(torch, value)
    return name, kwargs


def sass_mix(lib_path, cuobjdump, pattern):
    """{kernel: {"instructions": n, "opcodes": {opcode: n}}} of every
    kernel whose (mangled) name holds ``pattern``, from the SASS of the
    library at ``lib_path``."""
    sass = subprocess.run([cuobjdump, "-sass", str(lib_path)],
                          capture_output=True, text=True, check=True,
                          timeout=600).stdout
    out, cur = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = collections.Counter() if pattern in m.group(1) else None
            if cur is not None:
                out[m.group(1)] = cur
            continue
        m = cur is not None and re.search(
            r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if m:
            cur[m.group(1).split(".")[0]] += 1
    return {k: {"instructions": sum(c.values()),
                "opcodes": dict(c.most_common())} for k, c in out.items()}


def one(root, ptxas, checks, smoke="", sass=""):
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import torch

    if smoke:
        spec = importlib.util.spec_from_file_location("chip_smoke", smoke)
        cs = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(cs)
    else:
        import chip_smoke as cs
    from paddle_tpu_torch.kernels import _build, autotune, ce_cuda, norm_cuda
    from paddle_tpu_torch.kernels import flash_attention_cuda as fac
    from paddle_tpu_torch.utils import flags
    if not torch.cuda.is_available():
        raise SystemExit("torch_checks_ab: no CUDA device available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _path, log = _build.build(ptxas_info=bool(ptxas))
    lib = _build.library()
    if ptxas:
        print(json.dumps({"root": root,
                          "ptxas": cs.ptxas_usage(log, ptxas)}), flush=True)
    if sass:
        cuobjdump = os.path.join(os.path.dirname(_build.find_nvcc()),
                                 "cuobjdump")
        print(json.dumps({"root": root, "sass": sass_mix(
            _path, cuobjdump, sass)}), flush=True)
    given = {"torch": torch, "fac": fac, "at": autotune, "lib": lib,
             "norm_cuda": norm_cuda, "ce_cuda": ce_cuda, "flags": flags}
    kind = torch.cuda.get_device_name(0)
    for spec in checks:
        name, kwargs = parse_check(torch, spec)
        fn = getattr(cs, name)
        args = [given[p.name] for p in inspect.signature(fn).parameters
                .values() if p.default is p.empty]
        print(json.dumps({"root": root, "check": spec,
                          "result": fn(*args, **kwargs), "kind": kind},
                         default=str), flush=True)
        torch.cuda.empty_cache()


def main(argv):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--ptxas", metavar="PATTERN", default="",
                        help="build with -Xptxas -v and print the "
                             "registers and spills of the kernels whose "
                             "name holds PATTERN")
    parser.add_argument("--sass", metavar="PATTERN", default="",
                        help="print the SASS opcode counts of the kernels "
                             "whose name holds PATTERN")
    parser.add_argument("--smoke", metavar="FILE", default="",
                        help="run the checks of this chip_smoke.py on "
                             "every ROOT's kernels")
    parser.add_argument("--checks", required=True,
                        help="comma-separated chip_smoke check functions, "
                             "each with optional :key=value arguments")
    parser.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    parser.add_argument("roots", nargs="+", metavar="ROOT")
    args = parser.parse_args(argv)
    checks = [c for c in args.checks.split(",") if c]
    smoke = os.path.abspath(args.smoke) if args.smoke else ""
    if args.one:
        one(args.roots[0], args.ptxas, checks, smoke, args.sass)
        return 0
    for root in args.roots:
        subprocess.run([sys.executable, os.path.abspath(__file__), "--one",
                        "--ptxas", args.ptxas, "--sass", args.sass,
                        "--smoke", smoke,
                        "--checks", ",".join(checks), root], check=True,
                       timeout=1200)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
