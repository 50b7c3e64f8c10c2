#!/usr/bin/env python3
"""chip_smoke.py's training step on one NVIDIA card, for one or more
checkouts in turn.

    python3 tools/torch_train_ab.py [--shape B,S] [--steps N] ROOT [ROOT ...]

Each ROOT is a checkout of this repository (its ``chip_smoke.py`` and
``paddle_tpu_torch/``).  For each ROOT, in the order given, a fresh
process builds that checkout's CUDA kernels and trains through that
checkout's ``jit.TrainStep``: GPT-2 345M at full width (24 layers,
hidden 1024, 16 heads of 64), max_position_embeddings at least S,
seeded random weights, dropout 0, AMP O2 bf16, AdamW, one seeded (B, S)
batch.  The default shape (1, 16384) is chip_smoke.py's train_long, whose
backward takes the split flash kernels; (8, 1024) is its train, which
takes the merged one.  It takes N steps (default 3; ms over steps 2..N
on the host clock, the launch counts of all N), then one more step timed
part by part on the stream.  Tuning is off, with no pin and an autotune
cache of the run's own.  One JSON line per run, then the card's name and
power limit.  Naming the parent and the change as ``parent change change
parent`` compares them in turns on one card.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile


def one(root, b, s, steps):
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import numpy as np
    import torch

    import chip_smoke as cs
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.kernels import _build, ce_cuda, norm_cuda
    from paddle_tpu_torch.kernels import flash_attention_cuda as fac
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.utils import flags
    if not torch.cuda.is_available():
        raise SystemExit("torch_train_ab: no CUDA device available")
    _build.library()
    tmp = tempfile.TemporaryDirectory(prefix="autotune-", dir=_build.BUILD_DIR)
    os.environ["PADDLE_TPU_AUTOTUNE_CACHE"] = os.path.join(tmp.name,
                                                           "autotune.json")
    for var in ("PADDLE_TPU_AUTOTUNE", "PADDLE_TPU_AUTOTUNE_PIN"):
        os.environ.pop(var, None)
    flags.set_flags({"autotune": False, "autotune_pin": "",
                     "use_pallas_norm": False})
    cfg = GPTConfig.gpt2_medium()
    cfg = dataclasses.replace(cfg, hidden_dropout_prob=0.0,
                              attention_dropout_prob=0.0,
                              max_position_embeddings=max(
                                  s, cfg.max_position_embeddings))
    base = GPTForCausalLM(cfg, generator=torch.Generator().manual_seed(1))
    step = cs.make_step(cs.train_model(torch, base, amp))
    del base
    ids = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (b, s)), device="cuda")
    counters = cs.Counters(fac, norm_cuda, ce_cuda)
    losses, launches, ms = cs.run_steps(torch, step, ids, counters, steps)
    line = {"root": root, "shape": [b, s], "steps": steps, "step_ms": ms,
            "losses": losses,
            "launches": {k: n for k, n in launches.items() if n},
            "breakdown": cs.step_breakdown(torch, step, ids),
            "kind": torch.cuda.get_device_name(0)}
    print(json.dumps(line), flush=True)
    tmp.cleanup()


def main(argv):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--shape", default="1,16384",
                        help="B,S of the batch (default 1,16384)")
    parser.add_argument("--steps", type=int, default=3)
    parser.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    parser.add_argument("roots", nargs="+", metavar="ROOT")
    args = parser.parse_args(argv)
    b, s = (int(x) for x in args.shape.split(","))
    if args.one:
        one(args.roots[0], b, s, args.steps)
        return 0
    for root in args.roots:
        subprocess.run([sys.executable, os.path.abspath(__file__), "--one",
                        "--shape", args.shape, "--steps", str(args.steps),
                        root], check=True, timeout=900)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
