"""What outlives a dropped captured step, and whether later replays
survive it.

Runs the sequence that once crashed ``chip_smoke.py``: capture the
slotted engine's step (A) and the paged one's (P), capture a tight-pool
engine's (T), drop T, capture a speculative engine's (C), then replay A
and C eagerly-compared and inside a ``torch.profiler`` trace.  Each
variant runs in a process of its own, so that a crash ends only that
variant:

* ``--pool private``: every capture on a private pool of its own (a new
  ``graph_pool_handle()``), as ``torch.cuda.graph`` does by default;
  ``shared``: the engine's own process-wide pool (``serving/graphs.py``);
* ``--clear-cublas``: drop cuBLAS's cached workspaces before each
  capture, so that none lives in a graph's pool;
* ``--traffic``: every capture under ``use_pallas_norm`` (the LayerNorm
  kernel B inside the graphs), and T serves twelve 128-token requests
  through the overlapped scheduler (it preempts) before it is dropped.

After T is dropped the variant prints what is still allocated in T's
pool (size and the Python stack that allocated it, from the allocator's
history).  Needs one NVIDIA card:

    python3 tools/torch_graph_pool_probe.py            # every variant
    python3 tools/torch_graph_pool_probe.py --pool private --size 345m
"""
import argparse
import copy
import faulthandler
import gc
import json
import os
import subprocess
import sys
import weakref

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

# (pool, size, clear cuBLAS workspaces, traffic)
VARIANTS = [("private", "small", False, False),
            ("private", "345m", False, False),
            ("private", "345m", True, False),
            ("shared", "345m", False, False),
            ("private", "345m", False, True),
            ("private", "345m", True, True),
            ("shared", "345m", False, True),
            ("shared", "345m", True, True)]


def emit(**kw):
    print(json.dumps(kw), flush=True)


def build(torch, size):
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM
    if size == "345m":
        cfg = GPTConfig.gpt2_medium()
    else:
        cfg = GPTConfig(vocab_size=512, max_position_embeddings=1024,
                        hidden_size=128, num_hidden_layers=2,
                        num_attention_heads=2, intermediate_size=256,
                        hidden_dropout_prob=0.0, attention_dropout_prob=0.0)
    cpu = GPTForCausalLM(cfg, generator=torch.Generator().manual_seed(0))
    return amp.decorate(copy.deepcopy(cpu.eval()), level="O2",
                        dtype="bfloat16")


def idle(engine, profiled=False):
    """One step over inactive lanes (commits nothing); its logits."""
    import torch
    n = engine.num_slots
    off = ([False] * n, [0.0] * n, [0] * n, [1.0] * n)
    if profiled:
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]):
            out = idle(engine)
            torch.cuda.synchronize()
        return out
    if engine.spec_k:
        return engine.decode_spec(np.zeros(n, np.int32),
                                  np.zeros((n, engine.spec_k), np.int32),
                                  *off)[2]
    return engine.decode(np.zeros(n, np.int32), *off)[1]


def replay_vs_eager(engine):
    """Max |captured - eager| of an idle step's logits."""
    got = idle(engine).float()
    engine._capture = False
    try:
        ref = idle(engine).float()
    finally:
        engine._capture = True
    return float((got - ref).abs().max())


def serve(engine, vocab, n=12):
    """Twelve greedy requests of 128 tokens (64 shared), 32 new each,
    through the overlapped scheduler."""
    from paddle_tpu_torch.serving import ContinuousBatchingScheduler, Request
    rng = np.random.default_rng(1)
    shared = rng.integers(0, vocab, (64,))
    sched = ContinuousBatchingScheduler(engine)
    for _ in range(n):
        prompt = np.concatenate([shared, rng.integers(0, vocab, (64,))])
        sched.submit(Request(prompt=prompt.astype(np.int32),
                             max_new_tokens=32, temperature=0.0))
    sched.run()
    return sched.preemptions_total


def run(pool, size, clear_cublas, traffic):
    faulthandler.enable(all_threads=True)
    import torch
    from paddle_tpu_torch.serving import DecodeEngine, graphs
    handles = []
    if pool == "private":
        def private():
            handles.append(torch.cuda.graph_pool_handle())
            return handles[-1]
        graphs._shared_pool = private
    if clear_cublas:
        capture = graphs.capture

        def cleared(fn):
            torch._C._cuda_clearCublasWorkspaces()
            return capture(fn)
        import paddle_tpu_torch.serving.engine as eng_mod
        eng_mod.capture = cleared
    torch.backends.cuda.matmul.allow_tf32 = False
    if traffic:
        from paddle_tpu_torch.utils import flags
        flags.set_flags({"use_pallas_norm": True})
    model = build(torch, size)
    kw = dict(num_slots=8, max_len=1024, seed=0)
    idle_profiled = {}
    a = DecodeEngine(model, paged=False, **kw)
    p = DecodeEngine(model, **kw)
    for name, e in (("A", a), ("P", p)):
        e.capture_steps()
        idle(e, profiled=True)
        idle_profiled[name] = True
    torch.cuda.memory._record_memory_history(max_entries=200000)
    t = DecodeEngine(model, num_pages=17, **kw)
    t.capture_steps()
    idle(t, profiled=True)
    if traffic:
        emit(step="T served", preemptions=serve(
            t, model.config.vocab_size))
    t_pool = handles[-1] if handles else None
    t_graph = weakref.ref(next(iter(t._graphs.values())).graph)
    del t
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    live = []
    for seg in torch.cuda.memory._snapshot()["segments"]:
        if t_pool is None or tuple(seg["segment_pool_id"]) != tuple(t_pool):
            continue
        for blk in seg["blocks"]:
            if blk["state"] != "inactive":
                frames = [f["filename"].rsplit("/", 1)[-1] + ":%d %s" % (
                    f["line"], f["name"]) for f in blk.get("frames", [])
                    if f["filename"].endswith(".py")][:8]
                live.append({"size": blk["size"], "state": blk["state"],
                             "frames": frames})
    torch.cuda.memory._record_memory_history(enabled=None)
    emit(step="dropped T", graph_freed=t_graph() is None,
         t_pool=list(t_pool) if t_pool else None,
         t_pool_segments_left=sum(
             1 for s in torch.cuda.memory._snapshot()["segments"]
             if t_pool is not None
             and tuple(s["segment_pool_id"]) == tuple(t_pool)),
         live_blocks_in_t_pool=live)
    c = DecodeEngine(model, spec_k=4, **kw)
    c.capture_steps()
    emit(step="captured C", A_vs_eager=replay_vs_eager(a),
         C_vs_eager=replay_vs_eager(c))
    for name, e in (("C", c), ("A", a), ("P", p)):
        idle(e, profiled=True)
        emit(step="profiled replay of %s" % name, ok=True)
    emit(step="end", ok=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--pool", choices=("private", "shared"))
    ap.add_argument("--size", choices=("small", "345m"), default="345m")
    ap.add_argument("--clear-cublas", action="store_true")
    ap.add_argument("--traffic", action="store_true")
    args = ap.parse_args()
    if args.pool:
        run(args.pool, args.size, args.clear_cublas, args.traffic)
        return 0
    for pool, size, clear, traffic in VARIANTS:
        cmd = [sys.executable, os.path.abspath(__file__), "--pool", pool,
               "--size", size] + (["--clear-cublas"] if clear else []) + (
                   ["--traffic"] if traffic else [])
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=600)
        emit(variant={"pool": pool, "size": size, "clear_cublas": clear,
                      "traffic": traffic}, rc=proc.returncode)
        print(proc.stdout, end="")
        if proc.returncode:
            print(proc.stderr[-3000:], end="")
    return 0


if __name__ == "__main__":
    sys.exit(main())
