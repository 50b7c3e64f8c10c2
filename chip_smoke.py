#!/usr/bin/env python3
"""Smoke run of paddle_tpu_torch on one NVIDIA card.

    python3 chip_smoke.py

Phases, one JSON line each; any failure raises and exits non-zero:

1. build    — compile the CUDA kernels from ``paddle_tpu_torch/csrc``.
2. checks   — every kernel against its plain PyTorch version on the card
              (bf16, the serving shapes), with CUDA-event times of the
              kernel, the plain version and one PyTorch library call
              (``*_ms``, host launch cost included) and their device
              times from a profiler trace (``*_device_ms``).
3. serve    — GPT-2 345M (seeded random weights, AMP O2 bf16) through the
              slotted DecodeEngine (8 slots, max_len 1024) and the
              continuous-batching scheduler: 12 greedy requests of 128
              prompt tokens and 32 new tokens, once with the default
              flags and once with ``use_pallas_norm`` on.  Launch
              counters are reset just before each run and read after.
4. decode_profile — host and device time of a batched decode step.
5. parity   — one 128-token prompt: the card's last-position logits
              (kernel path, bf16) against the same weights on the CPU in
              f32 (plain path).
6. decode_parity — 8 slots of ragged prompts, a few batched decode steps
              on the card and on the CPU, logits held at every step, for
              each LayerNorm route.
7. serve_compare — where the two serve runs' greedy tokens part, the
              CPU's logit gap between the two tokens, held small.

Then the ``{"kernels": [...]}`` summary, the card's name and power limit,
and, last, the device line.  Without a card (or without the repository
beside this file) it exits non-zero and prints no result.
"""
from __future__ import annotations

import copy
import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, dense bf16 and f32
# (non-tensor-core) FLOP/s
HBM_BPS = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12

# bf16 flash out: kernel and plain version both round an f32 result to
# bf16, so an element may differ by one bf16 ulp of |ref| (<= 2^-7 |ref|);
# on top, 1/64 of the reference's RMS at that shape (about 8e-4 at S=1024
# non-causal, where |out| ~ 0.05), far below what a misweighted V
# accumulation would leave
FLASH_ULP_REL = 2.0 ** -7
FLASH_RMS_FRAC = 2.0 ** -6
LSE_TOL = 1e-3          # f32 lse
LN_TOL = 1e-2           # bf16 out: abs, plus one bf16 half-ulp of |ref|
LOGIT_TOL = 0.1         # card bf16 vs CPU f32 last-position logits


def emit(obj):
    print(json.dumps(obj), flush=True)


def time_ms(fn, torch, reps=7, inner=20):
    """Median over ``reps`` CUDA-event windows of ``inner`` calls each."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return statistics.median(times)


def device_ms(fn, torch, n=20):
    """Mean device time per call: the sum of the card's kernel durations
    over ``n`` calls in a ``torch.profiler`` trace, so host launch overhead
    is left out.  None when the trace holds no device time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    total_us = 0.0
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = getattr(e, "self_cuda_time_total", 0.0)
        total_us += float(t)
    return total_us / n / 1e3 if total_us > 0 else None


def bf16_err(got, ref, atol):
    """(max abs error, passes) with an abs tolerance plus one bf16
    half-ulp of the reference magnitude (2^-8 relative)."""
    d = (got.float() - ref.float()).abs()
    ok = bool((d <= atol + ref.float().abs() * 2.0 ** -8).all())
    return float(d.max()), ok


def check_flash(torch, fac):
    import torch.nn.functional as tF
    b, h, d = 1, 16, 64
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows, worst = [], 0.0
    for s in (128, 256, 512, 1024):
        for causal in (True, False):
            # q/k/v as slices of one fused projection, as the model has them
            qkv = torch.randn((b, s, 3 * h * d), generator=gen,
                              device="cuda").to(torch.bfloat16)
            q, k, v = (qkv[:, :, i * h * d:(i + 1) * h * d]
                       .reshape(b, s, h, d) for i in range(3))
            scale = 1.0 / math.sqrt(d)
            out, lse = fac.flash_attention_bshd_with_lse(q, k, v, causal)
            ref, ref_lse = fac._flash_reference(q, k, v, causal, scale)
            torch.cuda.synchronize()
            diff = (out.float() - ref.float()).abs()
            rms = float(ref.float().pow(2).mean().sqrt())
            err = float(diff.max())
            ok = bool((diff <= FLASH_ULP_REL * ref.float().abs()
                       + FLASH_RMS_FRAC * rms).all())
            lse_err = float((lse - ref_lse).abs().max())
            if not ok or lse_err > LSE_TOL:
                raise AssertionError("flash_fwd S=%d causal=%s: out err %g "
                                     "(ref rms %g) lse err %g"
                                     % (s, causal, err, rms, lse_err))
            worst = max(worst, err)
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            nbytes = 4 * b * s * h * d * 2
            pairs = s * (s + 1) / 2 if causal else s * s
            flops = 4 * b * h * d * pairs
            bound = max(nbytes / HBM_BPS, flops / BF16_FLOPS) * 1e3
            rows.append({
                "shape": [b, s, h, d], "causal": causal, "max_abs_err": err,
                "ref_rms": rms, "tol_abs_part": FLASH_RMS_FRAC * rms,
                "lse_max_abs_err": lse_err,
                "kernel_ms": time_ms(
                    lambda: fac.flash_attention_bshd(q, k, v, causal),
                    torch),
                "kernel_device_ms": device_ms(
                    lambda: fac.flash_attention_bshd(q, k, v, causal),
                    torch),
                "plain_device_ms": device_ms(
                    lambda: fac._flash_reference(q, k, v, causal, scale),
                    torch),
                "library_device_ms": device_ms(
                    lambda: tF.scaled_dot_product_attention(
                        qt, kt, vt, is_causal=causal), torch),
                "plain_ms": time_ms(
                    lambda: fac._flash_reference(q, k, v, causal, scale),
                    torch),
                "library_ms": time_ms(
                    lambda: tF.scaled_dot_product_attention(
                        qt, kt, vt, is_causal=causal), torch),
                "bound_ms": bound,
                "bound_by": ("bytes" if nbytes / HBM_BPS
                             >= flops / BF16_FLOPS else "operations")})
    return rows, worst


def check_layer_norm(torch, norm_cuda):
    import torch.nn.functional as tF
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows, worst = [], 0.0
    for r in (8, 128):
        f = 1024
        x = torch.randn((r, f), generator=gen, device="cuda").to(
            torch.bfloat16)
        g = 1 + 0.1 * torch.randn((f,), generator=gen, device="cuda")
        bta = 0.1 * torch.randn((f,), generator=gen, device="cuda")
        out, mean, rstd = norm_cuda.layer_norm_fwd(x, g, bta)
        r_out, r_mean, r_rstd = norm_cuda._layer_norm_reference(x, g, bta,
                                                                1e-5)
        torch.cuda.synchronize()
        err, ok = bf16_err(out, r_out, LN_TOL)
        stat_err = max(float((mean - r_mean).abs().max()),
                       float(((rstd - r_rstd) / r_rstd).abs().max()))
        if not ok or stat_err > 1e-4:
            raise AssertionError("layer_norm_fwd (%d, %d): out err %g, stat "
                                 "err %g" % (r, f, err, stat_err))
        worst = max(worst, err)
        nbytes = 2 * r * f * 2 + 2 * f * 4 + 2 * r * 4
        flops = 8 * r * f
        # F.layer_norm takes no f32 gamma/beta with bf16 x: the yardstick
        # gets bf16 copies, made outside the timed calls
        g16, b16 = g.to(torch.bfloat16), bta.to(torch.bfloat16)
        rows.append({
            "shape": [r, f], "max_abs_err": err, "stat_err": stat_err,
            "kernel_ms": time_ms(
                lambda: norm_cuda.layer_norm_fwd(x, g, bta), torch),
            "kernel_device_ms": device_ms(
                lambda: norm_cuda.layer_norm_fwd(x, g, bta), torch),
            "plain_device_ms": device_ms(
                lambda: norm_cuda._layer_norm_reference(x, g, bta, 1e-5),
                torch),
            "library_device_ms": device_ms(
                lambda: tF.layer_norm(x, (f,), g16, b16, 1e-5), torch),
            "plain_ms": time_ms(
                lambda: norm_cuda._layer_norm_reference(x, g, bta, 1e-5),
                torch),
            "library_ms": time_ms(
                lambda: tF.layer_norm(x, (f,), g16, b16, 1e-5), torch),
            "bound_ms": max(nbytes / HBM_BPS, flops / F32_FLOPS) * 1e3,
            "bound_by": ("bytes" if nbytes / HBM_BPS >= flops / F32_FLOPS
                         else "operations")})
    return rows, worst


def serve(torch, engine, prompts, use_norm_kernel, fac, norm_cuda, flags):
    from paddle_tpu_torch.serving import ContinuousBatchingScheduler, Request
    flags.set_flags({"use_pallas_norm": use_norm_kernel})
    engine.reset()
    engine.reseed(0)
    sched = ContinuousBatchingScheduler(engine)
    for p in prompts:
        sched.submit(Request(prompt=p, max_new_tokens=32, temperature=0.0))
    torch.cuda.synchronize()
    fac.flash_fwd_launches = 0
    norm_cuda.layer_norm_fwd_launches = 0
    t0 = time.perf_counter()
    results = sched.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"flash_fwd": fac.flash_fwd_launches,
                "layer_norm_fwd": norm_cuda.layer_norm_fwd_launches}
    flags.set_flags({"use_pallas_norm": False})
    toks = sum(len(r.tokens) for r in results.values())
    if len(results) != len(prompts) or any(
            len(r.tokens) != 32 or r.finish_reason != "length"
            for r in results.values()):
        raise AssertionError("serve: unexpected results %r" % (
            {k: (len(r.tokens), r.finish_reason)
             for k, r in results.items()},))
    layers = engine.model.config.num_hidden_layers
    admissions = len(prompts)
    if launches["flash_fwd"] != layers * admissions:
        raise AssertionError("flash_fwd launched %d times, want %d x %d"
                             % (launches["flash_fwd"], layers, admissions))
    forwards = admissions + sched.decode_steps_total
    want_ln = (2 * layers + 1) * forwards if use_norm_kernel else 0
    if launches["layer_norm_fwd"] != want_ln:
        raise AssertionError("layer_norm_fwd launched %d times, want %d"
                             % (launches["layer_norm_fwd"], want_ln))
    line = {
        "phase": "serve", "use_pallas_norm": use_norm_kernel,
        "requests": len(results), "generated_tokens": toks,
        "decode_steps": sched.decode_steps_total, "wall_s": wall,
        "tokens_per_s": toks / wall,
        "ttft_p50_ms": 1e3 * statistics.median(
            r.ttft for r in results.values()),
        "tpot_p50_ms": 1e3 * statistics.median(
            r.tpot for r in results.values()),
        "launches": launches}
    emit(line)
    return line, [results[k].tokens for k in sorted(results)]


def decode_parity(torch, engine, cpu_model, prompts, flags, norm_cuda,
                  steps=4):
    """Every slot prefilled with a prompt of its own length (128 down to
    100 tokens), then ``steps`` batched decode steps on the card (bf16,
    kernels) and on the CPU (f32, plain versions), both fed the CPU's
    greedy tokens; once per LayerNorm route.  Holds every slot's logits
    at every step within LOGIT_TOL."""
    from paddle_tpu_torch.serving import DecodeEngine
    n = engine.num_slots
    ctx = [prompts[i][:128 - 4 * i] for i in range(n)]
    greedy = ([0.0] * n, [0] * n, [1.0] * n)
    cpu_engine = DecodeEngine(cpu_model, num_slots=n, max_len=engine.max_len,
                              device="cpu")
    first, pre = np.zeros(n, np.int32), []
    for i, c in enumerate(ctx):
        first[i], lg = cpu_engine.prefill(i, c, temperature=0.0)
        pre.append(lg)
    cpu_logits, inputs, toks = [torch.stack(pre)], [], first
    for _ in range(steps):
        inputs.append(toks)
        toks, lg = cpu_engine.decode(toks, [True] * n, *greedy)
        cpu_logits.append(lg.float())
    del cpu_engine
    for use_norm in (False, True):
        flags.set_flags({"use_pallas_norm": use_norm})
        engine.reset()
        ln_before = norm_cuda.layer_norm_fwd_launches
        card = [torch.stack([engine.prefill(i, c, temperature=0.0)[1]
                             for i, c in enumerate(ctx)])]
        for t in inputs:
            card.append(engine.decode(t, [True] * n, *greedy)[1])
        errs = [float((c.float().cpu() - r).abs().max())
                for c, r in zip(card, cpu_logits)]
        ln_launched = norm_cuda.layer_norm_fwd_launches - ln_before
        flags.set_flags({"use_pallas_norm": False})
        emit({"phase": "decode_parity", "use_pallas_norm": use_norm,
              "prompt_lens": [len(c) for c in ctx], "decode_steps": steps,
              "max_abs_err_prefill": errs[0],
              "max_abs_err_per_step": errs[1:], "tolerance": LOGIT_TOL,
              "layer_norm_fwd_launches": ln_launched})
        if max(errs) > LOGIT_TOL:
            raise AssertionError("decode parity (use_pallas_norm=%s): card "
                                 "vs CPU logits err %g > %g"
                                 % (use_norm, max(errs), LOGIT_TOL))
        if bool(ln_launched) != use_norm:
            raise AssertionError("decode parity: layer_norm_fwd launched %d "
                                 "times with use_pallas_norm=%s"
                                 % (ln_launched, use_norm))


def serve_compare(torch, cpu_model, prompts, toks_a, toks_b):
    """Where the greedy tokens of the two LayerNorm routes part: for each
    request that parts, the first step, the two tokens, and the gap
    between them in the CPU's f32 logits at that step.  Both card routes
    hold within LOGIT_TOL of the CPU (decode_parity), so rounding can part
    them only where that gap is below 2 * LOGIT_TOL; a wider gap fails."""
    parts = []
    for i, (a, b) in enumerate(zip(toks_a, toks_b)):
        diff = np.flatnonzero(np.asarray(a) != np.asarray(b))
        if diff.size == 0:
            continue
        j = int(diff[0])
        ctx = np.concatenate([prompts[i], np.asarray(a[:j], np.int32)])
        with torch.no_grad():
            lg = cpu_model(torch.as_tensor(ctx[None]))[0, -1]
        top2 = torch.topk(lg, 2).values
        parts.append({"request": i, "step": j,
                      "tokens": [int(a[j]), int(b[j])],
                      "cpu_gap": abs(float(lg[int(a[j])] - lg[int(b[j])])),
                      "cpu_top2_margin": float(top2[0] - top2[1])})
    emit({"phase": "serve_compare", "same_greedy_tokens": not parts,
          "parted": parts, "gap_limit": 2 * LOGIT_TOL})
    wide = [p for p in parts if p["cpu_gap"] >= 2 * LOGIT_TOL]
    if wide:
        raise AssertionError("the LayerNorm routes part where the CPU's gap "
                             "is wide: %r" % (wide,))


def decode_profile(torch, engine, use_norm_kernel, flags, steps=5):
    """Wall time of a batched decode step (all 8 slots active, host clock
    around a synchronised step) beside the card's kernel time in it
    (profiler trace): the device's busy share of a step."""
    from torch.profiler import ProfilerActivity, profile
    flags.set_flags({"use_pallas_norm": use_norm_kernel})
    args = (np.zeros(engine.num_slots, np.int32), [True] * engine.num_slots,
            [0.0] * engine.num_slots, [0] * engine.num_slots,
            [1.0] * engine.num_slots)
    engine.decode(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        engine.decode(*args)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            engine.decode(*args)
        torch.cuda.synchronize()
    events = prof.key_averages()
    dev_us = sum(float(getattr(e, "self_device_time_total", 0.0))
                 for e in events)
    kernels = sum(int(e.count) for e in events
                  if float(getattr(e, "self_device_time_total", 0.0)) > 0)
    flags.set_flags({"use_pallas_norm": False})
    line = {"phase": "decode_profile", "use_pallas_norm": use_norm_kernel,
            "step_wall_ms": wall_ms,
            "step_device_ms": dev_us / steps / 1e3 if dev_us else None,
            "device_kernels_per_step": kernels / steps,
            "device_busy_share": (dev_us / steps / 1e3 / wall_ms
                                  if dev_us else None)}
    emit(line)
    return line


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels import flash_attention_cuda as fac
    from paddle_tpu_torch.kernels import norm_cuda
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.serving import DecodeEngine
    from paddle_tpu_torch.utils import flags

    # f32 products on the card stay f32, so f32 comparisons mean what
    # they say
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)

    t0 = time.perf_counter()
    lib_path, log = _build.build(ptxas_info="--ptxas" in sys.argv)
    _build.library()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "library": str(lib_path.name)})
    if log and "--ptxas" in sys.argv:
        print(log, file=sys.stderr)

    flash_rows, flash_err = check_flash(torch, fac)
    ln_rows, ln_err = check_layer_norm(torch, norm_cuda)
    emit({"phase": "checks", "flash_fwd": flash_rows,
          "layer_norm_fwd": ln_rows})

    # -- serve: GPT-2 345M, seeded weights, AMP O2 bf16 -------------------
    t0 = time.perf_counter()
    cfg = GPTConfig.gpt2_medium()
    cpu_model = GPTForCausalLM(cfg, generator=torch.Generator().manual_seed(0))
    cpu_model.eval()
    model = amp.decorate(copy.deepcopy(cpu_model), level="O2",
                         dtype="bfloat16")
    engine = DecodeEngine(model, num_slots=8, max_len=1024, seed=0)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 50257, (128,)).astype(np.int32)
               for _ in range(12)]
    # warm-up (library handles, allocator) outside the counted runs
    engine.prefill(0, prompts[0], temperature=0.0)
    engine.decode(np.zeros(8, np.int32), [True] * 8, [0.0] * 8, [0] * 8,
                  [1.0] * 8)
    torch.cuda.synchronize()
    emit({"phase": "setup", "seconds": time.perf_counter() - t0,
          "params": sum(p.numel() for p in model.parameters())})
    run_default, toks_default = serve(torch, engine, prompts, False, fac,
                                      norm_cuda, flags)
    run_norm, toks_norm = serve(torch, engine, prompts, True, fac,
                                norm_cuda, flags)
    for t in toks_default + toks_norm:
        if not (0 <= int(t.min()) and int(t.max()) < cfg.vocab_size):
            raise AssertionError("token ids out of range")
    for use_norm in (False, True):
        decode_profile(torch, engine, use_norm, flags)

    # -- parity: card (kernels, bf16) vs CPU (plain, f32) -----------------
    flags.set_flags({"use_pallas_norm": True})
    engine.reset()
    before = (fac.flash_fwd_launches, norm_cuda.layer_norm_fwd_launches)
    _tok, card_logits = engine.prefill(0, prompts[0], temperature=0.0)
    card_logits = card_logits.float().cpu()
    if (fac.flash_fwd_launches == before[0]
            or norm_cuda.layer_norm_fwd_launches == before[1]):
        raise AssertionError("parity prefill did not run both kernels")
    flags.set_flags({"use_pallas_norm": False})
    with torch.no_grad():
        cpu_logits = cpu_model(torch.as_tensor(prompts[0][None]))[0, -1]
    if not bool(torch.isfinite(card_logits).all()):
        raise AssertionError("card logits are not finite")
    err = float((card_logits - cpu_logits).abs().max())
    top2 = torch.topk(cpu_logits, 2).values
    margin = float(top2[0] - top2[1])
    same = int(card_logits.argmax()) == int(cpu_logits.argmax())
    emit({"phase": "parity", "max_abs_err": err, "tolerance": LOGIT_TOL,
          "logit_std": float(cpu_logits.std()), "same_greedy_token": same,
          "cpu_top2_margin": margin})
    if err > LOGIT_TOL or not (same or margin < LOGIT_TOL):
        raise AssertionError("card vs CPU logits disagree: err %g, same "
                             "token %s, margin %g" % (err, same, margin))
    decode_parity(torch, engine, cpu_model, prompts, flags, norm_cuda)
    serve_compare(torch, cpu_model, prompts, toks_default, toks_norm)

    prefill_row = flash_rows[0]            # (1, 128, 16, 64) causal
    decode_row = ln_rows[0]                # (8, 1024)
    emit({"kernels": [
        {"name": "flash_fwd", "route": "cuda",
         "source": "paddle_tpu_torch/csrc/flash_fwd.cu",
         "replaces": "paddle_tpu/kernels/flash_attention_pallas.py:382",
         "launches": run_default["launches"]["flash_fwd"],
         "max_abs_err": flash_err, "ms": prefill_row["kernel_ms"],
         "device_ms": prefill_row["kernel_device_ms"],
         "plain_ms": prefill_row["plain_ms"],
         "bound_ms": prefill_row["bound_ms"],
         "bound_by": prefill_row["bound_by"],
         "library_ms": prefill_row["library_ms"]},
        {"name": "layer_norm_fwd", "route": "cuda",
         "source": "paddle_tpu_torch/csrc/layer_norm_fwd.cu",
         "replaces": "paddle_tpu/kernels/norm_pallas.py:118",
         "launches": run_norm["launches"]["layer_norm_fwd"],
         "max_abs_err": ln_err, "ms": decode_row["kernel_ms"],
         "device_ms": decode_row["kernel_device_ms"],
         "plain_ms": decode_row["plain_ms"],
         "bound_ms": decode_row["bound_ms"],
         "bound_by": decode_row["bound_by"],
         "library_ms": decode_row["library_ms"]}]})
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
