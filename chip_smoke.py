#!/usr/bin/env python3
"""Smoke run of paddle_tpu_torch on one NVIDIA card.

    python3 chip_smoke.py

Phases, one JSON line each; any failure raises and exits non-zero:

1. build    — compile the CUDA kernels from ``paddle_tpu_torch/csrc``.
2. checks   — every kernel against its plain PyTorch version on the card
              (bf16, the serving and training shapes), with CUDA-event
              times of the kernel, the plain version and one PyTorch
              library call (``*_ms``, host launch cost included) and
              their device times from a profiler trace (``*_device_ms``).
              ``checks_bwd``: the flash backward kernels C1 (merged), C2
              and C3 (split) with each route pinned, one case with an lse
              cotangent, and the LayerNorm backward D.  ``checks_long``:
              at S=16384 kernel A and C2/C3 against their plain versions
              (2 heads), and split against merged at 16 heads.
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
8. train    — bench.py's training step through ``jit.TrainStep``: GPT-2
              345M (the serve run's weights, dropout 0), AMP O2 bf16,
              AdamW, the label-shift criterion, one seeded (8, 1024)
              batch; 3 warm-up and 10 timed steps, the stream time of
              each part of a step and a profile of 2 steps.  Flash
              forward and C1 launch 24 times a step.
9. train_norm — 3 steps with ``use_pallas_norm`` on from the same
              weights: kernels B and D launch 49 times a step; the first
              loss held against the default route's.
10. train_parity — one step at (1, 256) on the card (bf16, kernels, each
              LayerNorm route) and on the CPU (f32, plain): the loss and
              every parameter's gradient held.
11. train_long — GPT-2 345M at (1, 16384), 2 steps: flash forward, C2
              and C3 launch 24 times a step, C1 never.

Launch counters are set to 0 just before each run of a path and read
just after.  Then the seconds of each part, the ``{"kernels": [...]}``
summary, the card's name and power limit, and, last, the device line.
Without a card (or without the repository beside this file) it exits
non-zero and prints no result.
"""
from __future__ import annotations

import copy
import dataclasses
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
# bf16 flash dq/dk/dv: the kernels and the plain version both round an f32
# result to bf16 (one ulp of |ref|, 2^-7), and sum in other orders (C1's
# dQ by atomics); on top, 1/64 of the reference's RMS at that shape
FLASH_BWD_ULP_REL = 2.0 ** -7
FLASH_BWD_RMS_FRAC = 2.0 ** -6
# LayerNorm backward: bf16 dx as the flash grads; f32 dgamma / dbeta are
# sums over all rows in another order (1e-5 relative plus 1e-4 of RMS)
LN_BWD_F32_REL = 1e-5
LN_BWD_F32_RMS_FRAC = 1e-4
# train: the first loss of seeded 0.02-std weights is near ln(vocab)
FIRST_LOSS_TOL = 0.5
# train_norm vs train first loss, same weights: both bf16 forwards, the
# kernel's one-pass variance vs the default two-pass one
NORM_ROUTE_LOSS_TOL = 0.01
# train_parity: card (bf16, kernels) vs CPU (f32, plain) at (1, 256).
# Measured on an H100: loss within 2.4e-4, every parameter's gradient
# within 0.019 relative L2 (median 0.014), both LayerNorm routes; the
# limits leave 1.5x room over that bf16 rounding
PARITY_LOSS_TOL = 0.02
PARITY_GRAD_REL_TOL = 0.03


def emit(obj):
    print(json.dumps(obj), flush=True)


def within(got, ref, ulp, frac):
    """(max abs error, ref RMS, passes): every element within ``ulp`` x
    |ref| plus ``frac`` x the reference's RMS."""
    ref = ref.float()
    d = (got.float() - ref).abs()
    rms = float(ref.pow(2).mean().sqrt())
    return float(d.max()), rms, bool((d <= ulp * ref.abs() + frac * rms)
                                     .all())


def bound(nbytes, flops, peak_flops):
    """(bound ms, what bounds it) from the bytes a function must move and
    the operations it must do."""
    t_bytes, t_ops = nbytes / HBM_BPS, flops / peak_flops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


class Counters:
    """The kernel wrappers' launch counts, by kernel name."""

    def __init__(self, fac, norm_cuda):
        self.spec = {
            "flash_fwd": (fac, "flash_fwd_launches"),
            "flash_bwd": (fac, "flash_bwd_launches"),
            "flash_bwd_dq": (fac, "flash_bwd_dq_launches"),
            "flash_bwd_dkv": (fac, "flash_bwd_dkv_launches"),
            "layer_norm_fwd": (norm_cuda, "layer_norm_fwd_launches"),
            "layer_norm_bwd": (norm_cuda, "layer_norm_bwd_launches")}

    def reset(self):
        for mod, attr in self.spec.values():
            setattr(mod, attr, 0)

    def read(self):
        return {k: getattr(mod, attr) for k, (mod, attr) in
                self.spec.items()}


def device_times(fn, torch, n=20):
    """{kernel name: (device ms summed over the trace, launches)} over
    ``n`` calls in a ``torch.profiler`` trace."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        t = float(getattr(e, "self_device_time_total", 0.0) or 0.0)
        if t > 0:
            ms, count = out.get(e.key, (0.0, 0))
            out[e.key] = (ms + t / 1e3, count + int(e.count))
    return out


def kernel_ms(times, pattern):
    """Mean device ms per launch of the kernels whose name holds
    ``pattern`` (each launched once per call): a launch missing from the
    trace does not halve it."""
    hit = [v for name, v in times.items() if pattern in name]
    if not hit:
        return None
    return sum(t for t, _ in hit) / sum(c for _, c in hit)


def call_ms(times, n):
    """Device ms per call of all the kernels of ``n`` traced calls."""
    return sum(t for t, _ in times.values()) / n or None


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
    return call_ms(device_times(fn, torch, n), n)


def bf16_err(got, ref, atol):
    """(max abs error, passes) with an abs tolerance plus one bf16
    half-ulp of the reference magnitude (2^-8 relative)."""
    d = (got.float() - ref.float()).abs()
    ok = bool((d <= atol + ref.float().abs() * 2.0 ** -8).all())
    return float(d.max()), ok


def check_flash(torch, fac):
    import torch.nn.functional as tF
    h, d = 16, 64
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows, worst = [], 0.0
    # the serving prefill shapes at B=1, then the training shape
    cases = [(1, s, c) for s in (128, 256, 512, 1024) for c in (True, False)]
    for b, s, causal in cases + [(8, 1024, True)]:
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
        bound_ms, bound_by = bound(nbytes, flops, BF16_FLOPS)
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
            "bound_ms": bound_ms, "bound_by": bound_by})
    return rows, worst


def check_layer_norm(torch, norm_cuda):
    import torch.nn.functional as tF
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows, worst = [], 0.0
    for r in (8, 128, 8192):    # decode, prefill, training (8 x 1024)
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


def flash_case(torch, fac, b, s, h, d, causal, gen):
    """bf16 q/k/v (slices of one fused projection), a cotangent, and
    kernel A's (out, lse) on them."""
    qkv = torch.randn((b, s, 3 * h * d), generator=gen,
                      device="cuda").to(torch.bfloat16)
    q, k, v = (qkv[:, :, i * h * d:(i + 1) * h * d].reshape(b, s, h, d)
               for i in range(3))
    do = torch.randn((b, s, h, d), generator=gen,
                     device="cuda").to(torch.bfloat16)
    out, lse = fac.flash_attention_bshd_with_lse(q, k, v, causal)
    return q, k, v, do, out, lse


def bwd_bound(b, s, h, d, causal, products, n_tensors):
    """Bound of a backward kernel: ``products`` (S x S x D) products and
    ``n_tensors`` bf16 (B, S, H, D) tensors read or written (q, k, v, dO
    in; dq and/or dk, dv out), plus the f32 lse and delta rows."""
    pairs = s * (s + 1) / 2 if causal else s * s
    flops = products * 2 * b * h * d * pairs
    nbytes = n_tensors * b * s * h * d * 2 + 2 * b * s * h * 4
    return bound(nbytes, flops, BF16_FLOPS)


def time_bwd(torch, fac, tF, q, k, v, do, out, lse, causal, reps, inner,
             plain=True):
    """Times of C1 (through the wrapper), C2 and C3 (each launched alone),
    the plain backward and the library's (SDPA's backward through
    autograd), CUDA-event and device."""
    scale = q.shape[-1] ** -0.5
    delta = (do.float() * out.float()).sum(-1)
    args = (q, k, v, do, lse, delta, causal, scale)
    runs = {
        "flash_bwd": lambda: fac.flash_attention_bwd(
            q, k, v, out, lse, do, causal, scale, route="merged"),
        "flash_bwd_dq": lambda: fac._launch_bwd_dq(*args),
        "flash_bwd_dkv": lambda: fac._launch_bwd_dkv(*args)}
    patterns = {"flash_bwd": "flash_bwd_kv_kernel",
                "flash_bwd_dq": "flash_bwd_dq_kernel",
                "flash_bwd_dkv": "flash_bwd_kv_kernel"}
    if plain:
        runs["plain"] = lambda: fac._flash_bwd_reference(
            q, k, v, out, lse, do, causal, scale)
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    lib_out = tF.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
    dot = do.transpose(1, 2)
    runs["library"] = lambda: torch.autograd.grad(
        lib_out, (qt, kt, vt), dot, retain_graph=True)
    res = {}
    for name, fn in runs.items():
        res[name + "_ms"] = time_ms(fn, torch, reps=reps, inner=inner)
        times = device_times(fn, torch, n=inner)
        res[name + "_device_ms"] = (kernel_ms(times, patterns[name])
                                    if name in patterns
                                    else call_ms(times, inner))
    return res


def check_flash_bwd(torch, fac):
    """C1, C2 and C3 against the plain backward, bf16, B=1 H=16 D=64 at
    S = 128, 1024, 2048, causal or not, each route pinned; then the
    training shape (8, 1024, 16, 64) causal; then one with-lse case."""
    import torch.nn.functional as tF
    gen = torch.Generator(device="cuda").manual_seed(2)
    rows = []
    worst = {"flash_bwd": 0.0, "flash_bwd_dq": 0.0, "flash_bwd_dkv": 0.0}
    cases = [(1, s, 16, 64, c) for s in (128, 1024, 2048)
             for c in (True, False)] + [(8, 1024, 16, 64, True)]
    for b, s, h, d, causal in cases:
        q, k, v, do, out, lse = flash_case(torch, fac, b, s, h, d, causal,
                                           gen)
        scale = d ** -0.5
        ref = fac._flash_bwd_reference(q, k, v, out, lse, do, causal, scale)
        row = {"shape": [b, s, h, d], "causal": causal}
        for route, kernels in (("merged", ("flash_bwd",) * 3),
                               ("split", ("flash_bwd_dq", "flash_bwd_dkv",
                                          "flash_bwd_dkv"))):
            got = fac.flash_attention_bwd(q, k, v, out, lse, do, causal,
                                          scale, route=route)
            torch.cuda.synchronize()
            for name, g, r, kern in zip(("dq", "dk", "dv"), got, ref,
                                        kernels):
                err, rms, ok = within(g, r, FLASH_BWD_ULP_REL,
                                      FLASH_BWD_RMS_FRAC)
                row["%s_%s_err" % (route, name)] = err
                row["%s_rms" % name] = rms
                if not ok:
                    raise AssertionError(
                        "%s %s %s causal=%s: err %g (ref rms %g)"
                        % (kern, name, (b, s, h, d), causal, err, rms))
                worst[kern] = max(worst[kern], err)
        row.update(time_bwd(torch, fac, tF, q, k, v, do, out, lse, causal,
                            reps=5, inner=10))
        for kern, products, tensors in (("flash_bwd", 5, 7),
                                        ("flash_bwd_dq", 3, 5),
                                        ("flash_bwd_dkv", 4, 6)):
            row[kern + "_bound_ms"], row[kern + "_bound_by"] = bwd_bound(
                b, s, h, d, causal, products, tensors)
        rows.append(row)
    # with lse: a nonzero lse cotangent folds in as delta - dlse
    q, k, v, do, out, lse = flash_case(torch, fac, 1, 256, 16, 64, True,
                                       gen)
    dlse = torch.randn(lse.shape, generator=gen, device="cuda")
    ref = fac._flash_bwd_reference(q, k, v, out, lse, do, True, 0.125,
                                   dlse=dlse)
    lse_row = {"shape": [1, 256, 16, 64], "causal": True, "with_lse": True}
    for route in ("merged", "split"):
        got = fac.flash_attention_bwd(q, k, v, out, lse, do, True, 0.125,
                                      dlse=dlse, route=route)
        errs = [within(g, r, FLASH_BWD_ULP_REL, FLASH_BWD_RMS_FRAC)
                for g, r in zip(got, ref)]
        lse_row[route + "_err"] = max(e[0] for e in errs)
        if not all(e[2] for e in errs):
            raise AssertionError("flash backward with lse (%s): err %g"
                                 % (route, lse_row[route + "_err"]))
    rows.append(lse_row)
    return rows, worst


def check_flash_long(torch, fac):
    """S = 16384: kernel A (the TPU's streamed-forward regime) and C2/C3
    against their plain versions at H=2, where each (S, S) f32 array of
    the plain versions is 2.1 GB; then, at the train_long shape
    (1, 16384, 16, 64), split (C2 + C3) against merged (C1) on the card,
    with the times of kernel A, C1, C2, C3 and the library calls."""
    import torch.nn.functional as tF
    gen = torch.Generator(device="cuda").manual_seed(3)
    s, d, scale = 16384, 64, 0.125
    out_row = {"shape": [1, s, 2, d], "causal": True}
    q, k, v, do, out, lse = flash_case(torch, fac, 1, s, 2, d, True, gen)
    ref, ref_lse = fac._flash_reference(q, k, v, True, scale)
    err, rms, ok = within(out, ref, FLASH_ULP_REL, FLASH_RMS_FRAC)
    lse_err = float((lse - ref_lse).abs().max())
    del ref, ref_lse
    if not ok or lse_err > LSE_TOL:
        raise AssertionError("flash_fwd at S=16384: out err %g (rms %g), "
                             "lse err %g" % (err, rms, lse_err))
    out_row.update(flash_fwd_err=err, flash_fwd_lse_err=lse_err)
    ref = fac._flash_bwd_reference(q, k, v, out, lse, do, True, scale)
    got = fac.flash_attention_bwd(q, k, v, out, lse, do, True, scale,
                                  route="split")
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        e, rms, ok = within(g, r, FLASH_BWD_ULP_REL, FLASH_BWD_RMS_FRAC)
        out_row["split_%s_err" % name] = e
        if not ok:
            raise AssertionError("split backward at S=16384 (%s): err %g "
                                 "(rms %g)" % (name, e, rms))
    del ref, got
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    fwd = {"flash_fwd": lambda: fac.flash_attention_bshd(q, k, v, True),
           "plain": lambda: fac._flash_reference(q, k, v, True, scale),
           "library": lambda: tF.scaled_dot_product_attention(
               qt, kt, vt, is_causal=True)}
    for name, fn in fwd.items():
        out_row["fwd_%s_ms" % name] = time_ms(fn, torch, reps=3, inner=2)
        times = device_times(fn, torch, n=2)
        out_row["fwd_%s_device_ms" % name] = (
            kernel_ms(times, "flash_fwd_kernel") if name == "flash_fwd"
            else call_ms(times, 2))
    out_row.update(time_bwd(torch, fac, tF, q, k, v, do, out, lse, True,
                            reps=3, inner=2))
    out_row["fwd_bound_ms"], out_row["fwd_bound_by"] = bound(
        4 * s * 2 * d * 2, 4 * 2 * d * s * (s + 1) / 2, BF16_FLOPS)
    del q, k, v, do, out, lse, qt, kt, vt
    torch.cuda.empty_cache()

    h = 16
    long_row = {"shape": [1, s, h, d], "causal": True}
    q, k, v, do, out, lse = flash_case(torch, fac, 1, s, h, d, True, gen)
    merged = fac.flash_attention_bwd(q, k, v, out, lse, do, True, scale,
                                     route="merged")
    split = fac.flash_attention_bwd(q, k, v, out, lse, do, True, scale,
                                    route="split")
    for name, a, r in zip(("dq", "dk", "dv"), split, merged):
        e, rms, ok = within(a, r, FLASH_BWD_ULP_REL, FLASH_BWD_RMS_FRAC)
        long_row["split_vs_merged_%s_err" % name] = e
        if not ok:
            raise AssertionError("split vs merged at (1, 16384, 16, 64) "
                                 "(%s): err %g (rms %g)" % (name, e, rms))
    del merged, split
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    for name, fn in (("flash_fwd",
                      lambda: fac.flash_attention_bshd(q, k, v, True)),
                     ("library", lambda: tF.scaled_dot_product_attention(
                         qt, kt, vt, is_causal=True))):
        long_row["fwd_%s_ms" % name] = time_ms(fn, torch, reps=3, inner=2)
        times = device_times(fn, torch, n=2)
        long_row["fwd_%s_device_ms" % name] = (
            kernel_ms(times, "flash_fwd_kernel") if name == "flash_fwd"
            else call_ms(times, 2))
    long_row.update(time_bwd(torch, fac, tF, q, k, v, do, out, lse, True,
                             reps=3, inner=2, plain=False))
    long_row["fwd_bound_ms"], long_row["fwd_bound_by"] = bound(
        4 * s * h * d * 2, 4 * h * d * s * (s + 1) / 2, BF16_FLOPS)
    for kern, products, tensors in (("flash_bwd", 5, 7),
                                    ("flash_bwd_dq", 3, 5),
                                    ("flash_bwd_dkv", 4, 6)):
        long_row[kern + "_bound_ms"], long_row[kern + "_bound_by"] = \
            bwd_bound(1, s, h, d, True, products, tensors)
    # the split pair's bound counts the five products the backward needs;
    # C2 and C3 recompute QK^T and dP, so the pair does seven
    long_row["split_pair_bound_ms"], _ = bwd_bound(1, s, h, d, True, 5, 7)
    del q, k, v, do, out, lse, qt, kt, vt
    torch.cuda.empty_cache()
    return out_row, long_row


def check_layer_norm_bwd(torch, norm_cuda):
    """Kernel D against the plain backward at (8192, 1024), the training
    shape, and (128, 1024): bf16 x / dO, f32 gamma."""
    import torch.nn.functional as tF
    gen = torch.Generator(device="cuda").manual_seed(4)
    rows, worst = [], 0.0
    for r in (8192, 128):
        f = 1024
        x, do = (torch.randn((r, f), generator=gen, device="cuda")
                 .to(torch.bfloat16) for _ in range(2))
        g = 1 + 0.1 * torch.randn((f,), generator=gen, device="cuda")
        bta = 0.1 * torch.randn((f,), generator=gen, device="cuda")
        _o, mean, rstd = norm_cuda.layer_norm_fwd(x, g, bta)
        got = norm_cuda.layer_norm_bwd(x, g, mean, rstd, do)
        ref = norm_cuda._layer_norm_bwd_reference(x, g, mean, rstd, do)
        torch.cuda.synchronize()
        row = {"shape": [r, f]}
        for name, a, w, tol in (
                ("dx", got[0], ref[0], (FLASH_BWD_ULP_REL,
                                        FLASH_BWD_RMS_FRAC)),
                ("dgamma", got[1], ref[1], (LN_BWD_F32_REL,
                                            LN_BWD_F32_RMS_FRAC)),
                ("dbeta", got[2], ref[2], (LN_BWD_F32_REL,
                                           LN_BWD_F32_RMS_FRAC))):
            err, rms, ok = within(a, w, *tol)
            row[name + "_err"] = err
            if not ok:
                raise AssertionError("layer_norm_bwd (%d, %d) %s: err %g "
                                     "(rms %g)" % (r, f, name, err, rms))
            worst = max(worst, err)
        # the library yardstick takes bf16 gamma / beta with bf16 x
        xr = x.detach().requires_grad_()
        g16, b16 = (t.to(torch.bfloat16).requires_grad_() for t in (g, bta))
        lib_out = tF.layer_norm(xr, (f,), g16, b16, 1e-5)
        runs = {
            "kernel": lambda: norm_cuda.layer_norm_bwd(x, g, mean, rstd, do),
            "plain": lambda: norm_cuda._layer_norm_bwd_reference(
                x, g, mean, rstd, do),
            "library": lambda: torch.autograd.grad(
                lib_out, (xr, g16, b16), do, retain_graph=True)}
        for name, fn in runs.items():
            row[name + "_ms"] = time_ms(fn, torch)
            row[name + "_device_ms"] = device_ms(fn, torch)
        # D is two launches: the rows' pass and the partials' reduction
        times = device_times(runs["kernel"], torch)
        row["rows_pass_device_ms"] = kernel_ms(times,
                                               "layer_norm_bwd_kernel")
        row["reduce_device_ms"] = kernel_ms(times,
                                            "layer_norm_bwd_reduce_kernel")
        nbytes = 3 * r * f * 2 + f * 4 + 2 * r * 4 + 2 * f * 4
        row["bound_ms"], row["bound_by"] = bound(nbytes, 12 * r * f,
                                                 F32_FLOPS)
        rows.append(row)
    return rows, worst


def train_model(torch, base, amp):
    """A card copy of the f32 CPU model ``base``, AMP O2 bf16."""
    return amp.decorate(copy.deepcopy(base), level="O2",
                        dtype="bfloat16").to("cuda")


def make_step(model, lr=1e-4, device="cuda"):
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models.gpt import GPTPretrainingCriterion
    from paddle_tpu_torch.optimizer import AdamW
    opt = AdamW(learning_rate=lr, weight_decay=0.01,
                parameters=model.parameters())
    return TrainStep(model, GPTPretrainingCriterion(), opt,
                     device=device)


def step_breakdown(torch, step, ids):
    """One step with CUDA events at forward start and end, after the
    loss, around the optimizer update and at the end: the stream time of
    each part (host-side gaps included)."""
    marks = {}

    def mark(name):
        marks[name] = torch.cuda.Event(enable_timing=True)
        marks[name].record()
    hooks = [step.model.register_forward_pre_hook(
                 lambda m, a: mark("forward")),
             step.model.register_forward_hook(
                 lambda m, a, o: mark("criterion"))]
    loss_fn, apply = step.loss_fn, step.optimizer.apply_gradients

    def timed_loss(*a):
        loss = loss_fn(*a)
        mark("backward")
        return loss

    def timed_apply(*a):
        mark("optimizer")
        out = apply(*a)
        mark("write_back")
        return out
    step.loss_fn, step.optimizer.apply_gradients = timed_loss, timed_apply
    try:
        torch.cuda.synchronize()
        mark("start")
        step(ids, ids)
        mark("end")
        torch.cuda.synchronize()
    finally:
        for h in hooks:
            h.remove()
        step.loss_fn = loss_fn
        del step.optimizer.apply_gradients
    order = ["start", "forward", "criterion", "backward", "optimizer",
             "write_back", "end"]
    out = {"%s_ms" % a: marks[a].elapsed_time(marks[b])
           for a, b in zip(order[1:-1], order[2:])}
    out["step_ms"] = marks["start"].elapsed_time(marks["end"])
    return out


def profile_steps(torch, step, ids, n=2):
    """Device-busy share and top kernels over ``n`` steps
    (``torch.profiler`` trace; host clock around the traced steps)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step(ids, ids)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    events = [(e.key, int(e.count),
               float(getattr(e, "self_device_time_total", 0.0) or 0.0))
              for e in prof.key_averages()]
    events = [e for e in events if e[2] > 0]
    dev_ms = sum(e[2] for e in events) / n / 1e3
    events.sort(key=lambda e: -e[2])
    return {"traced_step_wall_ms": wall_ms, "step_device_ms": dev_ms,
            "device_busy_share": dev_ms / wall_ms,
            "device_kernels_per_step": sum(e[1] for e in events) / n,
            "top_kernels": [{"name": k[:90], "per_step": c / n,
                             "ms_per_step": t / n / 1e3}
                            for k, c, t in events[:12]]}


def expect_launches(got, want, what):
    """Raise unless every named count in ``want`` matches ``got``."""
    bad = {k: (got[k], w) for k, w in want.items() if got[k] != w}
    if bad:
        raise AssertionError("%s: launches (got, want) %r" % (what, bad))


def train(torch, base, amp, counters, flags, steps=10, warmup=3):
    """bench.py's step: GPT-2 345M, AMP O2 bf16, AdamW(1e-4, wd 0.01), the
    label-shift criterion, one seeded (8, 1024) batch as input and
    labels; ``warmup`` steps, then ``steps`` timed ones with one sync at
    the end."""
    flags.set_flags({"use_pallas_norm": False})
    step = make_step(train_model(torch, base, amp))
    ids = torch.as_tensor(np.random.default_rng(0).integers(
        0, base.config.vocab_size, (8, 1024)), device="cuda")
    torch.cuda.reset_peak_memory_stats()
    losses = [step(ids, ids) for _ in range(warmup)]
    torch.cuda.synchronize()
    counters.reset()
    t0 = time.perf_counter()
    for _ in range(steps):
        losses.append(step(ids, ids))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counters.read()
    per_step = {k: n / steps for k, n in launches.items()}
    losses = [float(x) for x in losses]
    line = {"phase": "train", "shape": [8, 1024], "warmup_steps": warmup,
            "timed_steps": steps, "step_ms": wall * 1e3 / steps,
            "tokens_per_s": 8 * 1024 * steps / wall, "losses": losses,
            "launches": launches, "launches_per_step": per_step,
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    line["breakdown"] = step_breakdown(torch, step, ids)
    line["profile"] = profile_steps(torch, step, ids)
    emit(line)
    layers = base.config.num_hidden_layers
    expect_launches(launches, {"flash_fwd": layers * steps,
                               "flash_bwd": layers * steps,
                               "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
                               "layer_norm_fwd": 0, "layer_norm_bwd": 0},
                    "train")
    first, last = losses[0], losses[-1]
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError("train: non-finite loss %r" % (losses,))
    if abs(first - math.log(base.config.vocab_size)) > FIRST_LOSS_TOL:
        raise AssertionError("train: first loss %g, want ln(%d) = %g +- %g"
                             % (first, base.config.vocab_size,
                                math.log(base.config.vocab_size),
                                FIRST_LOSS_TOL))
    if not last < first:
        raise AssertionError("train: loss did not fall: %r" % (losses,))
    return line


def train_norm(torch, base, amp, counters, flags, first_loss, steps=3):
    """The train step for ``steps`` steps with ``use_pallas_norm`` on, from
    the same weights: kernels B and D, 49 launches each per step."""
    flags.set_flags({"use_pallas_norm": True})
    try:
        step = make_step(train_model(torch, base, amp))
        ids = torch.as_tensor(np.random.default_rng(0).integers(
            0, base.config.vocab_size, (8, 1024)), device="cuda")
        torch.cuda.synchronize()
        counters.reset()
        t0 = time.perf_counter()
        losses = [step(ids, ids) for _ in range(steps)]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        flags.set_flags({"use_pallas_norm": False})
    launches = counters.read()
    losses = [float(x) for x in losses]
    line = {"phase": "train_norm", "steps": steps,
            "step_ms": wall * 1e3 / steps,
            "tokens_per_s": 8 * 1024 * steps / wall, "losses": losses,
            "first_loss_default_route": first_loss,
            "first_loss_diff": abs(losses[0] - first_loss),
            "tolerance": NORM_ROUTE_LOSS_TOL, "launches": launches}
    emit(line)
    n_ln = 2 * base.config.num_hidden_layers + 1
    expect_launches(launches, {"layer_norm_fwd": n_ln * steps,
                               "layer_norm_bwd": n_ln * steps,
                               "flash_bwd": base.config.num_hidden_layers
                               * steps}, "train_norm")
    if not all(math.isfinite(x) for x in losses) or \
            abs(losses[0] - first_loss) > NORM_ROUTE_LOSS_TOL:
        raise AssertionError("train_norm: losses %r against the default "
                             "route's first %g" % (losses, first_loss))
    return line


def train_long(torch, cfg, amp, counters, flags, steps=2):
    """The long-context shape of the JAX package's long-sequence run:
    GPT-2 345M at full width, max_position_embeddings 16384, B=1,
    S=16384: kernel A, C2 and C3 on every layer, C1 never."""
    from paddle_tpu_torch.models.gpt import GPTForCausalLM
    flags.set_flags({"use_pallas_norm": False})
    s = 16384
    lcfg = dataclasses.replace(cfg, max_position_embeddings=s)
    base = GPTForCausalLM(lcfg, generator=torch.Generator().manual_seed(1))
    step = make_step(train_model(torch, base, amp))
    del base
    ids = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (1, s)), device="cuda")
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    counters.reset()
    t0 = time.perf_counter()
    losses = [step(ids, ids) for _ in range(steps)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counters.read()
    losses = [float(x) for x in losses]
    line = {"phase": "train_long", "shape": [1, s], "steps": steps,
            "step_ms": wall * 1e3 / steps, "tokens_per_s": s * steps / wall,
            "losses": losses, "launches": launches,
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    emit(line)
    layers = cfg.num_hidden_layers
    expect_launches(launches, {"flash_fwd": layers * steps,
                               "flash_bwd_dq": layers * steps,
                               "flash_bwd_dkv": layers * steps,
                               "flash_bwd": 0}, "train_long")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError("train_long: non-finite loss %r" % (losses,))
    return line


def step_grads(torch, step, ids):
    """One train step; returns (loss, the f32 gradients it handed the
    optimizer, by name, on the CPU)."""
    seen = {}
    apply = step.optimizer.apply_gradients

    def keep(params, grads, state, lr):
        seen.update({k: g.detach().float().cpu() for k, g in grads.items()})
        return apply(params, grads, state, lr)
    step.optimizer.apply_gradients = keep
    try:
        loss = float(step(ids, ids))
    finally:
        del step.optimizer.apply_gradients
    return loss, seen


def train_parity(torch, base, amp, flags, counters, s=256):
    """One train step at (1, 256) from the same weights on the card (bf16,
    kernels, each LayerNorm route) and on the CPU (f32, plain versions):
    the loss, and every parameter's gradient by its relative L2 error."""
    ids = np.random.default_rng(2).integers(0, base.config.vocab_size,
                                            (1, s))
    cpu_loss, cpu_grads = step_grads(
        torch, make_step(copy.deepcopy(base), device="cpu"),
        torch.as_tensor(ids))
    lines = []
    for use_norm in (False, True):
        flags.set_flags({"use_pallas_norm": use_norm})
        try:
            counters.reset()
            loss, grads = step_grads(
                torch, make_step(train_model(torch, base, amp)),
                torch.as_tensor(ids, device="cuda"))
            launches = counters.read()
        finally:
            flags.set_flags({"use_pallas_norm": False})
        rel = {k: float((grads[k] - g).norm() / g.norm())
               for k, g in cpu_grads.items()}
        worst = sorted(rel.items(), key=lambda kv: -kv[1])[:5]
        line = {"phase": "train_parity", "use_pallas_norm": use_norm,
                "shape": [1, s], "card_loss": loss, "cpu_loss": cpu_loss,
                "loss_diff": abs(loss - cpu_loss),
                "loss_tolerance": PARITY_LOSS_TOL,
                "grad_rel_l2_max": worst[0][1],
                "grad_rel_l2_median": statistics.median(rel.values()),
                "grad_rel_l2_worst": worst,
                "grad_rel_tolerance": PARITY_GRAD_REL_TOL,
                "params": len(rel), "launches": launches}
        emit(line)
        lines.append(line)
        if launches["flash_bwd"] == 0 or \
                bool(launches["layer_norm_bwd"]) != use_norm:
            raise AssertionError("train_parity: kernels not on the path: %r"
                                 % (launches,))
        if abs(loss - cpu_loss) > PARITY_LOSS_TOL or \
                worst[0][1] > PARITY_GRAD_REL_TOL:
            raise AssertionError("train_parity (use_pallas_norm=%s): loss "
                                 "%g vs %g, worst grads %r"
                                 % (use_norm, loss, cpu_loss, worst))
    return lines


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

    seconds = {}
    t0 = time.perf_counter()
    flash_rows, flash_err = check_flash(torch, fac)
    ln_rows, ln_err = check_layer_norm(torch, norm_cuda)
    emit({"phase": "checks", "flash_fwd": flash_rows,
          "layer_norm_fwd": ln_rows})
    bwd_rows, bwd_err = check_flash_bwd(torch, fac)
    ln_bwd_rows, ln_bwd_err = check_layer_norm_bwd(torch, norm_cuda)
    emit({"phase": "checks_bwd", "flash_bwd": bwd_rows,
          "layer_norm_bwd": ln_bwd_rows})
    long_plain_row, long_row = check_flash_long(torch, fac)
    emit({"phase": "checks_long", "against_plain": long_plain_row,
          "split_vs_merged": long_row})
    seconds["checks"] = time.perf_counter() - t0

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
    del engine, model, cpu_model
    torch.cuda.empty_cache()
    seconds["serve"] = time.perf_counter() - t0

    # -- train: bench.py's step, GPT-2 345M, AMP O2 bf16, AdamW -----------
    t0 = time.perf_counter()
    counters = Counters(fac, norm_cuda)
    train_cfg = dataclasses.replace(cfg, hidden_dropout_prob=0.0,
                                    attention_dropout_prob=0.0)
    # the serve run's seeded weights (same generator, same draw order)
    base = GPTForCausalLM(train_cfg,
                          generator=torch.Generator().manual_seed(0))
    run_train = train(torch, base, amp, counters, flags)
    torch.cuda.empty_cache()
    seconds["train"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    run_train_norm = train_norm(torch, base, amp, counters, flags,
                                run_train["losses"][0])
    torch.cuda.empty_cache()
    seconds["train_norm"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    train_parity(torch, base, amp, flags, counters)
    del base
    torch.cuda.empty_cache()
    seconds["train_parity"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    run_long = train_long(torch, train_cfg, amp, counters, flags)
    torch.cuda.empty_cache()
    seconds["train_long"] = time.perf_counter() - t0
    emit({"phase": "seconds", **seconds})

    prefill_row = flash_rows[0]            # (1, 128, 16, 64) causal
    train_fwd_row = flash_rows[-1]         # (8, 1024, 16, 64) causal
    decode_row = ln_rows[0]                # (8, 1024)
    train_ln_row = ln_rows[-1]             # (8192, 1024)
    train_bwd_row = [r for r in bwd_rows
                     if r["shape"] == [8, 1024, 16, 64]][0]
    ln_bwd_row = ln_bwd_rows[0]            # (8192, 1024)
    fwd_launches = {"serve": run_default["launches"]["flash_fwd"],
                  "train": run_train["launches"]["flash_fwd"],
                  "train_long": run_long["launches"]["flash_fwd"]}

    def bwd_entry(kern, src_row, plain_row, launches, err):
        return {
            "name": kern, "route": "cuda",
            "source": "paddle_tpu_torch/csrc/flash_bwd.cu",
            "replaces": "paddle_tpu/kernels/flash_attention_pallas.py:%d"
                        % {"flash_bwd": 736, "flash_bwd_dq": 790,
                           "flash_bwd_dkv": 828}[kern],
            "launches": launches, "max_abs_err": err,
            "shape": src_row["shape"], "ms": src_row[kern + "_ms"],
            "device_ms": src_row[kern + "_device_ms"],
            "plain_ms": plain_row["plain_ms"],
            "plain_device_ms": plain_row["plain_device_ms"],
            "plain_shape": plain_row["shape"],
            # the kernel at the plain version's shape, to compare with it
            "ms_at_plain_shape": plain_row[kern + "_ms"],
            "bound_ms": src_row[kern + "_bound_ms"],
            "bound_by": src_row[kern + "_bound_by"],
            "library_ms": src_row["library_ms"],
            "library_device_ms": src_row["library_device_ms"]}
    split_err = max(long_plain_row["split_dq_err"],
                    long_plain_row["split_dk_err"],
                    long_plain_row["split_dv_err"])
    emit({"kernels": [
        {"name": "flash_fwd", "route": "cuda",
         "source": "paddle_tpu_torch/csrc/flash_fwd.cu",
         "replaces": "paddle_tpu/kernels/flash_attention_pallas.py:382 "
                     "and :450",
         "launches": run_train["launches"]["flash_fwd"],
         "launches_by_path": fwd_launches,
         "max_abs_err": max(flash_err, long_plain_row["flash_fwd_err"]),
         "ms": prefill_row["kernel_ms"],
         "device_ms": prefill_row["kernel_device_ms"],
         "plain_ms": prefill_row["plain_ms"],
         "bound_ms": prefill_row["bound_ms"],
         "bound_by": prefill_row["bound_by"],
         "library_ms": prefill_row["library_ms"],
         "at_train": {k: train_fwd_row[k] for k in (
             "shape", "kernel_ms", "kernel_device_ms", "plain_ms",
             "bound_ms", "library_ms")},
         "at_s16384": {
             "shape": long_row["shape"],
             "ms": long_row["fwd_flash_fwd_ms"],
             "device_ms": long_row["fwd_flash_fwd_device_ms"],
             "bound_ms": long_row["fwd_bound_ms"],
             "library_ms": long_row["fwd_library_ms"],
             "h2_ms": long_plain_row["fwd_flash_fwd_ms"],
             "h2_plain_ms": long_plain_row["fwd_plain_ms"],
             "h2_bound_ms": long_plain_row["fwd_bound_ms"],
             "h2_library_ms": long_plain_row["fwd_library_ms"]}},
        {"name": "layer_norm_fwd", "route": "cuda",
         "source": "paddle_tpu_torch/csrc/layer_norm_fwd.cu",
         "replaces": "paddle_tpu/kernels/norm_pallas.py:118",
         "launches": run_train_norm["launches"]["layer_norm_fwd"],
         "launches_by_path": {
             "serve_use_pallas_norm": run_norm["launches"]["layer_norm_fwd"],
             "train_norm": run_train_norm["launches"]["layer_norm_fwd"]},
         "max_abs_err": ln_err, "ms": decode_row["kernel_ms"],
         "device_ms": decode_row["kernel_device_ms"],
         "plain_ms": decode_row["plain_ms"],
         "bound_ms": decode_row["bound_ms"],
         "bound_by": decode_row["bound_by"],
         "library_ms": decode_row["library_ms"],
         "at_train": {k: train_ln_row[k] for k in (
             "shape", "kernel_ms", "kernel_device_ms", "plain_ms",
             "bound_ms", "library_ms")}},
        bwd_entry("flash_bwd", train_bwd_row, train_bwd_row,
                  run_train["launches"]["flash_bwd"], bwd_err["flash_bwd"]),
        bwd_entry("flash_bwd_dq", long_row, long_plain_row,
                  run_long["launches"]["flash_bwd_dq"],
                  max(bwd_err["flash_bwd_dq"], split_err)),
        bwd_entry("flash_bwd_dkv", long_row, long_plain_row,
                  run_long["launches"]["flash_bwd_dkv"],
                  max(bwd_err["flash_bwd_dkv"], split_err)),
        {"name": "layer_norm_bwd", "route": "cuda",
         "source": "paddle_tpu_torch/csrc/layer_norm_bwd.cu",
         "replaces": "paddle_tpu/kernels/norm_pallas.py:132",
         "launches": run_train_norm["launches"]["layer_norm_bwd"],
         "max_abs_err": ln_bwd_err, "shape": ln_bwd_row["shape"],
         "ms": ln_bwd_row["kernel_ms"],
         "device_ms": ln_bwd_row["kernel_device_ms"],
         "plain_ms": ln_bwd_row["plain_ms"],
         "bound_ms": ln_bwd_row["bound_ms"],
         "bound_by": ln_bwd_row["bound_by"],
         "library_ms": ln_bwd_row["library_ms"]}]})
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
