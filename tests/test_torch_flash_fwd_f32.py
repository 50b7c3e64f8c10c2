"""The numerics of the f32 flash forward kernels (kernel A,
``csrc/flash_fwd.cu``, and the f32 A', ``csrc/flash_fwd_pipelined.cu``),
emulated on the CPU.

On the card both run the same body (``flash_fwd_tf32x3`` of
``csrc/tf32x3_common.cuh``): q is scaled by scale log2(e) once, then for
each K/V tile of ``block_k`` rows S = q K^T and P V are taken on the
tensor cores as 3 x TF32 (each f32 operand split into big = tf32(x) and
small = tf32(x - big); a b summed as a.small b.big + a.big b.small +
a.big b.big in f32), each into fresh accumulators, with the base-2
online softmax between them and acc = acc corr + P V in f32.  Here that
walk is emulated in torch with the backward's emulated products (``mm3``
and ``mm1`` of ``tests/test_torch_flash_bwd_f32.py``) and held against
the plain forward ``_flash_reference`` and the JAX package's Pallas
``_fwd_kernel`` and ``_fwd_kernel_pipelined`` (interpret mode) at
``chip_smoke.py``'s f32 bars, the bars the kernels are held to on the
card: it stays within them, and one TF32 product a product does not.
A tile that a warp's rows do not reach is skipped on the card and visited
with every key masked here: with the row max already finite it scales by
exp2(0) = 1 and adds 0, so the two walks give the same bits."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from paddle_tpu.kernels import flash_attention_pallas as fap
from paddle_tpu_torch.kernels import flash_attention_cuda as fac
from test_torch_flash_bwd_f32 import mm1, mm3

ULP = chip_smoke.ULP_REL["float32"]
FRAC = chip_smoke.RMS_FRAC["float32"]
LOG2E = 1.4426950408889634
SHAPES = [(1, 256, 2, 64), (1, 256, 2, 128), (1, 256, 1, 256)]


def emulated_fwd(mm, q, k, v, causal, scale, block_k):
    """(out, base-e lse (B, S, H)) of the kernels' walk over K/V tiles of
    ``block_k`` rows, both products taken by ``mm``."""
    b, s, h, d = q.shape
    qs = q * np.float32(scale * LOG2E)
    m = torch.full((b, s, h), -1e30)
    l = torch.zeros((b, s, h))
    acc = torch.zeros((b, s, h, d))
    rows = torch.arange(s)
    for c0 in range(0, s, block_k):
        kt, vt = k[:, c0:c0 + block_k], v[:, c0:c0 + block_k]
        logits = mm("bqhd,bkhd->bqhk", qs, kt)
        if causal:
            cols = torch.arange(c0, c0 + block_k)
            hidden = (cols[None, :] > rows[:, None])[None, :, None, :]
            logits = logits.masked_fill(hidden, -1e30)
        m_new = torch.maximum(m, logits.amax(-1))
        corr = torch.exp2(m - m_new)
        p = torch.exp2(logits - m_new[..., None])
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + mm("bqhk,bkhd->bqhd", p, vt)
        m = m_new
    out = acc / l[..., None]
    return out, (m + torch.log2(l)) / LOG2E


def _qkv(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


def _block_ks(d):
    """The K/V tile rows of kernel A at head dim ``d`` and of every A'
    tile."""
    return sorted({fac._F32_FWD_BLOCKS[d][1]}
                  | {bk for _bq, bk in fac._PIPELINED_BLOCKS})


def _held(got, want, what):
    """``got`` = (out, lse) within the f32 bars of ``want``: every element
    of out within 1e-5 of |ref| plus 1e-4 of the reference's RMS, the lse
    within ``chip_smoke.LSE_TOL``."""
    err, rms, ok = chip_smoke.within(got[0], want[0], ULP, FRAC)
    lse_err = float((got[1] - want[1]).abs().max())
    assert ok and lse_err <= chip_smoke.LSE_TOL, \
        "%s: out err %g (ref rms %g), lse err %g" % (what, err, rms, lse_err)
    return err


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_3xtf32_forward_is_within_the_f32_bars(shape, causal):
    """3 x TF32 products at every K/V tile of A and A' against the plain
    f32 forward."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(shape, 150))
    scale = shape[-1] ** -0.5
    ref = fac._flash_reference(q, k, v, causal, scale)
    for bk in _block_ks(shape[-1]):
        _held(emulated_fwd(mm3, q, k, v, causal, scale, bk), ref,
              "%s causal=%s block_k %d" % (shape, causal, bk))


@pytest.mark.parametrize("variant", ["base", "pipelined"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_3xtf32_forward_is_within_the_f32_bars_of_pallas(shape, causal,
                                                         variant):
    """The emulation against the Pallas forward (f32, interpret mode) on
    the same numpy inputs: ``_fwd_kernel`` for the base variant (kernel
    A's tile), ``_fwd_kernel_pipelined`` at 128 x 128 tiles (its K/V
    prefetch runs at S = 256) for A' at each of its tiles."""
    q, k, v = _qkv(shape, 151)
    kw = dict(causal=causal, interpret=True)
    if variant == "pipelined":
        kw.update(block_q=128, block_k=128, variant="pipelined")
    want_out, want_lse = fap.flash_attention_bshd_with_lse(
        *(jnp.asarray(a) for a in (q, k, v)), **kw)
    want = (torch.from_numpy(np.array(want_out)),
            torch.from_numpy(np.array(want_lse)))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    d = shape[-1]
    bks = ([fac._F32_FWD_BLOCKS[d][1]] if variant == "base"
           else sorted({bk for _bq, bk in fac._PIPELINED_BLOCKS}))
    for bk in bks:
        _held(emulated_fwd(mm3, tq, tk, tv, causal, d ** -0.5, bk), want,
              "%s %s causal=%s block_k %d" % (variant, shape, causal, bk))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_one_tf32_product_fails_the_f32_bars(shape, causal):
    """The same walk with one TF32 product a product (about 2^-11 of each)
    leaves the f32 bars, and lies tens of times further from the plain
    forward than 3 x TF32 does."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(shape, 152))
    scale = shape[-1] ** -0.5
    bk = fac._F32_FWD_BLOCKS[shape[-1]][1]
    ref = fac._flash_reference(q, k, v, causal, scale)
    one = emulated_fwd(mm1, q, k, v, causal, scale, bk)
    three = emulated_fwd(mm3, q, k, v, causal, scale, bk)
    err1, _rms, ok1 = chip_smoke.within(one[0], ref[0], ULP, FRAC)
    err3, _rms, ok3 = chip_smoke.within(three[0], ref[0], ULP, FRAC)
    assert ok3 and not ok1, (err1, err3)
    assert err1 > 10 * err3
