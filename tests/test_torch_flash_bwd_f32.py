"""The numerics of the f32 flash backward kernels (``csrc/flash_bwd.cu``),
emulated on the CPU.

On the card the five products of the f32 backward (S = Q K^T, dV = P^T dO,
dP = dO V^T, dQ = dS K, dK = dS^T Q) run on the tensor cores as 3 x TF32:
each f32 operand x is split into big = tf32(x) and small = tf32(x - big)
(``cvt.rna.tf32.f32``: 10 mantissa bits, to nearest, ties away from
zero), and a b is summed as a.small b.big + a.big b.small + a.big b.big
in f32.  Here that arithmetic is emulated in torch and held against the
plain backward ``_flash_bwd_reference`` (and the JAX package's Pallas
backward in interpret mode) at ``chip_smoke.py``'s f32 bars, the bars the
kernels are held to on the card: it stays within them, and one TF32
product a product does not, so the bars tell the two apart.  The
emulation lives here, beside the test, not in the port."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from paddle_tpu.kernels import flash_attention_pallas as fap
from paddle_tpu_torch.kernels import flash_attention_cuda as fac

ULP = chip_smoke.ULP_REL["float32"]
FRAC = chip_smoke.RMS_FRAC["float32"]
SHAPES = [(1, 256, 4, 64), (1, 128, 2, 128), (1, 128, 2, 256)]


def tf32_rna(x):
    """``cvt.rna.tf32.f32`` of f32 ``x``: the mantissa rounded to 10 bits,
    to nearest, ties away from zero (half an ulp added to the magnitude
    bits, then the 13 low bits cleared), as an f32 tensor."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(x):
    big = tf32_rna(x)
    return big, tf32_rna(x - big)


def mm3(eq, a, b):
    """einsum ``eq`` of f32 a and b as 3 x TF32: the cross terms first,
    then big x big, each product exact in f32, the sums in f32."""
    (ab, as_), (bb, bs) = split(a), split(b)
    return (torch.einsum(eq, as_, bb) + torch.einsum(eq, ab, bs)
            + torch.einsum(eq, ab, bb))


def mm1(eq, a, b):
    """One TF32 product: both operands rounded to TF32."""
    return torch.einsum(eq, tf32_rna(a), tf32_rna(b))


def emulated_bwd(mm, q, k, v, out, lse, dout, causal, scale, dlse=None):
    """``_flash_bwd_reference``'s f32 backward with its five products
    taken by ``mm``: P in base 2 from the saved lse, the causal mask, dS =
    P (dP - delta), the scale on dQ and dK."""
    log2e = 1.4426950408889634
    logits = mm("bqhd,bkhd->bhqk", q, k) * (float(scale) * log2e)
    p = torch.exp2(logits - (lse * log2e).transpose(1, 2)[..., None])
    if causal:
        s = q.shape[1]
        p = p.masked_fill(~torch.ones((s, s), dtype=torch.bool).tril(), 0.0)
    delta = (dout * out).sum(-1)
    if dlse is not None:
        delta = delta - dlse
    dv = mm("bhqk,bqhd->bkhd", p, dout)
    dp = mm("bqhd,bkhd->bhqk", dout, v)
    ds = p * (dp - delta.transpose(1, 2)[..., None])
    dq = mm("bhqk,bkhd->bqhd", ds, k) * float(scale)
    dk = mm("bhqk,bqhd->bkhd", ds, q) * float(scale)
    return dq, dk, dv


def _case(shape, seed, causal):
    rng = np.random.default_rng(seed)
    q, k, v, dout = (torch.from_numpy(rng.standard_normal(shape)
                                      .astype(np.float32)) for _ in range(4))
    dlse = torch.from_numpy(rng.standard_normal(shape[:3]).astype(np.float32))
    scale = shape[-1] ** -0.5
    out, lse = fac._flash_reference(q, k, v, causal, scale)
    return q, k, v, out, lse, dout, causal, scale, dlse


def _errors(got, ref):
    """(name, max abs error, reference RMS, within the f32 bars) of dq, dk
    and dv."""
    return [(name,) + chip_smoke.within(g, r, ULP, FRAC)
            for name, g, r in zip(("dq", "dk", "dv"), got, ref)]


def test_tf32_rna_rounds_to_nearest_ties_away():
    one = torch.tensor([1.0], dtype=torch.float32)
    ulp10, half = 2.0 ** -10, 2.0 ** -11
    xs = torch.tensor([1 + half, -(1 + half), 1 + half - 2.0 ** -23,
                       1 + ulp10 + half, 3.0, 0.0], dtype=torch.float32)
    want = torch.tensor([1 + ulp10, -(1 + ulp10), 1.0, 1 + 2 * ulp10, 3.0,
                         0.0], dtype=torch.float32)
    assert torch.equal(tf32_rna(xs), want)
    assert torch.equal(tf32_rna(one), one)
    # big + small gives x back to 2^-22 of it; big alone to 2^-11
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(4096)
                         .astype(np.float32))
    big, small = split(x)
    assert float(((big + small - x).abs() / x.abs()).max()) <= 2.0 ** -22
    assert float(((big - x).abs() / x.abs()).max()) <= 2.0 ** -11
    assert float(((big - x).abs() / x.abs()).max()) > 2.0 ** -13


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_3xtf32_backward_is_within_the_f32_bars(shape, causal):
    """3 x TF32 products, with an lse cotangent, against the plain f32
    backward: every element of dq, dk and dv within 1e-5 of |ref| plus
    1e-4 of the reference's RMS."""
    args = _case(shape, 140, causal)
    ref = fac._flash_bwd_reference(*args)
    for name, err, rms, ok in _errors(emulated_bwd(mm3, *args), ref):
        assert ok, "%s %s causal=%s: err %g, ref rms %g" % (
            name, shape, causal, err, rms)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_one_tf32_product_fails_the_f32_bars(shape, causal):
    """The same backward with one TF32 product a product (about 2^-11 of
    each) leaves the f32 bars, and lies tens of times further from the
    plain backward than 3 x TF32 does."""
    args = _case(shape, 140, causal)
    ref = fac._flash_bwd_reference(*args)
    one = _errors(emulated_bwd(mm1, *args), ref)
    three = _errors(emulated_bwd(mm3, *args), ref)
    assert not all(ok for _n, _e, _r, ok in one), one
    assert max(e for _n, e, _r, _ok in one) > \
        10 * max(e for _n, e, _r, _ok in three)


def test_3xtf32_backward_is_within_the_f32_bars_of_pallas():
    """The emulation against ``jax.grad`` through the Pallas kernels
    (interpret mode, f32) on the same numpy inputs, lse cotangent
    included: within the same bars."""
    shape, causal = (1, 256, 2, 64), True
    rng = np.random.default_rng(141)
    q, k, v, ct = (rng.standard_normal(shape).astype(np.float32)
                   for _ in range(4))
    ct_lse = rng.standard_normal(shape[:3]).astype(np.float32)

    def loss(q_, k_, v_):
        out, lse = fap.flash_attention_bshd_with_lse(
            q_, k_, v_, causal=causal, interpret=True)
        return jnp.sum(out * ct) + jnp.sum(lse * ct_lse)
    want = jax.grad(loss, argnums=(0, 1, 2))(
        *(jnp.asarray(a) for a in (q, k, v)))
    tq, tk, tv, tct = (torch.from_numpy(a) for a in (q, k, v, ct))
    scale = shape[-1] ** -0.5
    out, lse = fac._flash_reference(tq, tk, tv, causal, scale)
    got = emulated_bwd(mm3, tq, tk, tv, out, lse, tct, causal, scale,
                       torch.from_numpy(ct_lse))
    ref = [torch.from_numpy(np.array(w)) for w in want]
    for name, err, rms, ok in _errors(got, ref):
        assert ok, "%s: err %g, ref rms %g" % (name, err, rms)
