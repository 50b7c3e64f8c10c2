"""The CUDA kernels of paddle_tpu_torch on the card, each held against
its plain PyTorch version at several shapes and dtypes.  Marked ``gpu``:
without an NVIDIA card every test skips.  This file imports no JAX, so it
runs on a machine that has only PyTorch and the CUDA toolkit:

    python -m pytest tests/test_torch_cuda_kernels.py -m gpu -q
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.kernels import ce_cuda
from paddle_tpu_torch.kernels import flash_attention_cuda as fac
from paddle_tpu_torch.kernels import norm_cuda


def _qkv(shape, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


def _ln_inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * 2.0 + 0.5).astype(np.float32)
    g = (1.0 + 0.1 * rng.standard_normal(shape[-1])).astype(np.float32)
    b = (0.1 * rng.standard_normal(shape[-1])).astype(np.float32)
    return x, g, b


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_matches_plain(dtype, causal):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    for shape in [(1, 128, 16, 64), (2, 256, 4, 128), (1, 192, 2, 256)]:
        q, k, v = (torch.from_numpy(a).to("cuda", dtype)
                   for a in _qkv(shape, seed=5))
        # f32 takes kernel A, bf16 the tensor-core forward
        counter = ("flash_fwd_launches" if dtype == torch.float32
                   else "flash_fwd_tc_launches")
        before = getattr(fac, counter)
        out, lse = fac.flash_attention_bshd_with_lse(q, k, v, causal=causal)
        torch.cuda.synchronize()
        assert getattr(fac, counter) == before + 1
        ref, ref_lse = fac._flash_reference(q, k, v, causal,
                                            1.0 / shape[-1] ** 0.5)
        tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
        torch.testing.assert_close(out.float(), ref.float(), atol=tol,
                                   rtol=0)
        torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=0)


def _close(got, ref, dtype, what):
    """Per element within one ulp of |ref| in the working dtype (both
    sides round an f32 result to it) plus a small share of the
    reference's RMS (the kernels and the plain version sum in other
    orders, and C1 adds dQ with atomics)."""
    ref = ref.float()
    rms = float(ref.pow(2).mean().sqrt())
    ulp, share = {torch.bfloat16: (2.0 ** -7, 2.0 ** -6),
                  torch.float16: (2.0 ** -10, 2.0 ** -6)}.get(dtype,
                                                             (1e-5, 1e-4))
    err = (got.float() - ref).abs()
    bad = err > ulp * ref.abs() + share * rms
    assert not bool(bad.any()), "%s: max err %g (ref rms %g)" % (
        what, float(err.max()), rms)


@pytest.mark.gpu
@pytest.mark.parametrize("route", ["merged", "split"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_bwd_kernels_match_plain(dtype, causal, route):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    for shape in [(1, 128, 16, 64), (2, 256, 4, 128), (1, 192, 2, 64)]:
        q, k, v, do = (torch.from_numpy(a).to("cuda", dtype)
                       for a in _qkv(shape, seed=6) + _qkv(shape, seed=7)[:1])
        scale = 1.0 / shape[-1] ** 0.5
        out, lse = fac.flash_attention_bshd_with_lse(q, k, v, causal=causal)
        counts = (fac.flash_bwd_launches, fac.flash_bwd_dq_launches,
                  fac.flash_bwd_dkv_launches)
        got = fac.flash_attention_bwd(q, k, v, out, lse, do, causal, scale,
                                      route=route)
        torch.cuda.synchronize()
        want = (1, 0, 0) if route == "merged" else (0, 1, 1)
        assert (fac.flash_bwd_launches - counts[0],
                fac.flash_bwd_dq_launches - counts[1],
                fac.flash_bwd_dkv_launches - counts[2]) == want
        ref = fac._flash_bwd_reference(q, k, v, out, lse, do, causal, scale)
        for name, g, r in zip(("dq", "dk", "dv"), got, ref):
            assert g.dtype == dtype and g.shape == q.shape
            _close(g, r, dtype, "%s %s %s" % (name, shape, route))


@pytest.mark.gpu
def test_flash_bwd_with_lse_cotangent():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    shape = (1, 256, 4, 64)
    q, k, v, do = (torch.from_numpy(a).to("cuda")
                   for a in _qkv(shape, seed=8) + _qkv(shape, seed=9)[:1])
    dlse = torch.from_numpy(_qkv(shape[:3], seed=10)[0]).to("cuda")
    out, lse = fac.flash_attention_bshd_with_lse(q, k, v, causal=True)
    for route in ("merged", "split"):
        got = fac.flash_attention_bwd(q, k, v, out, lse, do, True, 0.125,
                                      dlse=dlse, route=route)
        ref = fac._flash_bwd_reference(q, k, v, out, lse, do, True, 0.125,
                                       dlse=dlse)
        for g, r in zip(got, ref):
            _close(g, r, torch.float32, "with-lse %s" % route)


@pytest.mark.gpu
def test_attention_on_the_card_joins_autograd():
    """The forward kernel's output carries a grad_fn, and the gradients
    through it match the plain route's."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from paddle_tpu_torch.nn import functional as F
    q, k, v = (torch.from_numpy(a).to("cuda").requires_grad_()
               for a in _qkv((2, 128, 4, 64), seed=11))
    ct = torch.from_numpy(_qkv((2, 128, 4, 64), seed=12)[0]).to("cuda")
    before = fac.flash_fwd_launches
    out = F.scaled_dot_product_attention(q, k, v, is_causal=True)
    assert fac.flash_fwd_launches == before + 1
    assert out.grad_fn is not None
    got = torch.autograd.grad((out * ct).sum(), (q, k, v))
    want = torch.autograd.grad(
        (F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                        use_flash=False) * ct).sum(),
        (q, k, v))
    for g, w in zip(got, want):
        assert float(g.abs().max()) > 0
        _close(g, w, torch.float32, "sdpa grad")


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [False, True])
def test_head_dim_256_forward_and_both_backward_routes_match_plain(causal):
    """Head dim 256 (in f32 C1 on 32-row 3 x TF32 tiles; in bf16 C1, C2
    and C3 on the tensor cores): under autograd the forward launches kernel A,
    and the backward, with each route pinned, matches its plain
    version."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from paddle_tpu_torch.nn import functional as F
    # the model's route takes S % 128 == 0; the kernels S % 64 == 0
    q, k, v = (torch.from_numpy(a).to("cuda").requires_grad_()
               for a in _qkv((1, 128, 2, 256), seed=17))
    before = fac.flash_fwd_launches
    out = F.scaled_dot_product_attention(q, k, v, is_causal=causal)
    assert fac.flash_fwd_launches == before + 1
    assert out.grad_fn is not None
    assert len(torch.autograd.grad(out.sum(), (q, k, v))) == 3
    shape = (1, 192, 2, 256)
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, do = (torch.from_numpy(a).to("cuda", dtype)
                       for a in _qkv(shape, seed=18) + _qkv(shape, seed=19)[:1])
        out, lse = fac.flash_attention_bshd_with_lse(q, k, v, causal=causal)
        ref = fac._flash_bwd_reference(q, k, v, out, lse, do, causal, 0.0625)
        for route in ("merged", "split"):
            got = fac.flash_attention_bwd(q, k, v, out, lse, do, causal,
                                          0.0625, route=route)
            torch.cuda.synchronize()
            for name, g, r in zip(("dq", "dk", "dv"), got, ref):
                _close(g, r, dtype, "d=256 %s %s %s" % (name, route, dtype))


@pytest.mark.gpu
def test_layer_norm_on_the_card_joins_autograd(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.utils import flags
    x, g, b = (torch.from_numpy(a).to("cuda").requires_grad_()
               for a in _ln_inputs((64, 256), seed=13))
    ct = torch.from_numpy(_ln_inputs((64, 256), seed=14)[0]).to("cuda")
    monkeypatch.setitem(flags._REGISTRY, "use_pallas_norm", True)
    before = (norm_cuda.layer_norm_fwd_launches,
              norm_cuda.layer_norm_bwd_launches)
    out = F.layer_norm(x, [256], g, b)
    assert out.grad_fn is not None
    got = torch.autograd.grad((out * ct).sum(), (x, g, b))
    assert (norm_cuda.layer_norm_fwd_launches - before[0],
            norm_cuda.layer_norm_bwd_launches - before[1]) == (1, 1)
    monkeypatch.setitem(flags._REGISTRY, "use_pallas_norm", False)
    want = torch.autograd.grad((F.layer_norm(x, [256], g, b) * ct).sum(),
                               (x, g, b))
    for gg, w in zip(got, want):
        assert float(gg.abs().max()) > 0
        torch.testing.assert_close(gg, w, atol=1e-4, rtol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("w_dtype", [torch.float32, torch.bfloat16])
def test_layer_norm_bwd_kernel_matches_plain(x_dtype, w_dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    for shape in [(8, 1024), (200, 1024), (24, 136)]:
        x, g, b = _ln_inputs(shape, seed=15)
        do = _ln_inputs(shape, seed=16)[0]
        x, do = (torch.from_numpy(a).to("cuda", x_dtype) for a in (x, do))
        g = torch.from_numpy(g).to("cuda", w_dtype)
        _out, mean, rstd = norm_cuda.layer_norm_fwd(x, g, g)
        before = norm_cuda.layer_norm_bwd_launches
        got = norm_cuda.layer_norm_bwd(x, g, mean, rstd, do)
        torch.cuda.synchronize()
        assert norm_cuda.layer_norm_bwd_launches == before + 1
        ref = norm_cuda._layer_norm_bwd_reference(x, g, mean, rstd, do)
        for name, a, r in zip(("dx", "dgamma", "dbeta"), got, ref):
            assert a.dtype == r.dtype
            _close(a, r, a.dtype, "%s %s" % (name, shape))


@pytest.mark.gpu
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("w_dtype", [torch.float32, torch.bfloat16])
def test_layer_norm_kernel_matches_plain(x_dtype, w_dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    for shape in [(8, 1024), (128, 1024), (24, 128)]:
        x, g, b = _ln_inputs(shape, seed=4)
        x = torch.from_numpy(x).to("cuda", x_dtype)
        g = torch.from_numpy(g).to("cuda", w_dtype)
        b = torch.from_numpy(b).to("cuda", w_dtype)
        before = norm_cuda.layer_norm_fwd_launches
        out, mean, rstd = norm_cuda.layer_norm_fwd(x, g, b)
        torch.cuda.synchronize()
        assert norm_cuda.layer_norm_fwd_launches == before + 1
        r_out, r_mean, r_rstd = norm_cuda._layer_norm_reference(x, g, b,
                                                                1e-5)
        tol = 2e-2 if x_dtype == torch.bfloat16 else 1e-5
        torch.testing.assert_close(out.float(), r_out.float(), atol=tol,
                                   rtol=0)
        torch.testing.assert_close(mean, r_mean, atol=1e-5, rtol=0)
        torch.testing.assert_close(rstd, r_rstd, atol=1e-4, rtol=1e-5)


# Kernels B and D at every launch plan: a warp a row (rows >= 1024, F <=
# 1024; or F <= 256), 128 threads a row (few rows at F <= 1024, or F <=
# 4096), 256 (F <= 8192), each with 1, 2 or 4 packs a thread, and F = 8200
# just past the register plan, where both take their streaming kernels
LN_PLAN_SHAPES = [(8, 128), (8192, 128), (200, 136), (8192, 512),
                  (8, 1024), (128, 1024), (200, 1024), (8192, 1024),
                  (128, 1280), (8192, 1280), (8, 4096), (200, 4096),
                  (8, 8192), (8, 8200), (200, 8200)]
# x's dtype, then gamma / beta in f32 or in a 16-bit dtype
LN_DTYPES = [(torch.float32, torch.float32), (torch.float32, torch.bfloat16),
             (torch.bfloat16, torch.float32), (torch.bfloat16, torch.bfloat16),
             (torch.float16, torch.float32), (torch.float16, torch.float16)]


@pytest.mark.gpu
@pytest.mark.parametrize("x_dtype,w_dtype", LN_DTYPES)
def test_layer_norm_kernels_match_plain_at_every_plan(x_dtype, w_dtype):
    """B and D against their plain versions at every row count and width
    of LN_PLAN_SHAPES: out, dx, dgamma and dbeta within one ulp of |ref|
    in their dtype plus a small share of the RMS (other summation
    orders), the f32 statistics as the other LayerNorm tests hold them."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    for shape in LN_PLAN_SHAPES:
        x, g, b = _ln_inputs(shape, seed=31)
        do = _ln_inputs(shape, seed=32)[0]
        x, do = (torch.from_numpy(a).to("cuda", x_dtype) for a in (x, do))
        g, b = (torch.from_numpy(a).to("cuda", w_dtype) for a in (g, b))
        counts = (norm_cuda.layer_norm_fwd_launches,
                  norm_cuda.layer_norm_bwd_launches)
        out, mean, rstd = norm_cuda.layer_norm_fwd(x, g, b)
        got = norm_cuda.layer_norm_bwd(x, g, mean, rstd, do)
        torch.cuda.synchronize()
        assert (norm_cuda.layer_norm_fwd_launches - counts[0],
                norm_cuda.layer_norm_bwd_launches - counts[1]) == (1, 1)
        r_out, r_mean, r_rstd = norm_cuda._layer_norm_reference(x, g, b,
                                                                1e-5)
        assert out.dtype == x_dtype
        _close(out, r_out, x_dtype, "ln out %s %s" % (shape, x_dtype))
        torch.testing.assert_close(mean, r_mean, atol=1e-5, rtol=0)
        torch.testing.assert_close(rstd, r_rstd, atol=1e-4, rtol=1e-5)
        ref = norm_cuda._layer_norm_bwd_reference(x, g, mean, rstd, do)
        for name, a, r in zip(("dx", "dgamma", "dbeta"), got, ref):
            assert a.dtype == r.dtype
            _close(a, r, a.dtype, "ln %s %s %s" % (name, shape, x_dtype))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(8192, 1024), (200, 4096), (64, 8200)])
def test_layer_norm_bwd_runs_are_bit_identical(shape):
    """D sums dgamma / dbeta in a fixed order, without atomics: two calls
    on the same inputs give the same bits (dx too)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    x, g, b = _ln_inputs(shape, seed=33)
    do = _ln_inputs(shape, seed=34)[0]
    x, do = (torch.from_numpy(a).to("cuda", torch.bfloat16) for a in (x, do))
    g, b = (torch.from_numpy(a).to("cuda") for a in (g, b))
    _out, mean, rstd = norm_cuda.layer_norm_fwd(x, g, b)
    first = norm_cuda.layer_norm_bwd(x, g, mean, rstd, do)
    again = norm_cuda.layer_norm_bwd(x, g, mean, rstd, do)
    torch.cuda.synchronize()
    for name, a, r in zip(("dx", "dgamma", "dbeta"), first, again):
        assert torch.equal(a, r), "%s differs between two runs" % name


@pytest.mark.gpu
def test_layer_norm_kernels_take_unaligned_parameter_views():
    """gamma / beta as views at a 4-byte offset of one buffer (as a flat
    parameter buffer may hold them): the kernels read them with 16-byte
    loads, so the wrapper hands them a copy, and the results equal those
    of aligned parameters to the bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    x, g, b = _ln_inputs((256, 1024), seed=35)
    do = _ln_inputs((256, 1024), seed=36)[0]
    x, do = (torch.from_numpy(a).to("cuda", torch.bfloat16) for a in (x, do))
    g, b = (torch.from_numpy(a).to("cuda") for a in (g, b))
    buf = torch.empty(2 * 1024 + 1, device="cuda")
    gv, bv = buf[1:1025], buf[1025:]
    gv.copy_(g)
    bv.copy_(b)
    assert gv.data_ptr() % 16 and bv.data_ptr() % 16
    want = norm_cuda.layer_norm_fwd(x, g, b)
    got = norm_cuda.layer_norm_fwd(x, gv, bv)
    want_bwd = norm_cuda.layer_norm_bwd(x, g, want[1], want[2], do)
    got_bwd = norm_cuda.layer_norm_bwd(x, gv, got[1], got[2], do)
    torch.cuda.synchronize()
    for a, w in zip(got + got_bwd, want + want_bwd):
        assert torch.equal(a, w)


def _ce_inputs(n, v, dtype, seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy((3.0 * rng.standard_normal((n, v)))
                         .astype(np.float32)).to("cuda", dtype)
    y = torch.from_numpy(rng.integers(0, v, (n, 1)).astype(np.int32)).cuda()
    g = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).cuda()
    return x, y, g


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_ce_kernels_match_plain(dtype):
    """E1, E2 and E3 against their plain versions: lse and nll (f32, sums
    of up to 50304 terms in other orders) within 1e-4; dlogits within one
    ulp of |ref| in the logits' dtype plus a small share of the RMS."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    for n, v in [(8, 128), (64, 1024), (16, 50304)]:
        x, y, g = _ce_inputs(n, v, dtype, seed=20)
        y[0, 0] = v - 1
        counts = (ce_cuda.ce_lse_launches, ce_cuda.ce_fwd_launches,
                  ce_cuda.ce_bwd_launches)
        lse = ce_cuda.lse_fwd(x)
        nll, lse2 = ce_cuda.ce_fwd(x, y)
        dx = ce_cuda.ce_bwd(x, y, lse2, g)
        torch.cuda.synchronize()
        assert (ce_cuda.ce_lse_launches - counts[0],
                ce_cuda.ce_fwd_launches - counts[1],
                ce_cuda.ce_bwd_launches - counts[2]) == (1, 1, 1)
        r_nll, r_lse = ce_cuda.softmax_ce_reference(x, y)
        for got, want in ((lse, r_lse), (lse2, r_lse), (nll, r_nll)):
            torch.testing.assert_close(got, want, atol=1e-4, rtol=0)
        r_dx = ce_cuda.softmax_ce_bwd_reference(x, y, r_lse, g)
        assert dx.dtype == dtype
        # f16's ulp is finer than bf16's, which _close allows for both
        _close(dx, r_dx, torch.float32 if dtype == torch.float32
               else torch.bfloat16, "dlogits %s %s" % ((n, v), dtype))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_softmax_kernel_matches_plain(dtype):
    """F against its plain version: rows in registers (8 and 64 rows),
    staged rows (up to 220 KB) and rows read twice (f32 rows of
    65536)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    rng = np.random.default_rng(21)
    for shape in [(8, 128), (64, 1024), (8, 50304), (2, 65536)]:
        x = torch.from_numpy((3.0 * rng.standard_normal(shape))
                             .astype(np.float32)).to("cuda", dtype)
        before = norm_cuda.softmax_fwd_launches
        got = norm_cuda.softmax_pallas(x)
        torch.cuda.synchronize()
        assert norm_cuda.softmax_fwd_launches == before + 1
        assert got.dtype == dtype and got.shape == x.shape
        _close(got, norm_cuda._softmax_reference(x), dtype,
               "softmax %s" % (shape,))


# Kernel F at every launch plan: a warp a row (rows >= 1024 at F <= 1024,
# or F <= 256), 128 threads a row (few rows at F <= 1024, or F <= 4096),
# 256 (F <= 8192), with 1, 2 or 4 packs a thread; past the register plan
# (F = 8320, 50304, 65536) the staged kernel, 1024 threads a row below
# 132 rows and 256 from there, rows kept in shared memory up to 220 KB
# (an f32 row of 65536 is read twice)
SOFTMAX_PLAN_SHAPES = [(8, 128), (16384, 128), (8, 1024), (200, 1024),
                       (8192, 1024), (16384, 1024), (1024, 512),
                       (8, 4096), (1024, 4096), (8, 8192), (200, 8192),
                       (8, 8320), (64, 8320), (200, 8320), (8, 50304),
                       (64, 50304), (200, 65536)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_softmax_kernel_matches_plain_at_every_plan(dtype):
    """F against its plain version at every row count and width of
    SOFTMAX_PLAN_SHAPES: within one ulp of |ref| in the dtype plus a
    small share of the RMS (f32 statistics summed in other orders), and
    a second run on the same input gives the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    rng = np.random.default_rng(22)
    for shape in SOFTMAX_PLAN_SHAPES:
        x = torch.from_numpy((3.0 * rng.standard_normal(shape))
                             .astype(np.float32)).to("cuda", dtype)
        before = norm_cuda.softmax_fwd_launches
        got = norm_cuda.softmax_pallas(x)
        again = norm_cuda.softmax_pallas(x)
        torch.cuda.synchronize()
        assert norm_cuda.softmax_fwd_launches == before + 2
        assert got.dtype == dtype and got.shape == x.shape
        _close(got, norm_cuda._softmax_reference(x), dtype,
               "softmax %s %s" % (shape, dtype))
        assert torch.equal(got, again), "softmax %s %s: reruns differ" % (
            shape, dtype)


@pytest.mark.gpu
def test_softmax_kernel_copies_strided_views_and_refuses_unaligned_rows():
    """A strided view of x is copied to dense rows first and gives the
    bits of its dense copy; a dense view that does not start on 16 bytes
    raises, as the kernel reads rows with 16-byte loads."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    rng = np.random.default_rng(23)
    x = torch.from_numpy(rng.standard_normal((64, 1024))
                         .astype(np.float32)).to("cuda", torch.bfloat16)
    strided = x[::2]
    assert not strided.is_contiguous()
    got = norm_cuda.softmax_pallas(strided)
    want = norm_cuda.softmax_pallas(strided.contiguous())
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    buf = torch.empty(32 * 1024 + 1, device="cuda", dtype=torch.bfloat16)
    view = buf[1:].view(32, 1024)
    view.copy_(x[:32])
    assert view.is_contiguous() and view.data_ptr() % 16
    with pytest.raises(ValueError, match="16-byte aligned"):
        norm_cuda.softmax_pallas(view)


@pytest.mark.gpu
@pytest.mark.parametrize("flag", ["use_pallas_ce", "use_pallas_lse"])
def test_cross_entropy_routes_join_autograd_on_the_card(flag, monkeypatch):
    """Under each flag the GPT criterion's cross entropy launches its
    kernels and its loss and logits gradient match the plain route's,
    ignored labels included."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.utils import flags
    # V = 1024: the lse route's chunk must reach 1024 lanes
    x, y, _g = _ce_inputs(64, 1024, torch.float32, seed=22)
    assert ce_cuda.supported(64, 1024) and ce_cuda.lse_supported(64, 1024, 4)
    x = x.reshape(4, 16, 1024).requires_grad_()
    labels = y.reshape(4, 16).long()
    labels[1, 3] = labels[2, 15] = -100
    want = F.cross_entropy(x, labels)
    (want_grad,) = torch.autograd.grad(want, x)
    monkeypatch.setitem(flags._REGISTRY, flag, True)
    counts = (ce_cuda.ce_lse_launches, ce_cuda.ce_fwd_launches,
              ce_cuda.ce_bwd_launches)
    got = F.cross_entropy(x, labels)
    assert got.grad_fn is not None
    (got_grad,) = torch.autograd.grad(got, x)
    launched = (ce_cuda.ce_lse_launches - counts[0],
                ce_cuda.ce_fwd_launches - counts[1],
                ce_cuda.ce_bwd_launches - counts[2])
    assert launched == ((0, 1, 1) if flag == "use_pallas_ce" else (1, 0, 0))
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    torch.testing.assert_close(got_grad, want_grad, atol=1e-6, rtol=1e-5)
    assert float(got_grad[1, 3].abs().max()) == 0.0


@pytest.fixture
def _tune_cache(tmp_path, monkeypatch):
    """An autotune cache of the test's own, clean memos, no pins and
    tuning off: nothing reads or writes the user's default cache."""
    from paddle_tpu_torch.kernels import autotune as at
    from paddle_tpu_torch.utils import flags
    monkeypatch.setenv("PADDLE_TPU_AUTOTUNE_CACHE",
                       str(tmp_path / "autotune.json"))
    monkeypatch.delenv("PADDLE_TPU_AUTOTUNE", raising=False)
    monkeypatch.delenv("PADDLE_TPU_AUTOTUNE_PIN", raising=False)
    monkeypatch.setitem(flags._REGISTRY, "autotune", False)
    monkeypatch.setitem(flags._REGISTRY, "autotune_pin", "")
    monkeypatch.setattr(at, "_MEMO", {})
    monkeypatch.setattr(at, "_MEMO_DEFAULT", {})
    monkeypatch.setattr(at, "_RESOLVED", {})
    monkeypatch.setattr(at, "_CACHE", None)
    monkeypatch.setattr(at, "_CACHE_LOADED_FROM", None)
    return at


def _pipelined_smem_c(d, bq, bk, dtype):
    """A''s shared memory as the C side counts it: the tensor-core kernel's
    for 16-bit inputs, the 3 x TF32 kernel's for f32."""
    from paddle_tpu_torch.kernels import _build
    lib = _build.library()
    if dtype in fac._TC_DTYPES:
        return lib.paddle_flash_fwd_pipelined_tc_smem(d, bq, bk)
    return lib.paddle_flash_fwd_pipelined_smem(d, bq, bk, fac._DTYPES[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("blocks", [(64, 32), (64, 64), (128, 64),
                                    (128, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_pipelined_kernel_matches_plain(dtype, blocks):
    """Kernel A' at each of its instantiations, causal and not, D 64, 128
    and 256, against its plain version (out and lse): the TMA-fed
    tensor-core kernel in bf16 and fp16, the 3 x TF32 kernel in f32; a
    configuration whose shared memory exceeds a block's is refused by the
    gate and never launched, and the C side's size agrees with the
    gate's."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from paddle_tpu_torch.kernels import autotune as at
    torch.backends.cuda.matmul.allow_tf32 = False
    bq, bk = blocks
    limit = at.smem_limit(torch.device("cuda"))
    for shape in [(1, 256, 4, 64), (2, 256, 2, 128), (1, 128, 2, 256)]:
        d = shape[-1]
        need = fac.pipelined_smem_bytes(d, bq, bk, dtype)
        assert _pipelined_smem_c(d, bq, bk, dtype) == need
        if need > limit:
            cand = {"variant": "pipelined",
                    "config": {"block_q": bq, "block_k": bk}}
            # candidate [0]: the tensor-core forward in 16-bit, A in f32
            assert fac._sane_fwd_spec(
                cand, shape[1], shape[1], d, dtype, True, True,
                limit) == fac._fwd_specs(shape[1], shape[1], d, dtype,
                                         True)[0]
            continue
        q, k, v = (torch.from_numpy(a).to("cuda", dtype)
                   for a in _qkv(shape, seed=30))
        scale = 1.0 / d ** 0.5
        for causal in (False, True):
            before = fac.flash_fwd_pipelined_launches
            out, lse = fac._launch_pipelined(q, k, v, causal, scale, True,
                                             bq, bk)
            torch.cuda.synchronize()
            assert fac.flash_fwd_pipelined_launches == before + 1
            ref, ref_lse = fac._flash_tc_reference(q, k, v, causal,
                                                   scale, bq, bk)
            what = "A' %s %s %s causal=%s" % (blocks, shape, dtype, causal)
            _close(out, ref, dtype, what)
            torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=0,
                                       msg=what)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("d", [64, 128, 256])
def test_pipelined_tc_kernel_on_fused_and_unaligned_views(d, dtype):
    """The 16-bit A' reads q/k/v through 4-D tensor maps with the tensors'
    own strides: slices of one fused projection (sequence stride 3 H D)
    match the plain version at every tile that fits, causal and not, with
    the lse asked for or not (out the same either way); views whose rows
    do not start on 16 bytes are copied to aligned ones first, one launch
    each."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from paddle_tpu_torch.kernels import autotune as at
    limit = at.smem_limit(torch.device("cuda"))
    shape = (2, 384, 3, d)
    q, k, v = _fused_qkv(shape, dtype, seed=100 + d)
    scale = d ** -0.5
    for bq, bk in fac._PIPELINED_BLOCKS:
        if fac.pipelined_smem_bytes(d, bq, bk, dtype) > limit:
            continue
        for causal in (False, True):
            ref, ref_lse = fac._flash_tc_reference(q, k, v, causal,
                                                   scale, bq, bk)
            before = fac.flash_fwd_pipelined_launches
            out, lse = fac._launch_pipelined(q, k, v, causal, scale, True,
                                             bq, bk)
            bare, none = fac._launch_pipelined(q, k, v, causal, scale,
                                               False, bq, bk)
            torch.cuda.synchronize()
            assert fac.flash_fwd_pipelined_launches == before + 2
            assert none is None and out.dtype == dtype
            what = "A' fused %s d=%d %s causal=%s" % (dtype, d, (bq, bk),
                                                      causal)
            _close(out, ref, dtype, what)
            torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=0,
                                       msg=what)
            assert torch.equal(out, bare), what
    n = 256 * 2 * d
    flat = torch.from_numpy(np.concatenate(
        [np.zeros(1, np.float32)] + [a.ravel() for a in
                                     _qkv((1, 256, 2, d), seed=110)])).to(
        "cuda", dtype)
    uq, uk, uv = (flat[1 + i * n:1 + (i + 1) * n].view(1, 256, 2, d)
                  for i in range(3))
    assert not fac._aligned(uq)
    before = fac.flash_fwd_pipelined_launches
    out, lse = fac._launch_pipelined(uq, uk, uv, True, scale, True, 64, 64)
    torch.cuda.synchronize()
    assert fac.flash_fwd_pipelined_launches == before + 1
    ref, ref_lse = fac._flash_tc_reference(uq, uk, uv, True, scale,
                                           64, 64)
    _close(out, ref, dtype, "A' unaligned %s d=%d" % (dtype, d))
    torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_pipelined_tc_runs_are_bit_identical(dtype):
    """The 16-bit A' at every tile, 8 runs on one input at (2, 4096, 8,
    64) causal: out and lse equal the first run's bit for bit.  A K/V
    ring that let a slot be read before its copies landed, or refilled
    before its last product retired, would make some run differ."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    q, k, v = _fused_qkv((2, 4096, 8, 64), dtype, seed=120)
    for bq, bk in fac._PIPELINED_BLOCKS:
        first = fac._launch_pipelined(q, k, v, True, 0.125, True, bq, bk)
        for _ in range(7):
            out, lse = fac._launch_pipelined(q, k, v, True, 0.125, True, bq,
                                             bk)
            assert torch.equal(out, first[0]) and torch.equal(lse, first[1]),\
                "A' %s %s: a run differs" % (dtype, (bq, bk))


@pytest.mark.gpu
def test_pipelined_refuses_unaligned_rows(_tune_cache, monkeypatch):
    """A' raises on rows that do not start on 16 bytes; under the pin the
    autotuner's check sends such a call to kernel A instead."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from paddle_tpu_torch.utils import flags
    n = 256 * 2 * 64
    flat = torch.randn(3 * n + 1, device="cuda")
    q, k, v = (flat[1 + i * n:1 + (i + 1) * n].view(1, 256, 2, 64)
               for i in range(3))
    assert not fac._aligned(q, k, v)
    with pytest.raises(ValueError, match="16"):
        fac._launch_pipelined(q, k, v, True, 0.125, True, 64, 64)
    monkeypatch.setitem(flags._REGISTRY, "autotune_pin",
                        "flash_fwd=pipelined")
    counts = (fac.flash_fwd_launches, fac.flash_fwd_pipelined_launches)
    out = fac.flash_attention_bshd(q, k, v, causal=True)
    assert (fac.flash_fwd_launches - counts[0],
            fac.flash_fwd_pipelined_launches - counts[1]) == (1, 0)
    ref, _ = fac._flash_reference(q, k, v, True, 0.125)
    _close(out, ref, torch.float32, "unaligned under the pin")


@pytest.mark.gpu
def test_pinned_pipelined_attention_joins_autograd(_tune_cache, monkeypatch):
    """Under ``flash_fwd=pipelined:block_q=128,block_k=64`` the model's
    attention launches A' (not A), and its gradients match the plain
    route's."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.utils import flags
    monkeypatch.setitem(flags._REGISTRY, "autotune_pin",
                        "flash_fwd=pipelined:block_q=128,block_k=64")
    q, k, v = (torch.from_numpy(a).to("cuda").requires_grad_()
               for a in _qkv((2, 256, 4, 64), seed=31))
    ct = torch.from_numpy(_qkv((2, 256, 4, 64), seed=32)[0]).to("cuda")
    counts = (fac.flash_fwd_launches, fac.flash_fwd_pipelined_launches)
    out = F.scaled_dot_product_attention(q, k, v, is_causal=True)
    assert (fac.flash_fwd_launches - counts[0],
            fac.flash_fwd_pipelined_launches - counts[1]) == (0, 1)
    got = torch.autograd.grad((out * ct).sum(), (q, k, v))
    want = torch.autograd.grad(
        (F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                        use_flash=False) * ct).sum(),
        (q, k, v))
    for g, w in zip(got, want):
        _close(g, w, torch.float32, "pinned A' grad")


@pytest.mark.gpu
@pytest.mark.parametrize("route", ["merged", "split"])
def test_flash_bwd_32_row_tiles_match_plain(route, _tune_cache,
                                            monkeypatch):
    """The backward kernels' 32-row candidates at D 64 and 128, pinned
    through their autotune families (f32; in bf16 the pin resolves to
    the tensor-core kernels' 64-row tile)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from paddle_tpu_torch.utils import flags
    monkeypatch.setitem(flags._REGISTRY, "autotune_pin", ";".join(
        "%s=base:block_q=32,block_k=32" % f
        for f in ("flash_bwd", "flash_bwd_dq", "flash_bwd_dkv")))
    for dtype in (torch.float32, torch.bfloat16):
        for shape in [(1, 256, 4, 64), (2, 128, 2, 128)]:
            q, k, v, do = (torch.from_numpy(a).to("cuda", dtype)
                           for a in _qkv(shape, seed=33)
                           + _qkv(shape, seed=34)[:1])
            # 16-bit C1 runs on the tensor cores, which have no 32-row
            # tile: the pin falls back to candidate [0]
            assert fac._resolve_bwd(q, True, "flash_bwd") == (
                32 if dtype == torch.float32 else 64)
            scale = 1.0 / shape[-1] ** 0.5
            out, lse = fac.flash_attention_bshd_with_lse(q, k, v, True)
            got = fac.flash_attention_bwd(q, k, v, out, lse, do, True, scale,
                                          route=route)
            torch.cuda.synchronize()
            ref = fac._flash_bwd_reference(q, k, v, out, lse, do, True,
                                           scale)
            for name, g, r in zip(("dq", "dk", "dv"), got, ref):
                _close(g, r, dtype, "32 rows %s %s %s %s"
                       % (route, name, shape, dtype))


@pytest.mark.gpu
def test_tune_flash_fwd_on_the_card(_tune_cache):
    """A real timed selection of flash_fwd at a small key, into the
    test's own cache file: every candidate timed or refused by the
    shared-memory gate, the winner one of them; at an f32 D=256 key the
    gate refuses the A' instantiations that do not fit, and the winner
    is one that does."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    import json
    at = _tune_cache
    for key, want_rejected in (
            (fac.autotune_key(1, 256, 256, 4, 64, torch.bfloat16, True,
                              "cuda"), 0),
            (fac.autotune_key(1, 256, 256, 2, 256, torch.float32, True,
                              "cuda"), 3)):
        cands = fac._fwd_candidates(key)
        chosen = at.tune("flash_fwd", key)
        assert chosen in cands
        with open(at.cache_path()) as f:
            entry = json.load(f)["families"]["flash_fwd"][at.key_str(key)]
        timings = entry["timings"]
        assert sorted(timings) == sorted(at._cand_sig(c) for c in cands)
        rejected = [s for s, t in timings.items()
                    if isinstance(t, str) and t.startswith("rejected: smem")]
        assert len(rejected) == want_rejected, timings
        assert all(isinstance(t, float) for s, t in timings.items()
                   if s not in rejected), timings
        assert at._cand_sig(chosen) not in rejected
        assert at.resolve("flash_fwd", key) == chosen


def _split_case(shape, seed, causal, dtype=torch.bfloat16):
    """bf16 q/k/v, a cotangent, kernel A's (out, lse) and delta."""
    arrays = _qkv(shape, seed=seed) + _qkv(shape, seed=seed + 1)[:1]
    q, k, v, do = (torch.from_numpy(a).to("cuda", dtype) for a in arrays)
    out, lse = fac.flash_attention_bshd_with_lse(q, k, v, causal=causal)
    delta = (do.float() * out.float()).sum(-1)
    return q, k, v, do, out, lse, delta


def _split_launch(q, k, v, do, lse, delta, causal, scale, block=None):
    """C2 then C3, each launch counted once: (dq, dk, dv)."""
    counts = (fac.flash_bwd_dq_launches, fac.flash_bwd_dkv_launches)
    dq = fac._launch_bwd_dq(q, k, v, do, lse, delta, causal, scale,
                            block=block)
    dk, dv = fac._launch_bwd_dkv(q, k, v, do, lse, delta, causal, scale,
                                 block=block)
    torch.cuda.synchronize()
    assert (fac.flash_bwd_dq_launches - counts[0],
            fac.flash_bwd_dkv_launches - counts[1]) == (1, 1)
    return dq, dk, dv


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [64, 128, 256])
def test_split_bf16_kernels_match_plain(d, causal):
    """bf16 C2 and C3 on the tensor cores against the plain backward,
    which rounds P and dS to bf16 where they do; at S 192 the 64-row
    tiles divide S and 128-row ones do not."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    for shape in [(2, 256, 4, d), (1, 192, 2, d)]:
        q, k, v, do, out, lse, delta = _split_case(shape, 40, causal)
        scale = d ** -0.5
        got = _split_launch(q, k, v, do, lse, delta, causal, scale)
        ref = fac._flash_bwd_reference(q, k, v, out, lse, do, causal, scale)
        for name, g, r in zip(("dq", "dk", "dv"), got, ref):
            assert g.dtype == torch.bfloat16 and g.shape == q.shape
            _close(g, r, torch.bfloat16, "split %s %s causal=%s"
                   % (name, shape, causal))


@pytest.mark.gpu
def test_split_bf16_kernels_with_lse_cotangent():
    """The lse cotangent folds into delta; the split route in bf16 holds
    against the plain backward with it."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    for d in (64, 128, 256):
        shape = (1, 256, 4, d)
        q, k, v, do, out, lse, _delta = _split_case(shape, 42, True)
        dlse = torch.from_numpy(_qkv(shape[:3], seed=44)[0]).to("cuda")
        got = fac.flash_attention_bwd(q, k, v, out, lse, do, True, d ** -0.5,
                                      dlse=dlse, route="split")
        ref = fac._flash_bwd_reference(q, k, v, out, lse, do, True,
                                       d ** -0.5, dlse=dlse)
        for name, g, r in zip(("dq", "dk", "dv"), got, ref):
            _close(g, r, torch.bfloat16, "with-lse %s d=%d" % (name, d))


@pytest.mark.gpu
@pytest.mark.parametrize("d,block", [(64, 64), (64, 128), (128, 64),
                                     (256, 64)])
def test_split_bf16_each_tile_pinned(d, block, _tune_cache, monkeypatch):
    """Each tensor-core tile candidate, pinned through the flash_bwd_dq
    and flash_bwd_dkv families, causal or not; the C side's shared memory
    agrees with the Python count."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.utils import flags
    assert _build.library().paddle_flash_bwd_tc_smem(d, block) == \
        fac.split_tc_smem_bytes(d, block)
    monkeypatch.setitem(flags._REGISTRY, "autotune_pin", ";".join(
        "%s=base:block_q=%d,block_k=%d" % (f, block, block)
        for f in ("flash_bwd_dq", "flash_bwd_dkv")))
    for causal in (False, True):
        shape = (2, 256, 2, d)
        q, k, v, do, out, lse, _delta = _split_case(shape, 46, causal)
        for fam in ("flash_bwd_dq", "flash_bwd_dkv"):
            assert fac._resolve_bwd(q, causal, fam) == block
        got = fac.flash_attention_bwd(q, k, v, out, lse, do, causal,
                                      d ** -0.5, route="split")
        torch.cuda.synchronize()
        ref = fac._flash_bwd_reference(q, k, v, out, lse, do, causal,
                                       d ** -0.5)
        for name, g, r in zip(("dq", "dk", "dv"), got, ref):
            _close(g, r, torch.bfloat16, "tile %d %s d=%d causal=%s"
                   % (block, name, d, causal))


@pytest.mark.gpu
def test_split_bf16_unaligned_rows_are_copied():
    """q/k/v/dO rows that do not start on 16 bytes: the wrapper hands the
    tensor-core kernels aligned copies, and the result matches plain."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    shape = (1, 256, 2, 64)
    n = 256 * 2 * 64
    flat = torch.from_numpy(np.concatenate(
        [np.zeros(1, np.float32)] + [a.ravel() for a in
                                     _qkv(shape, seed=48)
                                     + _qkv(shape, seed=49)[:1]])).to(
        "cuda", torch.bfloat16)
    q, k, v, do = (flat[1 + i * n:1 + (i + 1) * n].view(shape)
                   for i in range(4))
    assert not fac._aligned(q)
    out, lse = fac.flash_attention_bshd_with_lse(q, k, v, causal=True)
    delta = (do.float() * out.float()).sum(-1)
    got = _split_launch(q, k, v, do, lse, delta, True, 0.125)
    ref = fac._flash_bwd_reference(q, k, v, out, lse, do, True, 0.125)
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        _close(g, r, torch.bfloat16, "unaligned %s" % name)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [64, 128, 256])
def test_split_bf16_runs_are_bit_identical(d):
    """No atomics: two runs of C2 and C3 on the same inputs give the same
    bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    q, k, v, do, _out, lse, delta = _split_case((2, 512, 4, d), 50, True)
    first = _split_launch(q, k, v, do, lse, delta, True, d ** -0.5)
    again = _split_launch(q, k, v, do, lse, delta, True, d ** -0.5)
    for a, b in zip(first, again):
        assert torch.equal(a, b)


def _fused_qkv(shape, dtype, seed):
    """q, k, v as (B, S, H, D) slices of one fused (B, S, 3 H D) projection,
    as the model hands them over: dense heads, sequence stride 3 H D."""
    b, s, h, d = shape
    rng = np.random.default_rng(seed)
    qkv = torch.from_numpy(rng.standard_normal((b, s, 3 * h * d))
                           .astype(np.float32)).to("cuda", dtype)
    return [qkv[:, :, i * h * d:(i + 1) * h * d].view(b, s, h, d)
            for i in range(3)]


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("d", [64, 128, 256])
def test_tc_forward_matches_plain(d, dtype, causal):
    """The tensor-core forward at each of its tiles against its plain
    version (p rounded to the input dtype before p.v, at the same tiles):
    out within one ulp of |ref| plus 1/64 of the RMS, lse within 1e-3;
    q/k/v strided slices of one fused projection and contiguous ones; S
    384 takes every tile, S 192 only the 64-row ones."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    for shape in [(2, 384, 3, d), (1, 192, 2, d)]:
        fused = _fused_qkv(shape, dtype, seed=60 + d)
        for q, k, v in (fused, [t.contiguous() for t in fused]):
            for bq, bk in fac._TC_FWD_BLOCKS[d]:
                if shape[1] % bq:
                    continue
                before = fac.flash_fwd_tc_launches
                out, lse = fac._launch_tc(q, k, v, causal, d ** -0.5, True,
                                          bq, bk)
                torch.cuda.synchronize()
                assert fac.flash_fwd_tc_launches == before + 1
                ref, ref_lse = fac._flash_tc_reference(q, k, v, causal,
                                                       d ** -0.5, bq, bk)
                assert out.dtype == dtype and out.shape == q.shape
                _close(out, ref, dtype, "tc fwd %s %s tiles %s"
                       % (shape, dtype, (bq, bk)))
                torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=0)


@pytest.mark.gpu
def test_tc_forward_default_route_and_unaligned_rows():
    """A bf16 call with no pin takes the tensor-core forward at candidate
    [0] (never kernel A, which has no bf16); rows that do not start on 16
    bytes are copied to aligned ones first; out=None without lse."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    shape = (1, 256, 2, 64)
    n = 256 * 2 * 64
    flat = torch.from_numpy(np.concatenate(
        [np.zeros(1, np.float32)] + [a.ravel() for a in
                                     _qkv(shape, seed=70)])).to(
        "cuda", torch.bfloat16)
    q, k, v = (flat[1 + i * n:1 + (i + 1) * n].view(shape)
               for i in range(3))
    assert not fac._aligned(q)
    counts = (fac.flash_fwd_launches, fac.flash_fwd_tc_launches)
    out = fac.flash_attention_bshd(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert (fac.flash_fwd_launches - counts[0],
            fac.flash_fwd_tc_launches - counts[1]) == (0, 1)
    ref, _ = fac._flash_tc_reference(q, k, v, True, 0.125, 128, 128)
    _close(out, ref, torch.bfloat16, "unaligned tc fwd")
    with pytest.raises(TypeError, match="float32"):
        fac._launch(q, k, v, True, 0.125, False)


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [64, 128, 256])
def test_split_fp16_kernels_match_plain(d, causal):
    """fp16 C2 and C3 on the tensor cores (f32.f16.f16 products) against
    the plain backward, which rounds P and dS to fp16 where they do, each
    tile pinned; the default route of an fp16 backward is the split one,
    and the merged route (C1, on the tensor cores in fp16 too) matches the
    plain backward as well."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    for shape in [(2, 256, 4, d), (1, 192, 2, d)]:
        q, k, v, do, out, lse, delta = _split_case(shape, 80, causal,
                                                   dtype=torch.float16)
        scale = d ** -0.5
        ref = fac._flash_bwd_reference(q, k, v, out, lse, do, causal, scale)
        for block in fac._TC_BLOCKS[d]:
            if shape[1] % block:
                continue
            got = _split_launch(q, k, v, do, lse, delta, causal, scale,
                                block=block)
            for name, g, r in zip(("dq", "dk", "dv"), got, ref):
                assert g.dtype == torch.float16 and g.shape == q.shape
                _close(g, r, torch.float16, "fp16 split %s %s tile %d"
                       % (name, shape, block))
        counts = (fac.flash_bwd_launches, fac.flash_bwd_dq_launches)
        fac.flash_attention_bwd(q, k, v, out, lse, do, causal, scale)
        assert (fac.flash_bwd_launches - counts[0],
                fac.flash_bwd_dq_launches - counts[1]) == (0, 1)
        got = fac.flash_attention_bwd(q, k, v, out, lse, do, causal, scale,
                                      route="merged")
        torch.cuda.synchronize()
        assert fac.flash_bwd_launches - counts[0] == 1
        for name, g, r in zip(("dq", "dk", "dv"), got, ref):
            assert g.dtype == torch.float16
            _close(g, r, torch.float16, "fp16 merged %s %s" % (name, shape))


@pytest.mark.gpu
@pytest.mark.parametrize("w_dtype", [torch.float32, torch.float16])
def test_layer_norm_kernels_fp16_match_plain(w_dtype):
    """Kernels B and D on fp16 x (fp16 or f32 gamma / beta) against their
    plain versions: out and dx within one fp16 ulp of |ref| plus a small
    share of the RMS, the f32 statistics as in bf16."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    for shape in [(8, 1024), (200, 1024), (24, 136)]:
        x, g, b = _ln_inputs(shape, seed=90)
        do = _ln_inputs(shape, seed=91)[0]
        x, do = (torch.from_numpy(a).to("cuda", torch.float16)
                 for a in (x, do))
        g, b = (torch.from_numpy(a).to("cuda", w_dtype) for a in (g, b))
        counts = (norm_cuda.layer_norm_fwd_launches,
                  norm_cuda.layer_norm_bwd_launches)
        out, mean, rstd = norm_cuda.layer_norm_fwd(x, g, b)
        got = norm_cuda.layer_norm_bwd(x, g, mean, rstd, do)
        torch.cuda.synchronize()
        assert (norm_cuda.layer_norm_fwd_launches - counts[0],
                norm_cuda.layer_norm_bwd_launches - counts[1]) == (1, 1)
        r_out, r_mean, r_rstd = norm_cuda._layer_norm_reference(x, g, b,
                                                                1e-5)
        _close(out, r_out, torch.float16, "fp16 ln out %s" % (shape,))
        torch.testing.assert_close(mean, r_mean, atol=1e-5, rtol=0)
        torch.testing.assert_close(rstd, r_rstd, atol=1e-4, rtol=1e-5)
        ref = norm_cuda._layer_norm_bwd_reference(x, g, mean, rstd, do)
        for name, a, r in zip(("dx", "dgamma", "dbeta"), got, ref):
            assert a.dtype == r.dtype
            _close(a, r, a.dtype, "fp16 ln %s %s" % (name, shape))


def _fp16_steps(model, ids, steps):
    """``steps`` eager AdamW steps of an AMP O2 fp16 GPT under a
    GradScaler: the losses, and whether any step was skipped."""
    from paddle_tpu_torch.amp import GradScaler
    from paddle_tpu_torch.models.gpt import GPTPretrainingCriterion
    from paddle_tpu_torch.optimizer import AdamW
    opt = AdamW(learning_rate=1e-4, weight_decay=0.01,
                parameters=model.parameters())
    scaler = GradScaler(init_loss_scaling=2.0 ** 12)
    crit = GPTPretrainingCriterion()
    losses, skipped = [], []
    for _ in range(steps):
        loss = crit(model(ids), ids)
        scaler.scale(loss).backward()
        scaler.step(opt)
        opt.clear_grad()
        losses.append(float(loss.detach()))
        skipped.append(scaler.last_step_skipped)
    return losses, skipped


@pytest.mark.gpu
@pytest.mark.parametrize("use_norm", [False, True])
def test_fp16_gpt_steps_on_the_tensor_core_kernels(use_norm, monkeypatch):
    """The open fault's case: a GPT under amp.decorate(level="O2",
    dtype="float16") trains on the card through the flash route (the
    tensor-core forward, C2 and C3; never kernel A or C1), with
    use_pallas_norm both ways (B and D on fp16 activations).  Its first
    loss is finite and within 0.5 (chip_smoke.py's FIRST_LOSS_TOL) of the
    bf16 model's from the same weights."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    import copy
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.utils import flags
    monkeypatch.setitem(flags._REGISTRY, "use_pallas_norm", use_norm)
    cfg = GPTConfig(vocab_size=1024, max_position_embeddings=256,
                    hidden_size=256, num_hidden_layers=2,
                    num_attention_heads=4, intermediate_size=512,
                    hidden_dropout_prob=0.0, attention_dropout_prob=0.0)
    base = GPTForCausalLM(cfg, generator=torch.Generator().manual_seed(3))
    ids = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (2, 256))).cuda()
    with torch.no_grad():
        bf16 = amp.decorate(copy.deepcopy(base), level="O2",
                            dtype="bfloat16").cuda()
        from paddle_tpu_torch.models.gpt import GPTPretrainingCriterion
        bf16_loss = float(GPTPretrainingCriterion()(bf16(ids), ids))
    model = amp.decorate(copy.deepcopy(base), level="O2",
                         dtype="float16").cuda()
    names = ("flash_fwd_launches", "flash_fwd_tc_launches",
             "flash_bwd_launches", "flash_bwd_dq_launches",
             "flash_bwd_dkv_launches")
    before = [getattr(fac, n) for n in names]
    ln_before = (norm_cuda.layer_norm_fwd_launches,
                 norm_cuda.layer_norm_bwd_launches)
    losses, skipped = _fp16_steps(model, ids, 3)
    torch.cuda.synchronize()
    launched = [getattr(fac, n) - b for n, b in zip(names, before)]
    layers = cfg.num_hidden_layers
    assert launched == [0, 3 * layers, 0, 3 * layers, 3 * layers], launched
    n_ln = (2 * layers + 1) * 3 if use_norm else 0
    assert (norm_cuda.layer_norm_fwd_launches - ln_before[0],
            norm_cuda.layer_norm_bwd_launches - ln_before[1]) == (n_ln, n_ln)
    assert all(np.isfinite(losses)) and not any(skipped), (losses, skipped)
    assert abs(losses[0] - bf16_loss) < 0.5, (losses[0], bf16_loss)


@pytest.mark.gpu
def test_bf16_default_backward_is_bit_identical():
    """The default bf16 backward is the split pair, which sums without
    atomics: two runs through autograd give the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    shape = (2, 512, 4, 64)
    q, k, v = (torch.from_numpy(a).to("cuda", torch.bfloat16)
               for a in _qkv(shape, seed=95))
    ct = torch.from_numpy(_qkv(shape, seed=96)[0]).to("cuda", torch.bfloat16)
    runs = []
    for _ in range(2):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        out = fac.flash_attention_bshd(*leaves, causal=True)
        runs.append(torch.autograd.grad(out, leaves, ct))
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("d", [64, 128, 256])
def test_merged_tc_kernel_matches_plain(d, dtype):
    """C1 on the tensor cores at each of its tiles, causal and not,
    against the plain backward (which rounds P and dS where it does);
    q/k/v slices of one fused projection; its dK and dV bit-identical
    across two calls (dQ's atomics may reorder); the C side's shared
    memory agrees with the Python count."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from paddle_tpu_torch.kernels import _build
    b, s, h = 2, 256, 2
    q, k, v = _fused_qkv((b, s, h, d), dtype, seed=120 + d)
    do = torch.from_numpy(_qkv((b, s, h, d), seed=121)[0]).to("cuda", dtype)
    scale = d ** -0.5
    for block in fac._TC_BLOCKS[d]:
        assert _build.library().paddle_flash_bwd_merged_tc_smem(d, block) \
            == fac.merged_tc_smem_bytes(d, block)
        for causal in (False, True):
            out, lse = fac.flash_attention_bshd_with_lse(q, k, v, causal)
            delta = (do.float() * out.float()).sum(-1)
            ref = fac._flash_bwd_reference(q, k, v, out, lse, do, causal,
                                           scale)
            before = fac.flash_bwd_launches
            first = fac._launch_bwd_merged(q, k, v, do, lse, delta, causal,
                                           scale, block=block)
            again = fac._launch_bwd_merged(q, k, v, do, lse, delta, causal,
                                           scale, block=block)
            torch.cuda.synchronize()
            assert fac.flash_bwd_launches == before + 2
            for name, g, r in zip(("dq", "dk", "dv"), first, ref):
                assert g.dtype == dtype and g.shape == q.shape
                _close(g, r, dtype, "C1 %s d=%d tile %d %s causal=%s"
                       % (name, d, block, dtype, causal))
            assert torch.equal(first[1], again[1])
            assert torch.equal(first[2], again[2])


def _f32_launch(which, q, k, v, do, lse, delta, causal, scale, block):
    """One f32 kernel, its launch counted once: C1 (dq, dk, dv), C2 (dq,)
    or C3 (dk, dv)."""
    launch, counter = {
        "C1": (fac._launch_bwd_merged, "flash_bwd_launches"),
        "C2": (fac._launch_bwd_dq, "flash_bwd_dq_launches"),
        "C3": (fac._launch_bwd_dkv, "flash_bwd_dkv_launches")}[which]
    before = getattr(fac, counter)
    got = launch(q, k, v, do, lse, delta, causal, scale, block=block)
    torch.cuda.synchronize()
    assert getattr(fac, counter) == before + 1
    return got if isinstance(got, tuple) else (got,)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [64, 128, 256])
def test_f32_bwd_kernels_match_plain_at_every_tile(d):
    """The f32 C1, C2 and C3 (3 x TF32 on the tensor cores) at each of
    their tiles, S 192 and 1024, causal and not, q/k/v slices of one
    fused projection and a nonzero lse cotangent, against the plain
    backward at the f32 bars (1e-5 relative plus 1e-4 of the reference's
    RMS); C2, C3 and C1's dK and dV give the same bits twice; the C side's
    shared memory fits a block."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from paddle_tpu_torch.kernels import _build
    torch.backends.cuda.matmul.allow_tf32 = False
    f32 = torch.float32
    lib = _build.library()
    for block in fac._bwd_blocks(d, f32):
        for which in range(3):
            assert 0 < lib.paddle_flash_bwd_smem(which, d, block) <= 232448
    assert lib.paddle_flash_bwd_smem(0, 256, 64) == -1
    for s in (192, 1024):
        q, k, v = _fused_qkv((1, s, 2, d), f32, seed=130 + d)
        do, dlse = (torch.from_numpy(a).to("cuda") for a in
                    (_qkv((1, s, 2, d), seed=131)[0],
                     _qkv((1, s, 2), seed=132)[0]))
        scale = d ** -0.5
        for causal in (False, True):
            out, lse = fac.flash_attention_bshd_with_lse(q, k, v, causal)
            delta = (do * out).sum(-1) - dlse
            ref = fac._flash_bwd_reference(q, k, v, out, lse, do, causal,
                                           scale, dlse=dlse)
            for block in fac._bwd_blocks(d, f32):
                if s % block:
                    continue
                args = (q, k, v, do, lse, delta, causal, scale, block)
                what = "d=%d s=%d tile %d causal=%s" % (d, s, block, causal)
                c1 = _f32_launch("C1", *args)
                c1_again = _f32_launch("C1", *args)
                split = (_f32_launch("C2", *args)
                         + _f32_launch("C3", *args))
                split_again = (_f32_launch("C2", *args)
                               + _f32_launch("C3", *args))
                for name, g1, g2, r in zip(("dq", "dk", "dv"), c1, split,
                                           ref):
                    assert g1.dtype == f32 and g1.shape == q.shape
                    _close(g1, r, f32, "C1 %s %s" % (name, what))
                    _close(g2, r, f32, "split %s %s" % (name, what))
                assert torch.equal(c1[1], c1_again[1])
                assert torch.equal(c1[2], c1_again[2])
                for a, b in zip(split, split_again):
                    assert torch.equal(a, b)


@pytest.mark.gpu
def test_f32_bwd_unaligned_rows_are_copied():
    """f32 q/k/v/dO rows that do not start on 16 bytes: the wrapper hands
    the kernels (16-byte async copies) aligned copies, and C1, C2 and C3
    match the plain backward."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    shape = (1, 256, 2, 64)
    n = 256 * 2 * 64
    flat = torch.from_numpy(np.concatenate(
        [np.zeros(1, np.float32)] + [a.ravel() for a in
                                     _qkv(shape, seed=134)
                                     + _qkv(shape, seed=135)[:1]])).to("cuda")
    q, k, v, do = (flat[1 + i * n:1 + (i + 1) * n].view(shape)
                   for i in range(4))
    assert not fac._aligned(q)
    out, lse = fac.flash_attention_bshd_with_lse(q, k, v, causal=True)
    ref = fac._flash_bwd_reference(q, k, v, out, lse, do, True, 0.125)
    for route in ("merged", "split"):
        got = fac.flash_attention_bwd(q, k, v, out, lse, do, True, 0.125,
                                      route=route)
        torch.cuda.synchronize()
        for name, g, r in zip(("dq", "dk", "dv"), got, ref):
            _close(g, r, torch.float32, "unaligned %s %s" % (route, name))


@pytest.mark.gpu
def test_f32_bwd_route_at_s16384():
    """At S = 16384 (2 heads of 64) f32 takes the JAX package's route, the
    split pair C2 + C3, and matches the plain backward."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    shape = (1, 16384, 2, 64)
    q, k, v = _fused_qkv(shape, torch.float32, seed=136)
    do = torch.from_numpy(_qkv(shape, seed=137)[0]).to("cuda")
    out, lse = fac.flash_attention_bshd_with_lse(q, k, v, causal=True)
    counts = (fac.flash_bwd_launches, fac.flash_bwd_dq_launches,
              fac.flash_bwd_dkv_launches)
    got = fac.flash_attention_bwd(q, k, v, out, lse, do, True, 0.125)
    torch.cuda.synchronize()
    assert (fac.flash_bwd_launches - counts[0],
            fac.flash_bwd_dq_launches - counts[1],
            fac.flash_bwd_dkv_launches - counts[2]) == (0, 1, 1)
    ref = fac._flash_bwd_reference(q, k, v, out, lse, do, True, 0.125)
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        _close(g, r, torch.float32, "S=16384 %s" % name)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [64, 128, 256])
def test_f32_fwd_kernel_matches_plain_on_fused_and_unaligned_views(d):
    """Kernel A in f32 (3 x TF32 on the tensor cores) at S 192 and 1024,
    causal and not, on q/k/v slices of one fused projection: against the
    plain forward at the f32 bars (1e-5 relative plus 1e-4 of the
    reference's RMS), lse within 1e-3, one launch a call, out the same
    with the lse asked for or not; two runs give the same bits (the
    forward has no atomics).  Views whose rows do not start on 16 bytes
    are copied to aligned ones first, one launch each."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    f32 = torch.float32
    scale = d ** -0.5
    for s in (192, 1024):
        q, k, v = _fused_qkv((2, s, 3, d), f32, seed=160 + d)
        for causal in (False, True):
            before = fac.flash_fwd_launches
            out, lse = fac._launch(q, k, v, causal, scale, True)
            again, lse_again = fac._launch(q, k, v, causal, scale, True)
            bare, none = fac._launch(q, k, v, causal, scale, False)
            torch.cuda.synchronize()
            assert fac.flash_fwd_launches == before + 3
            assert none is None and out.dtype == f32
            what = "A d=%d s=%d causal=%s" % (d, s, causal)
            ref, ref_lse = fac._flash_reference(q, k, v, causal, scale)
            _close(out, ref, f32, what)
            torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=0,
                                       msg=what)
            assert torch.equal(out, again) and torch.equal(lse, lse_again)
            assert torch.equal(out, bare), what
    n = 256 * 2 * d
    flat = torch.from_numpy(np.concatenate(
        [np.zeros(1, np.float32)] + [a.ravel() for a in
                                     _qkv((1, 256, 2, d), seed=161)])).to(
        "cuda")
    uq, uk, uv = (flat[1 + i * n:1 + (i + 1) * n].view(1, 256, 2, d)
                  for i in range(3))
    assert not fac._aligned(uq)
    before = fac.flash_fwd_launches
    out, lse = fac.flash_attention_bshd_with_lse(uq, uk, uv, causal=True)
    torch.cuda.synchronize()
    assert fac.flash_fwd_launches == before + 1
    ref, ref_lse = fac._flash_reference(uq, uk, uv, True, scale)
    _close(out, ref, f32, "A unaligned d=%d" % d)
    torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=0)


@pytest.mark.gpu
def test_f32_pipelined_kernel_on_fused_views_is_bit_identical():
    """The f32 A' (3 x TF32, a ring of three stages where they fit) at
    every tile that fits a block, D 64, 128 and 256, on slices of one
    fused projection, causal and not: against its plain version at the
    f32 bars, lse within 1e-3, and two runs bit-identical."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from paddle_tpu_torch.kernels import autotune as at
    torch.backends.cuda.matmul.allow_tf32 = False
    f32 = torch.float32
    limit = at.smem_limit(torch.device("cuda"))
    for d in (64, 128, 256):
        q, k, v = _fused_qkv((2, 384, 3, d), f32, seed=170 + d)
        scale = d ** -0.5
        for bq, bk in fac._PIPELINED_BLOCKS:
            if fac.pipelined_smem_bytes(d, bq, bk, f32) > limit:
                continue
            for causal in (False, True):
                out, lse = fac._launch_pipelined(q, k, v, causal, scale,
                                                 True, bq, bk)
                again = fac._launch_pipelined(q, k, v, causal, scale, True,
                                              bq, bk)
                torch.cuda.synchronize()
                what = "f32 A' d=%d %s causal=%s" % (d, (bq, bk), causal)
                ref, ref_lse = fac._flash_tc_reference(q, k, v, causal,
                                                       scale, bq, bk)
                _close(out, ref, f32, what)
                torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=0,
                                           msg=what)
                assert torch.equal(out, again[0]), what
                assert torch.equal(lse, again[1]), what


# ---------------------------------------------------------------------------
# the quantized KV cache on the card (int8 and fp8 e4m3), against the CPU
# ---------------------------------------------------------------------------

def _bytes_of(t):
    """A tensor's bytes on the host, for bitwise comparison."""
    from paddle_tpu_torch.kernels.decode_attention import raw_bytes
    t = t.detach().cpu()
    return raw_bytes(t).numpy() if t.dtype.itemsize == 1 \
        else t.view(torch.int32).numpy()


_CODES = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}


@pytest.mark.gpu
@pytest.mark.parametrize("code", ["int8", "fp8"])
def test_quantize_kv_on_the_card_is_the_cpu_grid(code):
    """Codes and scales bit-identical to the CPU's on the same f32 rows
    (a row of zeros, values past 448 included), and the dequantized
    rows too."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from paddle_tpu_torch.kernels import decode_attention as da
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((8, 24, 16, 64)) * 5).astype(np.float32)
    x[0, 0, 0] = 0.0
    x[1, 2] *= 1e3
    cpu = da.quantize_kv(torch.from_numpy(x), _CODES[code])
    card = da.quantize_kv(torch.from_numpy(x).cuda(), _CODES[code])
    for c, g in zip(cpu, card):
        np.testing.assert_array_equal(_bytes_of(g), _bytes_of(c))
    np.testing.assert_array_equal(
        _bytes_of(da.dequantize_kv(*card, torch.float32)),
        _bytes_of(da.dequantize_kv(*cpu, torch.float32)))


@pytest.mark.gpu
@pytest.mark.parametrize("code", ["int8", "fp8"])
def test_quantized_paged_writes_and_cow_on_the_card(code):
    """The quantized scatter (invalid lanes and padding into the sink
    page) and a copy-on-write of a page, codes and scale rows: the card's
    pools end bit-identical to the CPU's."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from paddle_tpu_torch.kernels.decode_attention import (quantize_kv,
                                                           raw_bytes)
    from paddle_tpu_torch.serving import PagedKVCache, paged_scatter
    rng = np.random.default_rng(1)
    table = torch.tensor([[2, 5], [0, 3]])
    pos = torch.tensor([[1, 5, 9], [3, 4, 7]], dtype=torch.int32)
    valid = torch.tensor([[True, True, True], [False, True, True]])
    new = [torch.from_numpy(rng.standard_normal((2, 3, 4, 64)).astype(
        np.float32)) for _ in range(2)]
    pools = []
    for dev in ("cpu", "cuda"):
        c = PagedKVCache.create(6, 2, 4, 4, 64, 2, 2, device=dev,
                                kv_dtype=code)
        (kq, ks), (vq, vs) = (quantize_kv(n.to(dev), c.k.dtype)
                              for n in new)
        paged_scatter(c.k, c.v, 1, table.to(dev), pos.to(dev),
                      valid.to(dev), kq, vq, c.k_scale, c.v_scale, ks, vs)
        for pool in (c.k, c.v, c.k_scale, c.v_scale):
            raw_bytes(pool)[4] = raw_bytes(pool)[5]        # one CoW
        pools.append((c.k, c.v, c.k_scale, c.v_scale))
    for c, g in zip(*pools):
        np.testing.assert_array_equal(_bytes_of(g), _bytes_of(c))
    assert bool(raw_bytes(pools[1][0])[6].any())            # the sink


@pytest.mark.gpu
@pytest.mark.parametrize("pages_per_block", [0, 2])
@pytest.mark.parametrize("code", ["int8", "fp8"])
def test_q8_attention_on_the_card_matches_the_cpu(code, pages_per_block):
    """The paged q8 gather (one-shot and chunked) and the slotted q8
    attention in f32 on the card against the CPU on identical codes."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from paddle_tpu_torch.kernels import decode_attention as da
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(2)
    B, H, D, P, MP, NP = 8, 16, 64, 64, 4, 40
    q = torch.from_numpy(rng.standard_normal((B, 5, H, D)).astype(np.float32))
    (kp, ks), (vp, vs) = (da.quantize_kv(torch.from_numpy(
        rng.standard_normal((NP, P, H, D)).astype(np.float32)), _CODES[code])
        for _ in range(2))
    table = torch.from_numpy(rng.permutation(NP)[:B * MP].reshape(B, MP))
    pos = torch.tensor([0, 17, 64, 100, 150, 200, 230, 251],
                       dtype=torch.int32)
    ops = (q, kp, vp, table, pos)
    want = da.paged_decode_attention(*ops, pages_per_block=pages_per_block,
                                     k_scales=ks, v_scales=vs)
    got = da.paged_decode_attention(*(t.cuda() for t in ops),
                                    pages_per_block=pages_per_block,
                                    k_scales=ks.cuda(), v_scales=vs.cuda())
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)
    k8, v8 = (p[table].reshape(B, MP * P, H, D) for p in (kp, vp))
    k8s, v8s = (s[table].reshape(B, MP * P, H) for s in (ks, vs))
    bt = 128 if pages_per_block else 0
    want = da.decode_attention(q, k8, v8, pos, k_scales=k8s, v_scales=v8s,
                               block_t=bt)
    got = da.decode_attention(q.cuda(), k8.cuda(), v8.cuda(), pos.cuda(),
                              k_scales=k8s.cuda(), v_scales=v8s.cuda(),
                              block_t=bt)
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("code", ["int8", "fp8"])
def test_quantized_engine_on_the_card_matches_the_cpu(code):
    """A small GPT in f32, quantized paged engine with four drafts a
    verify step: two sharers of a 40-token prompt (a prefix hit, one
    copy-on-write of the tail page with its scale rows), three decode
    steps and one verify step, both engines fed the CPU's tokens; logits
    within 5e-3 of the CPU engine's at every point (a code may round the
    other way where the card's f32 K/V differ in the last bit)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    import copy
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.serving import DecodeEngine
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = GPTConfig(vocab_size=1024, max_position_embeddings=256,
                    hidden_size=256, num_hidden_layers=2,
                    num_attention_heads=4, intermediate_size=512,
                    hidden_dropout_prob=0.0, attention_dropout_prob=0.0)
    base = GPTForCausalLM(cfg, generator=torch.Generator().manual_seed(5))
    prompt = np.random.default_rng(6).integers(0, 1024, (40,))
    args = ([True, True], [0.0] * 2, [0] * 2, [1.0] * 2)
    runs, fed = [], None
    for dev in ("cpu", "cuda"):
        eng = DecodeEngine(copy.deepcopy(base), num_slots=2, max_len=128,
                           page_size=16, kv_dtype=code, spec_k=4,
                           device=dev)
        t0, l0 = eng.prefill(0, prompt, temperature=0.0)
        _t1, l1 = eng.prefill(1, prompt, temperature=0.0)
        logits, toks, inputs = [l0, l1], [t0, t0], []
        for i in range(3):
            toks = toks if fed is None else fed[i]
            inputs.append(toks)
            nt, lg = eng.decode(toks, *args)
            toks = [int(t) for t in nt]
            logits.append(lg)
        toks = toks if fed is None else fed[3]
        inputs.append(toks)
        _e, c, lg = eng.decode_spec(toks, np.asarray([toks * 2] * 2),
                                    *args)
        logits.append(lg.reshape(-1, lg.shape[-1]))
        assert eng.cow_copies == 1 and 1 <= min(c) <= max(c) <= 5
        runs.append([x.float().cpu() for x in logits])
        fed = inputs
    for c, g in zip(*runs):
        torch.testing.assert_close(g, c, atol=5e-3, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("code", ["int8", "fp8"])
def test_slotted_quantized_engine_on_the_card_matches_the_cpu(code):
    """A small GPT in f32, quantized slotted engine: two prompts of two
    buckets (the prefill writes codes and scales, and attends the exact
    K/V), then four decode steps, slot 1 idle at the second (its row is
    written past its frozen length) and at ``max_len`` at the last (the
    append dropped: the last row keeps its value), both engines fed the
    CPU's tokens.  Lengths equal; layer 0's scales within 1e-5 (its rows
    come from the tokens through f32 products alone); codes equal but
    where a card's f32 K/V row differs in the last bit (under 1% of
    them); logits within 5e-3 of the CPU's at every point.  Later
    layers' scales hold within 1e-3: their rows attend codes that may
    round the other way, and one e4m3 step is 1/16 to 1/8 of a value,
    so their amax moves by more than f32 rounding (2.6e-5 read on an
    H100)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    import copy
    from paddle_tpu_torch.kernels.decode_attention import raw_bytes
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.serving import DecodeEngine
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = GPTConfig(vocab_size=1024, max_position_embeddings=256,
                    hidden_size=256, num_hidden_layers=2,
                    num_attention_heads=4, intermediate_size=512,
                    hidden_dropout_prob=0.0, attention_dropout_prob=0.0)
    base = GPTForCausalLM(cfg, generator=torch.Generator().manual_seed(7))
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, 1024, (n,)) for n in (20, 62)]
    params = ([0.0] * 2, [0] * 2, [1.0] * 2)
    active = [[True, True], [True, False], [True, True], [True, True]]
    runs, fed = [], None
    for dev in ("cpu", "cuda"):
        eng = DecodeEngine(copy.deepcopy(base), num_slots=2, max_len=64,
                           paged=False, kv_dtype=code, device=dev)
        firsts = [eng.prefill(i, p, temperature=0.0) for i, p in
                  enumerate(prompts)]
        logits = [f[1] for f in firsts]
        toks, inputs = [int(f[0]) for f in firsts], []
        for i, act in enumerate(active):
            toks = toks if fed is None else fed[i]
            inputs.append(toks)
            nt, lg = eng.decode(toks, act, *params)
            toks = [int(t) for t in nt]
            logits.append(lg)
        c = eng.cache
        runs.append(([x.float().cpu() for x in logits],
                     [p.cpu() for p in (c.k, c.v, c.k_scale, c.v_scale)],
                     c.lengths.cpu()))
        fed = inputs
    (cpu_lg, cpu_pools, cpu_len), (lg, pools, lens) = runs
    assert cpu_len.tolist() == lens.tolist() == [24, 65]
    for c, g in zip(cpu_lg, lg):
        torch.testing.assert_close(g, c, atol=5e-3, rtol=0)
    for c, g in zip(cpu_pools[2:], pools[2:]):
        torch.testing.assert_close(g[:, 0], c[:, 0], atol=0, rtol=1e-5)
        torch.testing.assert_close(g, c, atol=0, rtol=1e-3)
    for c, g in zip(cpu_pools[:2], pools[:2]):
        assert g.dtype == _CODES[code]
        assert (raw_bytes(g) != raw_bytes(c)).float().mean() < 0.01
