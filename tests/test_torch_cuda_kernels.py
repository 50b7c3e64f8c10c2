"""The CUDA kernels of paddle_tpu_torch on the card, each held against
its plain PyTorch version at several shapes and dtypes.  Marked ``gpu``:
without an NVIDIA card every test skips.  This file imports no JAX, so it
runs on a machine that has only PyTorch and the CUDA toolkit:

    python -m pytest tests/test_torch_cuda_kernels.py -m gpu -q
"""
import numpy as np
import pytest
import torch

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
        before = fac.flash_fwd_launches
        out, lse = fac.flash_attention_bshd_with_lse(q, k, v, causal=causal)
        torch.cuda.synchronize()
        assert fac.flash_fwd_launches == before + 1
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
    ulp, share = (2.0 ** -7, 2.0 ** -6) if dtype == torch.bfloat16 \
        else (1e-5, 1e-4)
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
def test_head_dim_256_attention_runs_kernel_a_and_its_backward_raises():
    """The backward kernels take head_dim 64 and 128: at 256 the forward
    still launches kernel A under autograd, and differentiating it raises
    rather than taking a plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from paddle_tpu_torch.nn import functional as F
    q, k, v = (torch.from_numpy(a).to("cuda").requires_grad_()
               for a in _qkv((1, 128, 2, 256), seed=17))
    before = fac.flash_fwd_launches
    out = F.scaled_dot_product_attention(q, k, v, is_causal=True)
    assert fac.flash_fwd_launches == before + 1
    assert out.grad_fn is not None
    with pytest.raises(NotImplementedError, match="head_dim 256"):
        torch.autograd.grad(out.sum(), (q, k, v))


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
