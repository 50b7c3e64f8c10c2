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
@pytest.mark.parametrize("causal", [False, True])
def test_head_dim_256_forward_and_both_backward_routes_match_plain(causal):
    """Head dim 256 (C1 on 32-row FMA tiles, C2 and C3 on the tensor
    cores): under autograd the forward launches kernel A, and the
    backward, with each route pinned, matches its plain version."""
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
    """F against its plain version, staged rows (up to 220 KB) and rows
    read twice (f32 rows of 65536)."""
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


@pytest.mark.gpu
@pytest.mark.parametrize("blocks", [(64, 32), (64, 64), (128, 64),
                                    (128, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pipelined_kernel_matches_plain(dtype, blocks):
    """Kernel A' at each of its instantiations, causal and not, D 64, 128
    and 256, against its plain version (out and lse); a configuration
    whose shared memory exceeds a block's is refused by the gate and
    never launched, and the C side's size agrees with the gate's."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels import autotune as at
    torch.backends.cuda.matmul.allow_tf32 = False
    bq, bk = blocks
    limit = at.smem_limit(torch.device("cuda"))
    for shape in [(1, 256, 4, 64), (2, 256, 2, 128), (1, 128, 2, 256)]:
        d = shape[-1]
        need = fac.pipelined_smem_bytes(d, bq, bk, dtype)
        assert _build.library().paddle_flash_fwd_pipelined_smem(
            d, bq, bk, fac._DTYPES[dtype]) == need
        if need > limit:
            cand = {"variant": "pipelined",
                    "config": {"block_q": bq, "block_k": bk}}
            assert fac._sane_fwd_spec(cand, shape[1], shape[1], d, dtype,
                                      True, True, limit) == ("base", 64, 64)
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
            ref, ref_lse = fac._flash_pipelined_reference(q, k, v, causal,
                                                          scale, bq, bk)
            what = "A' %s %s %s causal=%s" % (blocks, shape, dtype, causal)
            _close(out, ref, dtype, what)
            torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=0,
                                       msg=what)


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
    through their autotune families."""
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
            assert fac._resolve_bwd(q, True, "flash_bwd") == 32
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
