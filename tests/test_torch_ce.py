"""paddle_tpu_torch cross entropy and row softmax against paddle_tpu on the
CPU: the plain versions of the CUDA kernels E1 (logsumexp), E2 / E3
(fused softmax-CE forward / backward) and F (row softmax) held against
the Pallas kernels in interpret mode (``ce_pallas``, ``norm_pallas``),
gradients included; the route predicates against the JAX package's; and
``cross_entropy`` / ``softmax_with_cross_entropy`` / ``nll_loss`` against
the JAX functionals with each kernel flag on (both packages take the
plain route on the CPU).  Inputs are numpy arrays from a seed.  The CUDA
kernels are held against the plain versions on the card by
tests/test_torch_cuda_kernels.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
from paddle_tpu.kernels import ce_pallas, norm_pallas
from paddle_tpu.utils import flags as jax_flags
from paddle_tpu_torch.kernels import _build, ce_cuda, norm_cuda
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.utils import flags

_DT = {"float32": (jnp.float32, torch.float32),
       "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _logits(shape, seed, scale=4.0):
    rng = np.random.default_rng(seed)
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _labels(n, v, seed):
    return np.random.default_rng(seed).integers(0, v, (n, 1)).astype(
        np.int32)


def _both(x, dtype):
    jdt, tdt = _DT[dtype]
    return jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_softmax_ce_matches_pallas(dtype):
    """nll of the plain forward against _fwd_kernel at (32, 384): the
    same bf16 values on both sides, f32 sums in other orders (1e-5 in
    f32, 1e-4 for bf16 inputs, whose logits reach ~16)."""
    x = _logits((32, 384), seed=0)
    y = _labels(32, 384, seed=1)
    jx, tx = _both(x, dtype)
    want = ce_pallas.softmax_ce_pallas(jx, jnp.asarray(y), True)
    nll, lse = ce_cuda.softmax_ce_reference(tx, torch.from_numpy(y))
    tol = 1e-5 if dtype == "float32" else 1e-4
    np.testing.assert_allclose(nll.numpy(), np.asarray(want), atol=tol,
                               rtol=0)
    got = ce_cuda.softmax_ce(tx, torch.from_numpy(y))
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, nll, atol=0, rtol=0)
    torch.testing.assert_close(lse, ce_cuda.logsumexp_reference(tx),
                               atol=0, rtol=0)


def test_softmax_ce_grad_matches_pallas_backward():
    """dlogits through the autograd Function (plain E3 on the CPU) against
    jax.grad through _bwd_kernel, with a per-row cotangent; the limits of
    tests/test_ce_kernel.py."""
    x = _logits((32, 384), seed=2, scale=3.0)
    y = _labels(32, 384, seed=3)
    g = np.random.default_rng(4).standard_normal(32).astype(np.float32)

    def loss(x_):
        return jnp.sum(ce_pallas.softmax_ce_pallas(x_, jnp.asarray(y), True)
                       * jnp.asarray(g))
    want = np.asarray(jax.grad(loss)(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_()
    nll = ce_cuda.softmax_ce(xt, torch.from_numpy(y))
    assert type(nll.grad_fn).__name__ == "_SoftmaxCEBackward"
    (got,) = torch.autograd.grad((nll * torch.from_numpy(g)).sum(), xt)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-4)


def test_plain_logsumexp_and_its_grad_match_pallas():
    """The plain logsumexp against _lse_kernel at (64, 2048) f32 (one
    streamed pass over 2048-wide chunks there), and its gradient against
    jax.grad through logsumexp_pallas's pullback."""
    x = _logits((64, 2048), seed=5)
    g = np.random.default_rng(6).standard_normal(64).astype(np.float32)
    assert ce_cuda.lse_supported(64, 2048, 4)
    want = ce_pallas.logsumexp_pallas(jnp.asarray(x), True)
    want_grad = jax.grad(lambda x_: jnp.sum(
        ce_pallas.logsumexp_pallas(x_, True) * jnp.asarray(g)))(
            jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    got = ce_cuda.logsumexp(xt)
    assert type(got.grad_fn).__name__ == "_LogSumExpBackward"
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5, rtol=0)
    (got_grad,) = torch.autograd.grad((got * torch.from_numpy(g)).sum(), xt)
    np.testing.assert_allclose(got_grad.numpy(), np.asarray(want_grad),
                               atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_softmax_matches_pallas(dtype):
    """The plain row softmax against _softmax_kernel (block_rows 16) at
    (48, 256): f32 statistics on both sides, the output in x's dtype."""
    x = _logits((2, 24, 256), seed=7, scale=2.0)
    jx, tx = _both(x, dtype)
    want = np.asarray(norm_pallas.softmax_pallas(jx, 16, True), np.float32)
    got = norm_cuda.softmax_pallas(tx, 16)
    assert got.shape == tx.shape and got.dtype == tx.dtype
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-5)
    else:
        # both round the same f32 quotient to bf16: at most one bf16 ulp
        # apart where the f32 quotients straddle a rounding boundary
        np.testing.assert_allclose(got.float().numpy(), want, atol=0,
                                   rtol=2.0 ** -7)


def test_softmax_refuses_the_shapes_jax_refuses():
    for shape in [(12, 200), (100, 256), (4, 250), (20, 128)]:
        x = np.zeros(shape, np.float32)
        with pytest.raises(ValueError) as jax_err:
            norm_pallas.softmax_pallas(jnp.asarray(x), 16, True)
        with pytest.raises(ValueError, match="not tileable") as err:
            norm_cuda.softmax_pallas(torch.from_numpy(x), 16)
        assert str(err.value) == str(jax_err.value)
    # the shapes it takes, at the default block rows too
    for shape, rows in [((100, 256), 256), ((16, 128), 8), ((24, 384), 16)]:
        x = np.zeros(shape, np.float32)
        norm_pallas.softmax_pallas(jnp.asarray(x), rows, True)
        norm_cuda.softmax_pallas(torch.from_numpy(x), rows)


def test_softmax_is_forward_only(monkeypatch):
    """With grad enabled and an x that requires grad it raises rather
    than return an output without a grad_fn; the CPU never loads the
    kernel library."""
    def no_library():
        raise AssertionError("the CPU route loaded the CUDA library")
    monkeypatch.setattr(_build, "library", no_library)
    x = torch.zeros(8, 128, requires_grad=True)
    with pytest.raises(RuntimeError, match="forward-only"):
        norm_cuda.softmax_pallas(x)
    with torch.no_grad():
        out = norm_cuda.softmax_pallas(x)
    torch.testing.assert_close(out, torch.full((8, 128), 1 / 128))


def test_route_predicates_equal_jax():
    ns = [1, 8, 16, 24, 32, 64, 96, 128, 256, 512, 1000, 1024, 8191, 8192]
    vs = [128, 256, 384, 1000, 1024, 2048, 4096, 16768, 50257, 50300, 50304,
          81920, 82048, 50304 * 40]
    for n in ns:
        for v in vs:
            assert ce_cuda.supported(n, v) == ce_pallas.supported(n, v), \
                (n, v)
            for itemsize in (2, 4):
                assert ce_cuda.lse_supported(n, v, itemsize) == \
                    ce_pallas.lse_supported(n, v, itemsize), (n, v, itemsize)
                assert ce_cuda._lse_layout(n, v, itemsize) == \
                    ce_pallas._lse_layout(n, v, itemsize), (n, v, itemsize)
    assert ce_cuda.supported(8192, 50304)
    assert ce_cuda._lse_layout(8192, 50304) == (32, 16768)
    for n, v in [(8191, 50304), (8192, 50300)]:
        assert not ce_cuda.supported(n, v)
        assert not ce_cuda.lse_supported(n, v)


def test_wrappers_check_inputs_and_take_the_plain_route_on_the_cpu(
        monkeypatch):
    def no_library():
        raise AssertionError("the CPU route loaded the CUDA library")
    monkeypatch.setattr(_build, "library", no_library)
    for name in ("ce_lse_launches", "ce_fwd_launches", "ce_bwd_launches"):
        monkeypatch.setattr(ce_cuda, name, 0)
    x = torch.from_numpy(_logits((8, 256), seed=8))
    y = torch.from_numpy(_labels(8, 256, seed=9))
    with pytest.raises(ValueError, match="multiple of 128"):
        ce_cuda.lse_fwd(x[:, :200].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        ce_cuda.lse_fwd(x.t().contiguous().t())
    with pytest.raises(TypeError, match="dtype"):
        ce_cuda.lse_fwd(x.double())
    with pytest.raises(ValueError, match="labels"):
        ce_cuda.ce_fwd(x, y.long())
    with pytest.raises(ValueError, match="labels"):
        ce_cuda.ce_fwd(x, y[:4])
    nll, lse = ce_cuda.ce_fwd(x, y)
    with pytest.raises(ValueError, match="g must be"):
        ce_cuda.ce_bwd(x, y, lse, torch.ones(8, dtype=torch.float64))
    dx = ce_cuda.ce_bwd(x.to(torch.bfloat16), y, lse, torch.ones(8))
    assert dx.dtype == torch.bfloat16 and dx.shape == x.shape
    assert (ce_cuda.ce_lse_launches, ce_cuda.ce_fwd_launches,
            ce_cuda.ce_bwd_launches) == (0, 0, 0)


def _jax_flags(monkeypatch, **kw):
    for k, v in kw.items():
        monkeypatch.setitem(flags._REGISTRY, k, v)
        monkeypatch.setitem(jax_flags._REGISTRY, k, v)


@pytest.mark.parametrize("flag", [None, "use_pallas_ce", "use_pallas_lse"])
def test_losses_match_jax_under_each_flag(flag, monkeypatch):
    if flag:
        _jax_flags(monkeypatch, **{flag: True})
    x = _logits((4, 8, 128), seed=10, scale=2.0)
    lab = np.random.default_rng(11).integers(0, 128, (4, 8)).astype(np.int64)
    lab[1, 2] = lab[3, 7] = -100
    jx, jl = paddle.to_tensor(x), paddle.to_tensor(lab)
    tx, tl = torch.from_numpy(x), torch.from_numpy(lab)
    for red in ("mean", "sum", "none"):
        want = JF.cross_entropy(jx, jl, reduction=red).numpy()
        got = F.cross_entropy(tx, tl, reduction=red)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-6,
                                   err_msg=red)
    want_loss, want_sm = JF.softmax_with_cross_entropy(
        jx, paddle.to_tensor(lab[..., None]), return_softmax=True)
    got_loss, got_sm = F.softmax_with_cross_entropy(
        tx, tl[..., None], return_softmax=True)
    assert got_loss.shape == (4, 8, 1)
    np.testing.assert_allclose(got_loss.numpy(), want_loss.numpy(),
                               atol=1e-5, rtol=1e-6)
    np.testing.assert_allclose(got_sm.numpy(), want_sm.numpy(), atol=1e-6,
                               rtol=1e-5)
    np.testing.assert_allclose(
        F.softmax_with_cross_entropy(tx, tl[..., None]).numpy(),
        want_loss.numpy(), atol=1e-5, rtol=1e-6)
    # nll_loss over log-probabilities (N, C), with and without weights
    logp = np.array(jax.nn.log_softmax(jnp.asarray(x.reshape(32, 128)),
                                       axis=-1))
    valid = np.clip(lab.reshape(32), 0, None)
    ignored = valid.copy()
    ignored[5] = -100
    w = np.random.default_rng(12).uniform(0.5, 2.0, 128).astype(np.float32)
    for red in ("mean", "sum", "none"):
        for weight in (None, w):
            # the JAX weighted mean turns an ignored row into NaN (its
            # gather fills it before the mask), so that case runs without
            labels = valid if weight is not None and red == "mean" \
                else ignored
            want = JF.nll_loss(
                paddle.to_tensor(logp), paddle.to_tensor(labels),
                weight=None if weight is None else paddle.to_tensor(weight),
                reduction=red).numpy()
            got = F.nll_loss(
                torch.from_numpy(logp), torch.from_numpy(labels),
                weight=None if weight is None else torch.from_numpy(weight),
                reduction=red)
            np.testing.assert_allclose(got.numpy(), want, atol=1e-5,
                                       rtol=1e-6,
                                       err_msg="%s %s" % (red, weight))
