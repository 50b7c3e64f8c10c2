"""paddle_tpu_torch LayerNorm: the plain versions of the CUDA kernels held
against the Pallas ``_ln_fwd_kernel`` (interpret mode: out, mean, rstd)
and, through ``jax.grad``, ``_ln_bwd_kernel`` (dx, dgamma, dbeta); the
port's ``layer_norm`` against the JAX ``layer_norm_raw`` with the kernel
flag off and on, its gradients under the flag, the wrappers' input
checks and their CPU route.  The CUDA kernels themselves are held against
the plain versions on the card by tests/test_torch_cuda_kernels.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.kernels import norm_pallas
from paddle_tpu.nn.functional.norm import layer_norm_raw
from paddle_tpu.utils import flags as jax_flags
from paddle_tpu_torch.kernels import _build
from paddle_tpu_torch.kernels import norm_cuda
from paddle_tpu_torch.nn.functional import layer_norm
from paddle_tpu_torch.utils import flags

SHAPES = [(8, 128), (64, 256)]


def _inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * 2.0 + 0.5).astype(np.float32)
    g = (1.0 + 0.1 * rng.standard_normal(shape[-1])).astype(np.float32)
    b = (0.1 * rng.standard_normal(shape[-1])).astype(np.float32)
    return x, g, b


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_pallas_kernel(shape):
    x, g, b = _inputs(shape)
    w_out, w_mean, w_rstd = norm_pallas._ln_core(
        jnp.asarray(x), jnp.asarray(g), jnp.asarray(b), 1e-5,
        norm_pallas.DEFAULT_BLOCK_ROWS, True)
    out, mean, rstd = norm_cuda.layer_norm_fwd(
        torch.from_numpy(x), torch.from_numpy(g), torch.from_numpy(b), 1e-5)
    # same one-pass f32 statistics on both sides; sums run in other orders
    np.testing.assert_allclose(out.numpy(), np.asarray(w_out), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(mean.numpy(), np.asarray(w_mean)[:, 0],
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(rstd.numpy(), np.asarray(w_rstd)[:, 0],
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_layer_norm_matches_jax(shape, use_kernel, monkeypatch):
    x, g, b = _inputs(shape, seed=1)
    x3 = x.reshape(2, shape[0] // 2, shape[1])
    monkeypatch.setitem(flags._REGISTRY, "use_pallas_norm", use_kernel)
    monkeypatch.setitem(jax_flags._REGISTRY, "use_pallas_norm", use_kernel)
    want = layer_norm_raw(jnp.asarray(x3), jnp.asarray(g), jnp.asarray(b),
                          (shape[1],), 1e-5)
    got = layer_norm(torch.from_numpy(x3), [shape[1]], torch.from_numpy(g),
                     torch.from_numpy(b), 1e-5)
    assert got.shape == x3.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


def test_one_pass_and_two_pass_paths_agree(monkeypatch):
    """The kernel route (one-pass variance) and the default route
    (two-pass) differ only by f32 rounding on unit-scale rows."""
    x, g, b = (torch.from_numpy(a) for a in _inputs((64, 256), seed=2))
    monkeypatch.setitem(flags._REGISTRY, "use_pallas_norm", False)
    two = layer_norm(x, [256], g, b)
    monkeypatch.setitem(flags._REGISTRY, "use_pallas_norm", True)
    one = layer_norm(x, [256], g, b)
    torch.testing.assert_close(one, two, atol=1e-5, rtol=0)


def test_bf16_activations_keep_their_dtype():
    x, g, b = _inputs((8, 128), seed=3)
    out, mean, rstd = norm_cuda.layer_norm_fwd(
        torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(g),
        torch.from_numpy(b))
    assert out.dtype == torch.bfloat16
    assert mean.dtype == rstd.dtype == torch.float32


def test_wrapper_checks_and_cpu_route(monkeypatch):
    def no_library():
        raise AssertionError("the CPU route loaded the CUDA library")
    monkeypatch.setattr(_build, "library", no_library)
    monkeypatch.setattr(norm_cuda, "layer_norm_fwd_launches", 0)
    x, g, b = (torch.from_numpy(a) for a in _inputs((8, 128)))
    with pytest.raises(ValueError, match="contiguous"):
        norm_cuda.layer_norm_fwd(x.t().contiguous().t(), g, b)
    with pytest.raises(TypeError, match="dtype"):
        norm_cuda.layer_norm_fwd(x.half(), g, b)
    with pytest.raises(ValueError, match="gamma"):
        norm_cuda.layer_norm_fwd(x, g[:64], b)
    norm_cuda.layer_norm_fwd(x, g, b)
    assert norm_cuda.layer_norm_fwd_launches == 0


BWD_SHAPES = [(32, 128), (64, 256)]


def _jax_ln_grads(x, g, b, ct):
    def loss(x_, g_, b_):
        out = norm_pallas.layer_norm_pallas(
            x_, g_, b_, 1e-5, norm_pallas.DEFAULT_BLOCK_ROWS, True)
        return jnp.sum(out * ct)
    return [np.asarray(a) for a in jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(g), jnp.asarray(b))]


@pytest.mark.parametrize("shape", BWD_SHAPES)
def test_plain_backward_matches_pallas_kernel(shape):
    """_layer_norm_bwd_reference against jax.grad through the Pallas
    _ln_bwd_kernel (interpret mode); JAX's own limit for it is 1e-4."""
    x, g, b = _inputs(shape, seed=5)
    ct = _inputs(shape, seed=6)[0]
    want = _jax_ln_grads(x, g, b, ct)
    xt, gt, bt, ctt = (torch.from_numpy(a) for a in (x, g, b, ct))
    _out, mean, rstd = norm_cuda.layer_norm_fwd(xt, gt, bt)
    got = norm_cuda._layer_norm_bwd_reference(xt, gt, mean, rstd, ctt)
    for name, a, w in zip(("dx", "dgamma", "dbeta"), got, want):
        np.testing.assert_allclose(a.numpy(), w, atol=1e-4, rtol=0,
                                   err_msg=name)


@pytest.mark.parametrize("shape", BWD_SHAPES)
def test_layer_norm_grads_under_the_flag_match_pallas(shape, monkeypatch):
    """The flagged route differentiates through the _LayerNorm autograd
    Function (on the CPU: the plain forward and backward)."""
    monkeypatch.setitem(flags._REGISTRY, "use_pallas_norm", True)
    x, g, b = _inputs(shape, seed=7)
    ct = _inputs(shape, seed=8)[0]
    want = _jax_ln_grads(x, g, b, ct)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (x, g, b)]
    out = layer_norm(leaves[0].reshape(2, -1, shape[1]), [shape[1]],
                     leaves[1], leaves[2])
    assert type(out.grad_fn.next_functions[0][0]).__name__ == \
        "_LayerNormBackward"
    got = torch.autograd.grad((out.reshape(shape) *
                               torch.from_numpy(ct)).sum(), leaves)
    for name, a, w in zip(("dx", "dgamma", "dbeta"), got, want):
        np.testing.assert_allclose(a.numpy(), w, atol=1e-4, rtol=0,
                                   err_msg=name)


def test_backward_wrapper_checks_and_cpu_route(monkeypatch):
    def no_library():
        raise AssertionError("the CPU route loaded the CUDA library")
    monkeypatch.setattr(_build, "library", no_library)
    monkeypatch.setattr(norm_cuda, "layer_norm_bwd_launches", 0)
    x, g, b = (torch.from_numpy(a) for a in _inputs((8, 128)))
    _out, mean, rstd = norm_cuda.layer_norm_fwd(x, g, b)
    with pytest.raises(ValueError, match="dout"):
        norm_cuda.layer_norm_bwd(x, g, mean, rstd, x[:4])
    with pytest.raises(ValueError, match="mean"):
        norm_cuda.layer_norm_bwd(x, g, mean[:4], rstd, x)
    dx, dg, db = norm_cuda.layer_norm_bwd(x, g.to(torch.bfloat16), mean,
                                          rstd, x)
    assert dg.dtype == db.dtype == torch.bfloat16 and dx.dtype == x.dtype
    assert norm_cuda.layer_norm_bwd_launches == 0
