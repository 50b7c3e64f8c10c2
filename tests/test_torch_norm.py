"""paddle_tpu_torch LayerNorm: the plain version of the CUDA kernel held
against the Pallas ``_ln_fwd_kernel`` (interpret mode: out, mean, rstd),
the port's ``layer_norm`` against the JAX ``layer_norm_raw`` with the
kernel flag off and on, the wrapper's input checks and its CPU route.
The CUDA kernel itself is held against the plain version on the card by
tests/test_torch_cuda_kernels.py."""
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
