"""paddle_tpu_torch flash-attention forward: the plain version of the CUDA
kernel held against the Pallas ``_fwd_kernel`` (interpret mode, lse
included), the wrapper's input checks, and the CPU route (a CPU tensor
never reaches the kernel). 
The CUDA kernel itself is held against the plain version on the card by
tests/test_torch_cuda_kernels.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.kernels import flash_attention as jax_fa
from paddle_tpu_torch.kernels import _build
from paddle_tpu_torch.kernels import flash_attention as fa
from paddle_tpu_torch.kernels import flash_attention_cuda as fac

SHAPES = [(1, 128, 2, 64), (2, 256, 4, 64)]   # (B, S, H, D)


def _qkv(shape, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


def _pallas(q, k, v, causal, dtype):
    out, lse = jax_fa.flash_attention_bshd_with_lse(
        *(jnp.asarray(a, dtype) for a in (q, k, v)), causal=causal,
        interpret=True)
    return (np.asarray(jnp.asarray(out, jnp.float32)),
            np.asarray(lse, np.float32))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_pallas_kernel_f32(shape, causal):
    q, k, v = _qkv(shape)
    want_out, want_lse = _pallas(q, k, v, causal, jnp.float32)
    out, lse = fac.flash_attention_bshd_with_lse(
        *(torch.from_numpy(a) for a in (q, k, v)), causal=causal)
    assert out.dtype == torch.float32 and lse.shape == shape[:3]
    # both sides are f32 softmax attention; the Pallas kernel sums in
    # blocks with an online max, so the last bits differ
    np.testing.assert_allclose(out.numpy(), want_out, atol=1e-5, rtol=0)
    np.testing.assert_allclose(lse.numpy(), want_lse, atol=1e-5, rtol=0)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_pallas_kernel_bf16(shape, causal):
    q, k, v = _qkv(shape, seed=1)
    want_out, _ = _pallas(q, k, v, causal, jnp.bfloat16)
    out = fac.flash_attention_bshd(
        *(torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)),
        causal=causal)
    assert out.dtype == torch.bfloat16
    # the Pallas kernel feeds p to the second product in bf16, the plain
    # version keeps it f32; outputs are rounded to bf16 (2^-8 relative)
    np.testing.assert_allclose(out.float().numpy(), want_out, atol=2e-2,
                               rtol=0)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    q, k, v = (torch.from_numpy(a) for a in _qkv((1, 128, 2, 64)))
    bhsd = q.transpose(1, 2).contiguous().transpose(1, 2)  # (H, D) not dense
    with pytest.raises(ValueError, match="dense"):
        fac.flash_attention_bshd(bhsd, k, v)
    # float16 is taken since the tensor-core forward; float64 never is
    with pytest.raises(TypeError, match="dtype"):
        fac.flash_attention_bshd(q.double(), k.double(), v.double())
    with pytest.raises(TypeError, match="dtypes differ"):
        fac.flash_attention_bshd(q, k.to(torch.bfloat16), v)
    d32 = torch.zeros(1, 128, 2, 32)
    with pytest.raises(ValueError, match="head_dim"):
        fac.flash_attention_bshd(d32, d32, d32)
    with pytest.raises(ValueError, match="multiple of 64"):
        fac.flash_attention_bshd(q[:, :96], k[:, :96], v[:, :96])


def test_cpu_tensor_never_touches_the_kernel(monkeypatch):
    def no_library():
        raise AssertionError("the CPU route loaded the CUDA library")
    monkeypatch.setattr(_build, "library", no_library)
    monkeypatch.setattr(fac, "flash_fwd_launches", 0)
    q, k, v = (torch.from_numpy(a) for a in _qkv((1, 128, 2, 64)))
    fac.flash_attention_bshd(q, k, v, causal=True)
    fac.flash_attention_bshd_with_lse(q, k, v)
    assert fac.flash_fwd_launches == 0
    # the dispatch gate sends CPU tensors to the plain path
    assert not fa.supported(q, k)


def test_strided_qkv_slices_match_contiguous():
    """The model hands the kernel q/k/v slices of the fused projection
    (free sequence stride): the plain route must read them as such."""
    rng = np.random.default_rng(3)
    qkv = torch.from_numpy(rng.standard_normal((1, 128, 3 * 128)).astype(
        np.float32))
    q, k, v = (qkv[:, :, i * 128:(i + 1) * 128].reshape(1, 128, 2, 64)
               for i in range(3))
    got = fac.flash_attention_bshd(q, k, v, causal=True)
    want = fac.flash_attention_bshd(q.contiguous(), k.contiguous(),
                                    v.contiguous(), causal=True)
    torch.testing.assert_close(got, want, atol=0, rtol=0)
