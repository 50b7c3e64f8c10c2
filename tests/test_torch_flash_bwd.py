"""paddle_tpu_torch flash-attention backward on the CPU: the plain version
of the CUDA backward kernels held against ``jax.grad`` through the Pallas
kernels (interpret mode), on the merged route and on the split route
(forced the way tests/test_flash_variants.py forces it), with and without
the lse output's cotangent; the port's router against the JAX package's
choice; kernel A's plain version against the long-sequence
``_fwd_kernel_streamed``; and the CPU autograd Function.  The CUDA kernels
themselves are held against the plain version on the card by
tests/test_torch_cuda_kernels.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.kernels import flash_attention_pallas as fap
from paddle_tpu_torch.kernels import _build
from paddle_tpu_torch.kernels import flash_attention as fa
from paddle_tpu_torch.kernels import flash_attention_cuda as fac

SHAPES = [(1, 128, 2, 64), (2, 256, 2, 64)]   # (B, S, H, D)
# f32 on both sides; the Pallas kernels sum in 128-row blocks
ATOL = 1e-5


def _arrays(shape, seed):
    rng = np.random.default_rng(seed)
    q, k, v, ct = (rng.standard_normal(shape).astype(np.float32)
                   for _ in range(4))
    ct_lse = rng.standard_normal(shape[:3]).astype(np.float32)
    return q, k, v, ct, ct_lse


def _jax_grads(q, k, v, ct, causal, dq_budget=None, ct_lse=None):
    def loss(q_, k_, v_):
        old = fap._DQ_SCRATCH_BUDGET
        if dq_budget is not None:
            fap._DQ_SCRATCH_BUDGET = dq_budget
        try:
            if ct_lse is None:
                out = fap.flash_attention_bshd_native(
                    q_, k_, v_, causal=causal, interpret=True)
                return jnp.sum(out * ct)
            out, lse = fap.flash_attention_bshd_with_lse(
                q_, k_, v_, causal=causal, interpret=True)
            return jnp.sum(out * ct) + jnp.sum(lse * ct_lse)
        finally:
            fap._DQ_SCRATCH_BUDGET = old
    grads = jax.grad(loss, argnums=(0, 1, 2))(
        *(jnp.asarray(a) for a in (q, k, v)))
    return [np.asarray(g) for g in grads]


def _port_grads(q, k, v, ct, causal, ct_lse=None):
    q, k, v, ct = (torch.from_numpy(a) for a in (q, k, v, ct))
    out, lse = fac._flash_reference(q, k, v, causal, q.shape[-1] ** -0.5)
    return fac._flash_bwd_reference(
        q, k, v, out, lse, ct, causal, q.shape[-1] ** -0.5,
        dlse=None if ct_lse is None else torch.from_numpy(ct_lse))


@pytest.mark.parametrize("split", [False, True])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_backward_matches_pallas(shape, causal, split):
    """Split: a dq-scratch budget too small for any head group sends JAX
    to _bwd_dq_kernel + _bwd_dkv_kernel."""
    q, k, v, ct, _ = _arrays(shape, seed=0)
    want = _jax_grads(q, k, v, ct, causal, dq_budget=1 if split else None)
    got = _port_grads(q, k, v, ct, causal)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), w, atol=ATOL, rtol=0,
                                   err_msg=name)


@pytest.mark.parametrize("causal", [False, True])
def test_plain_backward_with_lse_cotangent_matches_pallas(causal):
    q, k, v, ct, ct_lse = _arrays((1, 128, 2, 64), seed=1)
    want = _jax_grads(q, k, v, ct, causal, ct_lse=ct_lse)
    got = _port_grads(q, k, v, ct, causal, ct_lse=ct_lse)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), w, atol=ATOL, rtol=0,
                                   err_msg=name)


def test_router_picks_split_where_jax_does():
    seen = set()
    for d in (64, 128):
        for h in (2, 4, 12, 16, 32):
            for s in (128, 1024, 2048, 4096, 8192, 16384, 32768):
                hg_b = fap._pick_head_group(h, d, s)
                _fwd, bwd = fap._resolve_specs(
                    1, s, s, h, d, jnp.float32, True, 128, 128, hg_b, hg_b,
                    variant="base")
                assert fa._bwd_route(s, h, d) == bwd[0], (s, h, d)
                seen.add(bwd[0])
    assert seen == {"merged", "split"}
    # the training shapes: bench (S=1024) merged, long context split
    assert fa._bwd_route(1024, 16, 64) == "merged"
    assert fa._bwd_route(8192, 16, 64) == "merged"
    assert fa._bwd_route(16384, 16, 64) == "split"


@pytest.mark.parametrize("causal", [False, True])
def test_plain_forward_matches_streamed_pallas_forward(causal):
    """Row 2's hold on the CPU: a K/V budget of one byte sends JAX to the
    grid-streamed _fwd_kernel_streamed; kernel A's plain version gives
    its out and lse."""
    q, k, v, _ct, _ = _arrays((1, 256, 2, 64), seed=2)
    old = fap._RESIDENT_KV_BUDGET
    fap._RESIDENT_KV_BUDGET = 1
    try:
        w_out, w_lse = fap.flash_attention_bshd_with_lse(
            *(jnp.asarray(a) for a in (q, k, v)), causal=causal,
            interpret=True)
    finally:
        fap._RESIDENT_KV_BUDGET = old
    out, lse = fac.flash_attention_bshd_with_lse(
        *(torch.from_numpy(a) for a in (q, k, v)), causal=causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(w_out), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(lse.numpy(), np.asarray(w_lse), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("with_lse", [False, True])
def test_cpu_autograd_function_matches_autograd_of_plain(with_lse,
                                                         monkeypatch):
    def no_library():
        raise AssertionError("the CPU route loaded the CUDA library")
    monkeypatch.setattr(_build, "library", no_library)
    q, k, v, ct, ct_lse = _arrays((2, 128, 2, 64), seed=3)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    ct, ct_lse = torch.from_numpy(ct), torch.from_numpy(ct_lse)
    if with_lse:
        out, lse = fac.flash_attention_bshd_with_lse(*leaves, causal=True)
        loss = (out * ct).sum() + (lse * ct_lse).sum()
        fn = fac._FlashAttentionWithLse
    else:
        out = fac.flash_attention_bshd(*leaves, causal=True)
        loss = (out * ct).sum()
        fn = fac._FlashAttention
    assert type(out.grad_fn).__name__ == fn.__name__ + "Backward"
    got = torch.autograd.grad(loss, leaves)
    r_out, r_lse = fac._flash_reference(*leaves, True, 0.125)
    r_loss = (r_out * ct).sum() + ((r_lse * ct_lse).sum() if with_lse
                                   else 0.0)
    want = torch.autograd.grad(r_loss, leaves)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=ATOL, rtol=0)


def test_no_grad_call_saves_nothing():
    """Under inference (the serving engine) the forward takes no autograd
    Function: the output has no grad_fn."""
    q, k, v = (torch.from_numpy(a).requires_grad_()
               for a in _arrays((1, 128, 2, 64), seed=4)[:3])
    with torch.no_grad():
        assert fac.flash_attention_bshd(q, k, v).grad_fn is None
    with torch.inference_mode():
        assert fac.flash_attention_bshd(q.detach(), k.detach(),
                                        v.detach()).grad_fn is None


def test_backward_wrapper_rejects_what_the_kernels_do_not_take():
    q, k, v, ct, _ = (torch.from_numpy(a)
                      for a in _arrays((1, 128, 2, 64), seed=5))
    out, lse = fac._flash_reference(q, k, v, True, 0.125)
    with pytest.raises(ValueError, match="lse"):
        fac.flash_attention_bwd(q, k, v, out, lse[:, :64], ct, True, 0.125)
    with pytest.raises(ValueError, match="dout"):
        fac.flash_attention_bwd(q, k, v, out, lse, ct[:, :64], True, 0.125)
    # the backward kernels take head_dim 64 and 128; on a card a 256 raises
    # NotImplementedError (the card test holds that), on the CPU it takes
    # the plain version
    assert fac.BWD_HEAD_DIMS == (64, 128)
    q, k, v, ct, _ = (torch.from_numpy(a)
                      for a in _arrays((1, 128, 1, 256), seed=6))
    out, lse = fac._flash_reference(q, k, v, True, 0.0625)
    got = fac.flash_attention_bwd(q, k, v, out, lse, ct, True, 0.0625)
    want = fac._flash_bwd_reference(q, k, v, out, lse, ct, True, 0.0625)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
