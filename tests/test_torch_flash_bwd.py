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
    for d in (64, 128, 256):
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
    # head_dim 256 takes the kernels on a card (the card tests hold them
    # against the plain version) and the plain version on the CPU
    q, k, v, ct, _ = (torch.from_numpy(a)
                      for a in _arrays((1, 128, 1, 256), seed=6))
    out, lse = fac._flash_reference(q, k, v, True, 0.0625)
    got = fac.flash_attention_bwd(q, k, v, out, lse, ct, True, 0.0625)
    want = fac._flash_bwd_reference(q, k, v, out, lse, ct, True, 0.0625)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def _bf16_close(got, want, what, ulp=2.0 ** -7):
    """bf16 gradients: one bf16 ulp of |ref| (both sides round an f32
    result to bf16, and P and dS to bf16 before their products) plus 1/64
    of the reference's RMS (the two sum in other orders); fp16 ones with
    ``ulp`` one fp16 ulp (2^-10)."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    rms = float(np.sqrt(np.mean(want ** 2)))
    err = np.abs(got - want)
    bad = err > ulp * np.abs(want) + 2.0 ** -6 * rms
    assert not bad.any(), "%s: max err %g (ref rms %g)" % (
        what, float(err.max()), rms)


def _plain_against_pallas_16bit(shape, causal, split, jdt, tdt, ulp):
    """The plain backward in ``tdt`` against jax.grad through the Pallas
    kernels in ``jdt`` (merged, or split as in the f32 test).  Both
    backwards take the JAX forward's residuals (out, lse): the forwards
    round differently (the Pallas forward rounds P before P V)."""
    q, k, v, ct, _ = _arrays(shape, seed=7)
    q, k, v, ct = (jnp.asarray(a).astype(jdt) for a in (q, k, v, ct))

    def fwd(q_, k_, v_):
        return fap.flash_attention_bshd_with_lse(q_, k_, v_, causal=causal,
                                                 interpret=True)

    def loss(q_, k_, v_):
        old = fap._DQ_SCRATCH_BUDGET
        if split:
            fap._DQ_SCRATCH_BUDGET = 1
        try:
            out, _lse = fwd(q_, k_, v_)
            return jnp.sum(out.astype(jnp.float32) * ct.astype(jnp.float32))
        finally:
            fap._DQ_SCRATCH_BUDGET = old
    want = jax.grad(loss, argnums=(0, 1, 2))(q, k, v)
    out, lse = fwd(q, k, v)

    def to_torch(a):
        return torch.from_numpy(np.array(a.astype(jnp.float32)))
    tq, tk, tv, tct, tout = (to_torch(a).to(tdt)
                             for a in (q, k, v, ct, out))
    got = fac._flash_bwd_reference(tq, tk, tv, tout, to_torch(lse), tct,
                                   causal, shape[-1] ** -0.5)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == tdt
        _bf16_close(g.float().numpy(), to_torch(w).numpy(),
                    "%s %s causal=%s split=%s" % (name, shape, causal, split),
                    ulp=ulp)


@pytest.mark.parametrize("split", [False, True])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_backward_matches_pallas_in_bf16(shape, causal, split):
    """bf16 inputs: the plain backward rounds P and dS to bf16 where
    _bwd_head_math does, and holds against jax.grad through the Pallas
    kernels in bf16 (merged, and split as in the f32 test)."""
    _plain_against_pallas_16bit(shape, causal, split, jnp.bfloat16,
                                torch.bfloat16, 2.0 ** -7)


@pytest.mark.parametrize("split", [False, True])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_backward_matches_pallas_in_fp16(shape, causal, split):
    """fp16 inputs, which the merged kernel C1 now takes too: the plain
    backward (the card kernels' reference) rounds P and dS to fp16 where
    _bwd_head_math does, and holds against jax.grad through the Pallas
    kernels in fp16, merged and split, within one fp16 ulp of |ref| plus
    1/64 of the RMS."""
    _plain_against_pallas_16bit(shape, causal, split, jnp.float16,
                                torch.float16, 2.0 ** -10)


@pytest.mark.parametrize("causal", [False, True])
def test_fp16_merged_route_matches_the_f32_plain_backward(causal):
    """On the CPU the fp16 merged route (C1's plain version) returns fp16
    gradients within the fp16 tolerance of tests/test_torch_flash_tc.py
    (4e-3 absolute plus 2^-9 of |ref|) of the f32 plain backward on the
    same (fp16-representable) inputs, and the same as the split route."""
    shape = (1, 256, 2, 64)
    q, k, v, ct, _ = (torch.from_numpy(a).half()
                      for a in _arrays(shape, seed=9))
    out, lse = fac.flash_attention_bshd_with_lse(q, k, v, causal=causal)
    got = fac.flash_attention_bwd(q, k, v, out, lse, ct, causal, 0.125,
                                  route="merged")
    split = fac.flash_attention_bwd(q, k, v, out, lse, ct, causal, 0.125,
                                    route="split")
    want = fac._flash_bwd_reference(*(t.float() for t in (q, k, v, out)),
                                    lse, ct.float(), causal, 0.125)
    for g, sp, w in zip(got, split, want):
        assert g.dtype == torch.float16
        torch.testing.assert_close(g, sp, atol=0, rtol=0)
        torch.testing.assert_close(g.float(), w, atol=4e-3, rtol=2.0 ** -9)


def test_split_candidates_follow_the_dtype():
    """bf16 and fp16 keys list the tensor-core tiles for every backward
    family, the merged one (C1) too (64 then 128 at D 64, 64 at D 128 and
    256); f32 keys list the f32 kernels' 64 and 32 rows, the family's
    faster first at D 64 (32 for C1 and C3, 64 for C2) and 64 at D 128,
    and 32 alone at D 256."""
    def blocks(family, d, dtype):
        key = fac.autotune_key(8, 1024, 1024, 16, d, dtype, True, "cpu")
        return [c["config"]["block_q"]
                for c in fac._at.families()[family].candidates(key)]
    for fam in ("flash_bwd", "flash_bwd_dq", "flash_bwd_dkv"):
        for dt in (torch.bfloat16, torch.float16):
            assert blocks(fam, 64, dt) == [64, 128]
            assert blocks(fam, 128, dt) == [64]
            assert blocks(fam, 256, dt) == [64]
        assert blocks(fam, 64, torch.float32) == (
            [64, 32] if fam == "flash_bwd_dq" else [32, 64])
        assert blocks(fam, 128, torch.float32) == [64, 32]
        assert blocks(fam, 256, torch.float32) == [32]


@pytest.mark.parametrize("family", ["flash_bwd_dq", "flash_bwd_dkv"])
def test_sane_bwd_blocks_is_dtype_aware(family):
    """A stale 32-row pin or cache entry for a bf16 split family resolves
    to candidate [0] (the 64 tensor-core tile); f32 keeps taking it, and
    the merged family, on the tensor cores in bf16 too, does the same."""
    def cand(bm):
        return {"variant": "base", "config": {"block_q": bm, "block_k": bm}}
    bf16, f32 = torch.bfloat16, torch.float32
    assert fac._sane_bwd_blocks(cand(32), 1024, 64, True, bf16,
                                family) == ("base", 64)
    assert fac._sane_bwd_blocks(cand(128), 1024, 64, True, bf16,
                                family) == ("base", 128)
    assert fac._sane_bwd_blocks(cand(128), 1024, 128, True, bf16,
                                family) == ("base", 64)
    assert fac._sane_bwd_blocks(cand(128), 192, 64, True, bf16,
                                family) == ("base", 64)
    assert fac._sane_bwd_blocks(cand(32), 1024, 64, True, f32,
                                family) == ("base", 32)
    assert fac._sane_bwd_blocks(cand(128), 1024, 64, True, f32,
                                family) == (
        "base", 64 if family == "flash_bwd_dq" else 32)
    assert fac._sane_bwd_blocks(cand(32), 1024, 256, True, bf16,
                                family) == ("base", 64)
    assert fac._sane_bwd_blocks(cand(64), 1024, 256, True, f32,
                                family) == ("base", 32)
    assert fac._sane_bwd_blocks(cand(32), 1024, 64, True, bf16,
                                "flash_bwd") == ("base", 64)
    assert fac._sane_bwd_blocks(cand(128), 1024, 64, True, bf16,
                                "flash_bwd") == ("base", 128)
    assert fac._sane_bwd_blocks(cand(32), 1024, 64, True, f32,
                                "flash_bwd") == ("base", 32)


def test_split_bf16_pin_of_32_rows_resolves_to_candidate_0(monkeypatch):
    """Through the autotuner: a 32-row pin for any backward family gives
    the bf16 tensor-core kernels (C1 too) their 64 tile, f32 its 32
    rows."""
    from paddle_tpu_torch.kernels import autotune as at
    from paddle_tpu_torch.utils import flags
    for name in ("_MEMO", "_MEMO_DEFAULT", "_RESOLVED"):
        monkeypatch.setattr(at, name, {})
    monkeypatch.setitem(flags._REGISTRY, "autotune", False)
    monkeypatch.setitem(flags._REGISTRY, "autotune_pin", ";".join(
        "%s=base:block_q=32,block_k=32" % f
        for f in ("flash_bwd", "flash_bwd_dq", "flash_bwd_dkv")))
    q = torch.zeros((1, 256, 2, 64))
    for fam in ("flash_bwd_dq", "flash_bwd_dkv"):
        assert fac._resolve_bwd(q.to(torch.bfloat16), True, fam) == 64
        assert fac._resolve_bwd(q, True, fam) == 32
    assert fac._resolve_bwd(q.to(torch.bfloat16), True, "flash_bwd") == 64
    assert fac._resolve_bwd(q, True, "flash_bwd") == 32


def test_split_tc_smem_bytes_by_hand():
    """The tensor-core kernels' shared memory: 1024 bytes of alignment
    slack, six bf16 tiles, four f32 rows and, at D 256, two f32 score
    tiles."""
    # D 64, 64 rows: 6 tiles of 64 x 64 x 2 B = 49152, rows 4 x 64 x 4
    assert fac.split_tc_smem_bytes(64, 64) == 1024 + 49152 + 1024
    # D 64, 128 rows: 6 x 16384 = 98304, rows 4 x 128 x 4 = 2048
    assert fac.split_tc_smem_bytes(64, 128) == 1024 + 98304 + 2048
    # D 128, 64 rows: 6 x 16384 = 98304, rows 1024
    assert fac.split_tc_smem_bytes(128, 64) == 1024 + 98304 + 1024
    # D 256, 64 rows: 6 x 32768 = 196608, rows 1024, two 64 x 64 x 4 B
    # score tiles 32768: 231424, within the 232448 bytes a block may use
    assert fac.split_tc_smem_bytes(256, 64) == 1024 + 196608 + 1024 + 32768
    assert fac.split_tc_smem_bytes(256, 64) <= 232448


def test_merged_tc_smem_bytes_by_hand():
    """C1 on the tensor cores: at D 64 C3's shared memory and the 16-bit
    dS^T tile (block x block) that dQ reads; at D 128 and 256 (two
    warpgroups share the tile) the f32 exchange of C3 at D 256, whose
    unused half holds the dS^T tile; every tile fits a block."""
    assert fac.merged_tc_smem_bytes(64, 64) == \
        fac.split_tc_smem_bytes(64, 64) + 64 * 64 * 2
    assert fac.merged_tc_smem_bytes(64, 128) == 1024 + 98304 + 2048 + 32768
    # D 128: 6 x 16384, rows 1024, exchange 2 x 64 x 64 x 4
    assert fac.merged_tc_smem_bytes(128, 64) == 1024 + 98304 + 1024 + 32768
    assert fac.merged_tc_smem_bytes(256, 64) == \
        fac.split_tc_smem_bytes(256, 64)
    for d, blocks in fac._TC_BLOCKS.items():
        for bm in blocks:
            assert fac.merged_tc_smem_bytes(d, bm) <= 232448
