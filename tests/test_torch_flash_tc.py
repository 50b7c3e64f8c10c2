"""paddle_tpu_torch's tensor-core flash forward and the 16-bit routes on
the CPU: the forward's plain version ``_flash_tc_reference`` held against
the Pallas ``_fwd_kernel`` in bf16 (interpret mode, lse included), the
forward candidates and their checks by dtype, the tensor-core forward's
shared memory, the card's backward route by dtype, the fp16 calls that
the kernels' wrappers take (flash attention and LayerNorm), bf16
attention through the model's functional forward and backward against
``jax.grad`` through the Pallas kernels, and the build's hash of the
shared CUDA header.  The kernels themselves are held against these plain
versions on the card by tests/test_torch_cuda_kernels.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.kernels import flash_attention_pallas as jax_fap
from paddle_tpu_torch.kernels import _build
from paddle_tpu_torch.kernels import autotune as at
from paddle_tpu_torch.kernels import flash_attention as fa
from paddle_tpu_torch.kernels import flash_attention_cuda as fac
from paddle_tpu_torch.kernels import norm_cuda
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.utils import flags

BF16, F16, F32 = torch.bfloat16, torch.float16, torch.float32
# bf16 out: one bf16 ulp of |ref| (both sides round an f32 result, and p,
# to bf16) plus 1/64 of the reference's RMS (they sum in other orders)
ULP_REL, RMS_FRAC = 2.0 ** -7, 2.0 ** -6
LSE_TOL = 1e-3
# fp16 against the f32 plain version: the inputs and the output rounded to
# fp16 (11 bits: 2^-11 relative each), and p to fp16 before p.v; values of
# unit scale, so 4e-3 absolute plus 2^-9 of |ref| holds them
F16_ATOL, F16_REL = 4e-3, 2.0 ** -9


@pytest.fixture(autouse=True)
def _isolated_cache(tmp_path, monkeypatch):
    """Every test gets its own cache file, clean memos and no pins."""
    monkeypatch.setenv("PADDLE_TPU_AUTOTUNE_CACHE",
                       str(tmp_path / "autotune.json"))
    monkeypatch.delenv("PADDLE_TPU_AUTOTUNE", raising=False)
    monkeypatch.delenv("PADDLE_TPU_AUTOTUNE_PIN", raising=False)
    monkeypatch.setitem(flags._REGISTRY, "autotune", False)
    monkeypatch.setitem(flags._REGISTRY, "autotune_pin", "")
    for name in ("_MEMO", "_MEMO_DEFAULT", "_RESOLVED"):
        monkeypatch.setattr(at, name, {})
    monkeypatch.setattr(at, "_CACHE", None)
    monkeypatch.setattr(at, "_CACHE_LOADED_FROM", None)


def _qkv(shape, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


def _within(got, ref):
    """(max error, share of elements that differ, passes) at ULP_REL x
    |ref| plus RMS_FRAC x the reference's RMS."""
    err = np.abs(got - ref)
    rms = float(np.sqrt(np.mean(ref ** 2)))
    ok = bool((err <= ULP_REL * np.abs(ref) + RMS_FRAC * rms).all())
    return float(err.max()), float((err > 0).mean()), ok


# (shape, the Pallas kernel's tiles): None is its default, one tile of the
# whole sequence at these lengths; (128, 128) walks two K tiles at S 256
TC_CASES = [((1, 256, 2, 64), None), ((1, 256, 2, 64), (128, 128)),
            ((1, 128, 2, 128), None), ((1, 128, 1, 256), None)]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape,tiles", TC_CASES)
def test_tc_reference_matches_pallas_kernel_bf16(shape, tiles, causal):
    """The Pallas _fwd_kernel rounds p to bf16 before p.v relative to the
    running max of its K tiles; _flash_tc_reference does the same at the
    same tiles, so the two differ only where an f32 sum rounds the other
    way (under 0.2% of the elements here), while the unrounding
    _flash_reference differs in about a third of them."""
    q, k, v = _qkv(shape, seed=11)
    kw = {} if tiles is None else dict(block_q=tiles[0], block_k=tiles[1])
    want, want_lse = jax_fap.flash_attention_bshd_with_lse(
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), causal=causal,
        interpret=True, **kw)
    want = np.asarray(jnp.asarray(want, jnp.float32))
    tq, tk, tv = (torch.from_numpy(a).to(BF16) for a in (q, k, v))
    scale = shape[-1] ** -0.5
    bq, bk = tiles or (shape[1], shape[1])
    out, lse = fac._flash_tc_reference(tq, tk, tv, causal, scale, bq, bk)
    assert out.dtype == BF16 and lse.dtype == F32
    assert lse.shape == shape[:3]
    err, share, ok = _within(out.float().numpy(), want)
    assert ok, "out err %g" % err
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse),
                               atol=LSE_TOL, rtol=0)
    plain, _ = fac._flash_reference(tq, tk, tv, causal, scale)
    p_err, p_share, _ = _within(plain.float().numpy(), want)
    assert share < 0.002 and p_share > 0.2, (share, p_share)
    assert err <= p_err


def test_tc_reference_walks_tiles_as_the_pipelined_one():
    """In f32 the rounding of p is exact, so the tensor-core forward's
    plain version is A''s at every tile shape."""
    q, k, v = (torch.from_numpy(a) for a in _qkv((1, 256, 2, 64), seed=12))
    for bq, bk in ((128, 128), (128, 64), (64, 64)):
        for causal in (False, True):
            a = fac._flash_tc_reference(q, k, v, causal, 0.125, bq, bk)
            b = fac._flash_pipelined_reference(q, k, v, causal, 0.125, bq,
                                               bk)
            for x, y in zip(a, b):
                torch.testing.assert_close(x, y, atol=0, rtol=0)


def _fwd(dtype, d=64, s=1024, causal=True):
    key = fac.autotune_key(8, s, s, 16, d, dtype, causal, "cpu")
    return [(c["variant"], c["config"]["block_q"], c["config"]["block_k"])
            for c in fac._fwd_candidates(key)]


def test_fwd_candidates_follow_the_dtype():
    """bf16: the tensor-core tiles (the default first), then A'; fp16: the
    tensor-core tiles alone (A' has no fp16); f32: kernel A, then A'."""
    pipe = [("pipelined",) + bs for bs in fac._PIPELINED_BLOCKS]
    assert _fwd(BF16) == [("base", 128, 128), ("base", 128, 64),
                          ("base", 64, 64)] + pipe
    assert _fwd(BF16, d=128)[:2] == [("base", 128, 64), ("base", 64, 64)]
    assert _fwd(BF16, d=256)[:2] == [("base", 64, 64), ("base", 128, 64)]
    assert _fwd(F16) == [("base", 128, 128), ("base", 128, 64),
                         ("base", 64, 64)]
    assert _fwd(F16, d=256) == [("base", 64, 64), ("base", 128, 64)]
    assert _fwd(F32) == [("base", 64, 64)] + pipe
    # S = 192: no 128-row tile divides it; candidate [0] is 64 x 64
    assert _fwd(F16, s=192) == [("base", 64, 64)]
    assert _fwd(BF16, s=192)[0] == ("base", 64, 64)


def _cand(variant, bq, bk):
    return {"variant": variant, "config": {"block_q": bq, "block_k": bk}}


def test_sane_fwd_spec_is_dtype_aware():
    def sane(cand, dtype, d=64, s=1024, aligned=True, limit=232448):
        return fac._sane_fwd_spec(cand, s, s, d, dtype, True, aligned, limit)
    # an A' tile in fp16 (not instantiated): candidate [0]
    assert sane(_cand("pipelined", 64, 64), F16) == ("base", 128, 128)
    assert sane(_cand("pipelined", 64, 64), F16, d=256) == ("base", 64, 64)
    # the tensor-core tiles in bf16 and fp16, not in f32 (kernel A's 64 x 64)
    for dt in (BF16, F16):
        assert sane(_cand("base", 128, 64), dt) == ("base", 128, 64)
        assert sane(_cand("base", 128, 128), dt, d=256) == ("base", 64, 64)
        assert sane(_cand("iotafree", 64, 64), dt) == ("iotafree", 64, 64)
    assert sane(_cand("base", 128, 128), F32) == ("base", 64, 64)
    assert sane(_cand("pipelined", 128, 64), BF16) == \
        ("pipelined", 128, 64)
    # A' needs aligned rows; the tensor-core forward copies unaligned ones
    assert sane(_cand("pipelined", 128, 64), BF16, aligned=False) == \
        ("base", 128, 128)
    assert sane(_cand("base", 128, 64), BF16, aligned=False) == \
        ("base", 128, 64)
    # more shared memory than a block may use: candidate [0]
    assert sane(_cand("base", 128, 64), BF16, limit=40000) == \
        ("base", 128, 128)
    # a tile that does not divide S
    assert sane(_cand("base", 128, 128), BF16, s=192) == ("base", 64, 64)


def test_fp16_pin_of_an_a_prime_tile_resolves_to_candidate_0(monkeypatch):
    """Through the autotuner: ``flash_fwd=pipelined`` pinned reaches A' in
    f32 and bf16, and candidate [0], the tensor-core forward, in fp16."""
    monkeypatch.setitem(flags._REGISTRY, "autotune_pin",
                        "flash_fwd=pipelined:block_q=64,block_k=64")
    q = torch.zeros((1, 256, 2, 64))
    assert fac._resolve_fwd(q, q, q, True) == ("pipelined", 64, 64)
    qb = q.to(BF16)
    assert fac._resolve_fwd(qb, qb, qb, True) == ("pipelined", 64, 64)
    qh = q.to(F16)
    assert fac._resolve_fwd(qh, qh, qh, True) == ("base", 128, 128)


def test_fwd_tc_smem_bytes_by_hand():
    """1024 bytes of alignment slack, the 16-bit q tile and two stages of
    the K and V tiles; every instantiation fits the 232448 bytes a block
    may use, and the tune() gate prices the candidates by it."""
    # D 64, 128 x 128: q 128 x 64 x 2 = 16384, 4 x 128 x 64 x 2 = 65536
    assert fac.fwd_tc_smem_bytes(64, 128, 128) == 1024 + 16384 + 65536
    # D 128, 128 x 64: q 32768, 4 x 64 x 128 x 2 = 65536
    assert fac.fwd_tc_smem_bytes(128, 128, 64) == 1024 + 32768 + 65536
    # D 256, 64 x 64: q 32768, 4 x 64 x 256 x 2 = 131072
    assert fac.fwd_tc_smem_bytes(256, 64, 64) == 1024 + 32768 + 131072
    # D 256, 128 x 64: 197632, the largest
    assert fac.fwd_tc_smem_bytes(256, 128, 64) == 1024 + 65536 + 131072
    for d, tiles in fac._TC_FWD_BLOCKS.items():
        for bq, bk in tiles:
            assert fac.fwd_tc_smem_bytes(d, bq, bk) <= 232448
            key = fac.autotune_key(1, 1024, 1024, 4, d, BF16, True, "cpu")
            assert fac._fwd_smem(_cand("base", bq, bk), key) == \
                fac.fwd_tc_smem_bytes(d, bq, bk)
    f32 = fac.autotune_key(1, 1024, 1024, 4, 64, F32, True, "cpu")
    assert fac._fwd_smem(_cand("base", 64, 64), f32) is None
    assert fac._fwd_smem(_cand("pipelined", 64, 64), f32) == \
        fac.pipelined_smem_bytes(64, 64, 64, F32)


def test_card_bwd_route_follows_the_dtype():
    """bf16 and fp16 take the split pair at every length; f32 keeps the
    JAX package's rule (merged at the bench shape, split at 16384)."""
    for s in (128, 1024, 16384):
        assert fa._card_bwd_route(s, 16, 64, BF16) == "split"
        assert fa._card_bwd_route(s, 16, 64, F16) == "split"
        assert fa._card_bwd_route(s, 16, 64, F32) == fa._bwd_route(s, 16, 64)
    assert fa._card_bwd_route(1024, 16, 64, F32) == "merged"
    assert fa._card_bwd_route(16384, 16, 64, F32) == "split"


def test_default_backward_route_resolves_the_split_families(monkeypatch):
    """With route=None a bf16 backward resolves C2's and C3's families and
    not C1's, an f32 one at S = 256 C1's alone."""
    seen = []
    real = fac._resolve_bwd
    monkeypatch.setattr(fac, "_resolve_bwd",
                        lambda q, causal, fam: seen.append(fam) or
                        real(q, causal, fam))
    q, k, v = (torch.from_numpy(a) for a in _qkv((1, 256, 2, 64), seed=13))
    for dtype, want in ((BF16, ["flash_bwd_dq", "flash_bwd_dkv"]),
                        (F32, ["flash_bwd"])):
        qq, kk, vv = (t.to(dtype) for t in (q, k, v))
        out, lse = fac.flash_attention_bshd_with_lse(qq, kk, vv, causal=True)
        seen.clear()
        fac.flash_attention_bwd(qq, kk, vv, out, lse, out, True, 0.125)
        assert seen == want, dtype


@pytest.mark.parametrize("causal", [False, True])
def test_fp16_flash_calls_take_the_plain_route(causal, monkeypatch):
    """The open fault: an fp16 call raised TypeError in the wrapper's
    check.  Now it returns the plain result (the tensor-core forward's
    plain version on the CPU), within the fp16 tolerance of the f32 plain
    attention, lse included, and differentiates."""
    def no_library():
        raise AssertionError("the CPU route loaded the CUDA library")
    monkeypatch.setattr(_build, "library", no_library)
    q, k, v = (torch.from_numpy(a) for a in _qkv((1, 256, 2, 64), seed=14))
    want, want_lse = fac._flash_reference(q, k, v, causal, 0.125)
    qh, kh, vh = (t.half() for t in (q, k, v))
    out = fac.flash_attention_bshd(qh, kh, vh, causal=causal)
    out2, lse = fac.flash_attention_bshd_with_lse(qh, kh, vh, causal=causal)
    for o in (out, out2):
        assert o.dtype == F16
        torch.testing.assert_close(o.float(), want, atol=F16_ATOL,
                                   rtol=F16_REL)
    torch.testing.assert_close(lse, want_lse, atol=F16_ATOL, rtol=0)
    leaves = [t.clone().requires_grad_() for t in (qh, kh, vh)]
    grads = torch.autograd.grad(
        fac.flash_attention_bshd(*leaves, causal=causal).float().sum(),
        leaves)
    assert all(g.dtype == F16 and bool(torch.isfinite(g).all())
               for g in grads)


def test_fp16_merged_route_raises():
    """C1 has no fp16 instantiation: a pinned merged route refuses fp16
    with a clear message, before anything is resolved or launched."""
    q, k, v = (torch.from_numpy(a).half()
               for a in _qkv((1, 128, 2, 64), seed=15))
    out, lse = fac.flash_attention_bshd_with_lse(q, k, v, causal=True)
    with pytest.raises(TypeError, match="merged"):
        fac.flash_attention_bwd(q, k, v, out, lse, out, True, 0.125,
                                route="merged")
    got = fac.flash_attention_bwd(q, k, v, out, lse, out, True, 0.125,
                                  route="split")
    assert all(g.dtype == F16 for g in got)


@pytest.mark.parametrize("w_dtype", [F32, F16])
def test_fp16_layer_norm_takes_the_plain_route(w_dtype, monkeypatch):
    """The open fault's second half: ``norm_cuda.layer_norm`` on fp16 x
    raised TypeError; now it returns the plain LayerNorm within the fp16
    tolerance of the f32 one, and differentiates."""
    def no_library():
        raise AssertionError("the CPU route loaded the CUDA library")
    monkeypatch.setattr(_build, "library", no_library)
    rng = np.random.default_rng(16)
    x = torch.from_numpy(rng.standard_normal((16, 256)).astype(np.float32))
    g = torch.from_numpy((1 + 0.1 * rng.standard_normal(256))
                         .astype(np.float32))
    b = torch.from_numpy((0.1 * rng.standard_normal(256)).astype(np.float32))
    want = norm_cuda._layer_norm_reference(x, g, b, 1e-5)[0]
    xh = x.half().requires_grad_()
    gw, bw = (t.to(w_dtype).requires_grad_() for t in (g, b))
    got = norm_cuda.layer_norm(xh, gw, bw)
    assert got.dtype == F16
    torch.testing.assert_close(got.float(), want, atol=F16_ATOL,
                               rtol=F16_REL)
    grads = torch.autograd.grad(got.float().sum(), (xh, gw, bw))
    assert [t.dtype for t in grads] == [F16, w_dtype, w_dtype]


class _AsIfOnCard:
    """A tensor's shape seen by the gate as if it lay on a card."""

    is_cuda = True

    def __init__(self, t):
        self.shape = t.shape

    def dim(self):
        return len(self.shape)


@pytest.mark.parametrize("causal", [False, True])
def test_bf16_attention_through_the_functional_tracks_pallas(causal,
                                                             monkeypatch):
    """The slice as a whole on the CPU: bf16 attention through the
    model's functional, routed through the flash path as on a card, runs
    the tensor-core forward's plain version at candidate [0] and the
    split backward, and its output and gradients hold against the Pallas
    forward and jax.grad through the Pallas backward in bf16."""
    real = fa.supported
    monkeypatch.setattr(fa, "supported",
                        lambda q, k=None: real(_AsIfOnCard(q), k))
    seen = []
    plain = fac._flash_tc_reference

    def spy(*args):
        seen.append(args[-2:])
        return plain(*args)
    monkeypatch.setattr(fac, "_flash_tc_reference", spy)
    shape = (2, 256, 2, 64)
    q, k, v = _qkv(shape, seed=17)
    ct = np.random.default_rng(18).standard_normal(shape).astype(np.float32)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    jct = jnp.asarray(ct, jnp.bfloat16).astype(jnp.float32)
    kw = dict(causal=causal, block_q=128, block_k=128, interpret=True)

    def loss(a, b, c):
        out = jax_fap.flash_attention_bshd_native(a, b, c, **kw)
        return jnp.sum(out.astype(jnp.float32) * jct)
    want_out = jax_fap.flash_attention_bshd_native(jq, jk, jv, **kw)
    want = jax.grad(loss, argnums=(0, 1, 2))(jq, jk, jv)
    leaves = [torch.from_numpy(a).to(BF16).requires_grad_()
              for a in (q, k, v)]
    out = F.scaled_dot_product_attention(*leaves, is_causal=causal)
    assert seen == [(128, 128)]        # candidate [0] at D 64
    got = torch.autograd.grad(
        (out.float() * torch.from_numpy(ct).to(BF16).float()).sum(), leaves)
    err, _share, ok = _within(
        out.detach().float().numpy(),
        np.asarray(want_out.astype(jnp.float32)))
    assert ok, "out err %g" % err
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == BF16
        err, _share, ok = _within(g.float().numpy(),
                                  np.asarray(w.astype(jnp.float32)))
        assert ok, "%s err %g" % (name, err)


def test_build_hashes_the_shared_header(tmp_path, monkeypatch):
    """The library's name carries the hash of the sources AND of the
    headers they include: an edit to a header alone names a new library,
    so a stale one is never loaded."""
    assert any(p.name == "wgmma_common.cuh" for p in _build.headers())
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "a.cu").write_text('#include "h.cuh"\n')
    (csrc / "h.cuh").write_text("// one\n")
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    first = _build.library_path()
    assert first.parent == tmp_path / "build"
    (csrc / "h.cuh").write_text("// two\n")
    second = _build.library_path()
    assert second != first
    (csrc / "h.cuh").write_text("// one\n")
    assert _build.library_path() == first
    # and build() loads what library_path() names, without nvcc when it
    # is there already
    second.parent.mkdir()
    first.write_bytes(b"")
    assert _build.build() == (first, "")


@pytest.mark.parametrize("causal", [False, True])
def test_fp16_plain_attention_masks_as_jax(causal):
    """The plain attention (the route of cached and unaligned calls) in
    fp16: a masked logit takes -1e30 in fp16, -inf, as the JAX version's
    jnp.asarray(-1e30, logits.dtype); it raised on the fill before.  The
    output holds within the fp16 tolerance of the f32 plain attention and
    of the JAX version in fp16."""
    from paddle_tpu.nn.functional import attention as jax_attn
    from paddle_tpu_torch.nn.functional import attention as attn
    q, k, v = _qkv((1, 128, 2, 64), seed=19)
    want = attn.sdpa_reference_raw(*(torch.from_numpy(a) for a in (q, k, v)),
                                   is_causal=causal)
    got = attn.sdpa_reference_raw(
        *(torch.from_numpy(a).half() for a in (q, k, v)), is_causal=causal)
    assert got.dtype == F16
    torch.testing.assert_close(got.float(), want, atol=F16_ATOL,
                               rtol=F16_REL)
    jax_out = jax_attn.scaled_dot_product_attention(
        *(jnp.asarray(a, jnp.float16) for a in (q, k, v)), is_causal=causal,
        use_flash=False)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(jax_out, np.float32),
                               atol=F16_ATOL, rtol=F16_REL)
