"""paddle_tpu_torch's pipelined flash forward (kernel A') on the CPU: its
plain version held against the Pallas ``_fwd_kernel_pipelined``
(interpret mode, lse included; f32 and bf16), the autotuner's routing
of a flash call to it under a pin, the variants the card refuses, the
``PADDLE_TPU_DISABLE_FLASH`` gate, and five AdamW steps of the tiny GPT
through the pinned forward against ``paddle_tpu.jit.TrainStep``.  The
kernel itself is held against the plain version on the card by
tests/test_torch_cuda_kernels.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.kernels import flash_attention_pallas as jax_fap
from paddle_tpu_torch.kernels import autotune as at
from paddle_tpu_torch.kernels import flash_attention as fa
from paddle_tpu_torch.kernels import flash_attention_cuda as fac
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.utils import flags
from test_torch_train import ATOL, _jax_params, _pair, _run


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


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", [(1, 256, 2, 64), (2, 256, 1, 128)])
def test_plain_matches_pallas_pipelined_kernel(shape, causal):
    """f32, the tolerance of tests/test_flash_variants.py: the Pallas
    pipelined forward (128-row blocks, so its K/V prefetch runs) against
    the plain version at every A' instantiation."""
    q, k, v = _qkv(shape, seed=3)
    jq, jk, jv = (jnp.asarray(a, jnp.float32) for a in (q, k, v))
    kw = dict(causal=causal, block_q=128, block_k=128, interpret=True,
              variant="pipelined")
    want_out, want_lse = jax_fap.flash_attention_bshd_with_lse(
        jq, jk, jv, **kw)
    want_native = jax_fap.flash_attention_bshd_native(jq, jk, jv, **kw)
    np.testing.assert_allclose(np.asarray(want_native),
                               np.asarray(want_out), atol=1e-6, rtol=0)
    scale = 1.0 / shape[-1] ** 0.5
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    for bq, bk in fac._PIPELINED_BLOCKS:
        out, lse = fac._flash_tc_reference(tq, tk, tv, causal, scale,
                                           bq, bk)
        assert out.shape == shape and lse.shape == shape[:3]
        np.testing.assert_allclose(out.numpy(), np.asarray(want_out),
                                   atol=1e-5, rtol=1e-5,
                                   err_msg=str((bq, bk)))
        np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse),
                                   atol=1e-5, rtol=1e-5,
                                   err_msg=str((bq, bk)))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", [(1, 256, 2, 64), (2, 256, 1, 128)])
def test_plain_matches_pallas_pipelined_kernel_in_bf16(shape, causal):
    """bf16: the Pallas pipelined forward rounds p to bf16 before p.v
    (``_online_step``), relative to the running max of its 128-row K
    tiles; A''s plain version rounds it too, so at the same 128 x 128
    tiles the two agree within one bf16 ulp of |ref| plus 1/64 of the
    reference's RMS (tests/test_torch_flash_tc.py's bar), lse within
    1e-3."""
    q, k, v = _qkv(shape, seed=9)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    want_out, want_lse = jax_fap.flash_attention_bshd_with_lse(
        jq, jk, jv, causal=causal, block_q=128, block_k=128, interpret=True,
        variant="pipelined")
    want = np.asarray(jnp.asarray(want_out, jnp.float32))
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    out, lse = fac._flash_tc_reference(tq, tk, tv, causal,
                                       shape[-1] ** -0.5, 128, 128)
    assert out.dtype == torch.bfloat16
    got = out.float().numpy()
    rms = float(np.sqrt(np.mean(want ** 2)))
    err = np.abs(got - want)
    assert (err <= 2.0 ** -7 * np.abs(want) + 2.0 ** -6 * rms).all(), \
        float(err.max())
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), atol=1e-3,
                               rtol=0)


def test_pin_routes_the_cpu_call_to_the_pipelined_plain_version(
        monkeypatch):
    """Without a pin a flash call takes the plain attention; under
    ``flash_fwd=pipelined:block_q=128,block_k=64`` it takes A''s plain
    version with the pinned blocks (and gives the same answer); blocks
    that do not divide S fall back to candidate [0]."""
    seen = []
    real = fac._flash_tc_reference

    def spy(q, k, v, causal, scale, block_q, block_k):
        seen.append((block_q, block_k))
        return real(q, k, v, causal, scale, block_q, block_k)
    monkeypatch.setattr(fac, "_flash_tc_reference", spy)
    q, k, v = (torch.from_numpy(a) for a in _qkv((1, 256, 2, 64), seed=4))
    want = fac.flash_attention_bshd(q, k, v, causal=True)
    assert seen == []
    monkeypatch.setitem(flags._REGISTRY, "autotune_pin",
                        "flash_fwd=pipelined:block_q=128,block_k=64")
    got, lse = fac.flash_attention_bshd_with_lse(q, k, v, causal=True)
    assert seen == [(128, 64)]
    torch.testing.assert_close(got, want, atol=1e-6, rtol=0)
    # the pin merges over candidate [0]'s config: 64 x 64
    monkeypatch.setitem(flags._REGISTRY, "autotune_pin",
                        "flash_fwd=pipelined")
    fac.flash_attention_bshd(q, k, v, causal=True)
    assert seen[-1] == (64, 64)
    assert at.report()["flash_fwd"][at.key_str(fac.autotune_key(
        1, 256, 256, 2, 64, torch.float32, True, "cpu"))] == {
            "variant": "pipelined", "config": {"block_q": 64,
                                               "block_k": 64}}
    # S = 192 is not a multiple of block_q = 128: candidate [0]
    monkeypatch.setitem(flags._REGISTRY, "autotune_pin",
                        "flash_fwd=pipelined:block_q=128,block_k=64")
    q3 = q[:, :192]
    assert fac._resolve_fwd(q3, q3, q3, True) == ("base", 64, 64)


@pytest.mark.parametrize("family,route", [("flash_fwd", None),
                                          ("flash_bwd", "merged"),
                                          ("flash_bwd_dq", "split")])
def test_bf16chain_pin_raises(family, route, monkeypatch):
    """bf16chain changes the numerics and has no card kernel: a pin of it
    raises, never a silent substitute."""
    q, k, v = (torch.from_numpy(a) for a in _qkv((1, 128, 2, 64), seed=5))
    out, lse = fac._flash_reference(q, k, v, True, 0.125)
    monkeypatch.setitem(flags._REGISTRY, "autotune_pin",
                        family + "=bf16chain+iotafree")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        if route is None:
            fac.flash_attention_bshd(q, k, v, causal=True)
        else:
            fac.flash_attention_bwd(q, k, v, out, lse, out, True, 0.125,
                                    route=route)


def test_iotafree_and_parq_are_accepted_and_change_nothing(monkeypatch):
    q, k, v = (torch.from_numpy(a) for a in _qkv((1, 128, 2, 64), seed=6))
    assert fac._resolve_fwd(q, k, v, True) == ("base", 64, 64)
    monkeypatch.setitem(flags._REGISTRY, "autotune_pin",
                        "flash_fwd=parq+iotafree;flash_bwd=iotafree")
    assert fac._resolve_fwd(q, k, v, True) == ("iotafree+parq", 64, 64)
    # the f32 C1's default tile at D 64
    assert fac._resolve_bwd(q, True, "flash_bwd") == 32
    monkeypatch.setitem(flags._REGISTRY, "autotune_pin",
                        "flash_fwd=iotafree+pipelined:block_q=64,block_k=32")
    assert fac._resolve_fwd(q, k, v, True) == ("iotafree+pipelined", 64, 32)
    assert fac.bwd_variant_of("iotafree+parq+pipelined") == "iotafree"
    # an unknown feature or a tile the kernels lack: candidate [0]
    for pin in ("flash_fwd=warp9", "flash_fwd=pipelined:block_q=96",
                "flash_fwd=base:block_q=128,block_k=128"):
        monkeypatch.setitem(flags._REGISTRY, "autotune_pin", pin)
        assert fac._resolve_fwd(q, k, v, True) == ("base", 64, 64), pin


class _AsIfOnCard:
    """A tensor's shape seen by the gate as if it lay on a card."""

    is_cuda = True

    def __init__(self, t):
        self.shape = t.shape

    def dim(self):
        return len(self.shape)


@pytest.mark.parametrize("value", ["1", "true", "yes"])
def test_disable_flash_sends_attention_to_the_plain_path(value,
                                                         monkeypatch):
    """PADDLE_TPU_DISABLE_FLASH turns the gate off, as in the JAX gate:
    attention then takes the plain path even where the kernels apply."""
    real = fa.supported
    monkeypatch.setattr(fa, "supported",
                        lambda q, k=None: real(_AsIfOnCard(q), k))
    calls = []
    monkeypatch.setattr(fa, "flash_attention_bshd",
                        lambda *a, **kw: calls.append(1) or
                        fac.flash_attention_bshd(*a, **kw))
    q, k, v = (torch.from_numpy(a) for a in _qkv((1, 128, 2, 64), seed=7))
    assert real(_AsIfOnCard(q), k)
    want = F.scaled_dot_product_attention(q, k, v, is_causal=True)
    assert calls == [1]
    monkeypatch.setenv("PADDLE_TPU_DISABLE_FLASH", value)
    assert not real(_AsIfOnCard(q), k)
    got = F.scaled_dot_product_attention(q, k, v, is_causal=True)
    assert calls == [1]
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)


def test_trainstep_through_the_pinned_pipelined_forward_tracks_jax(
        monkeypatch):
    """The slice as a whole: five AdamW steps of the tiny GPT (two heads
    of 64, S = 128) with every attention routed through the flash path
    and ``flash_fwd=pipelined`` pinned, so each forward takes A''s plain
    version and each backward the flash backward's, track
    ``paddle_tpu.jit.TrainStep`` to 1e-5 (the gate of
    tests/test_torch_train.py)."""
    real = fa.supported
    monkeypatch.setattr(fa, "supported",
                        lambda q, k=None: real(_AsIfOnCard(q), k))
    monkeypatch.setitem(flags._REGISTRY, "autotune_pin",
                        "flash_fwd=pipelined:block_q=64,block_k=32")
    seen = []
    plain = fac._flash_tc_reference

    def spy(*args):
        seen.append(args[-2:])
        return plain(*args)
    monkeypatch.setattr(fac, "_flash_tc_reference", spy)
    jstep, tstep = _pair(seed=4, wide=True)
    rng = np.random.default_rng(8)
    batches = [rng.integers(0, 512, (2, 128)).astype(np.int32)
               for _ in range(2)]
    jl, tl = _run(jstep, tstep, (batches * 3)[:5])
    assert seen == [(64, 32)] * (2 * 5)     # 2 layers x 5 steps
    np.testing.assert_allclose(tl, jl, atol=ATOL, rtol=0)
    assert tl[-1] < tl[0]
    want = _jax_params(jstep)
    got = tstep.state_dict()["params"]
    for name in want:
        np.testing.assert_allclose(got[name].numpy(), want[name], atol=ATOL,
                                   rtol=0, err_msg=name)
