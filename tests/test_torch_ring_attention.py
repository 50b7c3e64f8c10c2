"""Ring and Ulysses attention in the port
(``paddle_tpu_torch.distributed.ring_attention``) and the ``sep`` route of
its ``scaled_dot_product_attention``, on one four-rank gloo world (the
``sep`` group of {"sep": 4}, or of {"dp": 2, "sep": 2} with the batch
over ``dp``), against the JAX package's functions under ``shard_map`` on
CPU devices:

* ``ring_attention`` at (2, 4, 64, 16) f32, causal and full, on both
  meshes: out to rtol 1e-4 / atol 1e-5 and dq / dk / dv to 1e-4 against
  JAX's grads of the same ring; the additive mask, grouped-query heads
  (values and grads), a bf16 ring whose permuted K/V stay bf16, and
  ``ulysses_attention`` at (2, 8, 64, 16);
* every rank hands the backend the same sequence of exchanges (a causal
  backward, where rank 0 skips every step but its own, finishes);
* SDPA's ring route, its masks and multi-query K/V, the gathered
  ``sequence_parallel=False`` opt-out, and its raises;
* the flash-inner contract in one process: the port's ``_flash_inner``
  (its plain version on the CPU) against JAX's under
  ``PADDLE_TPU_RING_INNER=pallas_interpret`` (the Pallas kernels in
  interpret mode), values and grads through sum(out^2) + sum(sin(lse));
* the GPT's entry points on a mesh whose ``sep`` axis has more than one
  rank: the model, its train step, ``parallelize`` and the fleet give
  the one-process answers, the serving engine refuses;
* the exchanges (``collective.ppermute``, ``all_to_all_autograd``) and
  ``flash_attention_bwd``'s accumulators ``dq_acc`` and ``dkv_acc``."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from _jax_compat import shard_map

import paddle_tpu as paddle
from paddle_tpu.distributed import ring_attention as jring
from paddle_tpu.nn import functional as JF
from paddle_tpu.nn.functional.attention import \
    sdpa_reference_raw as jsdpa_reference

import _torch_dist
from paddle_tpu_torch.distributed import ring_attention as tring

MESHES = {"sep4": {"sep": 4}, "dp2_sep2": {"dp": 2, "sep": 2}}


@pytest.fixture(scope="module")
def world():
    w = _torch_dist.World(4)
    yield w
    w.close()


def _jax_mesh(axes):
    names = tuple(axes)
    devs = np.asarray(jax.devices()[:int(np.prod(list(axes.values())))])
    return Mesh(devs.reshape(tuple(axes.values())), names)


def _jax_ring(q, k, v, dout, axes, causal, mask=None, fn="ring"):
    """The JAX ring (or Ulysses) on ``axes``' shard_map: out and the grads
    of sum(out * dout)."""
    mesh = _jax_mesh(axes)
    spec = P("dp" if "dp" in axes else None, None, "sep", None)
    args = [jnp.asarray(a) for a in (q, k, v)]
    if fn == "ring":
        def f(q_, k_, v_, *m):
            return jring.ring_attention(q_, k_, v_, "sep", causal=causal,
                                        attn_mask=m[0] if m else None)
    else:
        def f(q_, k_, v_):
            return jring.ulysses_attention(q_, k_, v_, "sep", causal=causal)
    extra = [] if mask is None else [jnp.asarray(mask)]
    sm = shard_map(f, mesh=mesh, in_specs=(spec,) * (3 + len(extra)),
                   out_specs=spec, check_vma=False)

    def loss(a, b, c):
        out = sm(a, b, c, *extra)
        return jnp.sum(out.astype(jnp.float32) * jnp.asarray(dout)), out
    (_l, out), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(*args)
    return [np.asarray(out, np.float32)] + [np.asarray(g, np.float32)
                                            for g in grads]


def _gather(outs, axes, dims=(0, 2)):
    """The ranks' shards of (B, H, S, D) put back in place: rank r of the
    mesh holds dp coordinate r // sep, sep coordinate r % sep."""
    sep = axes["sep"]
    dp = axes.get("dp", 1)
    rows = [np.concatenate([outs[i * sep + j] for j in range(sep)],
                           axis=dims[1]) for i in range(dp)]
    return np.concatenate(rows, axis=dims[0])


def _inputs(shape, seed, kv_heads=None):
    rng = np.random.RandomState(seed)
    b, h, s, d = shape
    hk = kv_heads or h
    q = rng.randn(b, h, s, d).astype(np.float32)
    k = rng.randn(b, hk, s, d).astype(np.float32)
    v = rng.randn(b, hk, s, d).astype(np.float32)
    dout = rng.randn(b, h, s, d).astype(np.float32)
    return q, k, v, dout


def _run(world, axes, q, k, v, dout, causal, mask=None, fn="ring"):
    outs = world.run("_torch_sep:job_ring", q=q, k=k, v=v, dout=dout,
                     axes=axes, causal=causal, mask=mask, fn=fn)
    got = [_gather([o[i] for o in outs], axes) for i in range(4)]
    return got, outs


def _hold(got, ref, rtol_out=1e-4, atol_out=1e-5, tol_grad=1e-4):
    np.testing.assert_allclose(got[0], ref[0], rtol=rtol_out, atol=atol_out)
    for g, r in zip(got[1:], ref[1:]):
        np.testing.assert_allclose(g, r, rtol=tol_grad, atol=tol_grad)


def _same_exchanges(outs):
    """Every rank handed the backend the same (numel, dtype) sequence."""
    logs = [o[4] for o in outs]
    assert logs[0] and all(log == logs[0] for log in logs), logs


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_ring_matches_jax_ring(world, mesh, causal):
    axes = MESHES[mesh]
    q, k, v, dout = _inputs((2, 4, 64, 16), 1)
    got, outs = _run(world, axes, q, k, v, dout, causal)
    _hold(got, _jax_ring(q, k, v, dout, axes, causal))
    # the dense answer too (JAX's reference attention)
    full = np.swapaxes(np.asarray(jsdpa_reference(
        *(jnp.swapaxes(jnp.asarray(a), 1, 2) for a in (q, k, v)),
        is_causal=causal, scale=0.25)), 1, 2)
    np.testing.assert_allclose(got[0], full, rtol=1e-4, atol=1e-5)
    # a causal backward, where rank 0 (sep coordinate 0) skips every step
    # but its own, issues what every other rank issues; one permute of the
    # stacked K/V a forward step, then K/V and the f32 dK/dV a backward step
    _same_exchanges(outs)
    n = axes["sep"]
    assert outs[0][5] == ["torch.float32"] * ((n - 1) + (n - 1) + n)


@pytest.mark.parametrize("diagonal", ["masked", "visible"])
def test_ring_additive_mask_matches_jax(world, diagonal):
    """The JAX test's mask (a quarter of the key columns blocked, -1e30):
    out against JAX's ring.  A row whose every visible key is blocked is
    a degenerate softmax, whose result is implementation-defined: both
    rings spread it over the filled keys of the shard (the dense
    reference puts it on the blocked visible keys), and JAX's autodiff
    differentiates its -1e30 sentinels through the combine.  So the
    grads, and the dense answer, are held on the same mask with the
    diagonal kept visible, as JAX's SDPA mask test keeps it."""
    axes = MESHES["sep4"]
    q, k, v, dout = _inputs((2, 4, 64, 16), 3)
    rng = np.random.RandomState(3)
    mask = np.where(rng.rand(2, 1, 64, 64) < 0.25, -1e30,
                    0.0).astype(np.float32)
    if diagonal == "visible":
        mask[:, :, np.arange(64), np.arange(64)] = 0.0
    got, outs = _run(world, axes, q, k, v, dout, True, mask=mask)
    ref = _jax_ring(q, k, v, dout, axes, True, mask=mask)
    _same_exchanges(outs)
    if diagonal == "masked":
        _hold(got, ref[:1])
        return
    _hold(got, ref)
    full = np.swapaxes(np.asarray(jsdpa_reference(
        *(jnp.swapaxes(jnp.asarray(a), 1, 2) for a in (q, k, v)),
        attn_mask=jnp.asarray(mask), is_causal=True)), 1, 2)
    np.testing.assert_allclose(got[0], full, rtol=1e-4, atol=1e-5)


def test_ring_gqa_matches_jax_and_dense(world):
    """4 query heads over 2 K/V heads: the grouped K/V rotate."""
    axes = MESHES["sep4"]
    q, k, v, dout = _inputs((1, 4, 64, 16), 7, kv_heads=2)
    got, outs = _run(world, axes, q, k, v, dout, True)
    _hold(got, _jax_ring(q, k, v, dout, axes, True))
    # the dense GQA answer: each K/V head repeated for its 2 query heads
    kr, vr = (torch.from_numpy(a).repeat_interleave(2, 1).requires_grad_(True)
              for a in (k, v))
    qt = torch.from_numpy(q).requires_grad_(True)
    logits = torch.einsum("bhqd,bhkd->bhqk", qt, kr) * 0.25
    logits = logits.masked_fill(~torch.ones(64, 64, dtype=torch.bool).tril(),
                                -1e30)
    dense = torch.einsum("bhqk,bhkd->bhqd", torch.softmax(logits, -1), vr)
    np.testing.assert_allclose(got[0], dense.detach().numpy(), rtol=2e-5,
                               atol=2e-5)
    _same_exchanges(outs)
    assert got[2].shape == k.shape
    # the K/V permuted are the grouped ones: (2 [k, v], 1, 16, 2, 16)
    assert outs[0][4][0] == (2 * 16 * 2 * 16, "torch.float32")


def test_ring_bf16_rotation_and_refusals(world):
    """A bf16 ring stays bf16 (out, and the permuted K/V) and is near the
    dense answer; heads that do not divide and a mask whose rows are not
    the local shard raise, as Ulysses' heads that the axis does not
    divide do."""
    axes = MESHES["sep4"]
    # bf16 values, carried as f32 (the ranks cast them back)
    q, k, v, dout = (np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)
                     for a in _inputs((1, 2, 64, 16), 5))
    outs = world.run("_torch_sep:job_ring", q=q, k=k, v=v, dout=dout,
                     axes=axes, causal=True, dtype="bfloat16")
    assert outs[0][6] == "torch.bfloat16"
    assert "bfloat16" in outs[0][5][0]
    got = _gather([o[0] for o in outs], axes)
    qb, kb, vb, db = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v, dout))
    full = np.swapaxes(np.asarray(jsdpa_reference(
        *(jnp.swapaxes(a, 1, 2) for a in (qb, kb, vb)),
        is_causal=True)), 1, 2).astype(np.float32)
    np.testing.assert_allclose(got, full, rtol=5e-2, atol=5e-2)
    ref = _jax_ring(qb, kb, vb, db, axes, True)
    np.testing.assert_allclose(got, ref[0], rtol=5e-2, atol=5e-2)
    errors = world.run("_torch_sep:job_ring_errors", q=_inputs(
        (1, 2, 64, 16), 5)[0])[0]
    assert "NotImplementedError" in errors["gqa"]
    assert "multiple" in errors["gqa"]
    assert errors["mask_rows"].startswith("ValueError")
    assert errors["ulysses_heads"].startswith("ValueError")


def test_ulysses_matches_jax(world):
    axes = MESHES["sep4"]
    q, k, v, dout = _inputs((2, 8, 64, 16), 2)
    got, outs = _run(world, axes, q, k, v, dout, True, fn="ulysses")
    _hold(got, _jax_ring(q, k, v, dout, axes, True, fn="ulysses"))
    _same_exchanges(outs)
    # q, k and v in one exchange forward, one back; the same backward
    assert [c[0] for c in outs[0][4]] == [3 * 2 * 8 * 16 * 16,
                                          2 * 8 * 16 * 16,
                                          2 * 8 * 16 * 16,
                                          3 * 2 * 8 * 16 * 16]


def _jax_sdpa(q, k, v, mask=None, **kw):
    out = JF.scaled_dot_product_attention(
        paddle.Tensor(jnp.asarray(q)), paddle.Tensor(jnp.asarray(k)),
        paddle.Tensor(jnp.asarray(v)),
        attn_mask=None if mask is None else paddle.Tensor(jnp.asarray(mask)),
        is_causal=True, training=False, **kw)
    return np.asarray(out._array if hasattr(out, "_array") else out)


def _jax_sdpa_sep(q, k, v, mask=None):
    """JAX's SDPA under shard_map with 'sep' bound: the ring route."""
    mesh = _jax_mesh({"sep": 4})
    specs = [P(None, "sep")] * 3
    args = [jnp.asarray(a) for a in (q, k, v)]
    if mask is not None:
        specs.append(P(None, None, "sep", None))
        args.append(jnp.asarray(mask))

    def attn(q_, k_, v_, *m):
        out = JF.scaled_dot_product_attention(
            paddle.Tensor(q_), paddle.Tensor(k_), paddle.Tensor(v_),
            attn_mask=paddle.Tensor(m[0]) if m else None, is_causal=True,
            training=False)
        return out._array if hasattr(out, "_array") else out
    return np.asarray(jax.jit(shard_map(
        attn, mesh=mesh, in_specs=tuple(specs),
        out_specs=P(None, "sep")))(*args))


def test_sdpa_sep_route_masks_opt_out_and_raises(world):
    """SDPA under a bound 'sep' runs the ring on the local shards: its
    output against JAX's SDPA under shard_map and the unsharded one, with
    an additive mask (local rows, global columns) and with one K/V head;
    the gathered ``sequence_parallel=False`` opt-out equals unsharded
    attention; dropout, cross attention, a rank-3 input, heads that do
    not divide, a boolean mask and a mask of the wrong rows raise."""
    rng = np.random.RandomState(11)
    b, s, h, d = 1, 32, 2, 8
    q, k, v = ((rng.randn(b, s, h, d) * 0.3).astype(np.float32)
               for _ in range(3))
    mblock = np.where(rng.rand(b, 1, s, s) < 0.3, -1e30, 0.0)
    mblock[:, :, np.arange(s), np.arange(s)] = 0.0
    mask = mblock.astype(np.float32)
    outs = world.run("_torch_sep:job_sdpa", q=q, k=k, v=v, mask=mask,
                     gqa_kv=q[:, :, :1].copy())
    got = {name: np.concatenate([o[0][name] for o in outs], axis=1)
           for name in outs[0][0]}
    want = _jax_sdpa(q, k, v)
    np.testing.assert_allclose(got["ring"], want, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(got["ring"], _jax_sdpa_sep(q, k, v),
                               rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(got["mask"], _jax_sdpa(q, q, q, mask),
                               rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(got["mask"], _jax_sdpa_sep(q, q, q, mask),
                               rtol=2e-4, atol=2e-5)
    kv = np.repeat(q[:, :, :1], h, axis=2)
    np.testing.assert_allclose(got["mqa"], _jax_sdpa(q, kv, kv), rtol=2e-4,
                               atol=2e-5)
    np.testing.assert_allclose(got["gathered"], _jax_sdpa(q, q, q),
                               rtol=2e-4, atol=2e-5)
    errors = outs[0][1]
    for name in ("dropout", "cross", "rank3"):
        assert errors[name].startswith("NotImplementedError"), name
        assert "sequence-parallel" in errors[name]
    assert errors["heads"].startswith("NotImplementedError")
    assert "divisible" in errors["heads"]
    assert errors["bool_mask"].startswith("NotImplementedError")
    assert "additive" in errors["bool_mask"]
    assert errors["mask_rows"].startswith("ValueError")


@pytest.mark.parametrize("diag", [True, False])
def test_flash_inner_contract_matches_jax(monkeypatch, diag):
    """The port's flash inner (the flash forward with its lse; on the CPU
    its plain version) against the JAX package's ``_flash_inner`` over the
    Pallas kernels in interpret mode, values and grads through an
    lse-consuming combine, at JAX's own tolerances."""
    monkeypatch.setenv("PADDLE_TPU_RING_INNER", "pallas_interpret")
    b, h, s, d = 1, 2, 256, 64
    rng = np.random.RandomState(9)
    q, k, v = (rng.randn(b, h, s, d).astype(np.float32) for _ in range(3))
    scale = 1.0 / np.sqrt(d)

    def combine_jax(q_, k_, v_):
        out, lse = jring._flash_inner(q_, k_, v_, diag, scale)
        return jnp.sum(out ** 2) + jnp.sum(jnp.sin(lse)), (out, lse)
    (_l, (oj, sj)), gj = jax.value_and_grad(
        combine_jax, argnums=(0, 1, 2), has_aux=True)(
            *(jnp.asarray(a) for a in (q, k, v)))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out, lse = tring._flash_inner(*ts, diag, float(scale))
    loss = (out ** 2).sum() + torch.sin(lse).sum()
    gt = torch.autograd.grad(loss, ts)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(oj),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(lse.detach().numpy(), np.asarray(sj),
                               rtol=1e-4, atol=1e-4)
    for a, b_ in zip(gt, gj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b_), rtol=3e-3,
                                   atol=3e-3)
    # and the port's blockwise inner holds the same contract
    bo, bl = tring._blockwise_attn(*(t.detach() for t in ts), scale, 0, 0,
                                   diag, None, 128)
    np.testing.assert_allclose(bo.numpy(), np.asarray(oj), rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(bl.numpy(), np.asarray(sj), rtol=1e-4,
                               atol=1e-4)


def test_a_sep_mesh_is_refused_by_the_gpt_entry_points(world):
    """On {"dp": 2, "sep": 2} the GPT shards its sequences (ROADMAP §A5
    item 2): a plain forward, ``TrainStep`` (the GPT's criterion),
    ``parallelize`` and ``fleet.distributed_model`` run and give the
    one-process answers (outputs joined over 'sep' by
    ``gather_sequence``, within 1e-5); the serving engine, which does not
    shard sequences, still refuses, naming ROADMAP §A5.  On {"dp": 4}
    each runs."""
    out = world.run("_torch_sep:job_sep_refusal")
    for rank_out in out:
        for name in ("GPT", "TrainStep", "parallelize", "fleet"):
            msg, diff = rank_out["%s %s" % (name, ["dp", "sep"])]
            assert msg is None and diff is not None and diff <= 1e-5, (
                name, msg, diff)
        msg, _ = rank_out["DecodeEngine %s" % (["dp", "sep"],)]
        assert msg is not None and "§A5" in msg \
            and "does not shard sequences" in msg
        for name in ("GPT", "TrainStep", "DecodeEngine", "parallelize",
                     "fleet"):
            msg, diff = rank_out["%s %s" % (name, ["dp"])]
            assert msg is None and (diff is None or diff <= 1e-5), (
                name, msg, diff)


def test_exchanges_carry_their_gradients(world):
    """``ppermute`` sends rank r's rows to r + 1; ``all_to_all_autograd``
    trades dim-0 pieces and its backward trades the cotangent's back."""
    rng = np.random.RandomState(13)
    x = rng.randn(4, 4, 2).astype(np.float32)
    w = rng.randn(4, 4, 2).astype(np.float32)
    outs = world.run("_torch_sep:job_exchanges", x=x, w=w)
    for r, (y_p, (y_a, g_a)) in enumerate(outs):
        np.testing.assert_array_equal(y_p, x[(r - 1) % 4])
        np.testing.assert_array_equal(y_a, x[:, r])
        np.testing.assert_array_equal(g_a, w[:, r])


@pytest.mark.parametrize("route", ["split", "merged"])
def test_flash_bwd_adds_dq_into_an_accumulator_on_the_cpu(route):
    """``flash_attention_bwd(dq_acc=..., dkv_acc=...)``, the ring's
    gradients over its blocks: on the CPU the plain version's unrounded
    f32 dq, dk and dv are added into the accumulators, which come back
    in their place; each rounds to the result without them."""
    from paddle_tpu_torch.kernels import flash_attention_cuda as fac
    rng = np.random.RandomState(12)
    q, k, v, do = (torch.from_numpy(rng.randn(1, 128, 2, 64).astype(
        np.float32)).to(torch.bfloat16) for _ in range(4))
    out, lse = fac.flash_attention_bshd_with_lse(q, k, v, causal=True)
    start = torch.from_numpy(rng.randn(1, 128, 2, 64).astype(np.float32))
    dkv_start = torch.from_numpy(rng.randn(2, 1, 128, 2, 64).astype(
        np.float32))
    acc, dkv = start.clone(), dkv_start.clone()
    got = fac.flash_attention_bwd(q, k, v, out, lse, do, True, 0.125,
                                  route=route, dq_acc=acc, dkv_acc=dkv)
    plain = fac.flash_attention_bwd(q, k, v, out, lse, do, True, 0.125,
                                    route=route)
    ref = fac._flash_bwd_reference(q, k, v, out, lse, do, True, 0.125,
                                   f32=True)
    assert got[0] is acc and acc.dtype == torch.float32
    assert torch.equal(acc, start + ref[0])
    for i in (0, 1):
        assert got[1 + i].data_ptr() == dkv[i].data_ptr()
        assert torch.equal(dkv[i], dkv_start[i] + ref[1 + i])
    for g, r in zip(plain, ref):
        assert torch.equal(r.to(torch.bfloat16), g)
    with pytest.raises(ValueError, match="dq_acc"):
        fac.flash_attention_bwd(q, k, v, out, lse, do, True, 0.125,
                                dq_acc=acc.to(torch.bfloat16))
    with pytest.raises(ValueError, match="dkv_acc"):
        fac.flash_attention_bwd(q, k, v, out, lse, do, True, 0.125,
                                dkv_acc=dkv[0])


@pytest.mark.parametrize("causal", [False, True])
def test_flash_forward_out_f32_on_the_cpu(causal):
    """``flash_attention_bshd_with_lse(out_f32=True)``, the ring's inner
    blocks: out in f32, unrounded, which rounds to the 16-bit out bit for
    bit, the same lse; differentiable, its backward the plain one with
    the cotangent in q's dtype."""
    from paddle_tpu_torch.kernels import flash_attention_cuda as fac
    rng = np.random.RandomState(14)
    q, k, v, do = (torch.from_numpy(rng.randn(1, 128, 2, 64).astype(
        np.float32)).to(torch.bfloat16) for _ in range(4))
    o16, l16 = fac.flash_attention_bshd_with_lse(q, k, v, causal=causal)
    ts = [t.clone().requires_grad_(True) for t in (q, k, v)]
    o32, l32 = fac.flash_attention_bshd_with_lse(*ts, causal=causal,
                                                 out_f32=True)
    assert o32.dtype == torch.float32
    assert torch.equal(o32.detach().to(torch.bfloat16), o16)
    assert torch.equal(l32.detach(), l16)
    grads = torch.autograd.grad(o32, ts, do.float())
    ref = fac._flash_bwd_reference(q, k, v, o32.detach(), l32.detach(), do,
                                   causal, 0.125)
    for g, r in zip(grads, ref):
        assert torch.equal(g, r)
