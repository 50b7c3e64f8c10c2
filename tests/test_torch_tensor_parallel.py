"""Tensor parallelism in the port on a four-rank gloo world laid out as
{"dp": 2, "mp": 2}: the four mp layers against their dense selves and
the JAX package's (forward and gradients); the tiny GPT's Megatron
layout trained five steps at dp2 x mp2 against the JAX package's hybrid
step on a (dp 2, mp 2) mesh of CPU devices and against the port
unsharded, to 1e-5; the global-norm clip over mp shards against the
unsharded clip; the gathered state against the unsharded one; and the
dealing rule (a rank holds the q, k and v columns of its own heads)
shared by ``parallelize`` and ``convert``."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as JP

import paddle_tpu as paddle
from paddle_tpu.distributed import mesh as jmesh
from paddle_tpu.distributed import mp_layers as jmp
from paddle_tpu.models.gpt import (GPTConfig as JGPTConfig,
                                   GPTForCausalLM as JGPT,
                                   GPTPretrainingCriterion as JCrit)

import _torch_dist
from paddle_tpu_torch import convert
from paddle_tpu_torch.distributed import mp_layers as tmp
from paddle_tpu_torch.nn import clip_grad_norm_
from paddle_tpu_torch.models.gpt import GPTPretrainingCriterion


@pytest.fixture(scope="module")
def world():
    w = _torch_dist.World(4)
    yield w
    w.close()


def _np(t):
    return np.asarray(t.numpy())


# ---------------------------------------------------------------------------
# the mp layers
# ---------------------------------------------------------------------------

def _layer_inputs():
    rng = np.random.default_rng(5)
    return dict(x=rng.standard_normal((4, 16)).astype(np.float32),
                dy=rng.standard_normal((4, 8)).astype(np.float32),
                ids=rng.integers(0, 64, (2, 8)).astype(np.int64),
                logits=rng.standard_normal((6, 64)).astype(np.float32),
                labels=np.array([3, 40, 63, 0, 33, -100], np.int64))


def _jax_layers(inp):
    """The JAX layers eager, with their gradients: the reference."""
    paddle.seed(3)
    col = jmp.ColumnParallelLinear(16, 32, gather_output=False)
    row = jmp.RowParallelLinear(32, 8)
    weights = {"col.weight": _np(col.weight), "col.bias": _np(col.bias),
               "row.weight": _np(row.weight), "row.bias": _np(row.bias)}
    x = paddle.to_tensor(inp["x"], stop_gradient=False)
    y = row(paddle.nn.functional.relu(col(x)))
    (y * paddle.to_tensor(inp["dy"])).sum().backward()
    ref = {"y": _np(y), "dx": _np(x.grad),
           "grads": {"col.weight": _np(col.weight.grad),
                     "col.bias": _np(col.bias.grad),
                     "row.weight": _np(row.weight.grad),
                     "row.bias": _np(row.bias.grad)}}
    emb = jmp.VocabParallelEmbedding(64, 16)
    weights["emb"] = _np(emb.weight)
    e = emb(paddle.to_tensor(inp["ids"]))
    (e * e).sum().backward()
    ref["emb"], ref["emb_grad"] = _np(e), _np(emb.weight.grad)
    lg = paddle.to_tensor(inp["logits"], stop_gradient=False)
    ce = jmp.ParallelCrossEntropy()(lg, paddle.to_tensor(inp["labels"]))
    ce.sum().backward()
    ref["ce"], ref["ce_grad"] = _np(ce), _np(lg.grad)
    return weights, ref


def _jax_reference(inp):
    """:func:`_jax_layers` with the JAX package's recording switched on
    for the call and restored after.  The package keeps one recording
    switch for all threads (``paddle_tpu/core/grad_mode.py``), which each
    ``no_grad`` saves and restores, so engines tracing on several threads
    at once (a fleet's replicas, a front end's scheduler thread beside
    the test's) can leave it off for the rest of the process; every later
    eager backward in that process then leaves ``.grad`` unset."""
    with paddle.set_grad_enabled(True):
        return _jax_layers(inp)


@pytest.fixture(scope="module")
def layers(world):
    inp = _layer_inputs()
    weights, ref = _jax_reference(inp)
    out = world.run("job_mp_layers", weights=weights, emb=weights["emb"],
                    **inp)
    return inp, weights, ref, out


def _dense_layers(inp, weights, gather):
    """The port's layers without parallelize (their dense selves)."""
    col = tmp.ColumnParallelLinear(16, 32, gather_output=gather)
    row = tmp.RowParallelLinear(32, 8, input_is_parallel=not gather)
    with torch.no_grad():
        for mod, n in ((col, "col"), (row, "row")):
            mod.weight.copy_(torch.from_numpy(weights[n + ".weight"]))
            mod.bias.copy_(torch.from_numpy(weights[n + ".bias"]))
    x = torch.from_numpy(inp["x"]).requires_grad_(True)
    y = row(torch.relu(col(x)))
    (y * torch.from_numpy(inp["dy"])).sum().backward()
    return y.detach().numpy(), x.grad.numpy(), {
        "col.weight": col.weight.grad.numpy(),
        "col.bias": col.bias.grad.numpy(),
        "row.weight": row.weight.grad.numpy(),
        "row.bias": row.bias.grad.numpy()}


def test_jax_reference_under_a_switch_left_off(monkeypatch):
    """The reference the layer tests hold against does not depend on the
    JAX package's recording switch as another test left it: with the
    switch off it is the same, and the switch is off again after."""
    from paddle_tpu.core import grad_mode
    inp = _layer_inputs()
    _w, want = _jax_reference(inp)
    monkeypatch.setattr(grad_mode, "_grad_enabled", [False])
    _w, got = _jax_reference(inp)
    assert not paddle.is_grad_enabled()
    for key in ("y", "dx", "emb_grad", "ce_grad"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


@pytest.mark.parametrize("tag", ["parallel", "gather"])
def test_column_row_pair_matches_dense_and_jax(layers, tag):
    """Column (gather_output False / True) -> relu -> Row
    (input_is_parallel True / False): output, dx and every weight's
    gradient (gathered) on every rank, against the dense port layers and
    the JAX layers."""
    inp, weights, ref, out = layers
    y, dx, grads = _dense_layers(inp, weights, tag == "gather")
    for want in ((ref["y"], ref["dx"], ref["grads"]), (y, dx, grads)):
        for r in range(4):
            o = out[r]
            np.testing.assert_allclose(o["y_" + tag], want[0], rtol=1e-5,
                                       atol=1e-5)
            np.testing.assert_allclose(o["dx_" + tag], want[1], rtol=1e-5,
                                       atol=1e-5)
            for n, g in want[2].items():
                np.testing.assert_allclose(o["grads_" + tag][n], g,
                                           rtol=1e-5, atol=1e-5, err_msg=n)


def test_vocab_parallel_embedding_matches_jax(layers):
    inp, weights, ref, out = layers
    dense = tmp.VocabParallelEmbedding(64, 16)
    with torch.no_grad():
        dense.weight.copy_(torch.from_numpy(weights["emb"]))
    np.testing.assert_allclose(
        dense(torch.from_numpy(inp["ids"])).detach().numpy(), ref["emb"],
        rtol=1e-6)
    for r in range(4):
        np.testing.assert_allclose(out[r]["emb"], ref["emb"], rtol=1e-6)
        np.testing.assert_allclose(out[r]["emb_grad"], ref["emb_grad"],
                                   rtol=1e-6, atol=1e-6)


def test_parallel_cross_entropy_matches_jax(layers):
    """The vocab-sharded CE (three all-reduces, no gathered logits):
    per-row loss on every rank and the gradient of the rank's vocab
    shard, against the JAX layer over the full logits."""
    inp, _w, ref, out = layers
    dense = tmp.ParallelCrossEntropy()(torch.from_numpy(inp["logits"]),
                                       torch.from_numpy(inp["labels"]))
    np.testing.assert_allclose(dense.numpy(), ref["ce"], rtol=1e-5)
    for r in range(4):
        mp = r % 2
        np.testing.assert_allclose(out[r]["ce"], ref["ce"], rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(out[r]["ce_grad"],
                                   ref["ce_grad"][:, mp * 32:(mp + 1) * 32],
                                   rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# the GPT Megatron layout
# ---------------------------------------------------------------------------

def _jax_gpt(seed=11):
    paddle.seed(seed)
    m = JGPT(JGPTConfig.tiny())
    return m, {k: _np(v) for k, v in m.state_dict().items()}


def _ids():
    return np.random.default_rng(1).integers(0, 512, (4, 32)).astype(
        np.int64)


def _jax_hybrid_losses(steps, clip):
    """The JAX package's ``test_gpt_tiny_hybrid_step``: parallelize on a
    (dp 2, mp 2) mesh and a TrainStep over a ('dp', None) batch (AdamW at
    lr 1e-3, epsilon 1e-6 as the port's parity gates)."""
    from paddle_tpu.distributed.parallel_base import parallelize
    from paddle_tpu.jit import TrainStep
    model, weights = _jax_gpt()
    prev = jmesh.get_mesh()
    try:
        mesh = jmesh.init_mesh({"dp": 2, "mp": 2})
        parallelize(model)
        crit = JCrit()
        opt = paddle.optimizer.AdamW(
            parameters=model.parameters(), learning_rate=1e-3, epsilon=1e-6,
            grad_clip=None if clip is None else
            paddle.nn.ClipGradByGlobalNorm(clip))
        step = TrainStep(model, lambda lg, lb: crit(lg, lb), opt)
        x = jax.device_put(jnp.asarray(_ids().astype(np.int32)),
                           NamedSharding(mesh, JP("dp", None)))
        losses = [float(step(x, x).numpy()) for _ in range(steps)]
    finally:
        jmesh.set_mesh(prev)
    return weights, losses


@pytest.mark.parametrize("clip", [None, 0.5])
def test_gpt_tiny_hybrid_step_tracks_jax(world, clip):
    """Five steps at dp2 x mp2 (TrainStep(in_shardings=...) over a
    parallelized model; with a global-norm clip too): every rank's losses
    equal, within 1e-5 of the JAX hybrid step's and the port unsharded's;
    the gathered state after the steps within 1e-5 of the unsharded
    port's."""
    weights, jax_losses = _jax_hybrid_losses(5, clip)
    ids = _ids()
    out = world.run("job_gpt_hybrid", weights=weights, ids=ids, steps=5,
                    clip=clip)
    ref_losses, ref_state, _ = _torch_dist.gpt_train(weights, ids, 5,
                                                     clip=clip)
    assert np.all(np.isfinite(ref_losses)) and ref_losses[-1] < ref_losses[0]
    for losses, state, _shards in out:
        assert losses == out[0][0]
        np.testing.assert_allclose(losses, jax_losses, rtol=1e-5)
        np.testing.assert_allclose(losses, ref_losses, rtol=1e-5)
        for n, v in ref_state.items():
            np.testing.assert_allclose(state[n], v, rtol=1e-5, atol=1e-5,
                                       err_msg=n)


def test_hybrid_step_with_flat_master(world):
    """flat_master=True at dp2 x mp2: the replicated masters in the flat
    buffer, the shards per name; losses as the unsharded port's."""
    _m, weights = _jax_gpt()
    ids = _ids()
    out = world.run("job_gpt_hybrid", weights=weights, ids=ids, steps=3,
                    flat_master=True)
    ref_losses, _s, _ = _torch_dist.gpt_train(weights, ids, 3,
                                              flat_master=True)
    for losses, _state, _shards in out:
        np.testing.assert_allclose(losses, ref_losses, rtol=1e-5)


def test_gathered_state_and_dealing_rule(world):
    """parallelize then gather gives the full state back bit for bit; each
    rank's shards are convert.shard_paddle_tpu_state's for its mp rank,
    whose inverse is convert.unshard_paddle_tpu_state; the fused q/k/v
    projection's shard is [q | k | v] of the rank's own heads."""
    _m, weights = _jax_gpt()
    out = world.run("job_gpt_unshard", weights=weights)
    per_mp = {}
    for full, local, mp in out:
        for n, v in weights.items():
            np.testing.assert_array_equal(full[n], v, err_msg=n)
        want = convert.shard_paddle_tpu_state(weights, mp, 2)
        assert set(local) == set(want)
        for n, v in want.items():
            np.testing.assert_array_equal(local[n], v, err_msg=n)
        per_mp[mp] = local
        H = 64
        qkv = weights["gpt.h.0.attn.qkv_proj.weight"]
        cols = np.concatenate([qkv[:, p * H + mp * 32:p * H + (mp + 1) * 32]
                               for p in range(3)], axis=1)
        np.testing.assert_array_equal(local["gpt.h.0.attn.qkv_proj.weight"],
                                      cols)
        assert local["gpt.wte.weight"].shape == (256, 64)
        assert local["gpt.h.0.mlp.fc2.weight"].shape == (64, 64)
        assert local["gpt.h.0.ln1.weight"].shape == (64,)
    back = convert.unshard_paddle_tpu_state([per_mp[0], per_mp[1]])
    for n, v in weights.items():
        np.testing.assert_array_equal(back[n], v, err_msg=n)


def test_global_norm_clip_over_shards_matches_unsharded(world):
    """clip_grad_norm_ over the mp shards (squares of the sharded grads
    summed over mp, the replicated ones once): the norm and the clipped
    gradients, gathered, equal the unsharded clip's."""
    _m, weights = _jax_gpt()
    ids = _ids()
    out = world.run("job_clip", weights=weights, ids=ids, max_norm=0.1)
    m = _torch_dist.tiny_gpt(weights)
    x = torch.from_numpy(ids)
    GPTPretrainingCriterion()(m(x), x).backward()
    total = float(clip_grad_norm_(m.parameters(), 0.1))
    assert total > 0.1
    for got_total, grads in out:
        np.testing.assert_allclose(got_total, total, rtol=1e-5)
        for n, p in m.named_parameters():
            np.testing.assert_allclose(grads[n], p.grad.numpy(), rtol=1e-4,
                                       atol=1e-7, err_msg=n)


def test_scan_layout_at_mp_raises():
    """The stacked layout at mp > 1 builds now: each rank keeps the
    stacked (L, ...) slices that the per-layer parameters' Megatron cuts
    give, layer by layer (q/k/v by heads in every layer's slice), as
    ``convert`` cuts a scan-layout state; a group that does not divide
    the heads still raises, as in the per-layer layout."""
    from paddle_tpu_torch.distributed.collective import Group
    from paddle_tpu_torch.distributed.parallel_base import shard_module
    from paddle_tpu_torch.models.gpt import (GPTConfig, GPTForCausalLM,
                                             per_layer_state_to_scan,
                                             scan_state_to_per_layer)
    _m, weights = _jax_gpt()
    scan_weights = per_layer_state_to_scan(weights)
    c = GPTConfig.tiny()
    c.scan_layers = True
    for rank in (0, 1):
        m = GPTForCausalLM(c)
        convert.load_paddle_tpu_state(m, scan_weights)
        fake = Group("mp", [0, 1])
        fake.rank = rank
        shard_module(m, fake)
        got = {n: p.detach().numpy() for n, p in m.named_parameters()}
        per_layer = convert.shard_paddle_tpu_state(weights, rank, 2)
        for want in (per_layer_state_to_scan(per_layer),
                     convert.shard_paddle_tpu_state(scan_weights, rank, 2)):
            assert set(want) == set(got)
            for n, w in want.items():
                np.testing.assert_array_equal(got[n], w, err_msg=n)
        back = scan_state_to_per_layer(got)
        for n, w in per_layer.items():
            np.testing.assert_array_equal(back[n], w, err_msg=n)
    three = Group("mp", [0, 1, 2])
    three.rank = 0
    with pytest.raises(ValueError, match="divide"):
        shard_module(GPTForCausalLM(c), three)
