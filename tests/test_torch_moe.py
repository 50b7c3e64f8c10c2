"""Mixture-of-Experts in the port (``paddle_tpu_torch.distributed.moe``)
against the JAX package's ``paddle_tpu.distributed.moe`` on the same
numpy inputs, in one process and on one four-rank gloo world:

* ``top1_routing`` / ``top2_routing``: the dispatch masks exactly, the
  combine weights and ``aux`` to 1e-6, capacity overflow included;
  ``random_routing``'s noise from an explicit generator;
* ``moe_apply`` with all experts local, and ``MoELayer`` with the JAX
  layer's weights (``convert.load_paddle_tpu_state``): out and grads to
  1e-5;
* ep4 and ep2 x dp2 (``moe_apply``) against JAX's ep x dp program under
  ``shard_map``; ``MoELayer`` over {"ep": 4}, its experts dealt by
  ``convert.shard_moe_state``, against the JAX layer with every expert
  local;
* pp2 x ep2: ``moe_apply`` as the block of the port's 1F1B
  ``spmd_pipeline_1f1b_hetero``, loss and grads against JAX's
  ``moe_pp_sequential_loss`` on an ep2 mesh (the JAX test's recipe), to
  1e-5;
* ``global_scatter`` / ``global_gather`` round trip."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from _jax_compat import shard_map

import paddle_tpu as paddle
from paddle_tpu.distributed import moe as jmoe

import _torch_dist
import _torch_sep
from paddle_tpu_torch.convert import shard_moe_state
from paddle_tpu_torch.distributed import moe as tmoe


@pytest.fixture(scope="module")
def world():
    w = _torch_dist.World(4)
    yield w
    w.close()


def _close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("capacity", [6, 3])
@pytest.mark.parametrize("top_k", [1, 2])
def test_routing_matches_jax(top_k, capacity):
    """32 tokens over 4 experts; capacity 3 drops tokens."""
    logits = np.random.RandomState(3).randn(32, 4).astype(np.float32)
    jfn = jmoe.top1_routing if top_k == 1 else jmoe.top2_routing
    tfn = tmoe.top1_routing if top_k == 1 else tmoe.top2_routing
    jd, jc, ja = jfn(jnp.asarray(logits), capacity, 4)
    td, tc, ta = tfn(torch.from_numpy(logits), capacity, 4)
    assert td.dtype == torch.bool and td.shape == (32, 4, capacity)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    _close(tc.numpy(), jc, 1e-6)
    _close(float(ta), float(ja), 1e-6)
    if capacity == 3:
        assert int(td.sum()) < 32 * top_k       # some tokens were dropped


def test_random_routing_draws_from_the_generator():
    """``random_routing`` sends about 1% of the tokens to a random expert,
    drawn from the given generator: the same seed gives the same routes,
    and without the flag (or a generator) routing is the plain one."""
    logits = torch.from_numpy(
        np.random.RandomState(4).randn(4096, 8).astype(np.float32))

    def route(seed, flag=True):
        g = torch.Generator().manual_seed(seed) if seed is not None else None
        return tmoe.top1_routing(logits, 4096, 8, key=g,
                                 random_routing=flag)[0]
    plain = route(None)
    assert torch.equal(route(0, flag=False), plain)
    a, b = route(0), route(0)
    assert torch.equal(a, b)
    moved = int((a.any(-1) != plain.any(-1)).any(-1).sum())
    assert 0 < moved < 4096 * 0.02


def _params(seed=21, E=4, d=16, h=32):
    rng = np.random.RandomState(seed)
    return {"gate": (rng.randn(d, E) * 0.5).astype(np.float32),
            "w1": (rng.randn(E, d, h) * 0.2).astype(np.float32),
            "b1": (rng.randn(E, h) * 0.1).astype(np.float32),
            "w2": (rng.randn(E, h, d) * 0.2).astype(np.float32),
            "b2": (rng.randn(E, d) * 0.1).astype(np.float32)}


def _jax_loss(p, x):
    out, aux = jmoe.moe_apply(p, x, top_k=1, capacity_factor=2.0)
    return jnp.mean(out ** 2) + 0.01 * aux


def test_moe_apply_matches_jax_all_experts_local():
    params = _params()
    x = np.random.RandomState(22).randn(4, 8, 16).astype(np.float32)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jout, jaux = jmoe.moe_apply(jp, jnp.asarray(x), top_k=1,
                                capacity_factor=2.0)
    jg = jax.grad(_jax_loss)(jp, jnp.asarray(x))
    tp = {k: torch.from_numpy(v).requires_grad_(True)
          for k, v in params.items()}
    out, aux = tmoe.moe_apply(tp, torch.from_numpy(x), top_k=1,
                              capacity_factor=2.0)
    _close(out.detach().numpy(), jout, 1e-5)
    _close(float(aux.detach()), float(jaux), 1e-6)
    loss = torch.mean(out ** 2) + 0.01 * aux
    gs = torch.autograd.grad(loss, list(tp.values()))
    for name, g in zip(tp, gs):
        _close(g.numpy(), jg[name], 1e-5)


def _jax_layer(n_experts=4, d=16, hdim=32, top_k=2, gate="gshard"):
    paddle.seed(5)
    layer = jmoe.MoELayer(d, [jmoe.ExpertFFN(d, hdim)
                              for _ in range(n_experts)], gate=gate,
                          top_k=top_k, capacity_factor=2.0)
    state = {k: np.asarray(v.numpy() if hasattr(v, "numpy") else v)
             for k, v in layer.state_dict().items()}
    return layer, state


def _jax_layer_grads(layer, x, cot):
    # the JAX package's one recording switch, on for the call whatever an
    # earlier test in this process left it at
    with paddle.set_grad_enabled(True):
        out = layer(paddle.to_tensor(x))
        loss = (out * paddle.to_tensor(cot)).sum() + layer.aux_loss
        loss.backward()
    grads = {n: np.asarray(p.grad.numpy())
             for n, p in layer.named_parameters()}
    return np.asarray(out.numpy()), float(layer.aux_loss), grads


@pytest.fixture(scope="module")
def jax_layers():
    """The JAX layer of each gate, its state, inputs and results (one
    eager run each, shared by the tests)."""
    out = {}
    for gate in ("gshard", "switch"):
        jlayer, state = _jax_layer(top_k=2 if gate == "gshard" else 1,
                                   gate=gate)
        rng = np.random.RandomState(6)
        x = rng.randn(2, 8, 16).astype(np.float32)
        cot = rng.randn(2, 8, 16).astype(np.float32)
        out[gate] = (state, x, cot) + _jax_layer_grads(jlayer, x, cot)
    return out


@pytest.mark.parametrize("gate", ["gshard", "switch"])
def test_moe_layer_matches_jax_with_carried_weights(jax_layers, gate):
    top_k = 2 if gate == "gshard" else 1
    state, x, cot, jout, jaux, jg = jax_layers[gate]
    layer = _torch_sep.moe_layer(state, 16, 32, 4, top_k, gate)
    assert set(dict(layer.named_parameters())) == set(state)
    out, aux, grads = _torch_sep.layer_grads(layer, x, cot)
    _close(out, jout, 1e-5)
    _close(aux, jaux, 1e-6)
    for name, g in grads.items():
        _close(g, jg[name], 1e-5)


def test_shard_moe_state_deals_the_experts(jax_layers):
    state = jax_layers["gshard"][0]
    parts = [shard_moe_state(state, r, 2) for r in range(2)]
    assert set(parts[1]) == {k for k in state
                             if not k.startswith("experts.")
                             or k.split(".")[1] in "01"}
    np.testing.assert_array_equal(parts[1]["experts.0.fc1.weight"],
                                  state["experts.2.fc1.weight"])
    np.testing.assert_array_equal(parts[0]["gate.gate.weight"],
                                  state["gate.gate.weight"])
    with pytest.raises(ValueError, match="over 3 ranks"):
        shard_moe_state(state, 0, 3)


def _jax_ep_dp(params, x, axes):
    """JAX's ep x dp program (tests/test_distributed.py's): out, the aux
    averaged over dp, and the grads of the pmean'd loss."""
    names = tuple(axes)
    mesh = Mesh(np.asarray(jax.devices()[:int(np.prod(list(
        axes.values())))]).reshape(tuple(axes.values())), names)
    pspec = {"gate": P(), "w1": P("ep"), "b1": P("ep"), "w2": P("ep"),
             "b2": P("ep")}
    xspec = P("dp") if "dp" in axes else P()
    jp = {k: jnp.asarray(v) for k, v in params.items()}

    def fwd(p, x_):
        out, aux = jmoe.moe_apply(p, x_, top_k=1, capacity_factor=2.0)
        if "dp" in axes:
            aux = jax.lax.pmean(aux, "dp")
        return out, aux

    out, aux = jax.jit(shard_map(fwd, mesh=mesh, in_specs=(pspec, xspec),
                                 out_specs=(xspec, P()),
                                 check_vma=False))(jp, jnp.asarray(x))

    def loss_fn(p, x_):
        loss = _jax_loss(p, x_)
        if "dp" in axes:
            loss = jax.lax.pmean(loss, "dp")
        return jax.lax.pmean(loss, "ep")
    grads = jax.jit(shard_map(jax.grad(loss_fn), mesh=mesh,
                              in_specs=(pspec, xspec),
                              out_specs=pspec))(jp, jnp.asarray(x))
    return np.asarray(out), float(aux), {k: np.asarray(v)
                                         for k, v in grads.items()}


@pytest.mark.parametrize("axes", [{"ep": 4}, {"dp": 2, "ep": 2}],
                         ids=["ep4", "ep2_dp2"])
def test_moe_apply_ep_x_dp_matches_jax_program(world, axes):
    """Each dp rank routes its own tokens; the expert bank is dealt over
    ep; the port's per-rank grads, combined by the JAX recipe (replicated
    leaves averaged over ep and dp, the bank divided by ep and averaged
    over dp), against JAX's grads of the pmean'd loss."""
    params = _params()
    x = np.random.RandomState(21).randn(4, 8, 16).astype(np.float32)
    jout, jaux, jg = _jax_ep_dp(params, x, axes)
    outs = world.run("_torch_sep:job_moe_apply", params=params, x=x,
                     axes=axes)
    dp = axes.get("dp", 1)
    ep = axes["ep"]
    # rank = dp coordinate * ep + ep coordinate; every ep rank of a dp
    # slice returns the same tokens' outputs
    for r, (out, aux, grads, a2a) in enumerate(outs):
        i = r // ep
        _close(out, jout[i * (4 // dp):(i + 1) * (4 // dp)], 1e-5)
        _close(aux, jaux, 1e-6)
        e = r % ep
        nle = 4 // ep
        for k, g in grads.items():
            want = jg[k] if k == "gate" else jg[k][e * nle:(e + 1) * nle]
            _close(g, want, 1e-5)
        # the dispatch and the combine forward, the combine's backward (x
        # takes no gradient, so the dispatch's exchange needs none)
        assert a2a == 3


def test_moe_layer_over_ep4_matches_jax_all_local(world, jax_layers):
    state, x, cot, jout, jaux, jg = jax_layers["gshard"]
    outs = world.run("_torch_sep:job_moe_layer", state=state, x=x, cot=cot,
                     d_model=16, d_hidden=32, n_experts=4, top_k=2,
                     gate="gshard")
    for r, (out, aux, grads) in enumerate(outs):
        _close(out, jout, 1e-5)
        _close(aux, jaux, 1e-6)
        for name, g in grads.items():
            if name.startswith("experts."):
                _, i, rest = name.split(".", 2)
                name = "experts.%d.%s" % (int(i) + r, rest)
            _close(g, jg[name], 1e-5)


def _jax_pp_reference():
    """JAX's sequential MoE model on an ep2 mesh (a dp axis of one), with
    the JAX test's recipe: loss and full grads."""
    (params, x, labels, embed_fn, block_fn, head_loss_fn,
     dims) = jmoe.build_moe_pp_parity_demo()
    mesh = Mesh(np.asarray(jax.devices()[:2]).reshape(2, 1), ("ep", "dp"))
    bspec = {k: P(None, None, "ep") if k != "gate" else P()
             for k in ("gate", "w1", "b1", "w2", "b2")}
    spec = {"embed": {"we": P()}, "blocks": bspec, "head": {"wh": P()}}

    def seq_fn(p, x_, l_):
        loss, g = jax.value_and_grad(jmoe.moe_pp_sequential_loss)(
            p, x_, l_, embed_fn, block_fn, head_loss_fn, dims)
        nep = jax.lax.psum(1, "ep")
        mean = lambda a: jax.lax.pmean(a, "ep")
        g = {"embed": jax.tree_util.tree_map(mean, g["embed"]),
             "head": jax.tree_util.tree_map(mean, g["head"]),
             "blocks": {k: (mean(v) if k == "gate" else v / nep)
                        for k, v in g["blocks"].items()}}
        return loss, g
    loss, g = jax.jit(shard_map(seq_fn, mesh=mesh,
                                in_specs=(spec, P(None, "dp"),
                                          P(None, "dp")),
                                out_specs=(P(), spec),
                                check_vma=False))(params, x, labels)
    return float(loss), jax.tree_util.tree_map(np.asarray, g)


def test_moe_inside_the_1f1b_pipeline_matches_jax_sequential(world):
    """pp2 x ep2: the two ep ranks of a stage run one schedule, so their
    all-to-alls stay in lockstep (each issues as many as the other, and
    the run ends); loss and grads against JAX's sequential reference, and
    so are the port's own ``moe_pp_sequential_loss`` and its grads."""
    jloss, jg = _jax_pp_reference()
    outs = world.run("_torch_sep:job_moe_pp")
    stages = [o[3] for o in outs]
    assert stages == [0, 0, 1, 1]
    # rank = stage * 2 + ep coordinate: both ep ranks of a stage issued
    # the same all-to-alls (4 microbatches x 1 block x 2 forward + 2
    # backward)
    for st in (0, 1):
        a, b = outs[2 * st][2], outs[2 * st + 1][2]
        assert a.get("all_to_all_single") == b.get("all_to_all_single") \
            == 4 * 4
    for r, (loss, g, _issued, st, seq_loss, seq) in enumerate(outs):
        _close(loss, jloss, 1e-5)
        _close(seq_loss, jloss, 1e-5)
        _close(g["embed"]["we"], jg["embed"]["we"], 1e-5)
        _close(g["head"]["wh"], jg["head"]["wh"], 1e-5)
        e = r % 2
        for k, v in g["blocks"].items():
            want = jg["blocks"][k][st:st + 1]
            if k != "gate":
                want = want[:, :, e:e + 1]
            _close(v, want, 1e-5)
        # the port's own sequential reference (every stage's blocks)
        for part in ("embed", "head"):
            for k, v in seq[part].items():
                _close(v, jg[part][k], 1e-5)
        for k, v in seq["blocks"].items():
            _close(v, jg["blocks"][k] if k == "gate"
                   else jg["blocks"][k][:, :, e:e + 1], 1e-5)


def test_global_scatter_round_trip(world):
    x = np.arange(4 * 8 * 3, dtype=np.float32).reshape(4, 8, 3)
    outs = world.run("_torch_sep:job_global_scatter", x=x)
    for r, (got, back) in enumerate(outs):
        # rank r receives piece r (2 rows) of every rank, in rank order
        np.testing.assert_array_equal(
            got, np.concatenate([x[j, 2 * r:2 * r + 2] for j in range(4)]))
        np.testing.assert_array_equal(back, x[r])
    # without an ep group, both are the identity
    t = torch.from_numpy(x[0])
    assert tmoe.global_scatter(t) is t and tmoe.global_gather(t) is t
