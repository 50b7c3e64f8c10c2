"""Pipeline parallelism in the port (``distributed.pipeline``) on a
four-rank gloo world, against the JAX package: ``SegmentLayers``' bounds;
``SharedLayerDesc`` ties; the forward pipeline and the homogeneous 1F1B
at pp = 2 and 4 against ``spmd_pipeline`` / ``spmd_pipeline_1f1b`` under
``shard_map`` on the CPU mesh (loss and grads to 1e-5); the hetero 1F1B
at pp2 x dp2; tests/test_pipeline_fleet.py's tied-embedding model through
the port's fleet at pp2 x dp2 and pp4, 3 SGD steps, against JAX's
``train_batch`` at pp2 x dp2 (that test's limits); AMP bf16 O2 with AdamW
(f32 masters, the loss falls); fp16 under a GradScaler (an overflow
skipped on every rank); ``state_dict()`` on every rank; pp2 x mp2 with
the port's Megatron GPT blocks against the sequential run; the
single-process ``train_batch`` against JAX's to 1e-6; the contract
errors.  The JAX references are computed once, with the JAX package's
recording switch on for the call."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from _jax_compat import shard_map
from jax.sharding import Mesh, PartitionSpec as JP

import paddle_tpu as paddle
from paddle_tpu.distributed import fleet as jfleet
from paddle_tpu.distributed import mesh as jmesh
from paddle_tpu.distributed import pipeline as jpipe
from test_pipeline_fleet import Criterion as JCriterion
from test_pipeline_fleet import _data as jax_data
from test_pipeline_fleet import _descs as jax_descs

import _torch_dist
import _torch_pipe as TP
from paddle_tpu_torch.distributed import pipeline as tpipe

SPMD_CASES = [(2, 5), (4, 8)]     # (stages, microbatches)


@pytest.fixture(scope="module")
def world():
    w = _torch_dist.World(4)
    yield w
    w.close()


def _np(t):
    return np.asarray(t.numpy())


def _jstage(params, x):
    h = jnp.tanh(x @ params["w1"] + params["b1"])
    return h @ params["w2"] + x


def _jmse(out, label):
    return jnp.mean((out - label) ** 2)


def _spmd_inputs(pp, m):
    rng = np.random.RandomState(pp)
    d, mb = 16, 4
    params = {"w1": (rng.randn(pp, d, d) * 0.3).astype(np.float32),
              "b1": (rng.randn(pp, d) * 0.1).astype(np.float32),
              "w2": (rng.randn(pp, d, d) * 0.3).astype(np.float32)}
    x = rng.randn(m, mb, d).astype(np.float32)
    labels = rng.randn(m, mb, d).astype(np.float32)
    return params, x, labels


def _jax_spmd(pp, m):
    params, x, labels = _spmd_inputs(pp, m)
    mesh = Mesh(np.asarray(jax.devices()[:pp]), ("pp",))
    spec = {k: JP("pp") for k in params}
    fwd = shard_map(
        lambda p, x_: jpipe.spmd_pipeline(_jstage, p, x_, pp, m),
        mesh=mesh, in_specs=(spec, JP()), out_specs=JP())
    pipe = shard_map(
        lambda p, x_, l_: jpipe.spmd_pipeline_1f1b(_jstage, _jmse, p, x_,
                                                   l_, pp, m),
        mesh=mesh, in_specs=(spec, JP(), JP()), out_specs=(JP(), spec))
    out = jax.jit(fwd)(params, x)
    loss, grads = jax.jit(pipe)(params, x, labels)
    return {"out": np.asarray(out), "loss": float(loss),
            "grads": {k: np.asarray(v) for k, v in grads.items()}}


def _hetero_inputs():
    rng = np.random.RandomState(5)
    n_st, m, mb, d = 2, 4, 4, 8
    params = {
        "embed": {"we": (rng.randn(d, d) * 0.3).astype(np.float32)},
        "blocks": {"w": (rng.randn(n_st, 1, d, d) * 0.3).astype(
            np.float32)},
        "head": {"wh": (rng.randn(d, d) * 0.3).astype(np.float32)}}
    x = rng.randn(m, mb, d).astype(np.float32)
    labels = rng.randn(m, mb, d).astype(np.float32)
    return params, x, labels


def _jax_hetero():
    params, x, labels = _hetero_inputs()
    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2), ("pp", "dp"))
    pspec = {"embed": {"we": JP()}, "blocks": {"w": JP("pp")},
             "head": {"wh": JP()}}
    pipe = jax.jit(shard_map(
        lambda p, x_, l_: jpipe.spmd_pipeline_1f1b_hetero(
            lambda ep, xb: xb @ ep["we"],
            lambda bp, h: jnp.tanh(h @ bp["w"]) + h,
            lambda hp, ep, h, lbl: jnp.mean((h @ hp["wh"] - lbl) ** 2),
            p, x_, l_, 2, 1, 4, batch_axes=("dp",)),
        mesh=mesh, in_specs=(pspec, JP(None, "dp"), JP(None, "dp")),
        out_specs=(JP(), pspec), check_vma=False))
    loss, grads = pipe(params, x, labels)
    return float(loss), jax.tree_util.tree_map(np.asarray, grads)


def _jax_fleet_run(weights_seed, data, pp, dp):
    """tests/test_pipeline_fleet.py's compiled run through the JAX fleet
    at (pp, dp): losses and trained parameters."""
    strategy = jfleet.DistributedStrategy()
    strategy.hybrid_configs = {"pp_degree": pp, "dp_degree": dp}
    strategy.pipeline_configs = {"accumulate_steps": 4}
    jfleet.init(is_collective=True, strategy=strategy)
    try:
        paddle.seed(weights_seed)
        pl = jpipe.PipelineLayer(jax_descs(), num_stages=pp,
                                 loss_fn=JCriterion())
        model = jfleet.distributed_model(pl)
        opt = paddle.optimizer.SGD(learning_rate=0.1,
                                   parameters=model.parameters())
        losses = [float(model.train_batch((x, y), opt).numpy())
                  for x, y in data]
        model.sync_to_layers()
        return losses, {k: _np(v) for k, v in pl.named_parameters()}
    finally:
        jmesh.init_mesh({"dp": 1})


def _jax_single(weights_seed, data):
    """The JAX ``train_batch`` without a ``pp`` axis (the in-process
    microbatch loop): losses and trained parameters."""
    jmesh.init_mesh({"dp": 1})
    paddle.seed(weights_seed)
    pl = jpipe.PipelineLayer(jax_descs(), num_stages=2, loss_fn=JCriterion())
    model = jpipe.PipelineParallel(pl)
    model.accumulate_steps = 4
    opt = paddle.optimizer.SGD(learning_rate=0.1,
                               parameters=model.parameters())
    losses = [float(model.train_batch((x, y), opt).numpy()) for x, y in data]
    return losses, {k: _np(v) for k, v in pl.named_parameters()}


def _jax_references():
    """Every JAX reference of this module, computed once."""
    paddle.seed(11)
    pl = jpipe.PipelineLayer(jax_descs(), num_stages=2, loss_fn=JCriterion())
    weights = {k: _np(v) for k, v in pl.state_dict().items()}
    data = jax_data(3)
    ref = {"weights": weights,
           "names": [k for k, _ in pl.named_parameters()],
           "data": [(_np(x), _np(y)) for x, y in data],
           "fleet": _jax_fleet_run(11, data, 2, 2),
           "single": _jax_single(11, data),
           "spmd": {pp: _jax_spmd(pp, m) for pp, m in SPMD_CASES},
           "hetero": _jax_hetero()}
    return ref


def _jax_reference():
    """:func:`_jax_references` with the JAX package's recording switch on
    for the call and restored after (one switch for all threads, which
    another test's threads can leave off)."""
    with paddle.set_grad_enabled(True):
        return _jax_references()


@pytest.fixture(scope="module")
def jax_ref():
    return _jax_reference()


def test_jax_reference_under_a_switch_left_off(jax_ref, monkeypatch):
    """The references do not depend on the JAX package's recording switch
    as another test left it: with the switch off, the single-process run
    is the same, and the switch is off again after."""
    from paddle_tpu.core import grad_mode
    monkeypatch.setattr(grad_mode, "_grad_enabled", [False])
    with paddle.set_grad_enabled(True):
        paddle.seed(11)
        got = _jax_single(11, jax_data(3))
    assert not paddle.is_grad_enabled()
    assert got[0] == jax_ref["single"][0]


@pytest.mark.parametrize("n,parts", [(10, 4), (8, 2), (26, 2), (26, 3),
                                     (7, 7), (5, 8)])
def test_segment_layers_bounds_match_jax(n, parts):
    want = jpipe.SegmentLayers(list(range(n)), parts).do_segment()
    assert tpipe.SegmentLayers(list(range(n)), parts).do_segment() == want


def test_segment_layers_other_method_raises():
    with pytest.raises(NotImplementedError, match="layer"):
        tpipe.SegmentLayers(list(range(4)), 2, method="layer").do_segment()


def test_shared_desc_ties_weights_eager(jax_ref):
    """The head aliases the embedding's word weight; the tied weight is
    listed once, under JAX's names; the state loads by them."""
    pl = TP.pipeline_layer(jax_ref["weights"], 4)
    layers = list(pl.run_function)
    assert layers[-1].shared.word.weight is layers[0].word.weight
    ids = [id(p) for p in pl.parameters()]
    assert len(ids) == len(set(ids))
    assert [k for k, _ in pl.named_parameters()] == jax_ref["names"]
    assert pl.segment_bounds == [0, 3, 6, 8, 10]
    for k, v in jax_ref["weights"].items():
        np.testing.assert_array_equal(pl.state_dict()[k].numpy(), v)


@pytest.fixture(scope="module")
def spmd(world):
    out = {}
    for pp, m in SPMD_CASES:
        params, x, labels = _spmd_inputs(pp, m)
        out[pp] = world.run("_torch_pipe:job_spmd", params=params, x=x,
                            labels=labels, pp=pp)
    return out


@pytest.mark.parametrize("pp,m", SPMD_CASES)
def test_spmd_pipelines_match_jax(jax_ref, spmd, pp, m):
    """The forward pipeline's outputs on every rank, the 1F1B loss on
    every rank and each stage's grads, against the JAX schedules under
    shard_map, to 1e-5; 2 (m + 2 (pp - 1)) permutes a 1F1B step."""
    ref = jax_ref["spmd"][pp]
    for stage, out, loss, grads, permutes in spmd[pp]:
        np.testing.assert_allclose(out, ref["out"], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(loss, ref["loss"], rtol=1e-5)
        for k, g in grads.items():
            np.testing.assert_allclose(g[0], ref["grads"][k][stage],
                                       rtol=1e-5, atol=1e-5, err_msg=k)
        assert permutes == 2 * (m + 2 * (pp - 1))


def test_ppermute_partial_permutations(world):
    """A rank that sends or receives nothing under a partial permutation
    (the 1F1B handoffs) hands the backend an empty tensor: the receiver
    gets its source's tensor, every other rank zeros, as
    ``lax.ppermute``; synchronous and in flight alike."""
    outs = world.run("_torch_pipe:job_ppermute_partial")
    n = len(outs)
    for r, out in enumerate(outs):
        want = {"first_pair": 1.0 if r == 1 else 0.0,
                "forward": float(r) if r > 0 else 0.0,
                "backward": float(r + 2) if r < n - 1 else 0.0}
        for name, v in want.items():
            for key in (name, name + "_async"):
                np.testing.assert_array_equal(out[key],
                                              np.full((2, 3), v), key)


def test_hetero_1f1b_matches_jax(jax_ref, world):
    """The heterogeneous schedule at pp2 x dp2 (rows sharded over dp,
    the whole embed-grad accumulator in place of JAX's row-sharded one):
    loss and grads against JAX's to 1e-5; a loss scale leaves the loss
    and scales the grads."""
    loss_ref, g_ref = jax_ref["hetero"]
    params, x, labels = _hetero_inputs()
    plain = world.run("_torch_pipe:job_hetero", params=params, x=x,
                      labels=labels, pp=2)
    scaled = world.run("_torch_pipe:job_hetero", params=params, x=x,
                       labels=labels, pp=2, loss_scale=4.0)
    for (stage, loss, grads), (_s, loss4, grads4) in zip(plain, scaled):
        np.testing.assert_allclose(loss, loss_ref, rtol=1e-5)
        np.testing.assert_allclose(loss4, loss_ref, rtol=1e-5)
        for part, key in (("embed", "we"), ("head", "wh")):
            np.testing.assert_allclose(grads[part][key], g_ref[part][key],
                                       rtol=1e-5, atol=1e-6)
            np.testing.assert_allclose(grads4[part][key],
                                       4.0 * grads[part][key], rtol=1e-6)
        np.testing.assert_allclose(grads["blocks"]["w"][0],
                                   g_ref["blocks"]["w"][stage],
                                   rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def fleet_runs(jax_ref, world):
    return {(pp, dp): world.run("_torch_pipe:job_fleet",
                                weights=jax_ref["weights"],
                                data=jax_ref["data"], pp=pp, dp=dp)
            for pp, dp in ((2, 2), (4, 1))}


@pytest.mark.parametrize("pp,dp", [(2, 2), (4, 1)])
def test_fleet_tied_embeddings_match_jax(jax_ref, fleet_runs, pp, dp):
    """fleet.init + distributed_model + train_batch, 3 SGD steps: every
    rank's losses and trained parameters (tied embedding included)
    against JAX's pp2 x dp2 train_batch, within
    tests/test_pipeline_fleet.py's limits; 2 (m + 2 (pp - 1)) permutes a
    step; at most min(m, 2 (pp - 1 - s) + 1) microbatches in flight on
    stage s."""
    ref_losses, ref_params = jax_ref["fleet"]
    for out in fleet_runs[(pp, dp)]:
        np.testing.assert_allclose(out["losses"], ref_losses, rtol=2e-4,
                                   atol=1e-5)
        assert set(out["params"]) == set(ref_params)
        for k, v in ref_params.items():
            np.testing.assert_allclose(out["params"][k], v, atol=5e-4,
                                       rtol=1e-3, err_msg=k)
        assert out["permutes"] == 2 * (4 + 2 * (pp - 1))
        assert out["peak"] == min(4, 2 * (pp - 1 - out["stage"]) + 1)


def test_state_dict_every_rank_matches_single_rank(jax_ref, fleet_runs):
    """``state_dict()`` on every rank holds the whole trained model (the
    other stages' blocks gathered), equal to the single-rank port run's
    state (the in-process microbatch loop) to 1e-5, and JAX's
    single-process ``train_batch`` tracks the port's to 1e-6."""
    pl = TP.pipeline_layer(jax_ref["weights"], 2)
    model = tpipe.PipelineParallel(pl)
    model.accumulate_steps = 4
    from paddle_tpu_torch.optimizer import SGD
    opt = SGD(learning_rate=0.1, parameters=model.parameters())
    losses = [float(model.train_batch((torch.tensor(x), torch.tensor(y)),
                                      opt))
              for x, y in jax_ref["data"]]
    want = {k: v.numpy() for k, v in model.state_dict().items()}
    for runs in fleet_runs.values():
        for out in runs:
            assert set(out["state"]) == set(want)
            for k, v in want.items():
                np.testing.assert_allclose(out["state"][k], v,
                                           rtol=1e-5, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(losses, jax_ref["single"][0], rtol=1e-6)
    for k, v in jax_ref["single"][1].items():
        np.testing.assert_allclose(TP.np_params(pl)[k], v, rtol=1e-6,
                                   atol=1e-7, err_msg=k)


def test_bf16_o2_adamw_has_f32_masters(jax_ref, world):
    """AMP O2 bf16 at pp2 x dp2 with AdamW: the step's block slots carry
    f32 masters of the bf16 parameters, the losses are finite and fall,
    and every rank reports the same ones."""
    outs = world.run("_torch_pipe:job_fleet_amp", weights=jax_ref["weights"],
                     data=jax_ref["data"] + jax_ref["data"][:1],
                     dtype="bfloat16")
    for out in outs:
        assert out["masters"] == ["torch.float32"]
        assert out["param_dtypes"] == ["torch.bfloat16"]
        assert all(np.isfinite(out["losses"]))
        assert out["losses"][-1] < out["losses"][0]
        assert out["losses"] == outs[0]["losses"]


def test_fp16_grad_scaler_skips_overflow_on_every_rank(jax_ref, world):
    """fp16 under a GradScaler at 2^40: the first step overflows, is
    skipped on every rank with the parameters untouched, and the scale
    halves; at 2^10 training moves and stays finite, no new overflow."""
    outs = world.run("_torch_pipe:job_fleet_amp", weights=jax_ref["weights"],
                     data=jax_ref["data"] + jax_ref["data"][:1],
                     dtype="float16")
    for out in outs:
        assert out["skipped_first"] is True
        assert out["scales"] == [2.0 ** 39, 2.0 ** 10]
        assert out["masters"] == ["torch.float32"]
        assert all(np.isfinite(out["losses"]))
        assert out["losses"][-1] < out["losses"][0]


def test_state_dict_current_and_rebuilds(jax_ref, world):
    """``state_dict()`` reflects a trained step without a manual sync; a
    changed ``accumulate_steps`` rebuilds the step from the trained
    weights and carries the same optimizer's state (its step count)."""
    for out in world.run("_torch_pipe:job_rebuild",
                         weights=jax_ref["weights"], data=jax_ref["data"]):
        assert out["changed"]
        assert out["rebuilt"] and out["steps"] == [1, 2]
        assert np.isfinite(out["loss"])


def test_pp_mp_gpt_blocks_match_sequential(world):
    """pp2 x mp2: the port's GPT blocks in the Megatron layout as the
    stages (a tied head with the final LayerNorm), AdamW, 3 steps of two
    microbatches: losses and the gathered trained state against the
    sequential run of the same layers (atol 1e-5: the attention key
    bias's true gradient is zero, so Adam turns each side's rounding
    noise into steps of up to lr * noise / epsilon, ~1e-6 a step)."""
    ids = np.random.default_rng(3).integers(0, 512, (4, 16))
    want_losses, want_state = TP.gpt_sequential(ids)
    for losses, state in world.run("_torch_pipe:job_pp_mp", ids=ids):
        np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
        for k, v in want_state.items():
            np.testing.assert_allclose(state[k], v, rtol=1e-4, atol=1e-5,
                                       err_msg=k)


def test_contract_errors(jax_ref, world):
    """The compiled pipeline's contract, raised with the JAX package's
    messages: an indivisible batch or microbatch, ragged or heterogeneous
    blocks, no loss_fn; ZeRO x pipeline refused naming ROADMAP §A5."""
    out = world.run("_torch_pipe:job_contract_errors",
                    weights=jax_ref["weights"])[0]
    assert "not divisible by accumulate_steps" in out["indivisible_batch"]
    assert "data-parallel extent dp*sdp=2" in out["indivisible_dp"]
    assert "not divisible by pp=2" in out["ragged_blocks"]
    assert "structurally identical" in out["heterogeneous_blocks"]
    assert "loss_fn" in out["no_loss_fn"]
    assert out["zero_x_pipeline"].startswith("NotImplementedError") \
        and "§A5" in out["zero_x_pipeline"]


def test_huge_embedding_warns(jax_ref, monkeypatch):
    """The embedding's f32 accumulator is whole on every stage: over the
    threshold the step warns before its first run, under it it stays
    silent."""
    import warnings

    from paddle_tpu_torch.optimizer import SGD

    def build():
        pl = TP.pipeline_layer(jax_ref["weights"], 1)
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            tpipe._CompiledPipelineStep(
                pl, SGD(learning_rate=0.1, parameters=pl.parameters()), 1, 4)
        return any("REPLICATED per pipeline stage" in str(x.message)
                   for x in w)
    assert not build()
    monkeypatch.setattr(tpipe, "_EMBED_REPLICATION_WARN_BYTES", 64)
    assert build()
