"""The GPT's sequence sharding over ``sep`` in the port
(``paddle_tpu_torch/models/gpt.py``: each rank runs its contiguous rows
of every sequence, the ring inside each block's attention) against the
JAX package's one-device ``TrainStep`` on the same weights and global
batch, on one four-rank gloo world:

* the tiny GPT on {"sep": 2} (ranks 2 and 3 idle), {"dp": 2, "sep": 2}
  and {"sep": 4}, per layer and scan-layers, with recompute, with
  ``in_shardings`` ``P("dp")``, ``P("dp", "sep")`` or none, under AdamW
  and under SGD (whose step is proportional to the gradient, so a mean
  over 'sep' where a sum is due shows): five steps' losses to 1e-5 of
  JAX's, and the gradients the optimizer takes at the first step against
  JAX's eager ones (rtol 1e-5, atol 1e-7: f32 sums in another order);
* a short sequence (S = 16 over two ranks), where the boundary label a
  per-shard shift would lose moves the loss by more than the tolerance;
* a plain forward returns the rank's shard of JAX's logits, and
  ``gather_sequence`` the whole; global ``position_ids`` are sliced;
* ``DataParallel``, ``fleet.distributed_model(sep_degree=2)`` and
  ``parallelize`` sum the gradient shares over 'sep': JAX's gradients;
  ``DataParallel`` refuses a loss that is not a share and averages a
  model that does not shard its sequences over 'dp' alone;
* what raises: an S the ranks do not divide (ValueError), pp and the
  serving engine on a 'sep' mesh, a block run outside the model
  (NotImplementedError naming ROADMAP §A5), ``in_shardings`` with 'sep'
  on the batch dimension or another axis past it; ZeRO and mp on a
  'sep' mesh build."""
import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu.distributed import mesh as jmesh
from paddle_tpu.models.gpt import (GPTConfig as JGPTConfig,
                                   GPTForCausalLM as JGPT,
                                   GPTPretrainingCriterion as JCrit)

import _torch_dist

LOSS_TOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-5, 1e-7


@pytest.fixture(scope="module")
def world():
    w = _torch_dist.World(4)
    yield w
    w.close()


def _cfg(scan=False):
    cfg = JGPTConfig.tiny()
    cfg.scan_layers = scan
    return cfg


def _weights(scan=False, seed=11):
    paddle.seed(seed)
    m = JGPT(_cfg(scan))
    return {k: np.asarray(v.numpy()) for k, v in m.state_dict().items()}


#: the sequence length of every run: 8 rows a rank over two 'sep' ranks,
#: short enough that the boundary label a per-shard shift would lose
#: moves the loss by more than the tolerance
S = 16


def _ids(s=S, b=4, seed=1):
    return np.random.default_rng(seed).integers(0, 512, (b, s)).astype(
        np.int64)


def _jax_opt(name, params):
    if name == "sgd":
        return paddle.optimizer.SGD(learning_rate=0.5, parameters=params)
    return paddle.optimizer.AdamW(learning_rate=1e-3, parameters=params,
                                  epsilon=1e-6)


_JAX = {}


def _jax_ref(opt, scan, s):
    """JAX's one-device run (no mesh): five TrainStep losses, the first
    step's eager gradients and the full-sequence logits, cached."""
    key = (opt, scan, s)
    if key in _JAX:
        return _JAX[key]
    from paddle_tpu.jit import TrainStep
    weights, ids = _weights(scan), _ids(s)
    prev = jmesh.get_mesh()
    jmesh.set_mesh(None)
    try:
        crit = JCrit()
        m = JGPT(_cfg(scan))
        m.set_state_dict(weights)
        x = paddle.to_tensor(ids.astype(np.int32))
        with paddle.set_grad_enabled(True):
            logits = m(x)
            crit(logits, x).backward()
        grads = {n: np.asarray(p.grad.numpy())
                 for n, p in m.named_parameters()}
        m = JGPT(_cfg(scan))
        m.set_state_dict(weights)
        step = TrainStep(m, lambda lg, lb: crit(lg, lb),
                         _jax_opt(opt, m.parameters()))
        losses = [float(step(x, x).numpy()) for _ in range(5)]
    finally:
        jmesh.set_mesh(prev)
    _JAX[key] = (weights, ids, losses, grads, np.asarray(logits.numpy()))
    return _JAX[key]


def _hold_grads(got, want):
    assert set(got) == set(want)
    for n, g in want.items():
        np.testing.assert_allclose(got[n], g, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=n)


RUNS = {
    # name: (axes, optimizer, scan, in_shardings, cfg)
    "sep2_adamw": ({"sep": 2}, "adamw", False, None, {}),
    "sep2_adamw_scan": ({"sep": 2}, "adamw", True, None, {}),
    "sep2_sgd_recompute": ({"sep": 2}, "sgd", False, None,
                           {"use_recompute": True}),
    "dp2_sep2_adamw": ({"dp": 2, "sep": 2}, "adamw", False, "dp", {}),
    "dp2_sep2_adamw_scan": ({"dp": 2, "sep": 2}, "adamw", True, "dp_sep",
                            {}),
    "dp2_sep2_sgd": ({"dp": 2, "sep": 2}, "sgd", False, "dp_sep", {}),
    "dp2_sep2_sgd_scan_recompute": ({"dp": 2, "sep": 2}, "sgd", True, "dp",
                                    {"use_recompute": True}),
    "sep4_adamw": ({"sep": 4}, "adamw", False, None, {}),
}


def hold_run(world, name):
    """Five steps of the run ``name`` on the mesh: every rank of the mesh
    the same losses, within 1e-5 of JAX's one-device step; the first
    step's gradients (summed over 'sep', averaged over 'dp') JAX's."""
    axes, opt, scan, spec, cfg = RUNS[name]
    if scan:
        cfg = dict(cfg, scan_layers=True)
    weights, ids, jlosses, jgrads, _ = _jax_ref(opt, scan, S)
    outs = world.run("_torch_seq:job_seq_train", weights=weights, ids=ids,
                     steps=5, axes=axes, opt=opt, spec=spec, cfg=cfg)
    n = int(np.prod(list(axes.values())))
    assert all(o is None for o in outs[n:])
    for losses, grads in outs[:n]:
        assert losses == outs[0][0]
        np.testing.assert_allclose(losses, jlosses, rtol=LOSS_TOL)
        _hold_grads(grads, jgrads)
    assert jlosses[-1] < jlosses[0]


@pytest.mark.parametrize("name", sorted(n for n in RUNS if not RUNS[n][2]))
def test_sequence_sharded_steps_track_jax(world, name):
    """The per-layer runs (the scan-layers ones are in
    ``test_torch_seq_sharding_scan.py``)."""
    hold_run(world, name)


def test_short_sequence_keeps_its_boundary_label(world):
    """S = 16 over two ranks: rank 0's last row predicts rank 1's first
    label.  Dropping that label (a per-shard shift) would move the loss
    by more than the tolerance; the port's loss and grads are JAX's."""
    weights, ids, jlosses, jgrads, logits = _jax_ref("adamw", False, S)
    # the loss a per-shard shift would give: the boundary target ignored
    lse = np.log(np.exp(logits - logits.max(-1, keepdims=True)).sum(-1)) \
        + logits.max(-1)
    tok = -(np.take_along_axis(logits[:, :-1], ids[:, 1:, None], -1)[..., 0]
            - lse[:, :-1])
    keep = np.ones_like(tok, dtype=bool)
    keep[:, 7] = False                        # row 7 predicts label 8
    assert abs(tok[keep].mean() - tok.mean()) > 10 * LOSS_TOL
    assert abs(tok.mean() - jlosses[0]) < LOSS_TOL
    outs = world.run("_torch_seq:job_seq_train", weights=weights, ids=ids,
                     steps=5, axes={"sep": 2}, opt="adamw", spec=None)
    for losses, grads in outs[:2]:
        np.testing.assert_allclose(losses, jlosses, rtol=LOSS_TOL)
        _hold_grads(grads, jgrads)


def test_plain_forward_returns_the_rank_shard(world):
    """``model(ids)`` on {"dp": 2, "sep": 2}: the rank's rows of JAX's
    logits (its sequence shard, all rows of the batch: the model does not
    shard the batch), ``gather_sequence`` JAX's whole logits, the loss
    shares summing to JAX's loss; global ``position_ids`` (here the
    default ones, passed) give the same."""
    weights, ids, jlosses, _g, logits = _jax_ref("adamw", False, S)
    pos = np.arange(S, dtype=np.int64)[None].repeat(4, 0)
    for position_ids in (None, pos):
        outs = world.run("_torch_seq:job_seq_forward", weights=weights,
                         ids=ids, axes={"dp": 2, "sep": 2},
                         position_ids=position_ids)
        shares = {}
        for r, (mine, whole, share) in enumerate(outs):
            sep = r % 2
            rows = slice(sep * S // 2, (sep + 1) * S // 2)
            np.testing.assert_allclose(mine, logits[:, rows], rtol=1e-5,
                                       atol=1e-5)
            np.testing.assert_allclose(whole, logits, rtol=1e-5, atol=1e-5)
            shares.setdefault(r // 2, []).append(share)
        for pair in shares.values():
            np.testing.assert_allclose(sum(pair), jlosses[0], rtol=LOSS_TOL)


@pytest.mark.parametrize("via", ["data_parallel", "fleet", "parallelize"])
def test_data_parallel_sums_the_shares(world, via):
    """One eager step on {"dp": 2, "sep": 2}: ``apply_collective_grads``
    averages over 'dp' and sums over 'sep', so every rank holds JAX's
    gradients (a mean over 'sep' would halve them)."""
    weights, ids, jlosses, jgrads, _ = _jax_ref("adamw", False, S)
    outs = world.run("_torch_seq:job_seq_data_parallel", weights=weights,
                     ids=ids, axes={"dp": 2, "sep": 2}, via=via)
    for loss, grads in outs:
        np.testing.assert_allclose(loss, jlosses[0], rtol=LOSS_TOL)
        _hold_grads(grads, jgrads)


def test_data_parallel_sums_over_sep_only_a_sequence_sharded_share(world):
    """On {"dp": 2, "sep": 2}, ``DataParallel`` refuses a GPT step whose
    loss is not the criterion's share passed through ``scale_loss``
    (NotImplementedError naming ROADMAP §A5), and averages a model that
    does not shard its sequences over 'dp' alone: its gradient is the
    one-process gradient of the global batch's mean (rtol 1e-6), not
    that times the 'sep' size."""
    outs = world.run("_torch_seq:job_dp_sep_guard", weights=_weights(),
                     ids=_ids())
    for out in outs:
        for key in ("plain_mean", "share_unscaled"):
            assert out[key] is not None and out[key].startswith(
                "NotImplementedError") and "§A5" in out[key], (key, out[key])
        for got, want in out["dense"]:
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_what_a_sep_mesh_refuses(world):
    """Each raises, NotImplementedError naming ROADMAP §A5 where a module
    is missing: pp x sep (and through the fleet), the serving engine, a
    GPT block outside the model; ValueError for an S the ranks do not
    divide and for ``in_shardings`` with 'sep' on the batch dimension;
    another axis on dimension 1 names §A5.  ZeRO and mp x sep, refused
    until they were ported, now build (their parity is
    tests/test_torch_sep_hybrid.py's)."""
    out = world.run("_torch_seq:job_seq_refusals", weights=_weights(),
                    ids=_ids())[0]
    assert out["odd_s"].startswith("ValueError") and "7 rows" in out["odd_s"]
    assert "'sep' shards the sequence" in out["in_shardings_sep_dim0"]
    assert out["zero"] is None and out["mp_parallelize"] is None, out
    for key in ("decode_engine", "block", "in_shardings_dim1_dp", "pp",
                "fleet_pp"):
        assert out[key] is not None and out[key].startswith(
            "NotImplementedError") and "§A5" in out[key], (key, out[key])

