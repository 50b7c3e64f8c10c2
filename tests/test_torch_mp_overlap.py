"""The overlapped collective matmuls in the port
(``paddle_tpu_torch.distributed.mp_overlap``) on a four-rank gloo world
(the ``mp`` group of {"mp": 4} for n = 4, of {"dp": 2, "mp": 2} for
n = 2), against the JAX package's islands under ``shard_map`` on CPU
devices and against the dense products:

* the row, column, LM-head and embedding islands at n = 2 and 4 and
  chunks 1 and 2 (1e-5; the embedding 1e-6), and the gradients of the
  three autograd functions against JAX's ``custom_vjp`` and the dense
  ones (1e-5);
* ``qkv_heads`` exactly against the port's dense slice-then-reshape (the
  JAX re-deal at n = 4 fails on jax 0.9.0, so parity is not anchored on
  it);
* the switch (arg > scope > env; off, or a shape the ring cannot split,
  gives None), the ``mp_overlap`` autotune family and the
  ``mp.overlap_chunks`` counter, as tests/test_mp_overlap.py holds them;
* the tiny GPT at dp2 x mp2, per layer and scan-layers: three train steps
  with the overlap on track the monolithic port and the JAX package's
  monolithic hybrid step to 1e-5, and ``DecodeEngine(tp=2,
  overlap_comm=True)`` gives the monolithic engine's greedy tokens and
  the JAX package's tp=2 tokens."""
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as JP

import paddle_tpu as paddle
from paddle_tpu.distributed import mesh as jmesh
from paddle_tpu.distributed import mp_overlap as jmpo
from paddle_tpu.models.gpt import (GPTConfig as JGPTConfig,
                                   GPTForCausalLM as JGPT,
                                   GPTPretrainingCriterion as JCrit)

import _torch_dist
from paddle_tpu_torch.distributed import mesh as tmesh
from paddle_tpu_torch.distributed import mp_overlap as mpo
from paddle_tpu_torch.kernels import autotune as at
from paddle_tpu_torch.models.gpt import per_layer_state_to_scan
from paddle_tpu_torch.observability import registry


@pytest.fixture(scope="module")
def world():
    w = _torch_dist.World(4)
    yield w
    w.close()


def _scoped(n, chunks=None):
    """The JAX test's scope: an ('mp',) mesh of n CPU devices, overlap
    on."""
    import contextlib

    @contextlib.contextmanager
    def ctx():
        mesh = Mesh(np.asarray(jax.devices()[:n]), ("mp",))
        with jmesh.mesh_scope(mesh), jmpo.overlap_scope(True, chunks):
            yield
    return ctx()


def _inputs():
    rng = np.random.default_rng(23)

    def f32(*shape):
        return rng.standard_normal(shape).astype(np.float32)
    fwd = dict(x=f32(3, 4, 16), w=f32(16, 8), b=f32(8), xc=f32(2, 5, 12),
               wc=f32(12, 16), wte=f32(32, 12),
               ids=np.array([[0, 7, 31, 15], [3, 3, 30, 1]], np.int64))
    grad = dict(x=f32(4, 16), w=f32(16, 8), wte=f32(32, 16))
    qkv = dict(x=f32(2, 3, 8), w=f32(8, 48), b=f32(48), heads=4, head_dim=4)
    return fwd, grad, qkv


def _jax_cot(f, *args):
    return jax.grad(lambda *a: jnp.sum(jnp.sin(f(*a))),
                    argnums=tuple(range(len(args))))(*args)


def _jitted(fn, *args):
    """``fn(*args)`` through a fresh ``jax.jit`` (one program per call
    site and scope: the switch is read when it traces), as numpy."""
    out = jax.jit(lambda *a: fn(*a))(*args)
    if isinstance(out, (tuple, list)):
        return [np.asarray(o) for o in out]
    return np.asarray(out)


def _jax_islands(fwd, grad):
    """The JAX islands' outputs at n = 2, 4 and chunks 1, 2, and their
    custom_vjp gradients (at chunks 1: the ring's backward does not
    change with it, and the port's is held at both against the dense
    ones)."""
    out = {}
    j = {k: jnp.asarray(v) for k, v in fwd.items()}
    jg = {k: jnp.asarray(v) for k, v in grad.items()}
    for n in (2, 4):
        for chunks in (1, 2):
            with _scoped(n, chunks):
                res = out[(n, chunks)] = {
                    "row": _jitted(jmpo.row_parallel_matmul, j["x"], j["w"],
                                   j["b"]),
                    "col": _jitted(jmpo.column_parallel_matmul, j["xc"],
                                   j["wc"]),
                    "lm": _jitted(jmpo.lm_head_matmul, j["xc"], j["wte"]),
                    "emb": _jitted(jmpo.vocab_embed,
                                   j["ids"].astype(jnp.int32), j["wte"])}
                if chunks > 1:
                    res.update({k: out[(n, 1)][k] for k in
                                ("row_grads", "col_grads", "lm_grads")})
                    continue
                for kind, fn, w in (
                        ("row", jmpo.row_parallel_matmul, jg["w"]),
                        ("col", jmpo.column_parallel_matmul, jg["w"]),
                        ("lm", jmpo.lm_head_matmul, jg["wte"])):
                    res[kind + "_grads"] = _jitted(
                        lambda a, b, fn=fn: _jax_cot(
                            lambda p, q: fn(p, q), a, b), jg["x"], w)
    return out


@pytest.fixture(scope="module")
def islands(world):
    fwd, grad, qkv = _inputs()
    ref = _jax_islands(fwd, grad)
    out = world.run("job_mpo_islands", fwd=fwd, grad=grad, qkv=qkv)
    return fwd, grad, ref, out


def _pieces(a, dim, n):
    return np.split(np.asarray(a), n, axis=dim)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("chunks", [1, 2])
def test_islands_match_jax_and_dense(islands, n, chunks):
    """Row (RS+AG ring), column (local forward), LM head (rotate-weights
    ring) and embedding (masked gather + all-reduce) on every rank of the
    group: JAX's island and the dense product (1e-5; embedding 1e-6).  A
    row island issues 2 (n - 1) chunks ppermutes and counts its chunks in
    ``mp.overlap_chunks``."""
    fwd, _grad, ref, out = islands
    dense = {"row": fwd["x"] @ fwd["w"] + fwd["b"],
             "col": fwd["xc"] @ fwd["wc"], "lm": fwd["xc"] @ fwd["wte"].T,
             "emb": fwd["wte"][fwd["ids"]]}
    for r in range(4):
        got = out[r][(n, chunks)]
        g = r % n
        for key in ("row", "lm", "emb"):
            tol = 1e-6 if key == "emb" else 1e-5
            for want in (ref[(n, chunks)][key], dense[key]):
                np.testing.assert_allclose(got[key], want, rtol=tol,
                                           atol=tol, err_msg=key)
        for want in (ref[(n, chunks)]["col"], dense["col"]):
            np.testing.assert_allclose(got["col"], _pieces(want, 2, n)[g],
                                       rtol=1e-5, atol=1e-5)
        assert got["row_ppermutes"] == 2 * (n - 1) * chunks
        assert got["row_counted"] == chunks


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("chunks", [1, 2])
def test_autograd_functions_match_custom_vjp_and_dense(islands, n, chunks):
    """The gradients of sum(sin(island)) through the three autograd
    functions — row (collective-free backward), column (dx's all-reduce
    as the ring), LM head (shard partial + one all-reduce) — against
    JAX's custom_vjp and dense autodiff (1e-5): full dx where the island
    gives it, the rank's piece of dx and dw where it holds one."""
    _fwd, grad, ref, out = islands
    x, w, wte = (torch.from_numpy(grad[k]) for k in ("x", "w", "wte"))
    dense = {"row": _torch_dist._cot(lambda a, b: a @ b, x, w),
             "lm": _torch_dist._cot(lambda a, b: a @ b.T, x, wte)}
    dense["col"] = dense["row"]
    for r in range(4):
        got = out[r][(n, chunks)]
        g = r % n
        for kind, (x_dim, w_dim) in (("row", (1, 0)), ("col", (None, 1)),
                                     ("lm", (None, 0))):
            gx, gw = got[kind + "_grads"]
            for want in (ref[(n, chunks)][kind + "_grads"], dense[kind]):
                wx, ww = (np.asarray(t) for t in want)
                if x_dim is not None:
                    wx = _pieces(wx, x_dim, n)[g]
                np.testing.assert_allclose(gx, wx, rtol=1e-5, atol=1e-5,
                                           err_msg=kind + " dx")
                np.testing.assert_allclose(gw, _pieces(ww, w_dim, n)[g],
                                           rtol=1e-5, atol=1e-5,
                                           err_msg=kind + " dw")


@pytest.mark.parametrize("n", [2, 4])
def test_qkv_heads_redeal_exact(islands, n):
    """The three single-hop permutes re-deal a contiguous column shard to
    the rank's heads: equal, bit for bit, to the dense slice-then-reshape
    of the same projections, with and without the bias; one island
    counted."""
    *_rest, out = islands
    for r in range(4):
        got = out[r][("qkv", n)]
        assert got["exact"]
        assert got["shapes"] == [(2, 3, 4 // n, 4)] * 3
        assert got["counted"] == 2


def test_switch_levels_and_viability(world, monkeypatch):
    """arg > scope > env; off, or no group of two ranks, gives None;
    non-viable shapes give None (a group of three breaks the qkv
    bijection)."""
    monkeypatch.delenv(mpo.ENV_FLAG, raising=False)
    x, w = torch.ones(2, 8), torch.ones(8, 4)
    assert mpo.row_parallel_matmul(x, w) is None and not mpo.row_viable(8)
    with mpo.overlap_scope(True), tmesh.mesh_scope(None):
        assert mpo.active() is None          # no mp group in this process
    pair = types.SimpleNamespace(pg=object(), nranks=2, rank=0)
    three = types.SimpleNamespace(pg=object(), nranks=3, rank=0)
    with mpo.overlap_scope(True):
        assert mpo.active(group=pair) == (pair, 2)
        assert not mpo.row_viable(7, group=pair)
        assert mpo.qkv_viable(6, 4, group=pair)     # gcd(3, 2) == 1
        assert not mpo.qkv_viable(6, 4, group=three)
        assert mpo.qkv_heads(torch.ones(2, 1, 8), torch.ones(8, 24), None,
                             6, 4, group=three) is None
        assert not mpo.embed_viable(9, group=pair)
        assert mpo.active(arg=False, group=pair) is None
    monkeypatch.setenv(mpo.ENV_FLAG, "1")
    assert mpo.env_enabled() and mpo.enabled()
    with mpo.overlap_scope(False):
        assert not mpo.enabled() and mpo.enabled(True)
    monkeypatch.setenv(mpo.ENV_FLAG, "0")
    assert not mpo.enabled()
    assert mpo.scope_chunks() is None
    with mpo.overlap_scope(True, 2):
        assert mpo.enabled() and mpo.scope_chunks() == 2
        with mpo.overlap_scope(False):
            assert not mpo.enabled()
        assert mpo.scope_chunks() == 2
    rng = np.random.default_rng(3)
    got = world.run("job_mpo_switch",
                    x=rng.standard_normal((2, 4)).astype(np.float32),
                    w=rng.standard_normal((4, 8)).astype(np.float32))
    for g in got:
        assert g == {"off": True, "arg_false": True, "on": True,
                     "odd_n": True, "active_n": 2}


def test_autotune_family_and_counter():
    """The family's candidates and key are JAX's; resolve picks chunks1
    with tuning off; the runner raises with fewer ranks than the key's
    n_dev, as JAX's; a resolve under a chunk pin counts the pin in
    ``mp.overlap_chunks``."""
    for kind, m, k, n, n_dev in (("row", 8, 64, 32, 2),
                                 ("lmhead", 8, 64, 96, 4),
                                 ("colbwd", 4, 8, 6, 2)):
        key = mpo.autotune_key(kind, m, k, n, n_dev, torch.float32)
        assert key == jmpo.autotune_key(kind, m, k, n, n_dev, "float32")
        assert at.families()["mp_overlap"].candidates(key) == \
            jmpo._candidates(key)
    key = mpo.autotune_key("row", 8, 64, 32, 2, "float32")
    assert at.resolve("mp_overlap", key) == {"variant": "chunks1",
                                             "config": {"chunks": 1}}
    with pytest.raises(RuntimeError, match="needs 2 ranks, have 1"):
        mpo._runner({"variant": "chunks1", "config": {"chunks": 1}}, key)
    c = registry.counter("mp.overlap_chunks")
    before = c.value
    with mpo.overlap_scope(True, 2):
        assert mpo._resolve_chunks("row", 8, 64, 32, 2, torch.float32,
                                   16) == 2
        assert mpo._resolve_chunks("row", 8, 64, 32, 2, torch.float32,
                                   3) == 1
    assert c.value == before + 3


# ---------------------------------------------------------------------------
# the tiny GPT at dp2 x mp2
# ---------------------------------------------------------------------------

def _ids():
    return np.random.default_rng(1).integers(0, 512, (4, 32)).astype(
        np.int64)


def _prompts():
    rng = np.random.default_rng(7)
    return [rng.integers(0, 512, (5,)), rng.integers(0, 512, (19,))]


def _jax_references(steps=3):
    """The JAX package's monolithic references on the tiny GPT: the hybrid
    step's losses on a (dp 2, mp 2) mesh, and the tp=2 engine's greedy
    tokens."""
    from paddle_tpu.distributed.parallel_base import parallelize
    from paddle_tpu.jit import TrainStep
    from paddle_tpu.serving.engine import DecodeEngine
    paddle.seed(11)
    model = JGPT(JGPTConfig.tiny())
    weights = {k: np.asarray(v.numpy()) for k, v in
               model.state_dict().items()}
    model.eval()
    eng = DecodeEngine(model, num_slots=2, max_len=64, page_size=16, seed=3,
                       tp=2, overlap_comm=False)
    seqs = []
    for i, p in enumerate(_prompts()):
        tok, _lg = eng.prefill(i, p, temperature=0.0)
        seqs.append([int(tok)])
    for _ in range(6):
        nt, _lg = eng.decode([s[-1] for s in seqs], [True, True], [0.0, 0.0],
                             [0, 0], [1.0, 1.0])
        for b in range(2):
            seqs[b].append(int(nt[b]))
    del eng
    model.train()
    prev = jmesh.get_mesh()
    try:
        mesh = jmesh.init_mesh({"dp": 2, "mp": 2})
        parallelize(model)
        crit = JCrit()
        opt = paddle.optimizer.AdamW(parameters=model.parameters(),
                                     learning_rate=1e-3, epsilon=1e-6)
        step = TrainStep(model, lambda lg, lb: crit(lg, lb), opt)
        x = jax.device_put(jnp.asarray(_ids().astype(np.int32)),
                           NamedSharding(mesh, JP("dp", None)))
        losses = [float(step(x, x).numpy()) for _ in range(steps)]
    finally:
        jmesh.set_mesh(prev)
    return weights, losses, seqs


@pytest.fixture(scope="module")
def gpt(world):
    weights, losses, seqs = _jax_references()
    out = world.run("job_mpo_gpt", weights=weights,
                    scan_weights=per_layer_state_to_scan(weights),
                    ids=_ids(), prompts=_prompts())
    return losses, seqs, out


@pytest.mark.parametrize("scan", [False, True], ids=["per_layer", "scan"])
def test_gpt_train_with_overlap_tracks_monolithic_and_jax(gpt, scan):
    """Three AdamW steps at dp2 x mp2 with the islands on (out_proj and
    fc2 rings, the vocab lookup, the LM head ring with the plain CE over
    its full logits): the port's monolithic losses and the JAX hybrid
    step's to 1e-5, on every rank; each step runs the islands (ppermutes
    issued, chunks counted), the monolithic step none."""
    jax_losses, _seqs, out = gpt
    for r in range(4):
        on = out[r][("train", scan, True)]
        off = out[r][("train", scan, False)]
        for want in (off["losses"], jax_losses):
            np.testing.assert_allclose(on["losses"], want, rtol=1e-5,
                                       atol=1e-5)
        assert off["ppermute"] == 0 and off["chunks"] == 0
        assert on["ppermute"] > 0 and on["chunks"] > 0
    assert out[0][("train", scan, True)]["losses"] == \
        out[3][("train", scan, True)]["losses"]


@pytest.mark.parametrize("scan", [False, True], ids=["per_layer", "scan"])
def test_tp2_overlapped_engine_tokens(gpt, scan):
    """DecodeEngine(tp=2, overlap_comm=True): the monolithic tp=2 engine's
    greedy tokens and the JAX package's tp=2 tokens at every position,
    logits to 1e-5 of the monolithic engine's, the islands counted; the
    monolithic engine resolves overlap_comm False."""
    _losses, jax_seqs, out = gpt
    for r in range(4):
        on = out[r][("serve", scan, True)]
        off = out[r][("serve", scan, False)]
        assert on["overlap_comm"] and not off["overlap_comm"]
        assert on["seqs"] == off["seqs"] == jax_seqs
        for b in range(2):
            for a, c in zip(on["logits"][b], off["logits"][b]):
                np.testing.assert_allclose(a, c, rtol=1e-5, atol=1e-5)
        assert on["chunks"] > 0 and off["chunks"] == 0
