"""Tensor-parallel serving in the port (``DecodeEngine(tp=2)``) on a
two-rank gloo world, in f32: the JAX package's tests/test_tp_serving.py
checks that apply to one process per rank — greedy tokens equal to the
JAX package's tp=2 engine and to the port's tp=1 engine at every
position, with logits to 1e-5; int8 + speculative decoding at tp=2
against tp=1; scheduler drives (chunked prefill, churn; both loops);
KV accounting at 1/tp; the validation errors; ``engine_for``'s key; and
``refresh_state`` re-slicing a changed parameter."""
import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu.models.gpt import GPTConfig as JGPTConfig
from paddle_tpu.models.gpt import GPTForCausalLM as JGPT

import _torch_dist


@pytest.fixture(scope="module")
def world():
    w = _torch_dist.World(2)
    yield w
    w.close()


@pytest.fixture(scope="module")
def jax_model():
    paddle.seed(0)
    m = JGPT(JGPTConfig.tiny())
    m.eval()
    return m, {k: np.asarray(v.numpy()) for k, v in m.state_dict().items()}


def _prompts():
    rng = np.random.default_rng(7)
    return [rng.integers(0, 512, (5,)), rng.integers(0, 512, (19,))]


def _jax_greedy(model, prompts, steps, tp):
    from paddle_tpu.serving.engine import DecodeEngine
    eng = DecodeEngine(model, num_slots=2, max_len=64, page_size=16, seed=3,
                       tp=tp)
    seqs, logits = [], []
    for i, p in enumerate(prompts):
        tok, lg = eng.prefill(i, p, temperature=0.0)
        seqs.append([int(tok)])
        logits.append([np.asarray(lg)])
    for _ in range(steps):
        nt, lg = eng.decode([s[-1] for s in seqs], [True, True], [0.0, 0.0],
                            [0, 0], [1.0, 1.0])
        for b in range(2):
            seqs[b].append(int(nt[b]))
            logits[b].append(np.asarray(lg[b]))
    return seqs, logits


def test_tp2_greedy_parity_every_position(world, jax_model):
    """tp=2 greedy tokens equal the JAX tp=2 engine's and the port's tp=1
    engine's at every position, on both ranks; logits within 1e-5."""
    model, weights = jax_model
    prompts = _prompts()
    jax_seqs, jax_logits = _jax_greedy(model, prompts, 6, tp=2)
    _m, eng = _torch_dist.tp_engine(weights, 1, seed=3)
    tp1_seqs, tp1_logits = _torch_dist.greedy_drive(eng, prompts, 6)
    out = world.run("job_tp_greedy", weights=weights, prompts=prompts,
                    steps=6)
    assert tp1_seqs == jax_seqs
    for seqs, logits in out:
        assert seqs == jax_seqs
        for b in range(2):
            for got, want, ref in zip(logits[b], tp1_logits[b],
                                      jax_logits[b]):
                np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
                np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def _sched_prompts(n, base, step, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 512, (base + step * i,)) for i in range(n)]


def test_tp2_int8_spec_composed_matches_tp1(world, jax_model):
    """tp=2 over the int8 pool with speculative verify (k=3) through the
    scheduler: the tp=1 engine's completions."""
    _model, weights = jax_model
    prompts = [np.random.default_rng(11).integers(0, 512, (n,))
               for n in (7, 13, 9)]
    kw = dict(spec_k=3, kv_dtype="int8")
    _m, eng = _torch_dist.tp_engine(weights, 1, seed=0, **kw)
    want = _torch_dist.sched_drive(eng, prompts, 8, overlap=False)
    out = world.run("job_tp_sched", weights=weights, prompts=prompts,
                    max_new=8, overlap=False, **kw)
    assert all(got == want for got in out)


@pytest.mark.parametrize("overlap", [False, True])
def test_tp2_scheduler_drive(world, jax_model, overlap):
    """Chunked prefill (chunks of 8, pages of 8) and slot churn over four
    requests, through the synchronous and the overlapped loop: the tp=1
    engine's tokens."""
    _model, weights = jax_model
    prompts = _sched_prompts(4, 6, 5, 5)
    kw = dict(page_size=8, prefill_chunk=8)
    _m, eng = _torch_dist.tp_engine(weights, 1, seed=0, **kw)
    want = _torch_dist.sched_drive(eng, prompts, 5, overlap=overlap)
    out = world.run("job_tp_sched", weights=weights, prompts=prompts,
                    max_new=5, overlap=overlap, **kw)
    assert all(got == want for got in out)


def test_kv_accounting_reports_per_rank_truth(world, jax_model):
    """kv_row_bytes, kv_pool_bytes and kv_bytes_per_token of a tp=2 rank
    are half the tp=1 engine's; the pool holds 2 of the 4 heads; the
    engine runs uncaptured and says so; flight_state and the
    serving.tp_degree gauge carry tp."""
    _model, weights = jax_model
    _m, eng = _torch_dist.tp_engine(weights, 1)
    eng.prefill(0, np.arange(5, dtype=np.int32), temperature=0.0)
    eng.prefill(1, np.arange(9, dtype=np.int32), temperature=0.0)
    for _ in range(3):
        eng.decode([1, 2], [True, True], [0.0, 0.0], [0, 0], [1.0, 1.0])
    one = (eng.kv_row_bytes(), eng.kv_pool_bytes(), eng.kv_bytes_per_token())
    assert eng.graph_stats()["uncaptured"] is None
    for row, pool, per_tok, shape, why, tp, gauge in world.run(
            "job_tp_accounting", weights=weights):
        assert 2 * row == one[0] and 2 * pool == one[1]
        assert per_tok["paged"] == pytest.approx(one[2]["paged"] / 2)
        assert per_tok["flat"] == pytest.approx(one[2]["flat"] / 2)
        assert shape[3] == 2
        assert "uncaptured" in why and "§A5" in why
        assert tp == 2 and gauge == 2.0


def test_tp_validation_errors_and_engine_for_key(world, jax_model):
    """The JAX engine's errors ("paged", "tp must be >= 1", "devices",
    "divide") and overlap_comm=True building at a world of two;
    engine_for keys tp: tp=1 spelled or defaulted is one engine, tp=2
    another, and the resolved overlap switch (an enabling scope and an
    explicit overlap_comm=True share one tp=2 engine)."""
    _model, weights = jax_model
    for got in world.run("job_tp_errors", weights=weights):
        assert len(got) == 4


def test_refresh_state_reshards_a_changed_parameter(world, jax_model):
    """An unchanged re-snapshot is no change; a change of the full model's
    wte is re-sliced into the engine's copy, the prefix cache dropped (a
    re-admission maps nothing), and the logits are a fresh tp=2 engine's
    on the changed weights."""
    _model, weights = jax_model
    prompt = np.arange(20, dtype=np.int32)
    delta = np.random.default_rng(2).normal(0.0, 1e-2, (512, 64)).astype(
        np.float32)
    for before, unchanged, changed, shared, after, ref in world.run(
            "job_tp_refresh", weights=weights, prompt=prompt, delta=delta):
        assert unchanged is False and changed is True and shared == 0
        np.testing.assert_allclose(after, ref, rtol=1e-6, atol=1e-6)
        assert np.abs(after - before).max() > 1e-4
