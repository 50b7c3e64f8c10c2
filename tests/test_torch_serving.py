"""paddle_tpu_torch serving: the slotted engine + synchronous scheduler
against ``paddle_tpu``'s ``DecodeEngine(paged=False)`` +
``ContinuousBatchingScheduler(overlap=False)`` at the tiny config in f32
(greedy tokens identical through slot churn and an EOS), the sampling
filters against the JAX ones on the same logits, and what the slice
leaves raising."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu.models.gpt import GPTForCausalLM as JaxGPT
from paddle_tpu.serving import sampling as jax_sampling
from paddle_tpu.serving.engine import DecodeEngine as JaxEngine
from paddle_tpu.serving.scheduler import \
    ContinuousBatchingScheduler as JaxScheduler
from paddle_tpu.serving.scheduler import Request as JaxRequest
from paddle_tpu_torch.convert import load_paddle_tpu_state
from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM
from paddle_tpu_torch.serving import (ContinuousBatchingScheduler,
                                      DecodeEngine, Request, generate,
                                      sampling)


def _pair(seed=0, std=0.2):
    jm = JaxGPT(JaxGPTConfig.tiny())
    jm.eval()
    rng = np.random.default_rng(seed)
    arrays = {}
    for k, v in jm.state_dict().items():
        shape = tuple(v.shape)
        base = 1.0 if k.endswith(("ln1.weight", "ln2.weight",
                                  "ln_f.weight")) else 0.0
        scale = 0.1 if base else std
        arrays[k] = (base + scale * rng.standard_normal(shape)).astype(
            np.float32)
    jm.set_state_dict(arrays)
    tm = GPTForCausalLM(GPTConfig.tiny())
    load_paddle_tpu_state(tm, arrays)
    return jm, tm


def _prompts():
    rng = np.random.default_rng(7)
    return [rng.integers(0, 512, (n,)).astype(np.int32)
            for n in (5, 9, 17, 3, 12, 20)]


def _run_jax(jm, prompts, eos):
    sched = JaxScheduler(JaxEngine(jm, num_slots=2, max_len=64,
                                   paged=False, seed=0), overlap=False)
    rids = [sched.submit(JaxRequest(prompt=p, max_new_tokens=16,
                                    temperature=0.0, eos_token_id=e))
            for p, e in zip(prompts, eos)]
    res = sched.run()
    return [res[r] for r in rids]


def _run_torch(tm, prompts, eos):
    sched = ContinuousBatchingScheduler(
        DecodeEngine(tm, num_slots=2, max_len=64, device="cpu"))
    rids = [sched.submit(Request(prompt=p, max_new_tokens=16,
                                 temperature=0.0, eos_token_id=e))
            for p, e in zip(prompts, eos)]
    res = sched.run()
    return [res[r] for r in rids]


def test_greedy_tokens_identical_to_jax_through_slot_churn():
    jm, tm = _pair()
    prompts = _prompts()
    # pick the EOS of request 2 from its own first run: its 6th token
    probe = _run_jax(jm, prompts, [None] * 6)
    assert len({tuple(r.tokens) for r in probe}) > 1
    eos_tok = int(probe[2].tokens[5])
    first = list(probe[2].tokens).index(eos_tok)
    eos = [None, None, eos_tok, None, None, None]
    want = _run_jax(jm, prompts, eos)
    got = _run_torch(tm, prompts, eos)
    for w, g in zip(want, got):
        assert g.tokens.dtype == np.int32
        assert g.tokens.tolist() == w.tokens.tolist()
        assert g.finish_reason == w.finish_reason
    assert got[2].finish_reason == "eos"
    assert len(got[2].tokens) == first + 1
    assert all(len(r.tokens) == 16 for i, r in enumerate(got) if i != 2)
    for r in got:
        assert r.ttft > 0 and r.tpot > 0 and r.queue_wait >= 0


def test_generate_entry_point_matches_scheduler():
    _jm, tm = _pair(seed=1)
    prompts = _prompts()[:3]
    out = generate(tm, prompts, max_new_tokens=4, temperature=0.0,
                   device="cpu")
    sched = ContinuousBatchingScheduler(
        DecodeEngine(tm, num_slots=4, max_len=128, device="cpu"))
    rids = [sched.submit(Request(prompt=p, max_new_tokens=4,
                                 temperature=0.0)) for p in prompts]
    res = sched.run()
    assert [o.tolist() for o in out] == [res[r].tokens.tolist()
                                         for r in rids]


def test_cache_full_retires_the_request():
    _jm, tm = _pair(seed=2)
    sched = ContinuousBatchingScheduler(
        DecodeEngine(tm, num_slots=1, max_len=16, device="cpu"))
    rid = sched.submit(Request(prompt=np.arange(12), max_new_tokens=50,
                               temperature=0.0))
    res = sched.run()[rid]
    assert res.finish_reason == "cache_full"
    assert len(res.tokens) == 16 - 12 + 1


def _logits(seed=0, slots=4, vocab=96):
    return np.random.default_rng(seed).standard_normal(
        (slots, vocab)).astype(np.float32) * 3.0


@pytest.mark.parametrize("top_k", [0, 1, 5])
@pytest.mark.parametrize("top_p", [0.0, 0.3, 0.9, 1.0])
def test_filters_match_jax(top_k, top_p):
    x = _logits()
    temps = np.asarray([0.7, 1.0, 1.5, 0.2], np.float32)
    ks = np.full((4,), top_k, np.int32)
    ps = np.full((4,), top_p, np.float32)
    want = np.asarray(jax_sampling.filter_logits(
        jnp.asarray(x), jnp.asarray(temps), jnp.asarray(ks),
        jnp.asarray(ps)))
    got = sampling.filter_logits(torch.from_numpy(x), torch.from_numpy(temps),
                                 torch.from_numpy(ks),
                                 torch.from_numpy(ps)).numpy()
    np.testing.assert_array_equal(got <= -1e29, want <= -1e29)
    kept = want > -1e29
    np.testing.assert_allclose(got[kept], want[kept], rtol=1e-6)


def test_top_k_1_and_top_p_0_return_the_greedy_token():
    x = torch.from_numpy(_logits(1))
    greedy = torch.argmax(x, dim=-1).to(torch.int32)
    g = torch.Generator().manual_seed(0)
    ones = torch.ones(4)
    for ks, ps in ((torch.ones(4, dtype=torch.int32), ones),
                   (torch.zeros(4, dtype=torch.int32), torch.zeros(4))):
        for _ in range(5):
            tok = sampling.sample(x, g, ones, ks, ps)
            assert tok.dtype == torch.int32
            assert tok.tolist() == greedy.tolist()
    # greedy is the FIRST max index on ties
    tied = torch.tensor([[0.0, 2.0, 2.0, 1.0]])
    assert sampling.sample(tied, g, torch.zeros(1),
                           torch.zeros(1, dtype=torch.int32),
                           torch.ones(1)).tolist() == [1]


def test_seeded_generator_reproduces():
    x = torch.from_numpy(_logits(2))
    args = (torch.ones(4), torch.zeros(4, dtype=torch.int32), torch.ones(4))
    draws = []
    for _ in range(2):
        g = torch.Generator().manual_seed(123)
        draws.append([sampling.sample(x, g, *args).tolist()
                      for _ in range(8)])
    assert draws[0] == draws[1]
    assert len({tuple(d) for d in draws[0]}) > 1


def test_engine_reseed_reproduces_sampled_output():
    _jm, tm = _pair(seed=3)
    eng = DecodeEngine(tm, num_slots=1, max_len=64, seed=5, device="cpu")
    runs = []
    for _ in range(2):
        eng.reseed(5)
        sched = ContinuousBatchingScheduler(eng)
        rid = sched.submit(Request(prompt=np.arange(6), max_new_tokens=8,
                                   temperature=1.0))
        runs.append(sched.run()[rid].tokens.tolist())
    assert runs[0] == runs[1]


@pytest.mark.parametrize("kw", [dict(paged=True), dict(spec_k=2),
                                dict(kv_dtype="int8"), dict(tp=2)])
def test_unported_modes_raise(kw):
    tm = GPTForCausalLM(GPTConfig.tiny())
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        DecodeEngine(tm, device="cpu", **kw)


def test_overlapped_loop_raises():
    eng = DecodeEngine(GPTForCausalLM(GPTConfig.tiny()), device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ContinuousBatchingScheduler(eng, overlap=True)
