"""paddle_tpu_torch's paged serving engine against ``paddle_tpu``'s
``DecodeEngine(paged=True)`` at the tiny config in f32, on the same numpy
weights: the page allocators operation by operation, the paged decode
attention variants, model-level paged decode, and greedy tokens through
slot churn and EOS, prefix hits that map pages instead of recomputing
them, a fully cached prompt, copy-on-write, chunked prefill, a pool so
tight that requests are preempted, and the append cap at ``max_len``
(the JAX schedulers run their synchronous loop, ``overlap=False``, the
port's its default, overlapped one: greedy tokens do not depend on the
loop).
Then what the port shows alone: paged and slotted greedy tokens are
identical, ``generate(seed=...)`` repeats through the prefix cache, a
training step between two ``generate`` calls never serves stale K/V,
dropped writes land in the sink page, and what the port leaves
raising.  Speculative decoding and the quantized pools are held against
the JAX package in ``tests/test_torch_spec_quant.py``."""
import copy
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.kernels import decode_attention as jax_da
from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu.models.gpt import GPTForCausalLM as JaxGPT
from paddle_tpu.serving.engine import DecodeEngine as JaxEngine
from paddle_tpu.serving.pages import PageAllocator as JaxAllocator
from paddle_tpu.serving.pages import PagePoolExhausted as JaxExhausted
from paddle_tpu.serving.pages import \
    prompt_digest_chain as jax_digest_chain
from paddle_tpu.serving.scheduler import \
    ContinuousBatchingScheduler as JaxScheduler
from paddle_tpu.serving.scheduler import Request as JaxRequest
from paddle_tpu_torch.convert import load_paddle_tpu_state
from paddle_tpu_torch.kernels import decode_attention as da
from paddle_tpu_torch.models.gpt import (GPTConfig, GPTForCausalLM,
                                         GPTPretrainingCriterion)
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.serving import (ContinuousBatchingScheduler,
                                      DecodeEngine, PageAllocator,
                                      PagePoolExhausted, Request,
                                      engine_for, generate,
                                      prompt_digest_chain)

# f32 on both sides; matmuls sum in other orders (XLA vs ATen)
ATOL = 1e-4


def _pair(seed=0, std=0.2):
    """The tiny GPT in both packages on one set of seeded numpy weights,
    wider than the 0.02 initializer so that greedy tokens vary."""
    jm = JaxGPT(JaxGPTConfig.tiny())
    jm.eval()
    rng = np.random.default_rng(seed)
    arrays = {}
    for k, v in jm.state_dict().items():
        base = 1.0 if k.endswith(("ln1.weight", "ln2.weight",
                                  "ln_f.weight")) else 0.0
        scale = 0.1 if base else std
        arrays[k] = (base + scale * rng.standard_normal(tuple(v.shape))
                     ).astype(np.float32)
    jm.set_state_dict(arrays)
    tm = GPTForCausalLM(GPTConfig.tiny())
    load_paddle_tpu_state(tm, arrays)
    tm.eval()
    return jm, tm


def _engines(jm, tm, **kw):
    kw.setdefault("num_slots", 2)
    kw.setdefault("max_len", 64)
    kw.setdefault("page_size", 8)
    return (JaxEngine(jm, seed=0, paged=True, **kw),
            DecodeEngine(tm, seed=0, device="cpu", **kw))


def _prompt(seed, n):
    return np.random.default_rng(seed).integers(0, 512, (n,)).astype(
        np.int32)


def _full_last_logits(tm, ids):
    with torch.no_grad():
        return tm(torch.as_tensor(np.asarray(ids, np.int32)[None]))[
            0, -1].numpy()


def _run(sched_cls, req_cls, eng, prompts, max_new=16, eos=None, **skw):
    sched = sched_cls(eng, **skw)
    eos = eos or [None] * len(prompts)
    rids = [sched.submit(req_cls(prompt=p, max_new_tokens=max_new,
                                 temperature=0.0, eos_token_id=e))
            for p, e in zip(prompts, eos)]
    res = sched.run()
    return [res[r] for r in rids], sched


def _run_both(je, te, prompts, **kw):
    want, _ = _run(JaxScheduler, JaxRequest, je, prompts, overlap=False,
                   **kw)
    got, sched = _run(ContinuousBatchingScheduler, Request, te, prompts,
                      **kw)
    return want, got, sched


def _same_results(want, got):
    for w, g in zip(want, got):
        assert g.tokens.dtype == np.int32
        assert g.tokens.tolist() == w.tokens.tolist()
        assert g.finish_reason == w.finish_reason
        assert g.prefix_hit_tokens == w.prefix_hit_tokens


# ---------------------------------------------------------------------------
# the page allocator, operation by operation
# ---------------------------------------------------------------------------

def _drive(al, Exhausted):
    """One sequence of allocator operations; the state after each."""
    out = []

    def snap(tag, extra=None):
        out.append((tag, al.table.tolist(), al.mapped.tolist(),
                    al.refcount.tolist(), list(al._free), list(al._cached),
                    sorted(al._hash_to_page.items()), al.pages_free(),
                    al.pages_used(), [al.unshared_pages(s)
                                      for s in range(al.num_slots)],
                    extra))

    a = np.arange(10, dtype=np.int32)                 # 2 full pages + tail
    b = np.concatenate([a[:8], [99, 98, 97]]).astype(np.int32)
    for idx in range(3):
        al.map(0, idx, al.alloc())
    snap("map a")
    snap("register a", len(al.register_prefix(0, a)))
    pages, covered = al.lookup_prefix(b)
    snap("lookup b", (pages, covered))
    for idx, pid in enumerate(pages):
        al.share(1, idx, pid)
    snap("share b", [al.needs_cow(1, i) for i in range(3)])
    al.map(1, 2, al.alloc())
    snap("register b", len(al.register_prefix(1, b)))
    full, covered = al.lookup_prefix(a)
    snap("lookup a", (full, covered))
    for idx, pid in enumerate(full):
        al.share(2, idx, pid)
    snap("share a", [al.needs_cow(2, i) for i in range(3)])
    new = al.alloc()
    snap("cow", al.remap(2, 2, new))
    al.free_slot(0)
    snap("free 0")
    al.free_slot(2)
    snap("free 2")
    got = [al.alloc() for _ in range(al.pages_free())]
    snap("drain", got)
    with pytest.raises(Exhausted):
        al.alloc()
    for idx, pid in enumerate(got[:al.max_pages]):
        al.map(3, idx, pid)
    al.free_slot(1)
    snap("free 1")
    al.drop_prefix_cache()
    snap("drop", al.lookup_prefix(a))
    al.reset()
    snap("reset")
    return out


def test_allocators_agree_operation_by_operation():
    """Both packages' PageAllocator through one sequence: the same page
    ids, refcounts, free and cached lists (reclaim order), digests to
    the same pages, CoW decisions and lookups, after every operation;
    the digest chains are the same bytes."""
    kw = dict(num_pages=7, num_slots=4, max_pages=4, page_size=4)
    want = _drive(JaxAllocator(**kw), JaxExhausted)
    got = _drive(PageAllocator(**kw), PagePoolExhausted)
    assert len(got) == len(want)
    for w, g in zip(want, got):
        assert g == w, w[0]
    ids = _prompt(1, 37)
    assert prompt_digest_chain(ids, 8) == jax_digest_chain(ids, 8)


def test_device_table_uploads_only_when_the_table_changed():
    """One device tensor for the allocator's life (a captured step holds
    its address), refreshed from the host table only when that changed:
    a mark written into it survives a call with the table unchanged."""
    al = PageAllocator(num_pages=4, num_slots=2, max_pages=2, page_size=4)
    t0 = al.device_table("cpu")
    assert t0.dtype == torch.int64 and al.device_table("cpu") is t0
    t0.fill_(7)
    assert al.device_table("cpu").tolist() == [[7, 7], [7, 7]]
    al.map(0, 0, al.alloc())
    t1 = al.device_table("cpu")
    assert t1 is t0 and t1.tolist() == al.table.tolist()
    al.free_slot(0)
    assert al.device_table("cpu") is t0 and t0.tolist() == [[0, 0], [0, 0]]


# ---------------------------------------------------------------------------
# paged attention and model-level paged decode
# ---------------------------------------------------------------------------

def test_paged_scatter_matches_jax_and_drops_into_the_sink():
    """Writes of valid positions land where the JAX scatter puts them;
    invalid lanes, positions past the table and padding go to the sink
    page (the JAX scatter drops them), and no other page changes."""
    from paddle_tpu.serving.cache import paged_scatter as jax_scatter
    from paddle_tpu_torch.serving import paged_scatter
    rng = np.random.default_rng(3)
    NP, L, P, H, D = 6, 2, 4, 2, 3
    kc = rng.standard_normal((NP, L, P, H, D)).astype(np.float32)
    vc = rng.standard_normal((NP, L, P, H, D)).astype(np.float32)
    table = np.asarray([[2, 5], [0, 3]], np.int32)
    pos = np.asarray([[1, 5, 9], [3, 4, 7]], np.int32)       # 9: past it
    valid = np.asarray([[True, True, True], [False, True, True]])
    k_new = rng.standard_normal((2, 3, H, D)).astype(np.float32)
    v_new = rng.standard_normal((2, 3, H, D)).astype(np.float32)
    want_k, want_v, _, _ = jax_scatter(
        jnp.asarray(kc), jnp.asarray(vc), 1, jnp.asarray(table),
        jnp.asarray(pos), jnp.asarray(valid), jnp.asarray(k_new),
        jnp.asarray(v_new))
    sink = np.zeros((1, L, P, H, D), np.float32)
    tk = torch.from_numpy(np.concatenate([kc, sink]))
    tv = torch.from_numpy(np.concatenate([vc, sink]))
    paged_scatter(tk, tv, 1, torch.from_numpy(table.astype(np.int64)),
                  torch.from_numpy(pos), torch.from_numpy(valid),
                  torch.from_numpy(k_new), torch.from_numpy(v_new))
    np.testing.assert_array_equal(tk[:NP].numpy(), np.asarray(want_k))
    np.testing.assert_array_equal(tv[:NP].numpy(), np.asarray(want_v))
    assert bool(tk[NP].any()) and bool(tv[NP].any())


@pytest.mark.parametrize("s", [1, 4])
@pytest.mark.parametrize("pages_per_block", [None, 1, 2, 4])
def test_paged_decode_attention_matches_jax(pages_per_block, s):
    """Both variants over an arbitrary page mapping and ragged lengths
    (0 to the last row), one and several query positions, f32."""
    rng = np.random.default_rng(0)
    B, H, D, P, MP, NP = 3, 2, 8, 8, 8, 32
    q = rng.standard_normal((B, s, H, D)).astype(np.float32)
    kp = rng.standard_normal((NP, P, H, D)).astype(np.float32)
    vp = rng.standard_normal((NP, P, H, D)).astype(np.float32)
    table = rng.permutation(NP)[:B * MP].reshape(B, MP).astype(np.int32)
    pos = np.asarray([0, 17, 64 - s], np.int32)
    jargs = [jnp.asarray(a) for a in (q, kp, vp, table, pos)]
    if pages_per_block is None:
        want = jax_da._paged_gather(*jargs, None)
    else:
        want = jax_da._paged_chunked(*jargs, None, pages_per_block)
    got = da.paged_decode_attention(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
        torch.from_numpy(table.astype(np.int64)), torch.from_numpy(pos),
        pages_per_block=pages_per_block)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    assert da.supported_pages_per_block(MP) == \
        jax_da.supported_pages_per_block(MP)


def test_model_level_paged_decode_matches_jax_every_position():
    """``model(x, cache=gen_paged_cache(...))`` one token at a time: the
    logits at every position match the JAX model's paged decode and the
    full forward; the lengths advance to 8."""
    jm, tm = _pair(seed=3)
    ids = np.random.default_rng(3).integers(0, 512, (2, 8)).astype(np.int32)
    jc = jm.gen_paged_cache(2, max_len=64, page_size=16)
    tc = tm.gen_paged_cache(2, max_len=64, page_size=16, device="cpu")
    assert tuple(tc.k.shape) == (8 + 1, 2, 16, 4, 16)   # 8 pages + sink
    assert tc.num_pages == 8 and tc.max_len == 64
    with torch.no_grad():
        full = tm(torch.from_numpy(ids)).numpy()
    for t in range(8):
        jl, jc = jm(paddle.to_tensor(ids[:, t:t + 1]), cache=jc)
        with torch.no_grad():
            tl, tc = tm(torch.from_numpy(ids[:, t:t + 1]), cache=tc)
        np.testing.assert_allclose(tl.numpy(), jl.numpy(), atol=ATOL,
                                   rtol=0)
        np.testing.assert_allclose(tl.numpy()[:, 0], full[:, t], atol=ATOL,
                                   rtol=0)
    assert tc.lengths.tolist() == [8, 8]


def test_model_level_paged_cache_respects_declared_max_len():
    """max_len 12 in pages of 8: appends past 12 go to the sink page, the
    tail page's rows 4-7 stay zero and the lengths stop at 12, as the
    JAX cache's."""
    jm, tm = _pair(seed=4)
    jc = jm.gen_paged_cache(1, max_len=12, page_size=8)
    tc = tm.gen_paged_cache(1, max_len=12, page_size=8, device="cpu")
    assert tc.max_len == 12
    ids = np.asarray([[7]], np.int32)
    for _ in range(16):
        jl, jc = jm(paddle.to_tensor(ids), cache=jc)
        with torch.no_grad():
            tl, tc = tm(torch.from_numpy(ids), cache=tc)
    np.testing.assert_allclose(tl.numpy(), jl.numpy(), atol=ATOL, rtol=0)
    assert int(tc.lengths[0]) == int(np.asarray(jc.lengths)[0]) == 12
    assert not bool(tc.k[1, :, 4:].any())


# ---------------------------------------------------------------------------
# the engine against the JAX engine
# ---------------------------------------------------------------------------

def _churn_prompts():
    rng = np.random.default_rng(7)
    return [rng.integers(0, 512, (n,)).astype(np.int32)
            for n in (5, 9, 17, 3, 12, 20)]


def test_greedy_tokens_identical_to_jax_through_churn_and_eos():
    """Six requests through two slots, chunked prefill (chunks of 8),
    one request ending at an EOS taken from its own first run."""
    jm, tm = _pair()
    prompts = _churn_prompts()
    je, te = _engines(jm, tm, prefill_chunk=8)
    probe, _ = _run(JaxScheduler, JaxRequest, je, prompts, overlap=False)
    assert len({tuple(r.tokens) for r in probe}) > 1
    eos_tok = int(probe[2].tokens[5])
    first = list(probe[2].tokens).index(eos_tok)
    eos = [None, None, eos_tok, None, None, None]
    je, te = _engines(jm, tm, prefill_chunk=8)
    want, got, sched = _run_both(je, te, prompts, eos=eos)
    _same_results(want, got)
    assert got[2].finish_reason == "eos"
    assert len(got[2].tokens) == first + 1
    assert all(len(r.tokens) == 16 for i, r in enumerate(got) if i != 2)
    for r in got:
        assert r.ttft > 0 and r.tpot > 0 and r.queue_wait >= 0
        assert r.preemptions == 0
    assert sched.prefill_chunks_total == sum(-(-len(p) // 8)
                                             for p in prompts)
    assert te.pages_free() == te.num_pages - te._alloc.pages_used()


def test_prefix_hit_maps_pages_instead_of_recomputing():
    """A second admission of a 20-token prompt maps its two full pages
    and its tail page (capped at n - 1 = 19 tokens), runs one 1-token
    chunk that attends pages it never computed, copies the shared tail
    page before its write, and samples the first slot's greedy token:
    page tables, refcounts and last logits as the JAX engine's."""
    jm, tm = _pair(seed=1)
    je, te = _engines(jm, tm)
    prompt = _prompt(11, 20)
    tasks, firsts = [], []
    for eng in (je, te):
        tok0, _ = eng.prefill(0, prompt, temperature=0.0)
        task = eng.prefill_begin(1, prompt, temperature=0.0)
        assert task.shared_tokens == 19 and task.shared_pages == 3
        while not eng.prefill_step(task):
            pass
        assert task.chunks_run == 1
        assert task.first_token == tok0
        tasks.append(task)
        firsts.append(tok0)
    assert firsts[0] == firsts[1]
    np.testing.assert_allclose(tasks[1].last_logits.numpy(),
                               np.asarray(tasks[0].last_logits), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(tasks[1].last_logits.numpy(),
                               _full_last_logits(tm, prompt), atol=ATOL,
                               rtol=0)
    ja, ta = je._alloc, te._alloc
    assert ta.table.tolist() == ja.table.tolist()
    assert ta.refcount.tolist() == ja.refcount.tolist()
    for idx in range(2):
        assert ta.table[0, idx] == ta.table[1, idx]
    assert ta.table[0, 2] != ta.table[1, 2]
    assert te.cow_copies == 1
    assert te.slot_lengths().tolist() == [20, 20]


def test_fully_cached_prompt_admits_in_one_chunk():
    jm, tm = _pair(seed=2)
    je, te = _engines(jm, tm, prefill_chunk=8)
    prompt = _prompt(13, 24)                       # 3 full pages
    for eng in (je, te):
        tok0, _ = eng.prefill(0, prompt, temperature=0.0)
        task = eng.prefill_begin(1, prompt, temperature=0.0)
        assert task.shared_tokens == 23
        while not eng.prefill_step(task):
            pass
        assert task.chunks_run == 1
        assert task.first_token == tok0
    assert te._alloc.table.tolist() == je._alloc.table.tolist()


def _greedy_stream(eng, slot, first_tok, n):
    """``n`` greedy tokens for ``slot`` alone (the other lanes inactive:
    their writes go to the sink page)."""
    S = eng.num_slots
    toks = [int(first_tok)]
    for _ in range(n):
        feed = [0] * S
        feed[slot] = toks[-1]
        active = [False] * S
        active[slot] = True
        nt, _ = eng.decode(feed, active, [0.0] * S, [0] * S, [1.0] * S)
        toks.append(int(nt[slot]))
    return toks


def test_cow_one_sharers_decode_never_perturbs_another():
    """Two requests share a 16-token prompt's pages; each decodes while
    the other's pages sit in the same pool.  Each stream equals the JAX
    engine's and that of a fresh engine where nothing was shared."""
    jm, tm = _pair(seed=5)
    prompt = _prompt(17, 16)
    streams = []
    for eng in _engines(jm, tm):
        tok0, _ = eng.prefill(0, prompt, temperature=0.0)
        tok1, _ = eng.prefill(1, prompt, temperature=0.0)
        assert int(eng._alloc.refcount.max()) == 2
        streams.append((_greedy_stream(eng, 0, tok0, 8),
                        _greedy_stream(eng, 1, tok1, 8)))
    assert streams[1] == streams[0]
    for slot in (0, 1):
        ref = _engines(jm, tm)[1]
        tok, _ = ref.prefill(slot, prompt, temperature=0.0)
        assert streams[1][slot] == _greedy_stream(ref, slot, tok, 8)


def test_cow_fires_when_an_append_targets_a_shared_page():
    """Slot 1 maps slot 0's half-full tail page (what a tail-digest hit
    does); one decode of both copies the page before either write, and
    the tokens are the JAX engine's."""
    jm, tm = _pair(seed=6)
    prompt = _prompt(23, 12)
    toks = []
    for eng in _engines(jm, tm):
        eng.prefill(0, prompt, temperature=0.0)
        al = eng._alloc
        al.share(1, 0, int(al.table[0, 0]))
        al.share(1, 1, int(al.table[0, 1]))
        eng._set_length(1, 12)
        pid = int(al.table[1, 1])
        assert al.needs_cow(1, 1) and al.needs_cow(0, 1)
        nt, _ = eng.decode([3, 3], [True, True], [0.0, 0.0], [0, 0],
                           [1.0, 1.0])
        toks.append([int(t) for t in nt])
        assert int(al.table[0, 1]) != int(al.table[1, 1])
        assert int(al.refcount[pid]) == 1
    assert toks[1] == toks[0] and toks[1][0] == toks[1][1]
    assert eng.cow_copies == 1


def test_chunked_prefill_matches_one_shot_and_jax():
    """A 30-token prompt in chunks of 8 (4 chunks) gives the last logits
    of one 64-token chunk, of the JAX engine's chunks and of the full
    forward."""
    jm, tm = _pair(seed=7)
    prompt = _prompt(29, 30)
    je, te = _engines(jm, tm, num_slots=1, prefill_chunk=8)
    task = te.prefill_begin(0, prompt, temperature=0.0)
    steps = 0
    while not te.prefill_step(task):
        steps += 1
    assert steps + 1 == task.chunks_run == 4
    _tok, jl = je.prefill(0, prompt, temperature=0.0)
    one = _engines(jm, tm, num_slots=1, prefill_chunk=64)[1]
    _tok, ol = one.prefill(0, prompt, temperature=0.0)
    got = task.last_logits.numpy()
    np.testing.assert_allclose(got, ol.numpy(), atol=1e-5, rtol=0)
    np.testing.assert_allclose(got, np.asarray(jl), atol=ATOL, rtol=0)
    np.testing.assert_allclose(got, _full_last_logits(tm, prompt),
                               atol=ATOL, rtol=0)


def test_tight_pool_preempts_and_matches_jax():
    """Two 24-token prompts each need 5 pages of 8 at 8 new tokens; a
    pool of 6 forces evictions.  The victims are requeued and recomputed:
    every request finishes by length, with the tokens of the JAX engine
    and of a roomy pool."""
    jm, tm = _pair(seed=8)
    rng = np.random.default_rng(71)
    prompts = [rng.integers(0, 512, (24,)).astype(np.int32)
               for _ in range(2)]
    kw = dict(max_len=48, page_size=8, prefill_chunk=8)
    je, te = _engines(jm, tm, num_pages=6, **kw)
    want, got, sched = _run_both(je, te, prompts, max_new=8)
    _same_results(want, got)
    assert sched.preemptions_total > 0
    assert sum(r.preemptions for r in got) == sched.preemptions_total
    roomy, _ = _run(ContinuousBatchingScheduler, Request,
                    _engines(jm, tm, num_pages=12, **kw)[1], prompts,
                    max_new=8)
    for t, r in zip(got, roomy):
        assert t.finish_reason == r.finish_reason == "length"
        assert t.tokens.tolist() == r.tokens.tolist()


def test_pool_too_small_finishes_cache_full_as_jax():
    """Four requests through a pool of 6 pages at max_len 32: preemptions
    past ``max_preemptions`` and sole occupants the pool cannot hold end
    ``cache_full``, as in the JAX scheduler; nothing hangs."""
    jm, tm = _pair(seed=9)
    rng = np.random.default_rng(43)
    prompts = [rng.integers(0, 512, (n,)).astype(np.int32)
               for n in (8, 16, 8, 24)]
    je, te = _engines(jm, tm, max_len=32, num_pages=6, prefill_chunk=8)
    want, got, _sched = _run_both(je, te, prompts, max_new=10)
    _same_results(want, got)
    for r in got:
        assert r.tokens.size >= 1


def test_decode_append_capped_at_max_len():
    """max_len 12 in pages of 8: a direct caller keeping a full lane
    active has its appends dropped (sink page) and the lengths, device
    and host mirror, stop at 12; the tokens are the JAX engine's."""
    jm, tm = _pair(seed=10)
    prompt = _prompt(5, 8)
    seqs = []
    for eng in _engines(jm, tm, num_slots=1, max_len=12, num_pages=4):
        tok, _ = eng.prefill(0, prompt, temperature=0.0)
        seq = [int(tok)]
        for _ in range(8):
            nt, _ = eng.decode([seq[-1]], [True], [0.0], [0], [1.0])
            seq.append(int(nt[0]))
        assert int(eng.slot_lengths()[0]) == 12
        assert int(np.asarray(eng.cache.lengths)[0]) == 12
        seqs.append(seq)
    assert seqs[1] == seqs[0]


def test_prefix_hit_reported_in_result():
    """One slot: the second request is admitted after the first retired
    and hits its free-but-cached pages (15 of 16 tokens), as in JAX."""
    jm, tm = _pair(seed=11)
    prompt = _prompt(47, 16)
    je, te = _engines(jm, tm, num_slots=1)
    want, got, sched = _run_both(je, te, [prompt, prompt], max_new=2)
    _same_results(want, got)
    assert [r.prefix_hit_tokens for r in got] == [0, 15]
    assert sched.prefix_hit_pages == 2


def test_chunked_prefill_interleaves_with_decode():
    """While a 60-token prompt admits in chunks of 8, the running request
    gains a token every iteration; both finish with the greedy tokens of
    the full forward."""
    _jm, tm = _pair(seed=12)
    te = _engines(*_pair(seed=12), max_len=128, prefill_chunk=8)[1]
    sched = ContinuousBatchingScheduler(te)
    short, long = _prompt(31, 4), _prompt(37, 60)
    r_short = sched.submit(Request(prompt=short, max_new_tokens=20,
                                   temperature=0.0))
    sched.step()
    assert sched.slots[0].generated
    r_long = sched.submit(Request(prompt=long, max_new_tokens=4,
                                  temperature=0.0))
    before = len(sched.slots[0].generated)
    iters = 0
    while sched.slots[1] is None or sched.slots[1].prefill_task is not None:
        sched.step()
        iters += 1
        assert iters < 50
    assert iters == 8
    assert len(sched.slots[0].generated) - before >= iters - 1
    res = sched.run()
    assert res[r_short].tokens.size == 20 and res[r_long].tokens.size == 4
    seq = list(long)
    for t in res[r_long].tokens:
        assert int(_full_last_logits(tm, seq).argmax()) == int(t)
        seq.append(int(t))


# ---------------------------------------------------------------------------
# the port alone
# ---------------------------------------------------------------------------

def test_paged_and_slotted_greedy_tokens_identical():
    _jm, tm = _pair(seed=13)
    prompts = _churn_prompts()
    out = {}
    for paged in (False, True):
        eng = DecodeEngine(tm, num_slots=2, max_len=64, paged=paged,
                           page_size=8, prefill_chunk=8, device="cpu")
        res, _ = _run(ContinuousBatchingScheduler, Request, eng, prompts)
        out[paged] = [r.tokens.tolist() for r in res]
    assert out[True] == out[False]


def test_defaults_are_paged_as_in_jax():
    _jm, tm = _pair(seed=14)
    eng = DecodeEngine(tm, num_slots=3, max_len=100, device="cpu")
    assert eng.paged and eng.page_size == 64 and eng.max_pages == 2
    assert eng.num_pages == 6 and eng.prefill_chunk == 64
    assert eng.prompt_cap == 100
    assert tuple(eng.cache.k.shape) == (7, 2, 64, 4, 16)
    assert eng.kv_pool_bytes() == 6 * 64 * eng.kv_row_bytes()
    small = DecodeEngine(tm, num_slots=1, max_len=16, device="cpu")
    assert small.page_size == small.prefill_chunk == 16
    slotted = DecodeEngine(tm, num_slots=2, max_len=64, paged=False,
                           device="cpu")
    assert not slotted.paged and slotted.buckets[-1] == 64
    with pytest.raises(AttributeError):
        eng.bucket_for(5)
    assert engine_for(tm, num_slots=2, device="cpu").paged
    assert not engine_for(tm, num_slots=2, device="cpu",
                          paged=False).paged
    out = generate(tm, [_prompt(1, 5)], max_new_tokens=3, temperature=0.0,
                   device="cpu")
    assert next(iter(tm._serving_engines.values())).paged
    assert out[0].size == 3


def test_generate_seed_reproducible_across_prefix_cache():
    """Two ``generate(seed=0, temperature=1)`` calls on the cached engine:
    the second admission prefix-hits (one 1-token chunk instead of two
    chunks), and the sampled tokens are the same, because only the final
    chunk draws from the generator."""
    _jm, tm = _pair(seed=15)
    prompt = _prompt(83, 100)
    a = generate(tm, prompt, max_new_tokens=5, temperature=1.0, seed=0,
                 device="cpu")
    eng = next(iter(tm._serving_engines.values()))
    assert eng._alloc.lookup_prefix(prompt)[1] == 100
    b = generate(tm, prompt, max_new_tokens=5, temperature=1.0, seed=0,
                 device="cpu")
    assert a[0].tolist() == b[0].tolist()


def _assert_step_purges_prefix_cache(tm, train_step):
    """``generate`` fills the prefix cache; ``train_step()`` updates the
    parameters; the next ``generate`` of the same prompt must recompute
    (no prefix hit) and give a fresh engine's tokens on the new weights.
    Without a change the cache survives a reuse."""
    prompt = _prompt(89, 40)
    kw = dict(max_new_tokens=6, temperature=0.0, device="cpu")
    generate(tm, prompt, **kw)
    eng = next(iter(tm._serving_engines.values()))
    assert not eng.refresh_state()
    assert eng._alloc.lookup_prefix(prompt)[1] == 40
    train_step()
    tm.eval()
    task = eng.prefill_begin(0, prompt, temperature=0.0)
    assert task.shared_tokens == 0, "stale prefix pages after a step"
    eng.free_slot(0)
    got = generate(tm, prompt, **kw)
    fresh = DecodeEngine(tm, num_slots=1, device="cpu")
    want, _ = _run(ContinuousBatchingScheduler, Request, fresh, [prompt],
                   max_new=6)
    assert got[0].tolist() == want[0].tokens.tolist()


def test_training_step_between_generates_never_serves_stale_prefix():
    """One eager AdamW step, which updates the parameters in place."""
    _jm, tm = _pair(seed=16)
    ids = torch.from_numpy(_prompt(3, 32)[None].astype(np.int64))

    def step():
        tm.train()
        opt = AdamW(learning_rate=1e-2, parameters=tm.parameters())
        GPTPretrainingCriterion()(tm(ids), ids).backward()
        opt.step()

    _assert_step_purges_prefix_cache(tm, step)


def test_flat_master_train_step_between_generates_never_serves_stale_prefix():
    """One ``TrainStep(flat_master=True)`` step: its parameters view one
    buffer that the write-back fills, so the purge must not rely on the
    parameters' own writes."""
    _jm, tm = _pair(seed=16)
    ids = torch.from_numpy(_prompt(3, 32)[None].astype(np.int64))
    opt = AdamW(learning_rate=1e-2, parameters=tm.parameters())
    train = TrainStep(tm, GPTPretrainingCriterion(), opt, flat_master=True,
                      device="cpu")
    assert train._flat_groups
    _assert_step_purges_prefix_cache(tm, lambda: train(ids, ids))


def test_pinned_chunked_attention_serves_the_same_tokens(tmp_path,
                                                         monkeypatch):
    """``decode_attn_paged`` pinned to the chunked variant (two pages a
    block): the views resolve it once a step and the scheduler's greedy
    tokens are those of the default one-shot gather."""
    from paddle_tpu_torch.utils import flags
    monkeypatch.setenv("PADDLE_TPU_AUTOTUNE_CACHE",
                       str(tmp_path / "autotune.json"))
    _jm, tm = _pair(seed=21)
    prompts = _churn_prompts()
    out = []
    for pin in ("", "decode_attn_paged=paged_chunked:pages_per_block=2"):
        monkeypatch.setitem(flags._REGISTRY, "autotune_pin", pin)
        eng = DecodeEngine(tm, num_slots=2, max_len=64, page_size=8,
                           prefill_chunk=8, device="cpu")
        res, _ = _run(ContinuousBatchingScheduler, Request, eng, prompts)
        out.append([r.tokens.tolist() for r in res])
    assert out[1] == out[0]
    assert da.resolve_pages_per_block(
        torch.zeros(2, 1, 4, 16), eng.cache.k[:, 0], eng.cache.page_table) \
        == 2


def test_dropped_writes_land_in_the_sink_page():
    """A retired slot's lane stays inactive: its stale table row must
    never write, so a decode of the other slot changes only that slot's
    tail page and the sink page."""
    _jm, tm = _pair(seed=17)
    eng = DecodeEngine(tm, num_slots=2, max_len=64, page_size=8,
                       device="cpu")
    eng.prefill(0, _prompt(1, 10), temperature=0.0)
    eng.prefill(1, _prompt(2, 12), temperature=0.0)
    gone = eng._alloc.table[1, :2].tolist()
    eng.free_slot(1)
    before = eng.cache.k.clone()
    eng.decode([5, 5], [True, False], [0.0] * 2, [0] * 2, [1.0] * 2)
    changed = sorted(int(p) for p in
                     (eng.cache.k != before).flatten(1).any(1).nonzero())
    tail = int(eng._alloc.table[0, 1])
    assert changed == [tail, eng.num_pages]
    assert not set(gone) & set(changed[:-1])
    assert eng.slot_lengths().tolist() == [11, 0]


def test_zero_token_eviction_reports_no_ttft():
    _jm, tm = _pair(seed=18)
    eng = DecodeEngine(tm, num_slots=2, max_len=32, page_size=8,
                       prefill_chunk=8, device="cpu")
    sched = ContinuousBatchingScheduler(eng)
    rid = sched.submit(Request(prompt=_prompt(11, 24), max_new_tokens=2,
                               temperature=0.0))
    assert sched.admit() == 1
    sched._finish(0, "cache_full")
    res = sched.finished[rid]
    assert res.tokens.size == 0 and res.ttft == 0.0


def test_eviction_prefers_max_unshared_pages():
    """The victim is the slot with the most unshared pages, not the
    oldest: slots 1 and 2 share a prompt's first page."""
    _jm, tm = _pair(seed=19)
    eng = DecodeEngine(tm, num_slots=3, max_len=32, page_size=8,
                       num_pages=8, prefill_chunk=8, device="cpu")
    sched = ContinuousBatchingScheduler(eng)
    rng = np.random.default_rng(41)
    shared, unique = rng.integers(0, 512, (16,)), rng.integers(0, 512, (24,))
    eng.prefill(0, unique, temperature=0.0)
    eng.prefill(1, shared, temperature=0.0)
    eng.prefill(2, shared, temperature=0.0)
    assert [eng.unshared_pages(i) for i in range(3)] == [3, 1, 1]

    @dataclasses.dataclass
    class _Occupant:
        admit_order: int
        req: Request
        submit_t: float = 0.0
        prefill_task: object = None

    sched.slots = [_Occupant(i, Request(prompt=np.asarray([1]), rid=i))
                   for i in range(3)]
    assert sched._evict_for_pages(requester_idx=1)
    assert sched.slots[0] is None and sched.slots[2] is not None
    assert list(sched.waiting)[0].rid == 0 and sched.preemptions_total == 1


def test_kv_bytes_accounting_scales_with_true_lengths():
    _jm, tm = _pair(seed=20)
    eng = DecodeEngine(tm, num_slots=2, max_len=64, page_size=8,
                       device="cpu")
    eng.prefill(0, np.asarray([1, 2, 3], np.int32), temperature=0.0)
    eng.prefill(1, np.asarray([4, 5, 6, 7], np.int32), temperature=0.0)
    for _ in range(4):
        eng.decode([1, 2], [True, True], [0.0, 0.0], [0, 0], [1.0, 1.0])
    b = eng.kv_bytes_per_token()
    assert 0.0 < b["paged"] < b["flat"] / 4
    # 2 layers x 4 heads x 16 x 4 bytes x (K, V)
    assert eng.kv_row_bytes() == 2 * 4 * 16 * 4 * 2
    assert eng.kv_pool_bytes() == 16 * 8 * eng.kv_row_bytes()


@pytest.mark.parametrize("kw", [dict(tp=2)])
def test_unported_paged_features_raise(kw):
    """tp=2 without a world of two ranks: the JAX engine's "devices"
    error, with overlap_comm=True too (the islands are ported:
    tests/test_torch_mp_overlap.py)."""
    with pytest.raises(ValueError, match="devices"):
        DecodeEngine(GPTForCausalLM(GPTConfig.tiny()), device="cpu", **kw)
    with pytest.raises(ValueError, match="devices"):
        DecodeEngine(GPTForCausalLM(GPTConfig.tiny()), device="cpu",
                     overlap_comm=True, **kw)


def test_refresh_state_takes_a_state_and_purges_the_prefix_cache():
    """The JAX check of ``refresh_state`` (``tests/test_paged.py``): an
    unchanged re-snapshot keeps the prefix cache, so a re-admission maps
    15 of its 16 tokens; ``refresh_state(perturbed)`` serves the given
    state, shares no page computed under the old one, and the logits
    equal a fresh engine's under the same state."""
    _jm, tm = _pair(seed=29)
    reference = copy.deepcopy(tm)
    eng = DecodeEngine(tm, num_slots=1, max_len=64, page_size=8,
                       device="cpu")
    prompt = np.random.default_rng(29).integers(0, 512, (16,))
    _tok, logits0 = eng.prefill(0, prompt, temperature=0.0)
    ref0 = logits0.clone()
    eng.free_slot(0)
    assert not eng.refresh_state()
    task = eng.prefill_begin(0, prompt, temperature=0.0)
    assert task.shared_tokens == 15
    while not eng.prefill_step(task):
        pass
    torch.testing.assert_close(task.last_logits, ref0, atol=1e-5, rtol=1e-5)
    eng.free_slot(0)

    perturbed = {k: v + 0.01 for k, v in tm.state_dict().items()
                 if v.is_floating_point()}
    assert eng.refresh_state(perturbed)
    for k, v in tm.state_dict().items():
        assert torch.equal(v, perturbed[k]), k
    task = eng.prefill_begin(0, prompt, temperature=0.0)
    assert task.shared_tokens == 0, "stale prefix pages served after " \
                                    "a parameter change"
    while not eng.prefill_step(task):
        pass
    fresh = DecodeEngine(reference, num_slots=1, max_len=64, page_size=8,
                         device="cpu")
    fresh.refresh_state(perturbed)
    _tok, logits_fresh = fresh.prefill(0, prompt, temperature=0.0)
    torch.testing.assert_close(task.last_logits, logits_fresh, atol=1e-5,
                               rtol=1e-5)
    with pytest.raises(KeyError, match="no"):
        eng.refresh_state({"gpt.nonexistent": torch.zeros(1)})
