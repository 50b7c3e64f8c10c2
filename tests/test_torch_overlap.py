"""paddle_tpu_torch's overlapped serving loop (the scheduler's default)
against ``paddle_tpu``'s overlapped loop and the port's own synchronous
loop, at the tiny config in f32 on one set of numpy weights (``_pair`` of
``tests/test_torch_paged.py``), mirroring ``tests/test_overlap.py``:

* greedy tokens identical through admission churn (paged and slotted),
  EOS landing on an in-flight step, prefix hits, recompute preemption of
  a slot with an undrained step, speculative decoding (and its EOS cut;
  the per-request draft counts equal the JAX overlapped loop's) and the
  int8 pool;
* ``cancel`` of a running and of a waiting request gives the JAX
  package's ``RequestResult`` fields and returns every page;
* the ``on_token`` stream, the host length mirror after a drain, seeded
  sampling within a mode, the host-gap accounting, the
  ``PADDLE_TPU_SERVE_OVERLAP`` default, ``ThreadedTokens`` and
  ``generate``.

On the CPU the engine runs its eager step (a card replays it from a
captured graph: ``tests/test_torch_cuda_serving.py``)."""
import numpy as np
import pytest
import torch

from paddle_tpu.serving import generate as jax_generate
from paddle_tpu.serving.engine import DecodeEngine as JaxEngine
from paddle_tpu.serving.scheduler import \
    ContinuousBatchingScheduler as JaxScheduler
from paddle_tpu.serving.scheduler import Request as JaxRequest
from paddle_tpu_torch.serving import (ContinuousBatchingScheduler,
                                      DecodeEngine, Request,
                                      ThreadedTokens, generate)
from test_torch_paged import _pair


def _engines(jm, tm, **kw):
    kw.setdefault("num_slots", 2)
    kw.setdefault("max_len", 64)
    kw.setdefault("page_size", 8)
    return (JaxEngine(jm, seed=0, **kw),
            DecodeEngine(tm, seed=0, device="cpu", **kw))


def _prompts(n=5, length=8, seed=1, shared=0):
    rng = np.random.default_rng(seed)
    head = rng.integers(0, 512, (shared,))
    return [np.concatenate([head, rng.integers(0, 512, (length,))])
            .astype(np.int32) for _ in range(n)]


def _drive(eng, prompts, overlap, max_new=8, eos=None, temperature=0.0,
           jax=False, **skw):
    """Every prompt through a scheduler of either package; returns
    (results in submission order, the scheduler)."""
    sched_cls, req_cls = ((JaxScheduler, JaxRequest) if jax else
                          (ContinuousBatchingScheduler, Request))
    sched = sched_cls(eng, overlap=overlap, **skw)
    rids = [sched.submit(req_cls(prompt=p, max_new_tokens=max_new,
                                 temperature=temperature, eos_token_id=eos))
            for p in prompts]
    res = sched.run()
    return [res[r] for r in rids], sched


def _three(jm, tm, prompts, engine_kw=None, **kw):
    """(JAX overlapped, port overlapped, port synchronous) results, the
    port's overlapped engine and scheduler."""
    engine_kw = engine_kw or {}
    je, te = _engines(jm, tm, **engine_kw)
    jax_over, _ = _drive(je, prompts, True, jax=True, **kw)
    over, sched = _drive(te, prompts, True, **kw)
    sync, _ = _drive(_engines(jm, tm, **engine_kw)[1], prompts, False, **kw)
    return jax_over, over, sync, te, sched


def _same(a, b, spec_counts=False):
    for x, y in zip(a, b):
        assert y.tokens.tolist() == x.tokens.tolist()
        assert y.finish_reason == x.finish_reason
        assert y.prefix_hit_tokens == x.prefix_hit_tokens
        if spec_counts:
            assert (y.spec_proposed, y.spec_accepted) == \
                (x.spec_proposed, x.spec_accepted)


@pytest.fixture(scope="module")
def pair():
    return _pair()


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "slotted"])
def test_greedy_tokens_through_admission_churn(pair, paged):
    """Five requests through two slots: admissions land while a step is
    in flight (the freed lane's stale token is dropped, the new occupant
    joins the next launch with its host-known first token)."""
    jax_over, over, sync, te, sched = _three(
        *pair, _prompts(), engine_kw=dict(paged=paged))
    _same(jax_over, over)
    _same(sync, over)
    assert sched.overlap and sched._inflight is None
    if paged:
        assert te._alloc.pages_used() == 0
        assert te.slot_lengths().tolist() == [0, 0]


def test_eos_landing_on_an_inflight_step(pair):
    """EOS found at consume time, after the next step was launched with
    the finished slot still active: its token is dropped and the
    sequences are the JAX overlapped loop's and the synchronous loop's."""
    jm, tm = pair
    prompts = _prompts()
    base, _ = _drive(_engines(jm, tm)[1], prompts, False, max_new=10)
    eos = int(base[0].tokens[2])
    jax_over, over, sync, _te, sched = _three(jm, tm, prompts, max_new=10,
                                              eos=eos)
    _same(jax_over, over)
    _same(sync, over)
    assert any(r.finish_reason == "eos" for r in over)
    _sync, s_sync = _drive(_engines(jm, tm)[1], prompts, False, max_new=10,
                           eos=eos)
    assert sched.decode_steps_total >= s_sync.decode_steps_total


def test_prefix_hits_under_overlap(pair):
    """Six requests sharing 16 prompt tokens (two pages of 8): later
    admissions map the shared pages while a step is in flight."""
    jax_over, over, sync, te, sched = _three(
        *pair, _prompts(n=6, length=5, shared=16))
    _same(jax_over, over)
    _same(sync, over)
    assert sum(r.prefix_hit_tokens for r in over) > 0
    assert sched.prefix_hit_pages > 0 and te._alloc.pages_used() == 0


def test_preemption_of_a_slot_with_an_undrained_step(pair):
    """A pool of 7 pages: a prefill chunk's page demand drains the step
    in flight before it evicts; the victim recomputes and the tokens are
    the JAX overlapped loop's and the synchronous loop's."""
    jax_over, over, sync, te, sched = _three(
        *pair, _prompts(n=3, length=20),
        engine_kw=dict(num_pages=7, max_len=48))
    _same(jax_over, over)
    _same(sync, over)
    assert sched.preemptions_total > 0
    assert all(a is None for a in sched.slots)
    assert te._alloc.pages_used() == 0


def _spec_prompts():
    rng = np.random.default_rng(11)
    span = rng.integers(0, 512, (6,)).astype(np.int32)
    return ([rng.integers(0, 512, (8,)).astype(np.int32) for _ in range(3)]
            + [np.tile(span, 4), np.tile(span[:4], 5)])


def test_spec_overlapped_matches_jax_overlapped(pair):
    """Verify steps under overlap draft from one-step-stale history: the
    tokens equal the synchronous plain loop's, and every per-request
    draft count equals the JAX overlapped loop's (same drafts, same
    acceptance).  A verify step consumed after its lane was freed does
    not revive the lane's length: a second scheduler on the engine
    admits cleanly."""
    jm, tm = pair
    prompts = _spec_prompts()
    jax_over, over, _sync, te, _s = _three(
        jm, tm, prompts, engine_kw=dict(spec_k=4), max_new=10)
    plain, _ = _drive(_engines(jm, tm)[1], prompts, False, max_new=10)
    _same(jax_over, over, spec_counts=True)
    _same(plain, over)
    assert sum(r.spec_accepted for r in over) > 0
    assert te.slot_lengths().tolist() == [0, 0]
    again, _ = _drive(te, prompts[:1], True, max_new=4)
    assert again[0].tokens.tolist() == plain[0].tokens[:4].tolist()


def test_spec_eos_cut_under_overlap(pair):
    jm, tm = pair
    prompts = _spec_prompts()
    base, _ = _drive(_engines(jm, tm)[1], prompts, False, max_new=10)
    eos = int(base[3].tokens[1])
    jax_over, over, _sync, _te, _s = _three(
        jm, tm, prompts, engine_kw=dict(spec_k=4), max_new=10, eos=eos)
    plain, _ = _drive(_engines(jm, tm)[1], prompts, False, max_new=10,
                      eos=eos)
    _same(jax_over, over, spec_counts=True)
    _same(plain, over)
    assert any(r.finish_reason == "eos" for r in over)


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "slotted"])
def test_int8_pool_under_overlap(pair, paged):
    jax_over, over, sync, te, _s = _three(
        *pair, _prompts(), engine_kw=dict(kv_dtype="int8", paged=paged))
    _same(jax_over, over)
    _same(sync, over)
    assert te.cache.k.dtype == torch.int8


def _cancel_fields(r):
    return (r.tokens.tolist(), r.finish_reason, r.prefix_hit_tokens,
            r.spec_proposed, r.spec_accepted, r.ttft > 0, r.tpot > 0)


@pytest.mark.parametrize("spec_k", [0, 3])
def test_cancel_a_running_request_as_jax(pair, spec_k):
    """Cancel after four overlapped iterations: the tokens so far ride a
    ``"cancelled"`` result with the JAX package's fields, the survivor
    is unaffected and every page comes back."""
    jm, tm = pair
    out = []
    for jax, eng in zip((True, False), _engines(jm, tm, spec_k=spec_k)):
        sched_cls, req_cls = ((JaxScheduler, JaxRequest) if jax else
                              (ContinuousBatchingScheduler, Request))
        sched = sched_cls(eng, overlap=True)
        free0 = eng.pages_free()
        p0, p1 = _prompts(n=2)
        r0 = sched.submit(req_cls(prompt=p0, max_new_tokens=30,
                                  temperature=0.0))
        r1 = sched.submit(req_cls(prompt=p1, max_new_tokens=4,
                                  temperature=0.0))
        for _ in range(4):
            sched.step()
        assert eng.pages_free() < free0
        assert sched.cancel(r0) is True
        res = sched.run()
        assert eng.pages_free() == free0
        assert sched.cancel(r0) is False
        out.append([_cancel_fields(res[r]) for r in (r0, r1)])
    assert out[1] == out[0]
    assert out[1][0][1] == "cancelled" and len(out[1][0][0]) >= 1
    assert out[1][1][1] == "length" and len(out[1][1][0]) == 4


def test_cancel_a_waiting_request_as_jax(pair):
    jm, tm = pair
    out = []
    for jax, eng in zip((True, False), _engines(jm, tm, num_slots=1)):
        sched_cls, req_cls = ((JaxScheduler, JaxRequest) if jax else
                              (ContinuousBatchingScheduler, Request))
        sched = sched_cls(eng, overlap=True)
        p0, p1 = _prompts(n=2)
        r0 = sched.submit(req_cls(prompt=p0, max_new_tokens=4,
                                  temperature=0.0))
        r1 = sched.submit(req_cls(prompt=p1, max_new_tokens=4,
                                  temperature=0.0))
        sched.step()                          # r0 admitted, r1 waiting
        assert sched.cancel(r1) is True
        res = sched.run()
        assert sched.cancel(999) is False
        assert eng.pages_free() == eng.num_pages
        out.append([_cancel_fields(res[r]) for r in (r0, r1)]
                   + [res[r1].queue_wait])
    assert out[1] == out[0]
    assert out[1][1][:2] == ([], "cancelled")


def test_cancel_a_parked_preempted_request(pair):
    """A request evicted by page pressure waits, parked, with its tokens:
    cancelling it reports them and its preemption."""
    jm, tm = pair
    te = _engines(jm, tm, num_pages=7, max_len=48)[1]
    sched = ContinuousBatchingScheduler(te)
    rids = [sched.submit(Request(prompt=p, max_new_tokens=8,
                                 temperature=0.0))
            for p in _prompts(n=3, length=20)]
    while not sched._preempted:
        sched.step()
    rid = next(iter(sched._preempted))
    parked = sched._preempted[rid]
    assert sched.cancel(rid) is True
    r = sched.finished[rid]
    assert r.finish_reason == "cancelled" and r.preemptions == 1
    assert r.tokens.tolist() == parked.generated
    res = sched.run()
    assert set(res) == set(rids) and te._alloc.pages_used() == 0


def test_on_token_stream_equals_the_results(pair):
    """The streaming hook delivers exactly each result's tokens, in
    order (first tokens included); ``on_finish`` sees every result."""
    got, finished = {}, []
    results, _ = _drive(
        _engines(*pair)[1], _prompts(n=4), True,
        on_token=lambda rid, toks: got.setdefault(rid, []).extend(toks),
        on_finish=finished.append)
    for rid, r in enumerate(results):
        assert got[rid] == r.tokens.tolist()
    assert sorted(r.rid for r in finished) == [0, 1, 2, 3]


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "slotted"])
def test_host_length_mirror_is_exact_after_a_drain(pair, paged):
    """After run() consumed the last step, the host mirror equals the
    device lengths (paged: all zero, every page back): no stale append
    leaked a length or a page."""
    results, sched = _drive(_engines(*pair, paged=paged)[1], _prompts(),
                            True)
    eng = sched.engine
    assert sched._inflight is None
    assert eng.slot_lengths().tolist() == eng.cache.lengths.tolist()
    if paged:
        assert eng.slot_lengths().tolist() == [0, 0]
        assert eng._alloc.pages_used() == 0


def test_slotted_slot_lengths_reads_no_device_tensor(pair, monkeypatch):
    """The slotted engine serves its lengths from the host mirror: a
    device read there would stall the overlapped loop."""
    eng = _engines(*pair, paged=False)[1]
    eng.prefill(1, _prompts(n=1)[0], temperature=0.0)

    def no_read(*_a, **_k):
        raise AssertionError("slot_lengths read a tensor")
    monkeypatch.setattr(torch.Tensor, "cpu", no_read)
    monkeypatch.setattr(torch.Tensor, "numpy", no_read)
    assert eng.slot_lengths().tolist() == [0, 8]


@pytest.mark.parametrize("overlap", [True, False])
def test_seeded_sampling_reproducible_within_a_mode(pair, overlap):
    a, _ = _drive(_engines(*pair)[1], _prompts(), overlap, temperature=0.8)
    b, _ = _drive(_engines(*pair)[1], _prompts(), overlap, temperature=0.8)
    assert [r.tokens.tolist() for r in a] == [r.tokens.tolist() for r in b]


def test_host_gap_is_smaller_overlapped(pair):
    """The synchronous loop pays the host window between a fetch and the
    next launch every step; the overlapped loop launches before it
    consumes, so its gap shrinks to the pipeline's bubbles."""
    _r, s_sync = _drive(_engines(*pair)[1], _prompts(n=4), False,
                        max_new=10)
    _r, s_over = _drive(_engines(*pair)[1], _prompts(n=4), True,
                        max_new=10)
    assert s_sync.decode_steps_total > 0 and s_sync.host_gap_seconds > 0
    assert s_over.host_gap_seconds < s_sync.host_gap_seconds


def test_overlap_is_the_default_and_the_env_selects_the_sync_loop(
        pair, monkeypatch):
    eng = _engines(*pair)[1]
    monkeypatch.delenv("PADDLE_TPU_SERVE_OVERLAP", raising=False)
    assert ContinuousBatchingScheduler(eng).overlap is True
    assert ContinuousBatchingScheduler(eng, overlap=True).overlap is True
    monkeypatch.setenv("PADDLE_TPU_SERVE_OVERLAP", "0")
    assert ContinuousBatchingScheduler(eng).overlap is False
    assert JaxScheduler(_engines(*pair)[0]).overlap is False


@pytest.mark.parametrize("spec_k", [0, 2])
def test_threaded_tokens_feed_the_previous_steps_tokens(pair, spec_k):
    """A step fed ``ThreadedTokens`` (lane 0 from the step in flight,
    lane 1 a host token) gives the logits of an engine fed both tokens
    from the host."""
    jm, tm = pair
    engines = [_engines(jm, tm, spec_k=spec_k)[1] for _ in range(2)]
    p0, p1 = _prompts(n=2)
    args = ([True, True], [0.0, 0.0], [0, 0], [1.0, 1.0])
    drafts = np.full((2, spec_k), 5, np.int32)
    out = []
    for threaded, eng in zip((True, False), engines):
        t0, _ = eng.prefill(0, p0, temperature=0.0)
        t1, _ = eng.prefill(1, p1, temperature=0.0)
        if spec_k:
            first = eng.decode_spec_submit([t0, t1], drafts, *args)
            em, counts, _ = eng.decode_spec_fetch(first)
            last = int(em[0, counts[0] - 1])
        else:
            first = eng.decode_submit([t0, t1], *args)
            last = int(eng.decode_fetch(first)[0][0])
        host = [last, 7]
        feed = (ThreadedTokens(first, np.asarray([False, True]),
                               np.asarray([0, 7], np.int32))
                if threaded else host)
        if spec_k:
            out.append(eng.decode_spec(feed, drafts, *args)[2])
        else:
            out.append(eng.decode(feed, *args)[1])
    torch.testing.assert_close(out[0], out[1], rtol=0, atol=0)


def test_generate_runs_the_overlapped_loop_as_jax(pair):
    jm, tm = pair
    prompts = np.stack(_prompts(n=3))
    kw = dict(max_new_tokens=6, temperature=0.0, max_len=64, page_size=8)
    want = jax_generate(jm, prompts, **kw)
    got = generate(tm, prompts, device="cpu", **kw)
    assert [g.tolist() for g in got] == [np.asarray(w).tolist()
                                         for w in want]
