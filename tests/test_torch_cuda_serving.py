"""The serving engine's captured steps on the card: the slotted and paged
decode steps, the paged verify step and the paged prefill chunk,
replayed from CUDA graphs, held bit for bit against the same engine's
eager step, the opt-in ``serving.kv_quant_error`` gauge of an int8 step
included; one graph per step kind and routing through an overlapped run
(the chunk's through churn, prefix hits, copy-on-write and preemption);
a new capture when the LayerNorm route flips or a parameter is replaced
by another tensor (and none when one is updated in place); B counting
its launches inside a replay; replays after another engine's graph was
dropped; the fetch of step t-1 returning while step t still runs; two
engines replaying from two threads giving their single-thread tokens; a
sealed capture raising; ``reset`` waiting for a step left in flight; a
handoff moving page bytes exactly on the card, a fleet's failover
keeping each engine's captures, and the scan-layers model giving the
per-layer model's bits in a prefill and in captured decode steps.
Marked ``gpu``: without an NVIDIA card
every test skips.  This file imports no JAX:

    python -m pytest tests/test_torch_cuda_serving.py -m gpu -q
"""
import dataclasses
import threading

import numpy as np
import pytest
import torch

from paddle_tpu_torch.convert import load_paddle_tpu_state
from paddle_tpu_torch.models.gpt import (GPTConfig, GPTForCausalLM,
                                         per_layer_state_to_scan)
from paddle_tpu_torch.robustness import faultpoints as fp
from paddle_tpu_torch.serving import (ContinuousBatchingScheduler,
                                      DecodeEngine, DisaggScheduler, Request,
                                      Router, graphs)
from paddle_tpu_torch.utils import flags

# eight lanes: a decode step's rows (8) are what the LayerNorm kernel's
# route needs (rows % 8 == 0), so use_pallas_norm runs it in the graph
SLOTS = 8


def _cfg():
    # hidden 128: the LayerNorm kernel's route needs F % 128 == 0; heads
    # of 64, which the prefill's flash kernel takes
    return GPTConfig(vocab_size=512, max_position_embeddings=128,
                     hidden_size=128, num_hidden_layers=2,
                     num_attention_heads=2, intermediate_size=256,
                     hidden_dropout_prob=0.0, attention_dropout_prob=0.0)


def _model(seed=0, dtype=torch.bfloat16):
    m = GPTForCausalLM(_cfg(), generator=torch.Generator().manual_seed(seed))
    with torch.no_grad():
        for p in m.parameters():
            if p.dim() > 1:
                p.mul_(10.0)           # wider than 0.02: tokens vary
    return m.to("cuda", dtype).eval()


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False


def _prompts(n=SLOTS, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 512, (9 + 5 * i,)).astype(np.int32)
            for i in range(n)]


def _step_kind(eng):
    return "spec" if eng.spec_k else "decode"


def _kind_stats(eng, kind=None):
    return eng.graph_stats()["by_kind"][kind or _step_kind(eng)]


def _script(eng, steps=6, temps=(0.0, 0.0, 0.8, 1.0) * (SLOTS // 4)):
    """Prefill every slot, then ``steps`` decode (or verify) steps fed
    the engine's own tokens, half the lanes greedy and half sampled (one
    under top-k, one under top-p); returns each step's logits and tokens
    on the host."""
    eng.reset()
    eng.reseed(7)
    tok = np.zeros(SLOTS, np.int32)
    for i, p in enumerate(_prompts()):
        tok[i], _ = eng.prefill(i, p, temperature=0.0)
    out = []
    args = ([True] * SLOTS, list(temps), [0, 5, 0, 0] * (SLOTS // 4),
            [1.0, 1.0, 1.0, 0.9] * (SLOTS // 4))
    for s in range(steps):
        if eng.spec_k:
            drafts = (np.arange(SLOTS * eng.spec_k, dtype=np.int32)
                      .reshape(SLOTS, eng.spec_k) * (s + 3)) % 512
            em, counts, lg = eng.decode_spec(tok, drafts, *args)
            tok = em[np.arange(SLOTS), counts - 1].astype(np.int32)
            out.append((lg.float().cpu(), em.copy(), counts.copy()))
        else:
            tok, lg = eng.decode(tok, *args)
            out.append((lg.float().cpu(), tok.copy()))
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["slotted", "paged", "verify", "int8"])
@pytest.mark.parametrize("use_norm", [False, True])
def test_captured_step_is_bitwise_the_eager_step(kind, use_norm):
    _card()
    kw = {"slotted": dict(paged=False), "paged": {},
          "verify": dict(spec_k=3), "int8": dict(kv_dtype="int8")}[kind]
    model = _model()
    runs = []
    flags.set_flags({"use_pallas_norm": use_norm})
    try:
        for capture in (False, True):
            eng = DecodeEngine(model, num_slots=SLOTS, max_len=96,
                               page_size=16, **kw)
            eng._capture = capture
            runs.append(_script(eng))
            assert _kind_stats(eng)["graphs"] == int(capture)
            assert _kind_stats(eng, "chunk")["graphs"] == int(
                capture and eng.paged)
    finally:
        flags.set_flags({"use_pallas_norm": False})
    for eager, captured in zip(*runs):
        assert torch.equal(eager[0], captured[0])
        for a, b in zip(eager[1:], captured[1:]):
            np.testing.assert_array_equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["paged", "slotted", "verify"])
def test_kv_quant_error_gauge_of_a_replay_is_the_eager_steps(monkeypatch,
                                                              kind):
    """The opt-in ``serving.kv_quant_error`` gauge of an int8 engine: a
    replayed step computes it on the card and its one copy home carries
    it; every step's value is the eager step's, bit for bit, and
    positive."""
    _card()
    from paddle_tpu_torch.observability import registry
    monkeypatch.setenv("PADDLE_TPU_METRICS_KV_QUANT_ERROR", "1")
    kw = {"paged": {}, "slotted": dict(paged=False),
          "verify": dict(spec_k=3)}[kind]
    gauge = registry.gauge("serving.kv_quant_error")
    model = _model()
    runs = []
    for capture in (False, True):
        eng = DecodeEngine(model, num_slots=SLOTS, max_len=96,
                           page_size=16, kv_dtype="int8", **kw)
        eng._capture = capture
        seen = []
        publish = eng._set_quant_err

        def record(ints, publish=publish, seen=seen):
            publish(ints)
            seen.append(gauge.value)
        eng._set_quant_err = record
        _script(eng)
        assert _kind_stats(eng)["graphs"] == int(capture)
        runs.append(seen)
    assert len(runs[0]) == 6 and min(runs[0]) > 0
    assert runs[0] == runs[1]


@pytest.mark.gpu
def test_reseed_then_replay_repeats_the_sampled_tokens():
    """A step's uniforms are drawn from the engine's generator before
    its replay: after ``reseed(s)`` a replay draws what the eager step
    draws after the same reseed."""
    _card()
    model = _model(seed=1)
    eng = DecodeEngine(model, num_slots=SLOTS, max_len=96, page_size=16)
    a = _script(eng, temps=(1.0,) * SLOTS)
    b = _script(eng, temps=(1.0,) * SLOTS)
    eng._capture = False
    c = _script(eng, temps=(1.0,) * SLOTS)
    for x, y, z in zip(a, b, c):
        np.testing.assert_array_equal(x[1], y[1])
        np.testing.assert_array_equal(x[1], z[1])
    assert eng.graph_captures_by_kind == {"decode": 1, "spec": 0,
                                          "chunk": 1}


@pytest.mark.gpu
@pytest.mark.parametrize("spec_k", [0, 3])
def test_one_graph_per_geometry_through_an_overlapped_run(spec_k):
    """Twenty-odd steps of the overlapped loop, lanes joining and leaving
    (host tokens) between threaded ones, capture each step kind once,
    the prefill chunk included; greedy tokens equal the eager synchronous
    loop's."""
    _card()
    model = _model(seed=2)
    out = []
    for capture, overlap in ((True, True), (False, False)):
        eng = DecodeEngine(model, num_slots=2, max_len=96, page_size=16,
                           spec_k=spec_k)
        eng._capture = capture
        sched = ContinuousBatchingScheduler(eng, overlap=overlap)
        rids = [sched.submit(Request(prompt=p, max_new_tokens=6 + 2 * i,
                                     temperature=0.0))
                for i, p in enumerate(_prompts(6, seed=4))]
        res = sched.run()
        out.append([res[r].tokens.tolist() for r in rids])
        if capture:
            assert sched.decode_steps_total >= 20 or spec_k
            stats = _kind_stats(eng)
            assert stats["captures"] == 1 and stats["graphs"] == 1
            # every consumed step was a replay of that one graph
            assert stats["replays"] == sched.decode_steps_total
            chunk = _kind_stats(eng, "chunk")
            assert chunk["captures"] == 1 and chunk["graphs"] == 1
            assert chunk["replays"] == sched.prefill_chunks_total
    assert out[0] == out[1]


@pytest.mark.gpu
def test_new_capture_when_the_route_flips_or_a_parameter_is_replaced():
    _card()
    model = _model(seed=5)
    eng = DecodeEngine(model, num_slots=SLOTS, max_len=96, page_size=16)

    def captures():
        by = eng.graph_captures_by_kind
        assert by["decode"] == by["chunk"]    # each flip captures both
        return by["decode"]

    _script(eng, steps=2)
    assert captures() == 1
    flags.set_flags({"use_pallas_norm": True})
    try:
        _script(eng, steps=2)
    finally:
        flags.set_flags({"use_pallas_norm": False})
    assert captures() == 2
    _script(eng, steps=2)                     # the first graphs again
    assert captures() == 2
    # new weights through the bridge: copied in place, read live
    other = _model(seed=6, dtype=torch.float32).cpu()
    arrays = {k: v.numpy() for k, v in other.state_dict().items()}
    load_paddle_tpu_state(model, arrays)
    got = _script(eng, steps=3)
    assert captures() == 2
    fresh = DecodeEngine(model, num_slots=SLOTS, max_len=96, page_size=16)
    fresh._capture = False
    want = _script(fresh, steps=3)
    # a parameter replaced by another tensor: the graphs are dropped
    w = model.gpt.wte.weight
    w.data = w.data.clone() * 1.5
    got2 = _script(eng, steps=3)
    assert captures() == 3 and eng.graph_stats()["graphs"] == 2
    want2 = _script(fresh, steps=3)
    for g, w_ in zip(got + got2, want + want2):
        np.testing.assert_array_equal(g[1], w_[1])
        assert torch.equal(g[0], w_[0])


@pytest.mark.gpu
@pytest.mark.parametrize("spec_k", [0, 3])
def test_layer_norm_kernel_counts_its_launches_inside_a_replay(spec_k):
    """A replayed step launches B (2L + 1) times without its wrapper: the
    wrapper's count stays still, the kernel's own count on the card
    moves by 2L + 1 a replay."""
    from paddle_tpu_torch.kernels import norm_cuda
    _card()
    model = _model(seed=11)
    eng = DecodeEngine(model, num_slots=SLOTS, max_len=96, page_size=16,
                       spec_k=spec_k)
    flags.set_flags({"use_pallas_norm": True})
    try:
        _script(eng, steps=1)                 # captures the step
        eng.reset()
        torch.cuda.synchronize()
        wrapper = norm_cuda.layer_norm_fwd_launches
        norm_cuda.layer_norm_fwd_device_launches(reset=True)
        replays = eng.graph_stats()["replays"]
        off = ([False] * SLOTS, [0.0] * SLOTS, [0] * SLOTS, [1.0] * SLOTS)
        for _ in range(3):
            if spec_k:
                eng.decode_spec(np.zeros(SLOTS, np.int32),
                                np.zeros((SLOTS, spec_k), np.int32), *off)
            else:
                eng.decode(np.zeros(SLOTS, np.int32), *off)
        on_device = norm_cuda.layer_norm_fwd_device_launches()
    finally:
        flags.set_flags({"use_pallas_norm": False})
    assert eng.graph_stats()["replays"] - replays == 3
    assert norm_cuda.layer_norm_fwd_launches == wrapper
    assert on_device == 3 * (2 * _cfg().num_hidden_layers + 1)


@pytest.mark.gpu
def test_unaligned_layer_norm_weight_updated_in_place_is_read_live():
    """The LayerNorm kernel's wrapper copies a gamma that is not 16-byte
    aligned; the copy is a node of the captured step, re-run by every
    replay, so an in-place update of such a gamma needs no new capture."""
    _card()
    model = _model(seed=9)
    eng = DecodeEngine(model, num_slots=SLOTS, max_len=96, page_size=16)
    ln = model.gpt.ln_f
    buf = torch.empty(ln.weight.numel() + 1, dtype=ln.weight.dtype,
                      device="cuda")
    buf[1:].copy_(ln.weight.detach())
    ln.weight = torch.nn.Parameter(buf[1:], requires_grad=False)
    assert ln.weight.data_ptr() % 16
    flags.set_flags({"use_pallas_norm": True})
    try:
        before = _script(eng, steps=2)
        with torch.no_grad():
            ln.weight.mul_(1.5)
        got = _script(eng, steps=2)
        assert eng.graph_captures_by_kind == {"decode": 1, "spec": 0,
                                              "chunk": 1}
        eng._capture = False
        want = _script(eng, steps=2)
    finally:
        flags.set_flags({"use_pallas_norm": False})
    assert not torch.equal(before[0][0], got[0][0])
    for g, w in zip(got, want):
        assert torch.equal(g[0], w[0])
        np.testing.assert_array_equal(g[1], w[1])


@pytest.mark.gpu
def test_replays_after_another_engines_graph_is_dropped():
    """Capture on engine A, capture and drop engine B's step, capture on
    C: A's and C's replays, plain and inside a profiler trace, still
    give the eager step's logits bit for bit.  cuBLAS's cached
    workspaces are dropped before B's and C's captures, so that B's
    capture takes the workspace into the graph pool (the sequence that
    segfaulted with a private pool a graph)."""
    from torch.profiler import ProfilerActivity, profile
    _card()
    model = _model(seed=10)
    a = DecodeEngine(model, num_slots=SLOTS, max_len=96, paged=False)
    _script(a, steps=2)
    torch._C._cuda_clearCublasWorkspaces()
    b = DecodeEngine(model, num_slots=SLOTS, max_len=96, page_size=16,
                     num_pages=32)
    _script(b, steps=2)
    del b
    torch._C._cuda_clearCublasWorkspaces()
    c = DecodeEngine(model, num_slots=SLOTS, max_len=96, page_size=16,
                     spec_k=3)
    for eng in (a, c):
        got = _script(eng, steps=2)
        with profile(activities=[ProfilerActivity.CUDA]):
            traced = _script(eng, steps=2)
            torch.cuda.synchronize()
        eng._capture = False
        want = _script(eng, steps=2)
        assert _kind_stats(eng)["captures"] == 1
        for g, t, w in zip(got, traced, want):
            assert torch.equal(g[0], w[0]) and torch.equal(t[0], w[0])
            for x, y, z in zip(g[1:], t[1:], w[1:]):
                np.testing.assert_array_equal(x, z)
                np.testing.assert_array_equal(y, z)


@pytest.mark.gpu
def test_fetch_of_the_previous_step_returns_while_the_next_runs():
    """The fetch waits on its own step's copy event: with step t held
    behind a long kernel, fetching t-1 returns, its event done and t's
    not."""
    _card()
    model = _model(seed=8)
    eng = DecodeEngine(model, num_slots=SLOTS, max_len=96, page_size=16)
    tok = np.zeros(SLOTS, np.int32)
    for i, p in enumerate(_prompts()):
        tok[i], _ = eng.prefill(i, p, temperature=0.0)
    args = ([True] * SLOTS, [0.0] * SLOTS, [0] * SLOTS, [1.0] * SLOTS)
    eng.decode(tok, *args)                    # capture outside the window
    prev = eng.decode_submit(tok, *args)
    torch.cuda._sleep(200_000_000)            # ~0.1 s of spinning
    nxt = eng.decode_submit(tok, *args)
    toks, _ = eng.decode_fetch(prev)
    assert prev.ready.query() and not nxt.ready.query()
    assert prev.consumed and not nxt.consumed
    eng.decode_fetch(nxt)
    assert toks.shape == (SLOTS,)


# ---------------------------------------------------------------------------
# the captured prefill chunk, threads, handoff and the fleet
# ---------------------------------------------------------------------------

def _chunk_script(eng):
    """Admissions through the chunk: three prompts of 1-3 chunks, then a
    prefix hit; each one's first token and last logits."""
    eng.reset()
    rng = np.random.default_rng(12)
    out = []
    prompts = [rng.integers(0, 512, (n,)).astype(np.int32)
               for n in (40, 16, 7)]
    for slot, p in enumerate(prompts + [prompts[0]]):
        if slot == 3:
            eng.free_slot(0)
            slot = 0
        tok, last = eng.prefill(slot, p, temperature=0.0)
        out.append((tok, last.float().cpu()))
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("kw", [{}, dict(kv_dtype="int8"),
                                dict(kv_dtype="fp8")],
                         ids=["bf16", "int8", "fp8"])
@pytest.mark.parametrize("use_norm", [False, True])
def test_captured_chunk_is_bitwise_the_eager_chunk(kw, use_norm):
    """Each admission's last logits, and the pools afterwards, through
    the captured chunk and through the eager one: bit for bit."""
    _card()
    model = _model(seed=13)
    runs, pools = [], []
    flags.set_flags({"use_pallas_norm": use_norm})
    try:
        for capture in (False, True):
            eng = DecodeEngine(model, num_slots=SLOTS, max_len=96,
                               page_size=16, prefill_chunk=16, **kw)
            eng._capture = capture
            runs.append(_chunk_script(eng))
            torch.cuda.synchronize()
            pools.append([None if t is None else t.view(torch.uint8).clone()
                          for t in (eng.cache.k, eng.cache.v,
                                    eng.cache.k_scale, eng.cache.v_scale)]
                         + [eng.cache.lengths.clone()])
            assert _kind_stats(eng, "chunk")["captures"] == int(capture)
    finally:
        flags.set_flags({"use_pallas_norm": False})
    for (t0, l0), (t1, l1) in zip(*runs):
        assert t0 == t1 and torch.equal(l0, l1)
    sink = eng.num_pages
    for a, b in zip(*pools):
        if a is not None:
            assert torch.equal(a[:sink] if a.dim() > 1 else a,
                               b[:sink] if b.dim() > 1 else b)


def _serve_tokens(eng, prompts, max_new=8):
    sched = ContinuousBatchingScheduler(eng)
    rids = [sched.submit(Request(prompt=p, max_new_tokens=max_new,
                                 temperature=0.0)) for p in prompts]
    res = sched.run()
    return [res[r].tokens.tolist() for r in rids]


@pytest.mark.gpu
def test_two_engines_replaying_from_two_threads_match():
    """Two engines on one model, each driven by its own thread through
    the overlapped loop on captured steps and chunks (replays of both
    interleave on one stream and one graph pool): each thread's tokens
    equal the engine's single-thread run."""
    _card()
    model = _model(seed=14)
    engs = [DecodeEngine(model, num_slots=4, max_len=96, page_size=16,
                         prefill_chunk=16) for _ in range(2)]
    work = [_prompts(8, seed=20), _prompts(8, seed=21)]
    want = []
    for e, ps in zip(engs, work):
        e.capture_steps()
        want.append(_serve_tokens(e, ps))
        e.reset()
    captures = [e.graph_captures for e in engs]
    got = [None, None]
    graphs.seal("test")
    try:
        def run(i):
            torch.cuda.set_device(engs[i].cache.lengths.device)
            for _ in range(3):
                got[i] = _serve_tokens(engs[i], work[i])
                engs[i].reset()
        ths = [threading.Thread(target=run, args=(i,)) for i in range(2)]
        for t in ths:
            t.start()
        for t in ths:
            t.join(300)
    finally:
        graphs.unseal("test")
    assert got == want
    assert [e.graph_captures for e in engs] == captures


@pytest.mark.gpu
def test_a_sealed_capture_raises():
    _card()
    eng = DecodeEngine(_model(seed=15), num_slots=SLOTS, max_len=96,
                       page_size=16)
    graphs.seal("test")
    try:
        with pytest.raises(graphs.CaptureSealed):
            eng.capture_steps()
    finally:
        graphs.unseal("test")
    eng.capture_steps()
    assert eng.graph_captures == 2


@pytest.mark.gpu
def test_reset_waits_for_a_step_left_in_flight():
    _card()
    eng = DecodeEngine(_model(seed=16), num_slots=SLOTS, max_len=96,
                       page_size=16)
    tok = np.zeros(SLOTS, np.int32)
    args = ([True] * SLOTS, [0.0] * SLOTS, [0] * SLOTS, [1.0] * SLOTS)
    eng.decode(tok, *args)                    # capture first
    torch.cuda._sleep(200_000_000)
    rec = eng.decode_submit(tok, *args)
    assert not rec.ready.query()
    eng.reset()
    assert rec.ready.query()


@pytest.mark.gpu
@pytest.mark.parametrize("kw", [{}, dict(kv_dtype="int8"),
                                dict(kv_dtype="fp8")],
                         ids=["bf16", "int8", "fp8"])
def test_handoff_is_byte_exact_on_the_card(kw):
    """Pages exported from one engine's pool and imported into another's
    on the card carry their bytes exactly (codes and f32 scales); the
    disaggregated pair's greedy tokens, device and host staging, equal
    the colocated engine's."""
    _card()
    model = _model(seed=17)
    mk = dict(max_len=96, page_size=16, prefill_chunk=16, **kw)
    pe = DecodeEngine(model, num_slots=2, **mk)
    de = DecodeEngine(model, num_slots=4, **mk)
    pe.prefill(0, np.arange(50, dtype=np.int32), temperature=0.0)
    src = [int(p) for p in pe._alloc.table[0][pe._alloc.mapped[0]]][:3]
    de.import_pages(de.stage_handoff(pe.export_pages(src)), [4, 0, 9])
    torch.cuda.synchronize()
    for a, b in zip(pe._pools(), de._pools()):
        if a is not None:
            for s_, d in zip(src, (4, 0, 9)):
                assert torch.equal(a[s_].view(torch.uint8),
                                   b[d].view(torch.uint8))
    ps = _prompts(6, seed=22)
    want = _serve_tokens(DecodeEngine(model, num_slots=4, **mk), ps)
    for via_host in (False, True):
        de = DecodeEngine(model, num_slots=4, **mk)
        pe = DecodeEngine(model, num_slots=2, **mk)
        sched = DisaggScheduler(de, pe, via_host=via_host)
        rids = [sched.submit(Request(prompt=p, max_new_tokens=8,
                                     temperature=0.0)) for p in ps]
        res = sched.run()
        assert [res[r].tokens.tolist() for r in rids] == want
        assert sched.handoffs_total == len(ps)


@pytest.mark.gpu
def test_fleet_failover_keeps_each_engines_captures():
    """A two-replica fleet on one card: a HardExit on a replica in the
    middle of the drive, every stream finishes with the undisturbed
    tokens, the replica rejoins, and no engine captured again."""
    _card()
    model = _model(seed=18)
    engs = [DecodeEngine(model, num_slots=4, max_len=96, page_size=16,
                         prefill_chunk=16) for _ in range(2)]
    ps = _prompts(8, seed=23)
    want = _serve_tokens(engs[0], ps)
    engs[0].reset()
    router = Router(engs, respawn_delay=0.05, healthy_interval=0.2,
                    probe_interval=0.05)
    done = threading.Event()
    results = {}

    def on_finish(res):
        results[res.rid] = res
        if len(results) == len(ps):
            done.set()

    router.on_finish = on_finish
    router.start()
    captures = [e.graph_captures for e in engs]
    try:
        plan = fp.FaultPlan().inject("serve.replica", fp.HardExit(), at=10)
        with fp.chaos(plan):
            rids = [router.submit(Request(prompt=p, max_new_tokens=8,
                                          temperature=0.0)) for p in ps]
            assert done.wait(300)
        plan.assert_all_fired()
        import time
        deadline = time.monotonic() + 30
        while router.healthy_count() < 2 and time.monotonic() < deadline:
            time.sleep(0.05)
        assert router.replica_states() == ["healthy", "healthy"]
    finally:
        router.stop()
    assert [results[r].tokens.tolist() for r in rids] == want
    assert [e.graph_captures for e in engs] == captures


@pytest.mark.gpu
def test_a_collection_never_runs_inside_a_capture():
    """A dead reference cycle holding an earlier engine's graphs becomes
    garbage while a capture runs, with the collector set to run at every
    allocation: the capture keeps the collector off, so no graph is
    destroyed while the stream captures and the capture completes."""
    import gc
    _card()
    model = _model(seed=19)
    old = DecodeEngine(model, num_slots=SLOTS, max_len=96, page_size=16)
    old.capture_steps()
    cycle = {"engine": old}
    cycle["self"] = cycle
    holder = [cycle]
    del old, cycle
    eng = DecodeEngine(model, num_slots=SLOTS, max_len=96, page_size=16)
    calls = []

    def step():
        calls.append(1)
        if len(calls) == 3:              # the captured call
            holder.clear()
            junk = [[] for _ in range(2000)]
            del junk
        return eng._decode_step()

    thresholds = gc.get_threshold()
    gc.set_threshold(1)
    try:
        eng._io["decode"].active.zero_()
        with torch.inference_mode():
            graph = graphs.capture(step)
    finally:
        gc.set_threshold(*thresholds)
    gc.collect()
    graph.replay()
    torch.cuda.synchronize()
    assert len(calls) == 3


@pytest.mark.gpu
@pytest.mark.parametrize("paged", [True, False])
@pytest.mark.parametrize("use_norm", [False, True])
def test_scan_model_gives_the_per_layer_bits(paged, use_norm):
    """The scan-layers model on the per-layer model's weights (bf16): a
    128-token prefill's logits (the tensor-core forward on the slotted
    engine) and six captured decode steps' logits and tokens, bit for
    bit, each LayerNorm route."""
    _card()
    per = _model()
    scan = GPTForCausalLM(dataclasses.replace(_cfg(), scan_layers=True))
    scan = scan.to("cuda", torch.bfloat16).eval()
    scan.load_state_dict(per_layer_state_to_scan(per.state_dict()))
    prompt = np.random.default_rng(5).integers(0, 512, (128,)).astype(
        np.int32)
    runs = []
    flags.set_flags({"use_pallas_norm": use_norm})
    try:
        for model in (per, scan):
            eng = DecodeEngine(model, num_slots=SLOTS, max_len=128,
                               page_size=16, paged=paged)
            _tok, logits = eng.prefill(0, prompt, temperature=0.0)
            runs.append([logits.float().cpu()] + _script(eng))
            assert _kind_stats(eng)["graphs"] == 1
    finally:
        flags.set_flags({"use_pallas_norm": False})
    assert torch.equal(runs[0][0], runs[1][0])
    for a, b in zip(runs[0][1:], runs[1][1:]):
        assert torch.equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])


@pytest.mark.gpu
def test_an_engine_named_cuda_keeps_one_page_table():
    """``device="cuda"`` (no index) resolves to the current card, so the
    allocator's device page table is made once: a captured chunk or step
    reads it at its address.  (An unindexed device compared unequal to
    the table's ``cuda:0``, a new table was made at every sync, and a
    replay read a freed one: an index out of bounds on the card.)"""
    _card()
    from paddle_tpu_torch.core.device import resolve_device
    assert resolve_device("cuda") == torch.empty(0, device="cuda").device
    eng = DecodeEngine(_model(), num_slots=SLOTS, max_len=96, page_size=16,
                       device="cuda")
    table = eng.cache.page_table
    prompts = _prompts()
    for i, p in enumerate(prompts[:2]):
        eng.prefill(i, p, temperature=0.0)
    eng.prefill(2, prompts[1], temperature=0.0)      # a prefix hit
    assert eng.cache.page_table is table
    assert _kind_stats(eng, "chunk")["graphs"] == 1
