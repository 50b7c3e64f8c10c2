"""The serving engine's captured steps on the card: the slotted and paged
decode steps and the paged verify step, replayed from CUDA graphs, held
bit for bit against the same engine's eager step, the opt-in
``serving.kv_quant_error`` gauge of an int8 step included; one graph per
routing through an overlapped run; a new capture when the LayerNorm route flips
or a parameter is replaced by another tensor (and none when one is
updated in place); B counting its launches inside a replay; replays
after another engine's graph was dropped; and the fetch of step t-1
returning while step t still runs.  Marked ``gpu``: without an NVIDIA
card every test skips.  This file imports no JAX:

    python -m pytest tests/test_torch_cuda_serving.py -m gpu -q
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.convert import load_paddle_tpu_state
from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM
from paddle_tpu_torch.serving import (ContinuousBatchingScheduler,
                                      DecodeEngine, Request)
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
            assert eng.graph_stats()["graphs"] == int(capture)
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
        assert eng.graph_stats()["graphs"] == int(capture)
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
    assert eng.graph_captures == 1


@pytest.mark.gpu
@pytest.mark.parametrize("spec_k", [0, 3])
def test_one_graph_per_geometry_through_an_overlapped_run(spec_k):
    """Twenty-odd steps of the overlapped loop, lanes joining and leaving
    (host tokens) between threaded ones, capture each step kind once;
    greedy tokens equal the eager synchronous loop's."""
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
            stats = eng.graph_stats()
            assert stats["captures"] == 1 and stats["graphs"] == 1
            # every consumed step was a replay of that one graph
            assert stats["replays"] == sched.decode_steps_total
    assert out[0] == out[1]


@pytest.mark.gpu
def test_new_capture_when_the_route_flips_or_a_parameter_is_replaced():
    _card()
    model = _model(seed=5)
    eng = DecodeEngine(model, num_slots=SLOTS, max_len=96, page_size=16)
    _script(eng, steps=2)
    assert eng.graph_captures == 1
    flags.set_flags({"use_pallas_norm": True})
    try:
        _script(eng, steps=2)
    finally:
        flags.set_flags({"use_pallas_norm": False})
    assert eng.graph_captures == 2
    _script(eng, steps=2)                     # the first graph again
    assert eng.graph_captures == 2
    # new weights through the bridge: copied in place, read live
    other = _model(seed=6, dtype=torch.float32).cpu()
    arrays = {k: v.numpy() for k, v in other.state_dict().items()}
    load_paddle_tpu_state(model, arrays)
    got = _script(eng, steps=3)
    assert eng.graph_captures == 2
    fresh = DecodeEngine(model, num_slots=SLOTS, max_len=96, page_size=16)
    fresh._capture = False
    want = _script(fresh, steps=3)
    # a parameter replaced by another tensor: the graphs are dropped
    w = model.gpt.wte.weight
    w.data = w.data.clone() * 1.5
    got2 = _script(eng, steps=3)
    assert eng.graph_captures == 3 and eng.graph_stats()["graphs"] == 1
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
        assert eng.graph_captures == 1
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
        assert eng.graph_captures == 1
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
