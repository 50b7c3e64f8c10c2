"""The paged prefill chunk with device operands, the function a card
captures once (``DecodeEngine._chunk_step``), on the CPU: the chunk view
fed 0-d tensors for ``slot`` / ``n_before`` / ``n_valid`` gives bit for
bit the logits, K/V writes and lengths of the view fed Python ints (f32,
bf16, int8 and fp8 pools, after a prefix hit and at a partial chunk);
an admission through the engine's chunk equals one run chunk by chunk
through the int view, and its last-position logits match the JAX
engine's ``prefill_chunk_fn`` within 1e-4 (f32; XLA and ATen sum the
matmuls in other orders); the capture's warm-up writes only the sink
page and leaves every length as it was; only the final chunk draws from
the generator; ``prefill_step(sync=False)`` leaves the first token on the
device.  The tiny GPT on the same numpy weights in both packages."""
import numpy as np
import pytest
import torch

from paddle_tpu.serving.engine import DecodeEngine as JaxEngine
from paddle_tpu_torch.serving import DecodeEngine, PagedPrefillChunkView
from paddle_tpu_torch.serving.engine import _eval_scope

from _torch_pair import VOCAB, pair

ATOL = 1e-4


@pytest.fixture(scope="module")
def models():
    return pair(seed=7)


def _engine(tm, **kw):
    kw.setdefault("num_slots", 3)
    kw.setdefault("max_len", 96)
    kw.setdefault("page_size", 16)
    kw.setdefault("prefill_chunk", 16)
    return DecodeEngine(tm, seed=0, device="cpu", **kw)


def _pools(eng):
    c = eng.cache
    return [None if t is None else t.clone()
            for t in (c.k, c.v, c.k_scale, c.v_scale, c.lengths)]


def _run_view(eng, slot, n_before, n_valid, tokens, operands):
    """One chunk of ``tokens`` through the chunk view, its operands as
    Python ints or as 0-d int32 tensors; returns the last real
    position's logits."""
    C = eng.prefill_chunk
    padded = torch.zeros((1, C), dtype=torch.int32)
    padded[0, :n_valid] = torch.as_tensor(tokens[:n_valid])
    if operands:
        args = [torch.tensor(x, dtype=torch.int32)
                for x in (slot, n_before, n_valid)]
    else:
        args = (slot, n_before, n_valid)
    view = PagedPrefillChunkView(eng.cache, *args)
    with torch.inference_mode(), _eval_scope(eng.model):
        logits, _ = eng.model(padded, cache=view)
    view.finalize()
    return logits[:, n_valid - 1, :]


@pytest.mark.parametrize("kw", [{}, dict(cache_dtype="bfloat16"),
                                dict(kv_dtype="int8"),
                                dict(kv_dtype="fp8")],
                         ids=["f32", "bf16", "int8", "fp8"])
@pytest.mark.parametrize("n_valid", [16, 5])
def test_device_operands_are_bitwise_the_int_view(models, kw, n_valid):
    """The same chunk, after a prefix of two chunks in slot 1, through
    the view fed ints and the view fed tensors: identical logits, pools
    and lengths."""
    _jm, tm = models
    ids = np.random.default_rng(0).integers(0, VOCAB, (60,)).astype(
        np.int32)

    def setup():
        eng = _engine(tm, **kw)
        eng.prefill_begin(1, ids[:33])
        for pos in (0, 16):
            eng._ensure_write_range(1, pos, pos + 16)
            eng._sync_table()
            _run_view(eng, 1, pos, 16, ids[pos:pos + 16], False)
        eng._ensure_write_range(1, 32, 32 + n_valid)
        eng._sync_table()
        return eng

    eng, twin = setup(), setup()
    for x, y in zip(_pools(eng), _pools(twin)):
        if x is not None:
            assert torch.equal(x.view(torch.uint8), y.view(torch.uint8))
    a = _run_view(eng, 1, 32, n_valid, ids[32:], False)
    b = _run_view(twin, 1, 32, n_valid, ids[32:], True)
    assert torch.equal(a, b)
    for x, y in zip(_pools(eng), _pools(twin)):
        if x is not None:
            assert torch.equal(x.view(torch.uint8), y.view(torch.uint8))
    assert int(eng.cache.lengths[1]) == 32 + n_valid


@pytest.mark.parametrize("kw", [{}, dict(kv_dtype="int8")],
                         ids=["f32", "int8"])
def test_engine_chunk_equals_the_int_view_chunk_by_chunk(models, kw):
    """An admission through the engine's static-operand chunk (three
    chunks, the last partial, then a prefix hit in another slot) leaves
    the pools, lengths and last logits of the same admission run through
    the int view."""
    _jm, tm = models
    eng = _engine(tm, **kw)
    ref = _engine(tm, **kw)

    def int_launch(padded, slot, n_before, n_valid, eng=ref):
        eng._sync_table()
        return _run_view(eng, slot, n_before, n_valid, padded, False)

    ref._launch_chunk = int_launch
    ids = np.random.default_rng(1).integers(0, VOCAB, (41,)).astype(
        np.int32)
    for slot in (0, 2):
        tok, last = eng.prefill(slot, ids, temperature=0.0)
        want_tok, want_last = ref.prefill(slot, ids, temperature=0.0)
        assert tok == want_tok and torch.equal(last, want_last)
    assert eng._alloc.table.tolist() == ref._alloc.table.tolist()
    for x, y in zip(_pools(eng), _pools(ref)):
        if x is not None:
            assert torch.equal(x, y)


@pytest.mark.parametrize("plen", [16, 41, 64])
def test_last_logits_match_jax_prefill_chunk_fn(models, plen):
    """The engine's chunked admission against the JAX engine's
    ``prefill_chunk_fn``: the same first token and the last position's
    logits within 1e-4, then the same after a prefix hit."""
    jm, tm = models
    kw = dict(num_slots=2, max_len=96, page_size=16, prefill_chunk=16)
    je = JaxEngine(jm, seed=0, paged=True, **kw)
    te = DecodeEngine(tm, seed=0, device="cpu", **kw)
    ids = np.random.default_rng(plen).integers(0, VOCAB, (plen,)).astype(
        np.int32)
    for slot in (0, 1):                  # slot 1 hits slot 0's prefix
        jt, jl = je.prefill(slot, ids, temperature=0.0)
        tt, tl = te.prefill(slot, ids, temperature=0.0)
        assert tt == jt
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                                   rtol=0)


def test_capture_warmup_writes_only_the_sink(models):
    """The operands the capture's warm-up runs with (``n_valid`` 0, slot
    0's own length as ``n_before``, copied on the device): no live page
    and no length changes, only the sink page."""
    _jm, tm = models
    eng = _engine(tm)
    ids = np.random.default_rng(2).integers(0, VOCAB, (30,)).astype(
        np.int32)
    eng.prefill(0, ids, temperature=0.0)
    eng.prefill(1, ids[:20], temperature=0.0)
    before = _pools(eng)
    io = eng._chunk_io
    io.inp.fill_(7)
    io.inp.zero_()
    io.n_before.copy_(eng.cache.lengths[0])
    with torch.inference_mode():
        eng._chunk_step()
    after = _pools(eng)
    sink = eng.num_pages
    for x, y in zip(before[:4], after[:4]):
        if x is not None:
            assert torch.equal(x[:sink], y[:sink])
    assert torch.equal(before[4], after[4])


def test_only_the_final_chunk_draws(models):
    """Sampling stays outside the chunk: a non-final chunk leaves the
    generator as it was, and the sampled first token does not depend on
    how many chunks ran (a prefix hit collapses them)."""
    _jm, tm = models
    ids = np.random.default_rng(3).integers(0, VOCAB, (40,)).astype(
        np.int32)
    eng = _engine(tm)
    task = eng.prefill_begin(0, ids, temperature=1.0)
    state = eng._generator.get_state()
    assert not eng.prefill_step(task)
    assert torch.equal(state, eng._generator.get_state())
    while not eng.prefill_step(task):
        pass
    assert not torch.equal(state, eng._generator.get_state())
    toks = []
    for hit in (False, True):
        eng.reseed(5)
        if hit:
            eng.free_slot(0)
        t, _ = eng.prefill(1 if hit else 2, ids, temperature=1.0)
        toks.append(t)
    assert toks[0] == toks[1]


def test_async_first_token_stays_on_the_device(models):
    _jm, tm = models
    ids = np.random.default_rng(4).integers(0, VOCAB, (20,)).astype(
        np.int32)
    a, b = _engine(tm), _engine(tm)
    ta = a.prefill_begin(0, ids, temperature=0.0)
    while not a.prefill_step(ta, sync=False):
        pass
    assert ta.first_token == -1 and ta.first_token_ready is None
    assert isinstance(ta.first_token_dev, torch.Tensor)
    tok, _ = b.prefill(0, ids, temperature=0.0)
    assert int(ta.first_token_dev) == tok


def test_capture_is_a_card_operation(models):
    """On the CPU nothing is captured: the chunk runs eagerly, and the
    captures are counted by kind."""
    _jm, tm = models
    eng = _engine(tm)
    stats = eng.capture_steps()
    assert stats["captures"] == 0 and stats["graphs"] == 0
    assert set(stats["by_kind"]) == {"decode", "spec", "chunk"}
    eng.prefill(0, np.arange(20, dtype=np.int32), temperature=0.0)
    assert eng.graph_stats()["by_kind"]["chunk"]["replays"] == 0
    assert eng.flight_state()["graph_captures"]["prefill_chunk"] == 0
