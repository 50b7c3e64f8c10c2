"""paddle_tpu_torch's speculative decoding and int8/fp8 KV cache against
``paddle_tpu`` at the tiny config in f32, on one set of numpy weights
(``_pair`` of ``tests/test_torch_paged.py``); the JAX schedulers run
their synchronous loop (``overlap=False``).

Quantization: ``quantize_kv``'s codes and scales bit-identical to the
JAX package's (rows at +-amax, a row of zeros, values past 448), the
``kv_dtype`` gate, each q8 attention variant on identical codes, engine
logits at every position (int8 and fp8, paged and slotted), prefix
sharing and copy-on-write keeping the scales, the model-level
quantized caches, and the row, pool and per-token bytes.  Speculative
decoding: ``propose``, ``spec_accept`` (greedy, the cap, the sampled
distribution against the filtered softmax, the fixed draw order), and
greedy tokens bit-identical to the JAX spec engine's and to the port's
plain engine through churn, prefix hits, preemption, EOS and a slot
near ``max_len``, with the per-request draft counts.  Then the
autotune keys and ``generate(seed=...)`` with spec on a cached
engine."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

import paddle_tpu as paddle
from paddle_tpu.kernels import autotune as jax_at
from paddle_tpu.kernels import decode_attention as jax_da
from paddle_tpu.serving import cache as jax_cache
from paddle_tpu.serving import sampling as jax_sampling
from paddle_tpu.serving import spec as jax_spec
from paddle_tpu.serving.engine import DecodeEngine as JaxEngine
from paddle_tpu.serving.scheduler import \
    ContinuousBatchingScheduler as JaxScheduler
from paddle_tpu.serving.scheduler import Request as JaxRequest
from paddle_tpu_torch.kernels import autotune as at
from paddle_tpu_torch.kernels import decode_attention as da
from paddle_tpu_torch.serving import (ContinuousBatchingScheduler,
                                      DecodeEngine, Request, generate,
                                      propose, spec_accept)
from paddle_tpu_torch.serving import cache as tcache
from test_torch_paged import ATOL, _engines, _pair, _prompt, _run

CODES = {"int8": (torch.int8, jnp.int8),
         "fp8": (torch.float8_e4m3fn, jnp.float8_e4m3fn)}


def _bits(a):
    """An array's bytes as unsigned integers, for bitwise comparison."""
    a = np.asarray(a)
    return a.view("u%d" % a.dtype.itemsize)


def _tbits(t):
    return _bits(da.raw_bytes(t).numpy()) if t.dtype.itemsize == 1 \
        else _bits(t.numpy())


def _kv_input(seed=0):
    """(4, 3, 2, 16) f32 rows: normal draws times 5, one row of zeros,
    one whose amax sits at +x and -x at once, and rows with values far
    past 448."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((4, 3, 2, 16)) * 5).astype(np.float32)
    x[0, 0, 0] = 0.0
    x[0, 1, 1] = np.clip(x[0, 1, 1], -3.0, 3.0)
    x[0, 1, 1, :2] = [3.5, -3.5]
    x[1, 2] *= 1e3
    x[2, 0, 0, 3] = 1e30
    return x


# ---------------------------------------------------------------------------
# the quantization grid
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("code", ["int8", "fp8"])
def test_quantize_kv_bit_identical_to_jax(code):
    """Codes and scales bit for bit, and the dequantized rows in f32 and
    bf16; every fp8 code is finite (the clip before the cast)."""
    tdt, jdt = CODES[code]
    x = _kv_input()
    q, s = da.quantize_kv(torch.from_numpy(x), tdt)
    jq, js = jax_da.quantize_kv(jnp.asarray(x), jdt)
    assert q.dtype == tdt and s.dtype == torch.float32
    assert tuple(s.shape) == x.shape[:-1]
    np.testing.assert_array_equal(_tbits(q), _bits(jq))
    np.testing.assert_array_equal(_tbits(s), _bits(js))
    assert bool(torch.isfinite(q.float()).all())
    for tq, jq_ in ((torch.float32, jnp.float32),
                    (torch.bfloat16, jnp.bfloat16)):
        got = da.dequantize_kv(q, s, tq)
        want = jax_da.dequantize_kv(jq, js, jq_)
        np.testing.assert_array_equal(_tbits(got.view(torch.int16))
                                      if tq == torch.bfloat16
                                      else _tbits(got), _bits(want))
    # the zero row stays zero; the +-amax row hits both grid ends
    assert not bool(q[0, 0, 0].float().any())
    qmax = 127.0 if code == "int8" else 448.0
    assert q[0, 1, 1, :2].float().tolist() == [qmax, -qmax]


@pytest.mark.parametrize("spec", ["int8", "fp8", "FP8", "float8_e4m3fn",
                                  torch.int8, torch.float8_e4m3fn])
def test_kv_dtype_gate_accepts_what_jax_accepts(spec):
    code, scale = tcache._as_kv_dtypes(spec)
    jspec = spec if isinstance(spec, str) else str(spec)[6:]
    jcode, jscale = jax_cache._as_kv_dtypes(jspec)
    assert str(code)[6:] == str(jcode) and scale == torch.float32
    assert tcache._as_kv_dtypes(None) == (None, None)


@pytest.mark.parametrize("spec", ["float16", "garbage", torch.bfloat16,
                                  "int4"])
def test_kv_dtype_gate_rejects_what_jax_rejects(spec):
    with pytest.raises(ValueError, match="kv_dtype"):
        tcache._as_kv_dtypes(spec)
    with pytest.raises((ValueError, TypeError)):
        jax_cache._as_kv_dtypes(spec if isinstance(spec, str)
                                else str(spec)[6:])


@pytest.mark.parametrize("kw", [dict(paged=False, spec_k=2),
                                dict(spec_k=-1), dict(spec_k=64),
                                dict(kv_dtype="float16")])
def test_engine_rejects_invalid_combinations_as_jax(kw):
    """``spec_k`` with the slotted layout, a negative one or one not
    below ``max_len``, and an unknown ``kv_dtype``: ValueError in both
    packages."""
    jm, tm = _pair(seed=30)
    with pytest.raises(ValueError):
        JaxEngine(jm, num_slots=2, max_len=64, **kw)
    with pytest.raises(ValueError):
        DecodeEngine(tm, num_slots=2, max_len=64, device="cpu", **kw)


# ---------------------------------------------------------------------------
# the q8 attention variants, on identical codes
# ---------------------------------------------------------------------------

def _q8_operands(code, b, t, h, d, s, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    k = (rng.standard_normal((b, t, h, d)) * 3).astype(np.float32)
    v = (rng.standard_normal((b, t, h, d)) * 3).astype(np.float32)
    jdt = CODES[code][1]
    (jk, jks), (jv, jvs) = (jax_da.quantize_kv(jnp.asarray(k), jdt),
                            jax_da.quantize_kv(jnp.asarray(v), jdt))
    tdt = CODES[code][0]
    tk, tks = da.quantize_kv(torch.from_numpy(k), tdt)
    tv, tvs = da.quantize_kv(torch.from_numpy(v), tdt)
    return q, (jk, jks, jv, jvs), (tk, tks, tv, tvs)


@pytest.mark.parametrize("s", [1, 5])
@pytest.mark.parametrize("block_t", [0, 128])
@pytest.mark.parametrize("code", ["int8", "fp8"])
def test_slotted_q8_attention_matches_jax(code, block_t, s):
    """``masked_q8`` and ``chunked_q8`` over a 256-row slotted cache,
    ragged lengths, one and five query positions."""
    q, (jk, jks, jv, jvs), (tk, tks, tv, tvs) = _q8_operands(
        code, 3, 256, 2, 16, s, seed=1)
    pos = np.asarray([0, 100, 256 - s], np.int32)
    if block_t:
        want = jax_da._chunked_q8(jnp.asarray(q), jk, jks, jv, jvs,
                                  jnp.asarray(pos), None, block_t)
    else:
        want = jax_da._masked_q8(jnp.asarray(q), jk, jks, jv, jvs,
                                 jnp.asarray(pos), None)
    got = da.decode_attention(torch.from_numpy(q), tk, tv,
                              torch.from_numpy(pos), k_scales=tks,
                              v_scales=tvs, block_t=block_t)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("s", [1, 5])
@pytest.mark.parametrize("pages_per_block", [0, 1, 2, 4])
@pytest.mark.parametrize("code", ["int8", "fp8"])
def test_paged_q8_attention_matches_jax(code, pages_per_block, s):
    """``paged_gather_q8`` and ``paged_chunked_q8`` over an arbitrary
    page mapping: codes and scale pages gathered through one table."""
    B, H, D, P, MP, NP = 3, 2, 16, 8, 8, 32
    q, (jk, jks, jv, jvs), (tk, tks, tv, tvs) = _q8_operands(
        code, NP, P, H, D, s, seed=2)
    q = q[:B]
    table = np.random.default_rng(3).permutation(NP)[:B * MP].reshape(
        B, MP).astype(np.int32)
    pos = np.asarray([0, 17, 64 - s], np.int32)
    jargs = (jnp.asarray(q), jk, jks, jv, jvs, jnp.asarray(table),
             jnp.asarray(pos), None)
    want = (jax_da._paged_chunked_q8(*jargs, pages_per_block)
            if pages_per_block else jax_da._paged_gather_q8(*jargs))
    got = da.paged_decode_attention(
        torch.from_numpy(q), tk, tv, torch.from_numpy(table.astype(np.int64)),
        torch.from_numpy(pos), pages_per_block=pages_per_block,
        k_scales=tks, v_scales=tvs)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


# ---------------------------------------------------------------------------
# quantized engines against the JAX engines
# ---------------------------------------------------------------------------

def _drive(eng, prompts, steps):
    """Prefill each prompt into its slot, then ``steps`` greedy decode
    steps of all of them; (per-point logits, the tokens fed)."""
    S = eng.num_slots
    logits, toks = [], []
    for i, p in enumerate(prompts):
        tok, lg = eng.prefill(i, p, temperature=0.0)
        logits.append(np.asarray(lg.numpy() if hasattr(lg, "numpy")
                                 and not isinstance(lg, jax.Array)
                                 else lg)[None])
        toks.append(int(tok))
    seqs = [list(p) + [t] for p, t in zip(prompts, toks)]
    for _ in range(steps):
        nt, lg = eng.decode([s[-1] for s in seqs], [True] * S, [0.0] * S,
                            [0] * S, [1.0] * S)
        logits.append(np.asarray(lg.numpy() if isinstance(lg, torch.Tensor)
                                 else lg))
        for b in range(S):
            seqs[b].append(int(nt[b]))
    return logits, seqs


@pytest.mark.parametrize("paged", [True, False])
@pytest.mark.parametrize("code", ["int8", "fp8"])
def test_quantized_engine_logits_match_jax_every_position(code, paged):
    """Prompts of 5 and 19 tokens (the paged engines in chunks of 8, so
    later chunks attend the quantized rows of earlier ones), then 6
    decode steps: logits within ATOL of the JAX engine's at every point
    and the same greedy tokens; the pools hold codes and scales; rows,
    pools and bytes per token as the JAX engine's."""
    jm, tm = _pair(seed=31)
    kw = dict(num_slots=2, max_len=64, page_size=8, prefill_chunk=8,
              kv_dtype=code, paged=paged)
    je, te = (JaxEngine(jm, seed=0, **kw),
              DecodeEngine(tm, seed=0, device="cpu", **kw))
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 512, (n,)).astype(np.int32) for n in (5, 19)]
    want, want_seqs = _drive(je, prompts, 6)
    got, seqs = _drive(te, prompts, 6)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=0)
    assert seqs == want_seqs
    assert te.cache.k.dtype == CODES[code][0]
    assert str(np.asarray(je.cache.k).dtype) == str(te.kv_dtype)[6:]
    assert tuple(te.cache.k_scale.shape) == tuple(te.cache.k.shape[:-1])
    assert te.kv_row_bytes() == je.kv_row_bytes()
    assert te.kv_pool_bytes() == je.kv_pool_bytes()
    assert te.kv_bytes_per_token() == je.kv_bytes_per_token()
    # the quantization is real: the exact cache's logits differ
    exact, _ = _drive(DecodeEngine(tm, seed=0, device="cpu",
                                   **dict(kw, kv_dtype=None)), prompts, 6)
    assert max(float(np.abs(e - g).max()) for e, g in zip(exact, got)) > 1e-3


@pytest.mark.parametrize("code", ["int8", "fp8"])
def test_quantized_prefix_sharing_and_cow_keep_scales(code):
    """Two sharers of a quantized 12-token prompt (pages of 8): the
    second admission hits the first's pages and copies its tail page,
    codes AND scale rows; each then decodes alone.  Both streams equal
    the JAX engine's and a fresh never-shared engine's."""
    jm, tm = _pair(seed=32)
    prompt = _prompt(17, 12)
    streams = []

    def stream(e, slot, first, n):
        toks = [int(first)]
        for _ in range(n):
            feed, act = [0, 0], [False, False]
            feed[slot], act[slot] = toks[-1], True
            nt, _ = e.decode(feed, act, [0.0] * 2, [0] * 2, [1.0] * 2)
            toks.append(int(nt[slot]))
        return toks

    def engines():
        kw = dict(num_slots=2, max_len=64, page_size=8, kv_dtype=code,
                  seed=5)
        return JaxEngine(jm, **kw), DecodeEngine(tm, device="cpu", **kw)

    for eng in engines():
        tok0, _ = eng.prefill(0, prompt, temperature=0.0)
        tok1, _ = eng.prefill(1, prompt, temperature=0.0)
        assert tok1 == tok0
        if isinstance(eng, DecodeEngine):
            assert eng.cow_copies == 1
            src, dst = (int(eng._alloc.table[s, 1]) for s in (0, 1))
            assert src != dst
            c = eng.cache
            for pool in (c.k, c.v, c.k_scale, c.v_scale):
                # rows 0-2 of the tail page (positions 8-10) came over
                np.testing.assert_array_equal(_tbits(pool[dst, :, :3]),
                                              _tbits(pool[src, :, :3]))
        streams.append((stream(eng, 0, tok0, 6), stream(eng, 1, tok1, 6)))
    assert streams[1] == streams[0]
    ref = engines()[1]
    rtok, _ = ref.prefill(0, prompt, temperature=0.0)
    r0 = stream(ref, 0, rtok, 6)
    assert streams[1][0] == r0 and streams[1][1] == r0


@pytest.mark.parametrize("code", ["int8", "fp8"])
def test_model_level_quantized_caches_match_jax(code):
    """``model(x, cache=gen_paged_cache(kv_dtype=...))`` and the slotted
    ``gen_cache(kv_dtype=...)``, one token at a time: the JAX model's
    logits at every position, the lengths at 8."""
    jm, tm = _pair(seed=33)
    ids = np.random.default_rng(3).integers(0, 512, (2, 8)).astype(np.int32)
    for gen in ("gen_paged_cache", "gen_cache"):
        kw = dict(max_len=64, kv_dtype=code)
        if gen == "gen_paged_cache":
            kw["page_size"] = 16
        jc = getattr(jm, gen)(2, **kw)
        tc = getattr(tm, gen)(2, device="cpu", **kw)
        assert tc.quantized and tc.k.dtype == CODES[code][0]
        for t in range(8):
            jl, jc = jm(paddle.to_tensor(ids[:, t:t + 1]), cache=jc)
            with torch.no_grad():
                tl, tc = tm(torch.from_numpy(ids[:, t:t + 1]), cache=tc)
            np.testing.assert_allclose(tl.numpy(), jl.numpy(), atol=ATOL,
                                       rtol=0)
        assert tc.lengths.tolist() == [8, 8]


def test_quantized_row_is_codes_plus_scales():
    """At the bench's head dim 64 a 1-byte row is (64 + 4) / (2 * 64) of
    the bf16 one; the tiny config's int8 and fp8 rows price alike."""
    _jm, tm = _pair(seed=34)
    rows = {kv: DecodeEngine(tm, num_slots=2, max_len=64, kv_dtype=kv,
                             cache_dtype="bfloat16", device="cpu"
                             ).kv_row_bytes()
            for kv in (None, "int8", "fp8")}
    assert rows["int8"] == rows["fp8"]
    assert rows["int8"] / rows[None] == (16 + 4) / (2 * 16)
    assert 2 * 4 * (64 + 4) * 2 / (2 * 4 * 64 * 2 * 2) == (64 + 4) / 128


# ---------------------------------------------------------------------------
# drafting and the accept rule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_propose_matches_jax(seed):
    """Seeded histories over a small vocabulary (so n-grams recur), every
    draft length and n-gram cap, short and empty histories too."""
    rng = np.random.default_rng(seed)
    for n in (0, 1, 2, 3, 7, 20, 60):
        h = rng.integers(0, 5, (n,)).astype(np.int32)
        for k in (1, 3, 5):
            for ngram in (1, 2, 3):
                got = propose(h, k, ngram)
                want = jax_spec.propose(h, k, ngram)
                assert got[0].dtype == np.int32
                assert got[0].tolist() == want[0].tolist()
                assert got[1] == want[1]


def _jax_accept(logits, toks, temps, top_ks, top_ps, max_accept=None):
    return jax_sampling.spec_accept(
        jnp.asarray(logits), jnp.asarray(toks), jax.random.key(0),
        jnp.asarray(temps), jnp.asarray(top_ks), jnp.asarray(top_ps),
        max_accept=None if max_accept is None else jnp.asarray(max_accept))


@pytest.mark.parametrize("cap", [False, True])
@pytest.mark.parametrize("seed", range(3))
def test_spec_accept_greedy_matches_jax(seed, cap):
    """Random logits, drafts that follow the argmax for a random number
    of positions then part: emitted rows and counts as the JAX rule's,
    with and without a per-slot cap."""
    rng = np.random.default_rng(seed)
    S, k, V = 6, 4, 32
    logits = rng.standard_normal((S, k + 1, V)).astype(np.float32)
    greedy = logits.argmax(-1)
    toks = np.zeros((S, k + 1), np.int32)
    toks[:, 0] = rng.integers(0, V, S)
    for b in range(S):
        good = rng.integers(0, k + 1)
        toks[b, 1:] = greedy[b, :k]
        toks[b, 1 + good:] = (greedy[b, good:k] + 1) % V
    max_accept = rng.integers(-1, k + 1, S).astype(np.int32) if cap else None
    zeros = np.zeros(S, np.float32)
    args = (zeros, np.zeros(S, np.int32), np.ones(S, np.float32))
    we, wc = _jax_accept(logits, toks, *args, max_accept=max_accept)
    ge, gc = spec_accept(torch.from_numpy(logits), torch.from_numpy(toks),
                         torch.Generator().manual_seed(0),
                         *(torch.from_numpy(a) for a in args),
                         max_accept=None if max_accept is None
                         else torch.from_numpy(max_accept))
    assert ge.dtype == gc.dtype == torch.int32
    assert ge.tolist() == np.asarray(we).tolist()
    assert gc.tolist() == np.asarray(wc).tolist()


def test_spec_accept_unit_semantics_as_jax():
    """The JAX package's unit cases (a chain whose argmax at j is j+1):
    a perfect draft, one that parts at position 1, the cap; a cap's stop
    is not a rejection (under top_k = 1 the next token is still the
    capped draft's); a real rejection never emits the rejected draft.
    (Ten tokens, so that the parting draft 9 is a token.)"""
    V, S, k = 10, 2, 3
    logits = np.full((S, k + 1, V), -10.0, np.float32)
    for j in range(k + 1):
        logits[:, j, j + 1] = 10.0
    lg = torch.from_numpy(logits)
    g = torch.Generator().manual_seed(0)
    greedy = (torch.zeros(S), torch.zeros(S, dtype=torch.int32),
              torch.ones(S))
    toks = torch.tensor([[0, 1, 2, 3], [0, 1, 9, 3]])
    e, c = spec_accept(lg, toks, g, *greedy)
    assert c.tolist() == [4, 2]
    assert e.tolist() == [[1, 2, 3, 4], [1, 2, 0, 0]]
    e, c = spec_accept(lg, toks, g, *greedy,
                       max_accept=torch.tensor([1, 1]))
    assert c.tolist() == [2, 2] and e[0, :2].tolist() == [1, 2]
    sampled = (torch.ones(S), torch.ones(S, dtype=torch.int32),
               torch.ones(S))
    e, c = spec_accept(lg, torch.tensor([[0, 1, 2, 3]] * 2), g, *sampled,
                       max_accept=torch.tensor([0, 0]))
    assert c.tolist() == [1, 1] and e[:, 0].tolist() == [1, 1]
    e, c = spec_accept(lg, torch.tensor([[0, 1, 9, 3]] * 2), g, *sampled)
    assert (e[torch.arange(S), c.long() - 1] != 9).all()


@pytest.mark.parametrize("top_k,top_p", [(0, 1.0), (3, 1.0), (0, 0.7)])
def test_spec_accept_samples_the_filtered_softmax(top_k, top_p):
    """One draft at temperature 0.8 over 40,000 lanes of one row of
    logits: the first emitted token follows the filtered softmax
    (chi-square), and where the draft was rejected the token is never
    the draft and follows the softmax without it."""
    N, V = 40000, 8
    base = np.asarray([2.0, 1.5, 1.0, 0.7, 0.3, 0.0, -0.5, -1.0],
                      np.float32)
    logits = torch.from_numpy(np.broadcast_to(base, (N, 2, V)).copy())
    draft = 1
    toks = torch.tensor([[0, draft]] * N)
    temp = torch.full((N,), 0.8)
    tk = torch.full((N,), top_k, dtype=torch.int32)
    tp = torch.full((N,), top_p)
    e, c = spec_accept(logits, toks, torch.Generator().manual_seed(1), temp,
                       tk, tp)
    from paddle_tpu_torch.serving.sampling import filter_logits
    p = torch.softmax(filter_logits(logits[:1, 0], temp[:1], tk[:1],
                                    tp[:1]), -1)[0].double().numpy()
    first = e[:, 0].numpy()
    keep = p > 0
    counts = np.bincount(first, minlength=V)
    assert not counts[~keep].any()
    assert stats.chisquare(counts[keep],
                           p[keep] / p[keep].sum() * N).pvalue > 1e-3
    rej = c.numpy() == 1
    assert 0 < rej.sum() < N and not (first[rej] == draft).any()
    q = np.where(np.arange(V) == draft, 0.0, p)
    q /= q.sum()
    rc = np.bincount(first[rej], minlength=V)
    kq = q > 0
    assert not rc[~kq].any()
    assert stats.chisquare(rc[kq],
                           q[kq] / q[kq].sum() * rej.sum()).pvalue > 1e-3


def test_spec_accept_draws_in_a_fixed_order():
    """Uniforms (S, k), then Gumbel noise (S, V), on every call: the
    generator ends in the same state whether every draft or none was
    accepted, so a seed repeats whatever the accept count."""
    V, S, k = 8, 2, 3
    logits = np.full((S, k + 1, V), -10.0, np.float32)
    for j in range(k + 1):
        logits[:, j, j + 1] = 10.0
    states = []
    for toks in ([[0, 1, 2, 3]] * S, [[0, 7, 7, 7]] * S):
        g = torch.Generator().manual_seed(3)
        e, c = spec_accept(torch.from_numpy(logits), torch.tensor(toks), g,
                           torch.ones(S), torch.zeros(S, dtype=torch.int32),
                           torch.ones(S))
        states.append((c.tolist(), torch.rand(4, generator=g).tolist()))
    assert states[0][0] == [4, 4] and states[1][0] == [1, 1]
    assert states[0][1] == states[1][1]


# ---------------------------------------------------------------------------
# speculative engines against the JAX spec engine and the plain engine
# ---------------------------------------------------------------------------

def _spec_prompts():
    """Churn with prefix hits (a shared prompt every other request) and
    two prompts that repeat a span, so that drafts hit."""
    rng = np.random.default_rng(11)
    shared = rng.integers(0, 512, (16,)).astype(np.int32)
    out = [shared if i % 2 else rng.integers(0, 512, (5 + 3 * i,)).astype(
        np.int32) for i in range(5)]
    span = rng.integers(0, 512, (6,)).astype(np.int32)
    out += [np.tile(span, 4), np.tile(span[:4], 5)]
    return out


def _spec_both(jm, tm, prompts, max_new=10, **kw):
    """(JAX spec results, port spec results, port plain results, the
    engines)."""
    kw.setdefault("page_size", 16)
    je, te = _engines(jm, tm, **kw)
    want, _ = _run(JaxScheduler, JaxRequest, je, prompts, max_new=max_new,
                   overlap=False)
    got, sched = _run(ContinuousBatchingScheduler, Request, te, prompts,
                      max_new=max_new)
    plain_kw = {k: v for k, v in kw.items() if k != "spec_k"}
    plain, _ = _run(ContinuousBatchingScheduler, Request,
                    _engines(jm, tm, **plain_kw)[1], prompts,
                    max_new=max_new)
    return want, got, plain, je, te, sched


def _same_spec_results(want, got, plain):
    for w, g, p in zip(want, got, plain):
        assert g.tokens.tolist() == w.tokens.tolist() == p.tokens.tolist()
        assert g.finish_reason == w.finish_reason == p.finish_reason
        assert g.prefix_hit_tokens == w.prefix_hit_tokens
        assert (g.spec_proposed, g.spec_accepted) == \
            (w.spec_proposed, w.spec_accepted)


@pytest.mark.parametrize("k", [1, 4])
def test_spec_greedy_matches_jax_and_plain_through_churn(k):
    """Seven requests through two slots, prefix hits and drafts that
    hit: tokens bit-identical to the JAX spec engine's and to the port's
    plain engine; per-request draft counts, the engine's spec and KV
    accounting as the JAX engine's."""
    jm, tm = _pair()
    want, got, plain, je, te, sched = _spec_both(jm, tm, _spec_prompts(),
                                                 spec_k=k)
    _same_spec_results(want, got, plain)
    assert te.spec_stats == je.spec_stats
    assert te.spec_stats["accepted"] > 0
    assert te.spec_stats["proposed"] == sum(r.spec_proposed for r in got)
    assert te.spec_stats["accepted"] == sum(r.spec_accepted for r in got)
    assert te.kv_bytes_per_token() == je.kv_bytes_per_token()
    assert sum(r.prefix_hit_tokens for r in got) > 0
    assert sched.decode_steps_total == te.spec_stats["steps"]
    for r in got:
        assert r.ttft > 0 and r.tpot > 0


def test_spec_greedy_through_preemption_matches_jax():
    """A pool of 6 pages of 8 for two 24-token prompts at 8 new tokens:
    verify steps need 4 rows a slot, requests are preempted and resumed,
    and the tokens and draft counts are the JAX spec engine's and the
    plain roomy engine's."""
    jm, tm = _pair(seed=8)
    rng = np.random.default_rng(71)
    prompts = [rng.integers(0, 512, (24,)).astype(np.int32)
               for _ in range(2)]
    kw = dict(max_len=48, page_size=8, prefill_chunk=8, spec_k=3)
    want, got, _plain, je, te, sched = _spec_both(
        jm, tm, prompts, max_new=8, num_pages=6, **kw)
    roomy, _ = _run(ContinuousBatchingScheduler, Request,
                    _engines(jm, tm, max_len=48, page_size=8,
                             prefill_chunk=8, num_pages=12)[1],
                    prompts, max_new=8)
    _same_spec_results(want, got, roomy)
    assert sched.preemptions_total > 0
    assert te._alloc.table.tolist() == je._alloc.table.tolist()
    assert te._alloc.refcount.tolist() == je._alloc.refcount.tolist()


def test_spec_eos_inside_an_accepted_run_matches_jax():
    """EOS taken from the plain stream of a repeated-span prompt: the
    spec request ends exactly where sequential decode does."""
    jm, tm = _pair(seed=35)
    span = _prompt(7, 5)
    prompt = np.tile(span, 3)
    base, _ = _run(ContinuousBatchingScheduler, Request,
                   _engines(jm, tm)[1], [prompt], max_new=40)
    eos = int(base[0].tokens[6])
    je, te = _engines(jm, tm, spec_k=4)
    want, _ = _run(JaxScheduler, JaxRequest, je, [prompt], max_new=40,
                   eos=[eos], overlap=False)
    got, _ = _run(ContinuousBatchingScheduler, Request, te, [prompt],
                  max_new=40, eos=[eos])
    plain, _ = _run(ContinuousBatchingScheduler, Request,
                    _engines(jm, tm)[1], [prompt], max_new=40, eos=[eos])
    _same_spec_results(want, got, plain)
    assert got[0].finish_reason == "eos"
    assert got[0].tokens.tolist() == list(base[0].tokens[:list(
        base[0].tokens).index(eos) + 1])


def test_spec_near_max_len_caps_acceptance_as_jax():
    """A 28-token prompt at max_len 32, four drafts a step: acceptance
    is capped at the cache's room and the request ends ``cache_full``
    with the plain engine's tokens; the host lengths mirror the device
    lengths."""
    jm, tm = _pair(seed=36)
    prompt = np.tile(_prompt(19, 7), 4)
    want, got, plain, je, te, _s = _spec_both(jm, tm, [prompt], max_new=50,
                                              max_len=32, spec_k=4)
    _same_spec_results(want, got, plain)
    assert got[0].finish_reason == "cache_full"
    assert te.slot_lengths().tolist() == te.cache.lengths.tolist()


def test_spec_int8_composed_matches_jax_and_int8_decode():
    """Both levers at once: spec over the int8 pool equals the JAX
    engine's and the port's int8 plain stream."""
    jm, tm = _pair(seed=37)
    rng = np.random.default_rng(13)
    span = rng.integers(0, 512, (4,)).astype(np.int32)
    prompts = [rng.integers(0, 512, (12,)).astype(np.int32)
               for _ in range(2)] + [np.tile(span, 4)]
    want, got, plain, je, te, _s = _spec_both(jm, tm, prompts,
                                              kv_dtype="int8", spec_k=4)
    _same_spec_results(want, got, plain)
    assert te.cache.k.dtype == torch.int8
    assert te.kv_bytes_per_token() == je.kv_bytes_per_token()


def test_decode_spec_at_accept_extremes_matches_jax():
    """Direct ``decode_spec`` calls: the true greedy continuation as the
    draft (all accepted, counts 4) and garbage drafts (none, counts 1,
    the corrected token); emitted rows, counts and the host lengths as
    the JAX engine's."""
    jm, tm = _pair(seed=38)
    p = _prompt(23, 8)
    ref = _engines(jm, tm)[1]
    rtok, _ = ref.prefill(0, p, temperature=0.0)
    greedy = [rtok]
    for _ in range(6):
        nt, _ = ref.decode([greedy[-1], 0], [True, False], [0.0, 0.0],
                           [0, 0], [1.0, 1.0])
        greedy.append(int(nt[0]))
    out = []
    for eng in _engines(jm, tm, spec_k=3):
        tok, _ = eng.prefill(0, p, temperature=0.0)
        args = ([True, False], [0.0, 0.0], [0, 0], [1.0, 1.0])
        e1, c1, _ = eng.decode_spec([tok, 0], np.asarray(
            [greedy[1:4], [0, 0, 0]]), *args)
        e2, c2, _ = eng.decode_spec([greedy[4], 0],
                                    np.full((2, 3), 511, np.int32), *args)
        out.append((np.asarray(e1)[0].tolist(), int(c1[0]),
                    np.asarray(e2)[0].tolist(), int(c2[0]),
                    eng.slot_lengths().tolist(), dict(eng.spec_stats)))
    assert out[1] == out[0]
    assert out[1][1] == 4 and out[1][0] == greedy[1:5]
    assert out[1][3] == 1 and out[1][2][0] == greedy[5]
    assert out[1][4][0] == p.size + 5


def test_generate_seed_reproducible_with_spec_on_cached_engine():
    """``generate(seed=0, temperature=1, spec_k=4)`` twice on the cached
    engine (the second prefix-hits) gives the same tokens; seed 1 gives
    others; one engine serves all three."""
    _jm, tm = _pair(seed=15)
    prompt = _prompt(83, 40)
    kw = dict(max_new_tokens=8, temperature=1.0, max_len=64, page_size=16,
              spec_k=4, device="cpu")
    a = generate(tm, prompt, seed=0, **kw)
    b = generate(tm, prompt, seed=0, **kw)
    c = generate(tm, prompt, seed=1, **kw)
    assert a[0].tolist() == b[0].tolist()
    assert a[0].tolist() != c[0].tolist()
    assert len(tm._serving_engines) == 1
    (eng,) = tm._serving_engines.values()
    assert eng.spec_k == 4 and eng.spec_stats["steps"] > 0
    generate(tm, prompt, max_new_tokens=2, max_len=64, page_size=16,
             kv_dtype="fp8", spec_k=0, device="cpu")
    generate(tm, prompt, max_new_tokens=2, max_len=64, page_size=16,
             kv_dtype="float8_e4m3fn", device="cpu")
    assert len(tm._serving_engines) == 2


# ---------------------------------------------------------------------------
# autotune keys
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kv", [None, "int8", "float8_e4m3fn"])
def test_autotune_keys_and_candidates_spelled_as_jax(kv):
    """Paged and slotted keys, quantized or not, at one and five query
    positions: the JAX module's dicts and candidate lists; unquantized
    keys carry no ``kv_dtype``."""
    for qlen in (1, 5):
        key = da.paged_autotune_key(8, 128, 64, 16, 16, 64, qlen,
                                    torch.float32, "cpu", kv_dtype=kv)
        jkey = jax_da.paged_autotune_key(8, 128, 64, 16, 16, 64, qlen,
                                         jnp.float32, kv_dtype=kv)
        assert key == jkey and ("kv_dtype" in key) == (kv is not None)
        assert at.families()["decode_attn_paged"].candidates(key) == \
            jax_da._paged_candidates(jkey)
        key = da.autotune_key(8, 1024, 16, 64, qlen, torch.float32, "cpu",
                              kv_dtype=kv)
        jkey = jax_da.autotune_key(8, 1024, 16, 64, qlen, jnp.float32,
                                   kv_dtype=kv)
        assert key == jkey
        assert at.families()["decode_attn"].candidates(key) == \
            jax_da._candidates(jkey)
    jax_keys = [k for _f, k in jax_at.standard_keys()]
    for fam, key in at.standard_keys()[4:]:
        assert key in jax_keys, (fam, key)


@pytest.mark.parametrize("kv", [None, "int8", "float8_e4m3fn"])
def test_decode_family_runners_run_every_candidate(kv):
    """Both families' runners run each candidate on operands of the key
    (a quantized key's K/V made through ``quantize_kv``), and every
    candidate computes candidate [0]'s output within 1e-5."""
    keys = {"decode_attn": da.autotune_key(2, 256, 2, 8, 3, torch.float32,
                                           "cpu", kv_dtype=kv),
            "decode_attn_paged": da.paged_autotune_key(
                2, 8, 4, 4, 2, 8, 3, torch.float32, "cpu", kv_dtype=kv)}
    for fam, key in keys.items():
        family = at.families()[fam]
        cands = family.candidates(key)
        for cand in cands:
            family.runner(cand, key)()
        ops = da._RUNNER_OPERANDS[at.key_str(key)]
        q, k, v, ks, vs = ops[:5]
        assert (ks is None) == (kv is None)
        outs = []
        for cand in cands:
            cfg = cand["config"]
            if fam == "decode_attn":
                outs.append(da.decode_attention(
                    q, k, v, ops[5], k_scales=ks, v_scales=vs,
                    block_t=cfg.get("block_t", 0)))
            else:
                outs.append(da.paged_decode_attention(
                    q, k, v, *ops[5:], k_scales=ks, v_scales=vs,
                    pages_per_block=cfg.get("pages_per_block", 0)))
        for out in outs[1:]:
            torch.testing.assert_close(out, outs[0], atol=1e-5, rtol=1e-5)
        family.cleanup(key)
        assert at.key_str(key) not in da._RUNNER_OPERANDS
