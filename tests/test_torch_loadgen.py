"""paddle_tpu_torch.serving.loadgen against paddle_tpu.serving.loadgen:
the same seed offers the same workload (every draw of the arrival plan
and every payload, exactly), and ``summarize`` rolls the same records
into the same line (exactly: no float differs).  The requests go to a
recording stand-in for ``_one_request``, so no socket is opened."""
import numpy as np
import pytest

from paddle_tpu.serving import loadgen as jax_loadgen
from paddle_tpu_torch.serving import loadgen


class _Recorder:
    """Wraps every ``np.random.default_rng`` made while installed and logs
    each draw (method, arguments, result) of each generator."""

    def __init__(self, monkeypatch):
        self.draws = []
        real = np.random.default_rng

        def make(seed=None):
            gen = real(seed)
            log = self.draws

            class _Logged:
                def __getattr__(self, name):
                    fn = getattr(gen, name)

                    def call(*a, **kw):
                        out = fn(*a, **kw)
                        log.append((seed, name, repr(a), repr(kw),
                                    np.asarray(out).tolist()))
                        return out
                    return call
            return _Logged()
        monkeypatch.setattr(np.random, "default_rng", make)


def _fake_request(sent):
    async def one(host, port, payload, record_gaps=False):
        sent.append(payload)
        rec = {"status": 200, "ttft": 0.01, "tpot": 0.002,
               "tokens": payload["max_new_tokens"], "finish_reason": "length"}
        if record_gaps:
            rec["gaps"] = []
        return rec
    return one


def _offer(mod, monkeypatch, fn, **kw):
    sent = []
    monkeypatch.setattr(mod, "_one_request", _fake_request(sent))
    rec = _Recorder(monkeypatch)
    out = fn(mod)("127.0.0.1", 1, **kw)
    monkeypatch.undo()
    return sent, rec.draws, out


@pytest.mark.parametrize("mix", ["short", "long", ((64, 512), (16, 64))],
                         ids=["short", "long", "serve_http"])
def test_run_load_offers_the_jax_workload(monkeypatch, mix):
    kw = dict(qps=1000.0, n_requests=12, mix=mix, seed=3, vocab=50304,
              temperature=0.0, eos_token_id=7)
    jax_sent, jax_draws, jax_out = _offer(
        jax_loadgen, monkeypatch, lambda m: m.run_load_sync, **kw)
    sent, draws, out = _offer(loadgen, monkeypatch,
                              lambda m: m.run_load_sync, **kw)
    assert len(sent) == 12 and sent == jax_sent
    # a request draws its length, its tokens, its budget and its gap
    assert draws == jax_draws and len(draws) == 12 * 4
    for key in ("sent", "completed", "shed", "goodput_tokens", "mix",
                "ttft_p50_ms", "tpot_p99_ms"):
        assert out[key] == jax_out[key]


def test_run_interference_offers_the_jax_workload(monkeypatch):
    kw = dict(qps=1000.0, n_requests=6, wave_n=3, wave_qps=1000.0, seed=5,
              vocab=512, repeats=2)
    jax_sent, jax_draws, jax_out = _offer(
        jax_loadgen, monkeypatch, lambda m: m.run_interference_sync, **kw)
    sent, draws, out = _offer(loadgen, monkeypatch,
                              lambda m: m.run_interference_sync, **kw)
    # the steady stream and the wave interleave by wall time: compare
    # each as a multiset, and every draw of each generator in order
    key = lambda p: (len(p["prompt"]), p["prompt"], p["max_new_tokens"])
    assert sorted(sent, key=key) == sorted(jax_sent, key=key)
    by_seed = lambda ds: sorted(ds, key=lambda d: d[0])
    assert by_seed(draws) == by_seed(jax_draws)
    assert out["wave"]["requests"] == jax_out["wave"]["requests"] == 6
    assert out["wave"]["completed"] == jax_out["wave"]["completed"]


def test_summarize_matches_jax_on_the_same_records():
    rng = np.random.default_rng(11)
    recs = []
    for i in range(40):
        status = [200, 200, 200, 429, 503, 200][i % 6]
        reason = (None if status != 200 else
                  ["length", "eos", "error", None, "connection_error",
                   "length"][i % 5])
        ok = status == 200 and reason is not None
        recs.append({"status": status,
                     "ttft": float(rng.uniform(0.01, 0.5)) if ok else None,
                     "tpot": float(rng.uniform(0.001, 0.05))
                     if ok and i % 7 else None,
                     "tokens": int(rng.integers(0, 64)),
                     "finish_reason": reason})
    for wall in (0.0, 3.7):
        assert loadgen.summarize(recs, wall, 4.0, "custom") == \
            jax_loadgen.summarize(recs, wall, 4.0, "custom")
    vals = [float(v) for v in rng.uniform(0, 1, 17)]
    for q in (0.0, 0.5, 0.9, 0.99, 1.0):
        assert loadgen.percentile(vals, q) == jax_loadgen.percentile(vals, q)
    assert loadgen.percentile([], 0.5) == jax_loadgen.percentile([], 0.5)
    assert loadgen.MIXES == jax_loadgen.MIXES
