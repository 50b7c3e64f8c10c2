"""Poisson load generation against the serving front end (port of
``paddle_tpu/serving/loadgen.py``; pure asyncio and numpy, so the same
seed gives the same arrival plan and prompts as the JAX package's).

A stdlib-asyncio HTTP client that offers load to a live
:class:`~.frontend.ServingFrontend` the way real traffic arrives:
**Poisson arrivals** at a target QPS (exponential inter-arrival gaps,
seeded — the same plan replays identically) over a named **prompt/output
length mix**, with every request streamed over SSE so TTFT is measured
at the first *delivered* token, exactly what a client sees.

Per request it records: HTTP status (sheds — 429/503 — are first-class
outcomes, not errors), TTFT (request write → first token event), TPOT
(mean gap over subsequent token events), and delivered token count.
:func:`summarize` rolls a run into the serve-bench line's fields:
**goodput** (tokens delivered on COMPLETED streams / wall — shed or
disconnected work earns nothing), shed rate, and nearest-rank p50/p99
TTFT+TPOT.  The goodput-vs-QPS curve's knee is where the bounded
admission queue starts shedding.
"""
from __future__ import annotations

import asyncio
import json
import time
from typing import Dict, List, Optional

import numpy as np

__all__ = ["MIXES", "run_load", "run_load_sync", "run_interference",
           "run_interference_sync", "summarize", "percentile"]

#: named prompt/output length mixes: (prompt_len_range, max_new_range),
#: both inclusive.  Lengths are drawn uniformly per request from the
#: seeded plan RNG.  Kept small enough for a CPU engine of max_len 128;
#: a card run passes its own ``((plo, phi), (nlo, nhi))`` pair.
MIXES = {
    "short": ((8, 16), (4, 8)),
    "mixed": ((8, 48), (4, 16)),
    "long": ((32, 96), (8, 32)),
    # the interference worst case: long prompts, short
    # outputs — almost all of the request's compute is prefill, so a
    # wave of these steals the most decode iterations from a colocated
    # engine (the disaggregated A/B's admission wave)
    "prefill_heavy": ((64, 112), (2, 4)),
    # its counterpart: short prompts, long outputs — streams that live
    # long enough to BE in flight when the wave lands, so their
    # inter-token gaps sample exactly the decode-TPOT interference the
    # A/B measures (the steady stream of the isolation drive)
    "decode_heavy": ((8, 16), (24, 48)),
}


def percentile(values: List[float], q: float) -> float:
    """Nearest-rank percentile (the trace-report SLI convention); 0.0
    on an empty list — callers report counts alongside."""
    if not values:
        return 0.0
    v = sorted(values)
    idx = max(0, min(len(v) - 1, int(np.ceil(q * len(v))) - 1))
    return float(v[idx])


async def _one_request(host: str, port: int, payload: dict,
                       record_gaps: bool = False) -> dict:
    """POST one streaming generate and consume its SSE events.  Returns
    {status, ttft, tpot, tokens, finish_reason} — ttft/tpot are None
    when no token arrived (shed, error).  ``record_gaps=True`` also
    collects ``gaps``: one ``(arrival_time, gap_seconds)`` per
    post-first token event — the per-token samples the interference A/B
    classifies into quiet-vs-wave windows."""
    t0 = time.perf_counter()
    rec = {"status": 0, "ttft": None, "tpot": None, "tokens": 0,
           "finish_reason": None}
    if record_gaps:
        rec["gaps"] = []
    try:
        reader, writer = await asyncio.open_connection(host, port)
    except OSError:
        rec["finish_reason"] = "connect_error"
        return rec
    try:
        body = json.dumps(dict(payload, stream=True)).encode()
        writer.write(
            b"POST /v1/generate HTTP/1.1\r\nHost: loadgen\r\n"
            b"Content-Type: application/json\r\n"
            b"Content-Length: %d\r\n\r\n" % len(body) + body)
        await writer.drain()
        status_line = await reader.readline()
        parts = status_line.split()
        rec["status"] = int(parts[1]) if len(parts) > 1 else 0
        while True:                       # headers
            h = await reader.readline()
            if h in (b"\r\n", b"\n", b""):
                break
        if rec["status"] != 200:
            # shed/error body is a single JSON doc; drain and go
            await reader.read()
            return rec
        first_t = last_t = None
        n = 0
        while True:
            line = await reader.readline()
            if not line:
                break
            line = line.strip()
            if not line.startswith(b"data: "):
                continue
            ev = json.loads(line[6:])
            if ev.get("done"):
                rec["finish_reason"] = ev.get("finish_reason")
                break
            k = len(ev.get("tokens", ()))
            if k:
                now = time.perf_counter()
                if first_t is None:
                    first_t = now
                elif record_gaps:
                    # one sample per EVENT (a speculative run delivers
                    # several tokens at once): gap amortized per token
                    rec["gaps"].append((now, (now - last_t) / k))
                last_t = now
                n += k
        rec["tokens"] = n
        if first_t is not None:
            rec["ttft"] = first_t - t0
            if n > 1 and last_t > first_t:
                rec["tpot"] = (last_t - first_t) / (n - 1)
        return rec
    except (ConnectionResetError, ConnectionAbortedError,
            BrokenPipeError, asyncio.IncompleteReadError):
        rec["finish_reason"] = "connection_error"
        return rec
    finally:
        try:
            writer.close()
        except Exception:
            pass


async def run_load(host: str, port: int, qps: float, n_requests: int,
                   mix="short", seed: int = 0, vocab: int = 256,
                   temperature: float = 0.0,
                   eos_token_id: Optional[int] = None) -> dict:
    """Offer ``n_requests`` at Poisson rate ``qps`` and collect the
    summary.  ``mix`` is a name from :data:`MIXES` or a
    ``((plo, phi), (nlo, nhi))`` pair.  The arrival plan and every
    prompt are drawn from one seeded RNG — a rerun offers the identical
    workload."""
    rng = np.random.default_rng(seed)
    (plo, phi), (nlo, nhi) = MIXES[mix] if isinstance(mix, str) else mix
    loop = asyncio.get_running_loop()
    t_start = loop.time()
    t_next = 0.0
    tasks = []
    for _ in range(int(n_requests)):
        plen = int(rng.integers(plo, phi + 1))
        payload = {
            "prompt": [int(x) for x in rng.integers(0, vocab, (plen,))],
            "max_new_tokens": int(rng.integers(nlo, nhi + 1)),
            "temperature": float(temperature),
        }
        if eos_token_id is not None:
            payload["eos_token_id"] = int(eos_token_id)
        delay = (t_start + t_next) - loop.time()
        if delay > 0:
            await asyncio.sleep(delay)
        tasks.append(asyncio.ensure_future(
            _one_request(host, port, payload)))
        t_next += float(rng.exponential(1.0 / float(qps)))
    recs = await asyncio.gather(*tasks)
    wall = loop.time() - t_start
    return summarize(list(recs), wall, qps=float(qps),
                     mix=(mix if isinstance(mix, str) else "custom"))


def run_load_sync(host, port, qps, n_requests, **kw) -> dict:
    """:func:`run_load` from synchronous code (its own event loop)."""
    return asyncio.run(run_load(host, port, qps, n_requests, **kw))


async def run_interference(host: str, port: int, qps: float,
                           n_requests: int, mix="short",
                           wave_mix="prefill_heavy", wave_n: int = 4,
                           wave_qps: float = 8.0, seed: int = 0,
                           vocab: int = 256,
                           temperature: float = 0.0,
                           repeats: int = 1) -> dict:
    """The interference-isolation A/B drive: a steady Poisson
    stream of ``mix`` requests, plus a concurrent **admission wave** of
    ``wave_n`` ``wave_mix`` (long-prompt) requests offered at
    ``wave_qps`` starting once the steady stream is warm (~1/3 through).
    Every steady-stream token event records its inter-token gap with a
    timestamp; the summary classifies gaps into the **quiet** window vs
    the **wave** window (first wave request sent → last wave stream
    done), so ``wave_tpot_p99_ms / quiet_tpot_p99_ms`` measures exactly
    how much a long-prompt admission wave degrades IN-FLIGHT decode
    TPOT — flat for a disaggregated engine, inflated for the colocated
    chunked-prefill baseline.  Seeded like :func:`run_load`: a rerun
    offers the identical workload.

    ``repeats`` runs the whole steady+wave cycle that many times and
    POOLS the gap samples (per-cycle wave windows): a p99 over one
    cycle's ~10² wave-window gaps is essentially the max of the set and
    flaps on a single OS hiccup; pooling 3 cycles' samples makes the
    isolation gate CI-stable.  ``repeats=1`` is byte-identical to the
    pre-repeat behavior (cycle r>0 reseeds at ``seed + 1000*r``)."""
    loop = asyncio.get_running_loop()
    (plo, phi), (nlo, nhi) = MIXES[mix] if isinstance(mix, str) else mix
    (wplo, wphi), (wnlo, wnhi) = (MIXES[wave_mix]
                                  if isinstance(wave_mix, str) else wave_mix)

    async def _cycle(cycle_seed):
        rng = np.random.default_rng(cycle_seed)
        wave_rng = np.random.default_rng(cycle_seed + 1)
        t_start = loop.time()
        wave_window = {"t0": None, "t1": None}

        async def _steady():
            t_next, tasks = 0.0, []
            for _ in range(int(n_requests)):
                plen = int(rng.integers(plo, phi + 1))
                payload = {
                    "prompt": [int(x) for x in rng.integers(0, vocab,
                                                            (plen,))],
                    "max_new_tokens": int(rng.integers(nlo, nhi + 1)),
                    "temperature": float(temperature),
                }
                delay = (t_start + t_next) - loop.time()
                if delay > 0:
                    await asyncio.sleep(delay)
                tasks.append(asyncio.ensure_future(
                    _one_request(host, port, payload, record_gaps=True)))
                t_next += float(rng.exponential(1.0 / float(qps)))
            return await asyncio.gather(*tasks)

        async def _wave():
            # warm-up: let ~1/3 of the steady stream land first so the
            # quiet window has samples
            await asyncio.sleep((n_requests / 3.0) / float(qps))
            wave_window["t0"] = time.perf_counter()
            t_next, tasks = 0.0, []
            w0 = loop.time()
            for _ in range(int(wave_n)):
                plen = int(wave_rng.integers(wplo, wphi + 1))
                payload = {
                    "prompt": [int(x) for x in wave_rng.integers(
                        0, vocab, (plen,))],
                    "max_new_tokens": int(wave_rng.integers(wnlo,
                                                            wnhi + 1)),
                    "temperature": float(temperature),
                }
                delay = (w0 + t_next) - loop.time()
                if delay > 0:
                    await asyncio.sleep(delay)
                tasks.append(asyncio.ensure_future(
                    _one_request(host, port, payload)))
                t_next += float(wave_rng.exponential(
                    1.0 / float(wave_qps)))
            out = await asyncio.gather(*tasks)
            wave_window["t1"] = time.perf_counter()
            return out

        steady, wave = await asyncio.gather(_steady(), _wave())
        return steady, wave, wave_window, loop.time() - t_start

    all_steady, quiet, waved = [], [], []
    wave_sent = wave_done = 0
    wall = 0.0
    for rep in range(max(1, int(repeats))):
        steady, wave, window, cycle_wall = await _cycle(
            seed + 1000 * rep)
        wall += cycle_wall
        all_steady.extend(steady)
        t0, t1 = window["t0"], window["t1"]
        for r in steady:
            for ts, gap in r.get("gaps", ()):
                (waved if (t0 is not None and t0 <= ts <= t1)
                 else quiet).append(gap)
        wave_sent += int(wave_n)
        wave_done += sum(1 for r in wave if r["status"] == 200
                         and r["finish_reason"] not in
                         (None, "error", "connection_error"))
    summary = summarize(all_steady, wall, qps=float(qps),
                        mix=(mix if isinstance(mix, str) else "custom"))
    summary["wave"] = {
        "mix": (wave_mix if isinstance(wave_mix, str) else "custom"),
        "requests": wave_sent,
        "completed": wave_done,
        "repeats": max(1, int(repeats)),
        "quiet_gaps": len(quiet),
        "wave_gaps": len(waved),
        "quiet_tpot_p50_ms": round(1e3 * percentile(quiet, 0.50), 3),
        "quiet_tpot_p99_ms": round(1e3 * percentile(quiet, 0.99), 3),
        "wave_tpot_p50_ms": round(1e3 * percentile(waved, 0.50), 3),
        "wave_tpot_p99_ms": round(1e3 * percentile(waved, 0.99), 3),
    }
    return summary


def run_interference_sync(host, port, qps, n_requests, **kw) -> dict:
    """:func:`run_interference` from synchronous code."""
    return asyncio.run(run_interference(host, port, qps, n_requests,
                                        **kw))


def summarize(recs: List[dict], wall_s: float, qps: float,
              mix: str) -> dict:
    """Roll per-request records into the serve-bench metrics.  Goodput
    counts only tokens of streams that COMPLETED (got their done
    event); shed rate counts 429+503 over everything sent."""
    done = [r for r in recs if r["status"] == 200
            and r["finish_reason"] not in (None, "error",
                                           "connection_error")]
    shed = [r for r in recs if r["status"] in (429, 503)]
    n_errors = len(recs) - len(done) - len(shed)
    # a stream the server ACCEPTED (200) but never finished cleanly: a
    # dropped stream, which a drain or a recovery must never produce
    dropped = [r for r in recs if r["status"] == 200
               and r["finish_reason"] in (None, "error",
                                          "connection_error")]
    goodput_tokens = sum(r["tokens"] for r in done)
    ttfts = [r["ttft"] for r in done if r["ttft"] is not None]
    tpots = [r["tpot"] for r in done if r["tpot"] is not None]
    return {
        "qps": qps,
        "mix": mix,
        "sent": len(recs),
        "completed": len(done),
        "shed": len(shed),
        "errors": n_errors,
        "dropped_streams": len(dropped),
        "shed_rate": round(len(shed) / max(len(recs), 1), 4),
        "goodput_tokens": goodput_tokens,
        "goodput_tokens_per_sec": round(goodput_tokens / wall_s, 2)
        if wall_s > 0 else 0.0,
        "qps_achieved": round(len(recs) / wall_s, 2) if wall_s > 0
        else 0.0,
        "ttft_p50_ms": round(1e3 * percentile(ttfts, 0.50), 3),
        "ttft_p99_ms": round(1e3 * percentile(ttfts, 0.99), 3),
        "tpot_p50_ms": round(1e3 * percentile(tpots, 0.50), 3),
        "tpot_p99_ms": round(1e3 * percentile(tpots, 0.99), 3),
        "wall_s": round(wall_s, 3),
    }
