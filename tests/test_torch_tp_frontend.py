"""The HTTP front end over a tensor-parallel engine in the port: rank 0 of
a two-rank gloo world runs ``ServingFrontend(DecodeEngine(tp=2))``, rank 1
``serving.follow``.  Greedy tokens over HTTP equal the port's tp=1 engine
over HTTP and the JAX package's tp=2 engine; a client that leaves
mid-stream is cancelled on both ranks; a sampled request draws the same
tokens on both ranks; ``stop()`` ends the follower normally; a follower
whose rank 0 vanishes exits non-zero within its stated time; the fleet
and the disaggregated pair refuse a tp engine."""
import socket
import time

import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu.models.gpt import GPTConfig as JGPTConfig
from paddle_tpu.models.gpt import GPTForCausalLM as JGPT

import _torch_dist
import _torch_front as TF

MAX_NEW = 8
LEADER_TIMEOUT = 20.0


@pytest.fixture(scope="module")
def world():
    w = _torch_dist.World(2)
    yield w
    w.close()


def _prompts():
    rng = np.random.default_rng(11)
    return [rng.integers(0, 512, (n,)) for n in (5, 19, 12, 30)]


def _jax_tokens(model, prompts):
    """The JAX package's tp=2 engine through its scheduler, greedy."""
    from paddle_tpu.serving.engine import DecodeEngine
    from paddle_tpu.serving.scheduler import (ContinuousBatchingScheduler,
                                              Request)
    eng = DecodeEngine(model, num_slots=4, max_len=64, page_size=16, seed=0,
                       tp=2)
    sched = ContinuousBatchingScheduler(eng, overlap=False)
    rids = [sched.submit(Request(prompt=np.asarray(p, np.int32),
                                 max_new_tokens=MAX_NEW, temperature=0.0))
            for p in prompts]
    res = sched.run()
    return [np.asarray(res[r].tokens).tolist() for r in rids]


@pytest.fixture(scope="module")
def jax_ref():
    """The JAX tiny GPT's weights and its tp=2 engine's greedy tokens,
    with the JAX package's recording switch on for the call."""
    with paddle.set_grad_enabled(True):
        paddle.seed(0)
        m = JGPT(JGPTConfig.tiny())
        m.eval()
        weights = {k: np.asarray(v.numpy()) for k, v in
                   m.state_dict().items()}
        return weights, _jax_tokens(m, _prompts())


@pytest.fixture(scope="module")
def served(world, jax_ref):
    rng = np.random.default_rng(12)
    return world.run("_torch_front:job_tp_front", weights=jax_ref[0],
                     prompts=_prompts(), max_new=MAX_NEW,
                     sampled=rng.integers(0, 512, (9,)),
                     cut=rng.integers(0, 512, (7,)))


def test_tp2_http_greedy_equals_tp1_http_and_jax(served, jax_ref):
    """Greedy tokens over HTTP at tp=2 (rank 0's front end, rank 1
    following) equal the port's tp=1 engine over HTTP and the JAX
    package's tp=2 engine."""
    from paddle_tpu_torch.serving import ServingFrontend
    _m, eng = _torch_dist.tp_engine(jax_ref[0], 1, seed=0, num_slots=4)
    fe = ServingFrontend(eng)
    fe.start()
    try:
        tp1 = TF.serve_drive(fe, _prompts(), MAX_NEW)["greedy"]
    finally:
        fe.stop()
    assert tp1 == jax_ref[1]
    assert served[0]["greedy"] == jax_ref[1]


def test_follower_matches_rank0_request_by_request(served):
    """Rank 1's scheduler finished every request rank 0's did, under the
    same rids, with the same tokens and reasons: the greedy ones, the
    sampled one (both ranks drew the same tokens), and the client that
    left mid-stream (cancelled on both ranks)."""
    r0, r1 = served
    assert r1["finished"] == r0["finished"]
    rid, toks = r0["sampled"]
    assert r0["finished"][rid] == [toks, "length"]
    assert len(toks) == MAX_NEW
    cut = [v for v in r0["finished"].values() if v[1] == "cancelled"]
    assert len(cut) == 1 and 0 < len(cut[0][0]) < 40
    assert len(r0["finished"]) == len(_prompts()) + 2


def test_stop_ends_the_follower_normally(served):
    """``stop()`` on rank 0 sends the stop record: ``follow`` returned its
    scheduler (the job completed on rank 1) with rank 0's loop; the
    steps ran uncaptured on every rank."""
    r0, r1 = served
    assert r1["overlap"] is True
    assert r0["records"] > len(_prompts())
    assert r0["captures"] == 0


def test_follower_of_a_vanished_rank0_exits_nonzero(jax_ref):
    """Rank 0 serves a request, then its process ends without stop():
    the follower exits non-zero (LeaderLost from the backend, or the
    watchdog's exit code) within its leader timeout and a margin, and
    does not hang."""
    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    results = ctx.Queue()
    procs = [ctx.Process(target=TF.vanish_main,
                         args=(r, port, jax_ref[0], LEADER_TIMEOUT, results))
             for r in range(2)]
    t0 = time.monotonic()
    for p in procs:
        p.start()
    try:
        procs[1].join(LEADER_TIMEOUT + 60)
        elapsed = time.monotonic() - t0
        assert not procs[1].is_alive(), "the follower hangs"
        assert procs[1].exitcode not in (0, None)
        procs[0].join(10)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(5)
    got = {}
    while not results.empty():
        item = results.get()
        got[item[0]] = item[1:]
    assert got["leader"] == (3,)
    # the watchdog's exit reports nothing; a backend error LeaderLost
    assert "follower" not in got or got["follower"][0].startswith(
        "LeaderLost"), got
    assert elapsed < LEADER_TIMEOUT + 60


def test_tp_engine_refusals(world, jax_ref):
    """The fleet and the disaggregated pair refuse a tp engine with a
    ValueError naming the combination and ROADMAP.md; a front end on
    rank 1 points at ``follow``, and ``follow`` on rank 0 at the front
    end."""
    r0, r1 = world.run("_torch_front:job_tp_refusals", weights=jax_ref[0])
    for out in (r0, r1):
        for name in ("router", "frontend_router"):
            assert "Router over a tensor-parallel engine" in out[name]
            assert "ROADMAP.md" in out[name]
        for name in ("disagg", "frontend_disagg"):
            assert "disaggregated serving with a tensor-parallel" \
                in out[name] and "ROADMAP.md" in out[name]
    assert "ServingFrontend" in r0["follow"]
    assert "serving.follow" in r1["frontend"]


def test_follower_watchdog_ends_a_process_waiting_on_a_silent_leader(
        monkeypatch):
    """A follower's receive that has waited past its leader timeout ends
    the process with LEADER_LOST_EXIT (a hung rank 0 never closes its
    socket); one not waiting is left alone."""
    import os
    import threading
    from types import SimpleNamespace

    from paddle_tpu_torch.serving import frontend
    codes, done = [], threading.Event()
    monkeypatch.setattr(os, "_exit", lambda code: (codes.append(code),
                                                   done.set()))
    idle = SimpleNamespace(waiting_since=None)
    quiet = threading.Event()
    t = threading.Thread(target=frontend._watch_leader,
                         args=(idle, 0.1, quiet))
    t.start()
    time.sleep(0.6)
    quiet.set()
    t.join(5)
    assert codes == []
    stuck = SimpleNamespace(waiting_since=time.monotonic() - 1.0)
    t = threading.Thread(target=frontend._watch_leader,
                         args=(stuck, 0.5, done))
    t.start()
    t.join(5)
    assert codes == [frontend.LEADER_LOST_EXIT]
