"""The port's side of tests/test_torch_tp_frontend.py (not a test module;
it imports no JAX, so that the ranks of a ``_torch_dist.World``, and the
processes of the vanishing-rank-0 check, can run it): an HTTP client, the
serve drive over a front end, and the jobs."""
from __future__ import annotations

import threading

import chip_smoke


def payload(prompt, max_new, temperature=0.0, **kw):
    return dict({"prompt": [int(t) for t in prompt],
                 "max_new_tokens": int(max_new),
                 "temperature": float(temperature), "stream": True}, **kw)


def post(host, port, body):
    """POST /v1/generate, streamed: (tokens, the done event)."""
    _st, events = chip_smoke.http_request(host, port, "POST",
                                          "/v1/generate", body)
    done = chip_smoke.done_event(events)
    return done["tokens"], done


def serve_drive(fe, prompts, max_new, sampled=None, cut=None):
    """The traffic of the tp front-end checks, against a started front
    end: the greedy ``prompts`` all at once (a thread each), then
    ``cut`` (a prompt whose client leaves after a few events) and
    ``sampled`` (a prompt at temperature 0.8).  Returns {"greedy":
    [tokens], "rids", "sampled": (rid, tokens)}."""
    out = {"greedy": [None] * len(prompts), "rids": [None] * len(prompts)}

    def one(i):
        out["greedy"][i], done = post(fe.host, fe.port,
                                      payload(prompts[i], max_new))
        out["rids"][i] = done["rid"]
    threads = [threading.Thread(target=one, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(chip_smoke.HTTP_TIMEOUT)
    if cut is not None:
        chip_smoke.cut_stream(fe.host, fe.port, payload(cut, 40), after=1)
    if sampled is not None:
        toks, done = post(fe.host, fe.port,
                          payload(sampled, max_new, temperature=0.8,
                                  top_k=20))
        out["sampled"] = (done["rid"], toks)
    return out


def job_tp_front(weights, prompts, max_new, sampled, cut):
    """A tp=2 engine on both ranks; rank 0 serves :func:`serve_drive`'s
    traffic through ``ServingFrontend`` and stops it, rank 1 runs
    ``serving.follow``.  Each rank returns its scheduler's finished
    results and the records it sent or received; rank 0 the HTTP
    tokens too."""
    from paddle_tpu_torch import distributed as D
    from paddle_tpu_torch.serving import ServingFrontend, follow
    from _torch_dist import tp_engine
    _m, eng = tp_engine(weights, 2, seed=0, num_slots=4)
    if D.get_rank() == 0:
        fe = ServingFrontend(eng, queue_limit=16)
        fe.start()
        try:
            out = serve_drive(fe, prompts, max_new, sampled, cut)
        finally:
            fe.stop()
        out["finished"] = chip_smoke.finished_tokens(fe.scheduler)
        out["records"] = fe._lockstep.records
        out["captures"] = eng.graph_stats()["captures"]
        return out
    sched = follow(eng)
    return {"finished": chip_smoke.finished_tokens(sched),
            "overlap": sched.overlap}


def job_tp_refusals(weights):
    """The combinations a tp engine refuses: the fleet, the disaggregated
    pair, a front end on a rank other than 0, and ``follow`` on rank 0
    (each ValueError's message)."""
    from paddle_tpu_torch import distributed as D
    from paddle_tpu_torch.serving import (DisaggScheduler, Router,
                                          ServingFrontend, follow)
    from _torch_dist import tp_engine
    _m, eng = tp_engine(weights, 2, num_slots=2)
    _m, other = tp_engine(weights, 2, num_slots=2)
    out = {}
    for name, fn in (("router", lambda: Router([eng], probe_interval=None)),
                     ("frontend_router", lambda: ServingFrontend(
                         router=Router([eng], probe_interval=None))),
                     ("disagg", lambda: DisaggScheduler(eng, other)),
                     ("frontend_disagg", lambda: ServingFrontend(
                         eng, prefill_engine=other)),
                     ("frontend" if D.get_rank() else "follow",
                      (lambda: ServingFrontend(eng)) if D.get_rank()
                      else (lambda: follow(eng)))):
        try:
            fn()
            out[name] = None
        except ValueError as e:
            out[name] = str(e)
    return out


def vanish_main(rank, port, weights, leader_timeout, results):
    """The vanishing-rank-0 check, one process of a fresh world of two:
    rank 0 serves one request over HTTP, then ends its process without
    stopping; rank 1 follows with ``leader_timeout`` and reports how it
    ended (it may also be ended by ``follow``'s watchdog)."""
    import datetime
    import os
    import time
    import traceback

    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    os.environ.update(PADDLE_TRAINER_ID=str(rank), PADDLE_TRAINERS_NUM="2",
                      PADDLE_MASTER="127.0.0.1:%d" % port)
    dist.init_process_group("gloo", init_method="tcp://127.0.0.1:%d" % port,
                            rank=rank, world_size=2,
                            timeout=datetime.timedelta(seconds=120))
    from paddle_tpu_torch.distributed import init_parallel_env
    from paddle_tpu_torch.serving import LeaderLost, ServingFrontend, follow
    from _torch_dist import tp_engine
    init_parallel_env(backend="gloo", device="cpu")
    _m, eng = tp_engine(weights, 2, num_slots=2)
    if rank == 0:
        fe = ServingFrontend(eng)
        fe.start()
        toks, _done = post(fe.host, fe.port, payload([1, 2, 3], 3))
        results.put(("leader", len(toks)))
        results.close()
        results.join_thread()    # flushed before the process vanishes
        os._exit(0)
    t0 = time.monotonic()
    try:
        follow(eng, leader_timeout=leader_timeout)
        results.put(("follower", "returned", time.monotonic() - t0))
        code = 0
    except LeaderLost as e:
        results.put(("follower", "LeaderLost: %s" % e,
                     time.monotonic() - t0))
        code = 2
    except BaseException:
        results.put(("follower", traceback.format_exc(),
                     time.monotonic() - t0))
        code = 1
    results.close()
    results.join_thread()
    os._exit(code)
