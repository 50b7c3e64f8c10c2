"""The port's launcher (``distributed/launch_main.py``) and elastic
manager (``distributed/fleet/elastic``), after
``tests/test_launch_elastic.py`` and the launcher cases of
``tests/test_chaos.py``: the ``PADDLE_*`` environment equal to the JAX
package's ``Launcher`` for the same arguments (one node and two), the
env wiring and per-rank logs of a two-worker run, failure propagation,
an elastic restart that resumes from the checkpoint (the tiny GPT on the
CPU through ``tools/torch_launch_worker.py``) with the resumed steps
equal to the reference run's, crash-loop backoff doubling and resetting
after a healthy uptime, a ``PREEMPTED_RC`` restart that costs no budget
(and propagates without ``--elastic``), and ``ElasticManager``
membership, scale-down re-planning with training resumed at the new
world size and scale-up, on both store backends.  Workers are small
processes that import the port only; backoff delays are tens of
milliseconds."""
import json
import os
import subprocess
import sys
import textwrap
import time

import pytest

from paddle_tpu.distributed.launch_main import Launcher as JaxLauncher
import paddle_tpu_torch.distributed as tdist
from paddle_tpu_torch.distributed import fleet as tfleet
from paddle_tpu_torch.distributed.fleet.elastic import (ElasticManager,
                                                        ElasticStatus)
from paddle_tpu_torch.distributed.launch_main import Launcher, main
from paddle_tpu_torch.distributed import store as port_store_mod
from paddle_tpu_torch.distributed.store import TCPStore
from paddle_tpu_torch.robustness import faultpoints as fp
from paddle_tpu_torch.robustness.preemption import PREEMPTED_RC

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tools", "torch_launch_worker.py")


def _launcher(tmp_path, **kw):
    kw.setdefault("log_dir", os.path.join(str(tmp_path), "log"))
    return Launcher(**kw)


def test_sites_and_entry_points():
    assert "launch.respawn" in fp.SITES
    assert tdist.launch.Launcher is Launcher and tdist.launch.main is main
    assert tfleet.elastic.ElasticManager is ElasticManager


@pytest.mark.parametrize("kw", [
    dict(nproc_per_node=2),
    dict(nproc_per_node=1, master="10.0.0.1:6000"),
    dict(nnodes=2, node_rank=1, nproc_per_node=2, ips="hostA,hostB",
         master="hostA:6000")], ids=["one_node", "master", "two_nodes"])
def test_worker_env_equals_jax(monkeypatch, kw):
    monkeypatch.setenv("PADDLE_WORKER_PORT_BASE", "7100")
    ours, theirs = Launcher(**kw), JaxLauncher(**kw)
    for lr in range(kw["nproc_per_node"]):
        assert ours._worker_env(lr) == theirs._worker_env(lr)
    ours._restarts[0] = theirs._restarts[0] = 2
    assert ours._worker_env(0) == theirs._worker_env(0)
    assert ours.world_size == theirs.world_size


def test_multi_node_needs_ips():
    with pytest.raises(ValueError, match="--ips"):
        Launcher(nnodes=2, ips="onlyone")


def test_launch_env_wiring(tmp_path):
    """Workers receive rank/world/endpoint env and logs land per rank."""
    script = os.path.join(str(tmp_path), "worker.py")
    with open(script, "w") as f:
        f.write(textwrap.dedent("""
            import json, os, sys
            out = {k: os.environ.get(k) for k in (
                "PADDLE_TRAINER_ID", "PADDLE_TRAINERS_NUM",
                "PADDLE_LOCAL_RANK", "PADDLE_CURRENT_ENDPOINT",
                "PADDLE_TRAINER_ENDPOINTS", "PADDLE_MASTER")}
            with open(sys.argv[1] + "/env." +
                      os.environ["PADDLE_TRAINER_ID"], "w") as fh:
                json.dump(out, fh)
            print("worker", os.environ["PADDLE_TRAINER_ID"], "done")
        """))
    log_dir = os.path.join(str(tmp_path), "log")
    launcher = Launcher(nproc_per_node=2, log_dir=log_dir,
                        master="127.0.0.1:6123", poll_interval=0.02)
    assert launcher.run([sys.executable, script, str(tmp_path)]) == 0
    for rank in (0, 1):
        with open(os.path.join(str(tmp_path), f"env.{rank}")) as f:
            got = json.load(f)
        assert got["PADDLE_TRAINER_ID"] == str(rank)
        assert got["PADDLE_TRAINERS_NUM"] == "2"
        assert got["PADDLE_LOCAL_RANK"] == str(rank)
        assert got["PADDLE_CURRENT_ENDPOINT"].startswith("127.0.0.1:")
        assert len(got["PADDLE_TRAINER_ENDPOINTS"].split(",")) == 2
        assert got["PADDLE_MASTER"] == "127.0.0.1:6123"
        log = os.path.join(log_dir, f"workerlog.{rank}")
        assert f"worker {rank} done" in open(log).read()


def test_launch_propagates_failure(tmp_path):
    script = os.path.join(str(tmp_path), "bad.py")
    with open(script, "w") as f:
        f.write("import sys; sys.exit(3)\n")
    launcher = _launcher(tmp_path, nproc_per_node=2, poll_interval=0.02)
    assert launcher.run([sys.executable, script]) == 3


def test_main_parses_the_cli(tmp_path):
    script = os.path.join(str(tmp_path), "ok.py")
    with open(script, "w") as f:
        f.write("import sys; print('args', sys.argv[1:])\n")
    log_dir = os.path.join(str(tmp_path), "log")
    assert main(["--log_dir", log_dir, "--poll_interval", "0.02", script,
                 "x", "--y"]) == 0
    assert "args ['x', '--y']" in open(os.path.join(log_dir,
                                                    "workerlog.0")).read()


def _tiny_spec(workdir, **kw):
    spec = dict(workdir=workdir, device="cpu",
                model=dict(vocab_size=512, max_position_embeddings=128,
                           hidden_size=64, num_hidden_layers=2,
                           num_attention_heads=4, intermediate_size=128,
                           hidden_dropout_prob=0.1,
                           attention_dropout_prob=0.1),
                seed=0, rows_seed=1, batch=4, seq=32, steps=6, lr=1e-3,
                amp=False, use_pallas_norm=False, num_workers=2,
                mode="elastic")
    spec.update(kw)
    os.makedirs(workdir, exist_ok=True)
    path = os.path.join(workdir, "spec.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    return path


def test_elastic_restart_resumes_from_checkpoint(tmp_path):
    """A worker dies after its step-2 checkpoint; the elastic launcher
    restarts it, it resumes at step 3 from the checkpoint and the data
    cursor, and its losses (dropout 0.1) equal the uninterrupted run's
    bit for bit."""
    def run(tag, **kw):
        workdir = os.path.join(str(tmp_path), tag)
        launcher = _launcher(workdir, nproc_per_node=1, elastic=True,
                             max_restarts=2, restart_delay=0.02,
                             poll_interval=0.02)
        rc = launcher.run([sys.executable, WORKER,
                           _tiny_spec(workdir, **kw)])
        assert rc == 0, open(os.path.join(workdir, "log",
                                          "workerlog.0")).read()[-3000:]
        return launcher, workdir
    _, ref_dir = run("ref")
    launcher, crash_dir = run("crash", crash_at=3)
    assert launcher.backoff_log == [0.02]
    with open(os.path.join(ref_dir, "result-0-0.json")) as f:
        ref = json.load(f)
    with open(os.path.join(crash_dir, "result-0-1.json")) as f:
        got = json.load(f)
    assert got["resumed_at"] == 3 and got["restored_epoch"] == 2
    assert got["restored_cursor"] == {"epoch": 0, "batch": 3}
    assert got["route"] == "shm"
    assert got["losses"] == {str(s): ref["losses"][str(s)]
                             for s in range(3, 6)}
    assert not os.path.exists(os.path.join(crash_dir, "result-0-0.json"))


def test_launcher_crash_loop_backoff_doubles(tmp_path):
    script = os.path.join(str(tmp_path), "crash.py")
    with open(script, "w") as f:
        f.write("import sys; sys.exit(3)\n")
    launcher = _launcher(tmp_path, nproc_per_node=1, elastic=True,
                         max_restarts=3, restart_delay=0.05,
                         healthy_interval=100.0, poll_interval=0.02)
    assert launcher.run([sys.executable, script]) == 3
    assert launcher.backoff_log == [0.05, 0.1, 0.2]
    assert launcher._restarts[0] == 3


def test_launcher_backoff_resets_after_healthy_uptime(tmp_path):
    script = os.path.join(str(tmp_path), "crash2.py")
    with open(script, "w") as f:
        f.write("import sys; sys.exit(3)\n")
    launcher = _launcher(tmp_path, nproc_per_node=1, elastic=True,
                         max_restarts=3, restart_delay=0.05,
                         healthy_interval=0.0, poll_interval=0.02)
    assert launcher.run([sys.executable, script]) == 3
    assert launcher.backoff_log == [0.05, 0.05, 0.05]


def test_launcher_preempted_rc_restart_without_budget(tmp_path):
    script = os.path.join(str(tmp_path), "preempt_once.py")
    marker = os.path.join(str(tmp_path), "ran.marker")
    with open(script, "w") as f:
        f.write(textwrap.dedent(f"""
            import os, sys
            marker = {marker!r}
            if not os.path.exists(marker):
                open(marker, "w").close()
                sys.exit({PREEMPTED_RC})
            sys.exit(0)
        """))
    launcher = _launcher(tmp_path, nproc_per_node=1, elastic=True,
                         max_restarts=0, restart_delay=0.05,
                         poll_interval=0.02)
    assert launcher.run([sys.executable, script]) == 0
    assert launcher._restarts[0] == 0
    assert launcher.backoff_log == []
    assert launcher.preempt_respawns == 1


def test_launcher_preempted_rc_propagates_without_elastic(tmp_path):
    script = os.path.join(str(tmp_path), "preempt.py")
    with open(script, "w") as f:
        f.write(f"import sys; sys.exit({PREEMPTED_RC})\n")
    launcher = _launcher(tmp_path, nproc_per_node=1, elastic=False,
                         poll_interval=0.02)
    assert launcher.run([sys.executable, script]) == PREEMPTED_RC


def test_kill_all_terminates_the_others(tmp_path):
    """A non-elastic death aborts the job: the surviving worker is sent
    SIGTERM (then killed) and the launcher returns the dead one's rc."""
    script = os.path.join(str(tmp_path), "one_dies.py")
    with open(script, "w") as f:
        f.write(textwrap.dedent("""
            import os, sys, time
            if os.environ["PADDLE_TRAINER_ID"] == "1":
                sys.exit(5)
            time.sleep(60)
        """))
    launcher = _launcher(tmp_path, nproc_per_node=2, poll_interval=0.02)
    t0 = time.monotonic()
    assert launcher.run([sys.executable, script]) == 5
    assert time.monotonic() - t0 < 20
    assert all(p.poll() is not None for p in launcher._procs)


@pytest.fixture(params=["native", "python"])
def store_backend(request, monkeypatch):
    """The port's stores of the test on one backend: the native library,
    or the Python pair with the library's loader forced to fail (forked
    nodes inherit it)."""
    if request.param == "python":
        monkeypatch.setattr(port_store_mod._native, "load", lambda: None)
    return request.param


def test_elastic_manager_membership(store_backend):
    store = TCPStore("127.0.0.1", 0, is_master=True, world_size=1)
    assert store.backend == store_backend
    managers = [ElasticManager(store=store, job_id="j1", np_=2, node_rank=r,
                               heartbeat_interval=0.05, node_timeout=0.5)
                for r in range(2)]
    for m in managers:
        m.start()
    watcher = managers[0]
    assert watcher.wait_for_np(timeout=5)
    assert watcher.watch() == ElasticStatus.HOLD
    assert sorted(watcher.alive_nodes()) == [0, 1]
    managers[1].stop()
    deadline = time.time() + 5
    status = ElasticStatus.HOLD
    while time.time() < deadline:
        status = watcher.watch()
        if status == ElasticStatus.RESTART:
            break
        time.sleep(0.05)
    assert status == ElasticStatus.RESTART
    assert watcher.watch() == ElasticStatus.HOLD
    watcher.stop(completed=True)
    assert watcher.watch() == ElasticStatus.COMPLETED
    store.close()


def test_elastic_manager_default_store_from_env(monkeypatch):
    master = TCPStore("127.0.0.1", 0, is_master=True)
    monkeypatch.setenv("PADDLE_ELASTIC_SERVER", "127.0.0.1:%d" % master.port)
    monkeypatch.setenv("PADDLE_NODE_RANK", "1")
    monkeypatch.setenv("PADDLE_NNODES", "2")
    m = ElasticManager(job_id="env", heartbeat_interval=0.05)
    assert (m.np, m.node_rank, m.store.port) == (2, 1, master.port)
    assert not m.store.is_master
    m.start()
    assert master.get("elastic/env/nodes/1") == b"1"
    m.stop()
    m.store.close()
    master.close()


def test_elastic_replan_scale_down_resumes_training(tmp_path, store_backend):
    """Kill one of 3 nodes: the survivors RESTART, replan() to np=2 with
    dense re-ranking, and training resumes from the checkpoint at the new
    world size."""
    import multiprocessing as mp

    store = TCPStore("127.0.0.1", 0, is_master=True, world_size=1)
    assert store.backend == store_backend
    port = store.port
    workdir = str(tmp_path)
    total_steps = 14

    def node(rank, q):
        s = TCPStore("127.0.0.1", port, world_size=1)
        m = ElasticManager(store=s, job_id="replan", np_=3, node_rank=rank,
                           heartbeat_interval=0.05, node_timeout=0.4)
        m.start()
        assert m.wait_for_np(timeout=10)
        m.watch()
        world, my_rank = 3, rank
        ck = os.path.join(workdir, "step.json")
        log = []
        step = 0
        while step < total_steps:
            log.append((step, world, my_rank, 6 // world))
            if my_rank == 0:
                with open(ck + ".tmp", "w") as f:
                    json.dump({"step": step, "world": world}, f)
                os.replace(ck + ".tmp", ck)
            if rank == 2 and step == 4:
                os._exit(0)
            time.sleep(0.12)
            if m.watch() == ElasticStatus.RESTART:
                plan = m.replan()
                if plan["my_rank"] is None:
                    break
                world, my_rank = plan["np"], plan["my_rank"]
                with open(ck) as f:
                    step = json.load(f)["step"] + 1
                # the new world's rank 0 writes its first step only once
                # every survivor has read where the old world stopped
                s.world_size = world
                s.barrier("resume", timeout=10)
                continue
            step += 1
        m.stop(completed=(my_rank == 0 and step >= total_steps))
        q.put((rank, log))

    ctx = mp.get_context("fork")
    q = ctx.Queue()
    procs = [ctx.Process(target=node, args=(r, q)) for r in range(3)]
    for p in procs:
        p.start()
    results = {}
    for _ in range(2):
        r, log = q.get(timeout=60)
        results[r] = log
    for p in procs:
        p.join(10)
    for r in (0, 1):
        assert r in results, results.keys()
        assert {w for (_s, w, _mr, _sh) in results[r]} == {3, 2}
        shards = [sh for (_s, w, _mr, sh) in results[r] if w == 2]
        assert shards and all(sh == 3 for sh in shards)
        steps = [s for (s, *_rest) in results[r]]
        assert max(steps) == total_steps - 1
        assert sorted(set(steps)) == list(range(total_steps))
    store.close()


def test_elastic_replan_scale_up(store_backend):
    store = TCPStore("127.0.0.1", 0, is_master=True, world_size=1)
    assert store.backend == store_backend

    def mk(r):
        return ElasticManager(store=store, job_id="up", np_=2, node_rank=r,
                              heartbeat_interval=0.05, node_timeout=0.5,
                              max_np=3)
    m0, m1 = mk(0), mk(1)
    m0.start()
    m1.start()
    assert m0.wait_for_np(timeout=5)
    assert m0.watch() == ElasticStatus.HOLD
    m2 = mk(2)
    m2.start()
    deadline = time.time() + 5
    status = ElasticStatus.HOLD
    while time.time() < deadline and status == ElasticStatus.HOLD:
        time.sleep(0.1)
        status = m0.watch()
    assert status == ElasticStatus.RESTART
    plan = m0.replan()
    assert plan["np"] == 3 and plan["nodes"] == [0, 1, 2]
    assert plan["rank_map"] == {0: 0, 1: 1, 2: 2}
    for m in (m0, m1, m2):
        m.stop()
    store.close()


def test_python_m_launch_main_runs_a_job(tmp_path):
    """The user's command line: ``python -m
    paddle_tpu_torch.distributed.launch_main``."""
    script = os.path.join(str(tmp_path), "hello.py")
    with open(script, "w") as f:
        f.write("import os; print('rank', os.environ['PADDLE_TRAINER_ID'])\n")
    log_dir = os.path.join(str(tmp_path), "log")
    out = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch_main",
         "--nproc_per_node", "2", "--log_dir", log_dir, "--poll_interval",
         "0.02", script], capture_output=True, text=True, cwd=REPO,
        timeout=120)
    assert out.returncode == 0, out.stderr
    for r in (0, 1):
        assert "rank %d" % r in open(os.path.join(log_dir,
                                                  "workerlog.%d" % r)).read()
