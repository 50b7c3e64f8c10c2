"""Distributed launch CLI (port of ``paddle_tpu/distributed/launch_main.py``;
reference: python/paddle/distributed/launch/main.py:18 +
launch/controllers/collective.py — spawn a node's workers, wire the
cluster env, write per-rank logs; elastic restart per
fleet/elastic/manager.py:130).

One process a rank on ``torch.distributed``: ``--nproc_per_node`` workers
on this node (one a card with NCCL; several on one card, or on the CPU,
with gloo).  ``--nproc_per_node`` defaults to 1, as in the JAX package.

Usage::

    python -m paddle_tpu_torch.distributed.launch_main \
        [--nnodes 1] [--node_rank 0] [--nproc_per_node N] \
        [--master host:port] [--log_dir log] \
        [--elastic] [--max_restarts 3] \
        training_script [args...]

Env contract given to every worker (reference names, launch/controllers):
``PADDLE_TRAINER_ID`` (global rank), ``PADDLE_TRAINERS_NUM`` (world size),
``PADDLE_MASTER`` (only with ``--master``), ``PADDLE_LOCAL_RANK``,
``PADDLE_CURRENT_ENDPOINT``, ``PADDLE_TRAINER_ENDPOINTS``;
``init_parallel_env`` reads them (``parallel_base.py``), and needs
``--master`` (a free port) for a world above one.  With ``--elastic``, a
worker that dies is restarted (up to ``--max_restarts`` times) and is
expected to resume from its newest checkpoint (the auto-resume of
``incubate.checkpoint``); a worker that leaves with ``PREEMPTED_RC``
after an emergency checkpoint is restarted without using that budget.
"""
from __future__ import annotations

import argparse
import os
import signal
import subprocess
import sys
import time
from typing import List, Optional

from ..robustness.faultpoints import declare as _declare, faultpoint
from ..robustness.preemption import PREEMPTED_RC

__all__ = ["main", "Launcher"]

_declare("launch.respawn",
         "fires before an elastic worker respawn (rc + local_rank in ctx)")

#: crash-loop backoff ceiling — doubling stops here
_MAX_RESTART_DELAY = 60.0


def _parse(argv):
    p = argparse.ArgumentParser(
        prog="paddle_tpu_torch.distributed.launch",
        description="paddle_tpu_torch distributed launcher")
    p.add_argument("--nnodes", type=int,
                   default=int(os.getenv("PADDLE_NNODES", "1")))
    p.add_argument("--node_rank", type=int,
                   default=int(os.getenv("PADDLE_NODE_RANK", "0")))
    p.add_argument("--nproc_per_node", type=int,
                   default=int(os.getenv("PADDLE_NPROC_PER_NODE", "1")))
    p.add_argument("--master", type=str,
                   default=os.getenv("PADDLE_MASTER", ""))
    p.add_argument("--ips", type=str,
                   default=os.getenv("PADDLE_NODE_IPS", ""),
                   help="comma-separated node hostnames/IPs, one per node "
                        "(required for --nnodes > 1)")
    p.add_argument("--log_dir", type=str, default="log")
    p.add_argument("--elastic", action="store_true",
                   help="restart dead workers (fleet/elastic semantics)")
    p.add_argument("--max_restarts", type=int, default=3)
    p.add_argument("--poll_interval", type=float, default=0.2)
    p.add_argument("--restart_delay", type=float, default=1.0,
                   help="base delay before an elastic respawn; doubled per "
                        "consecutive fast failure (crash-loop backoff)")
    p.add_argument("--healthy_interval", type=float, default=30.0,
                   help="a worker alive at least this long resets its "
                        "crash-loop backoff to --restart_delay")
    p.add_argument("script", type=str)
    p.add_argument("script_args", nargs=argparse.REMAINDER)
    return p.parse_args(argv)


class Launcher:
    """Spawns + supervises this node's worker processes."""

    def __init__(self, nnodes=1, node_rank=0, nproc_per_node=1, master="",
                 ips="", log_dir="log", elastic=False, max_restarts=3,
                 poll_interval=0.2, restart_delay=1.0,
                 healthy_interval=30.0):
        self.nnodes = nnodes
        self.node_rank = node_rank
        self.nproc = nproc_per_node
        self.master = master
        self.ips = [h for h in ips.split(",") if h] if ips else []
        if nnodes > 1 and len(self.ips) != nnodes:
            raise ValueError(
                f"--nnodes {nnodes} needs --ips with exactly {nnodes} "
                "hostnames (endpoints cannot be 127.0.0.1 across nodes)")
        self.log_dir = log_dir
        self.elastic = elastic
        self.max_restarts = max_restarts
        self.poll_interval = poll_interval
        self.restart_delay = restart_delay
        self.healthy_interval = healthy_interval
        self.world_size = nnodes * nproc_per_node
        self._procs: List[Optional[subprocess.Popen]] = []
        self._logs: List = []
        self._restarts = [0] * nproc_per_node
        # crash-loop backoff state: next respawn delay + last spawn time,
        # per local worker; backoff_log records every applied delay (the
        # chaos tests assert the doubling schedule from it)
        self._delay = [restart_delay] * nproc_per_node
        self._spawned_at = [0.0] * nproc_per_node
        self.backoff_log: List[float] = []   # crash-backoff delays applied
        self.preempt_respawns = 0            # budget-free preempt restarts

    # -- env wiring ---------------------------------------------------------
    def _worker_env(self, local_rank: int) -> dict:
        rank = self.node_rank * self.nproc + local_rank
        env = dict(os.environ)
        base_port = int(os.getenv("PADDLE_WORKER_PORT_BASE", "6170"))

        def host_of(r):
            return self.ips[r // self.nproc] if self.ips else "127.0.0.1"

        endpoints = ",".join(
            f"{host_of(r)}:{base_port + r % self.nproc}"
            for r in range(self.world_size))
        env.update({
            "PADDLE_TRAINER_ID": str(rank),
            "PADDLE_TRAINERS_NUM": str(self.world_size),
            "PADDLE_LOCAL_RANK": str(local_rank),
            "PADDLE_RANK_IN_NODE": str(local_rank),
            "PADDLE_CURRENT_ENDPOINT":
                f"{host_of(rank)}:{base_port + local_rank}",
            "PADDLE_TRAINER_ENDPOINTS": endpoints,
            "PADDLE_RESTART_COUNT": str(self._restarts[local_rank]),
        })
        if self.master:
            env["PADDLE_MASTER"] = self.master
        return env

    # -- process control ----------------------------------------------------
    def _start_one(self, local_rank: int, cmd: List[str]):
        rank = self.node_rank * self.nproc + local_rank
        os.makedirs(self.log_dir, exist_ok=True)
        log = open(os.path.join(self.log_dir, f"workerlog.{rank}"), "ab",
                   buffering=0)
        proc = subprocess.Popen(cmd, env=self._worker_env(local_rank),
                                stdout=log, stderr=subprocess.STDOUT)
        self._spawned_at[local_rank] = time.time()
        return proc, log

    def run(self, cmd: List[str]) -> int:
        """Start all local workers and supervise until done.  Returns the
        job exit code (0 = every worker exited 0)."""
        self._procs, self._logs = [], []
        for lr in range(self.nproc):
            p, log = self._start_one(lr, cmd)
            self._procs.append(p)
            self._logs.append(log)
        try:
            return self._supervise(cmd)
        finally:
            self._kill_all()
            for log in self._logs:
                try:
                    log.close()
                except Exception:
                    pass

    def _respawn(self, lr: int, cmd, rc: int):
        faultpoint("launch.respawn", local_rank=lr, rc=rc)
        p, log = self._start_one(lr, cmd)
        self._procs[lr] = p
        try:
            # close the dead worker's log handle before replacing it —
            # appending leaked one fd per restart across long elastic runs
            self._logs[lr].close()
        except Exception:
            pass
        self._logs[lr] = log

    def _supervise(self, cmd) -> int:
        live = set(range(self.nproc))
        # lr -> (monotonic respawn deadline, rc): crash-loop backoff is a
        # per-worker DEADLINE, not an inline sleep — supervision of every
        # other worker (including "abort the job on a non-elastic death")
        # keeps polling while one worker waits out its backoff
        pending = {}
        while live:
            time.sleep(self.poll_interval)
            now = time.monotonic()
            for lr in sorted(pending):
                when, rc = pending[lr]
                if now >= when:
                    del pending[lr]
                    self._respawn(lr, cmd, rc)
            for lr in sorted(live):
                if lr in pending:
                    continue  # dead, waiting out its backoff
                rc = self._procs[lr].poll()
                if rc is None:
                    continue
                if rc == 0:
                    live.discard(lr)
                    continue
                # worker death (reference: elastic watch → restart)
                if self.elastic and rc == PREEMPTED_RC:
                    # the worker drained an emergency checkpoint and left on
                    # preemption notice — restart-eligible, NOT a crash: it
                    # consumes no restart budget.  It still rides the
                    # delay/doubling machinery (budget-free): a scheduler
                    # draining the node SIGTERMs every fresh incarnation,
                    # and an undelayed respawn loop would hammer the shared
                    # checkpoint filesystem with emergency saves
                    uptime = time.time() - self._spawned_at[lr]
                    if uptime >= self.healthy_interval:
                        self._delay[lr] = self.restart_delay
                    delay = self._delay[lr]
                    self.preempt_respawns += 1
                    sys.stderr.write(
                        f"[launch] worker {lr} preempted (rc={rc}) after "
                        f"{uptime:.1f}s; restarting in {delay:.1f}s "
                        "without consuming restart budget\n")
                    pending[lr] = (now + delay, rc)
                    if uptime < self.healthy_interval:
                        self._delay[lr] = min(delay * 2, _MAX_RESTART_DELAY)
                elif self.elastic and self._restarts[lr] < self.max_restarts:
                    uptime = time.time() - self._spawned_at[lr]
                    if uptime >= self.healthy_interval:
                        # it ran long enough to be considered healthy before
                        # dying — not a crash loop; restart promptly
                        self._delay[lr] = self.restart_delay
                    self._restarts[lr] += 1
                    delay = self._delay[lr]
                    sys.stderr.write(
                        f"[launch] worker {lr} exited rc={rc} after "
                        f"{uptime:.1f}s; elastic restart "
                        f"{self._restarts[lr]}/{self.max_restarts} in "
                        f"{delay:.1f}s\n")
                    self.backoff_log.append(delay)
                    pending[lr] = (now + delay, rc)
                    if uptime < self.healthy_interval:
                        # consecutive fast failure: double toward the cap so
                        # a crash-looping worker cannot hot-spin through
                        # max_restarts (and hammer the store/cluster)
                        self._delay[lr] = min(delay * 2, _MAX_RESTART_DELAY)
                else:
                    sys.stderr.write(
                        f"[launch] worker {lr} exited rc={rc}; aborting job\n")
                    return rc
        return 0

    def _kill_all(self):
        for p in self._procs:
            if p is not None and p.poll() is None:
                try:
                    p.send_signal(signal.SIGTERM)
                except Exception:
                    pass
        deadline = time.time() + 5
        for p in self._procs:
            if p is None:
                continue
            while p.poll() is None and time.time() < deadline:
                time.sleep(0.05)
            if p.poll() is None:
                try:
                    p.kill()
                except Exception:
                    pass


def main(argv=None) -> int:
    args = _parse(sys.argv[1:] if argv is None else argv)
    cmd = [sys.executable, args.script] + args.script_args
    launcher = Launcher(
        nnodes=args.nnodes, node_rank=args.node_rank,
        nproc_per_node=args.nproc_per_node, master=args.master,
        ips=args.ips, log_dir=args.log_dir, elastic=args.elastic,
        max_restarts=args.max_restarts, poll_interval=args.poll_interval,
        restart_delay=args.restart_delay,
        healthy_interval=args.healthy_interval)
    return launcher.run(cmd)


if __name__ == "__main__":
    sys.exit(main())
