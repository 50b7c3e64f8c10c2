"""Elastic training manager (port of
``paddle_tpu/distributed/fleet/elastic``; reference:
python/paddle/distributed/fleet/elastic/manager.py — ElasticManager:130,
watch loop :126, etcd node registry :190).

Membership lives in the port's TCPStore (``distributed/store.py``, native
or Python backend) instead of etcd.  Each node
heartbeats a timestamp key; the watch loop classifies the world as
HOLD (healthy), RESTART (membership changed — a node died or joined, the
job should relaunch workers and auto-resume from checkpoint), or
COMPLETED / EXIT.  The restart contract is incubate.checkpoint auto-resume:
a relaunched worker restores the newest complete checkpoint and
fast-forwards its data stream.
"""
from __future__ import annotations

import enum
import os
import threading
import time
from typing import Dict, List, Optional

__all__ = ["ElasticStatus", "ElasticManager"]


class ElasticStatus(enum.Enum):
    COMPLETED = "completed"
    HOLD = "hold"          # healthy, keep training
    RESTART = "restart"    # membership changed: relaunch + resume
    EXIT = "exit"          # stopped / max restarts exceeded
    ERROR = "error"


class ElasticManager:
    """Heartbeat membership over TCPStore.

    One manager per node.  ``start()`` registers the node and begins
    heartbeating; ``watch()`` returns the current ElasticStatus; a
    supervisor loop reacts to RESTART by relaunching workers (see
    launch_main.Launcher elastic mode for the in-node half).
    """

    def __init__(self, store=None, job_id: Optional[str] = None,
                 np_: Optional[int] = None, node_rank: Optional[int] = None,
                 heartbeat_interval: float = 0.5,
                 node_timeout: float = 3.0,
                 max_np: Optional[int] = None):
        if store is None:
            from ...store import TCPStore
            master = os.getenv("PADDLE_ELASTIC_SERVER",
                               os.getenv("PADDLE_MASTER", "127.0.0.1:0"))
            host, _, port = master.partition(":")
            is_master = int(os.getenv("PADDLE_NODE_RANK", "0")) == 0
            store = TCPStore(host or "127.0.0.1", int(port or 0),
                             is_master=is_master,
                             world_size=int(os.getenv("PADDLE_NNODES", "1")))
        self.store = store
        self.job_id = job_id or os.getenv("PADDLE_ELASTIC_JOB_ID", "default")
        self.np = np_ if np_ is not None else int(os.getenv(
            "PADDLE_NNODES", "1"))
        # scale-UP headroom (reference: PADDLE_ELASTIC_NP "min:max" range):
        # membership scans cover ranks up to max_np so a JOINING node's
        # heartbeat is visible to watch()/replan()
        self.max_np = max_np if max_np is not None else int(os.getenv(
            "PADDLE_ELASTIC_MAX_NP", str(self.np)))
        self.max_np = max(self.max_np, self.np)
        self.node_rank = node_rank if node_rank is not None else int(
            os.getenv("PADDLE_NODE_RANK", "0"))
        self.heartbeat_interval = heartbeat_interval
        self.node_timeout = node_timeout
        self._stop = threading.Event()
        self._hb_thread: Optional[threading.Thread] = None
        self._beat_n = 0
        # _beat runs on the caller's thread (start) and the heartbeat
        # thread; the counter bump must be atomic — the store.set stays
        # OUTSIDE the lock (blocking network I/O under a lock is TPU604)
        self._beat_lock = threading.Lock()
        self._last_alive: Optional[frozenset] = None
        # liveness is judged by heartbeat-value CHANGE against the watcher's
        # own clock — never by comparing remote wall clocks (cross-node skew
        # larger than node_timeout would otherwise declare healthy nodes
        # dead): {rank: (last_raw_value, watcher_time_first_seen)}
        self._hb_seen: Dict[int, tuple] = {}

    # -- key layout ----------------------------------------------------------
    def _k(self, *parts) -> str:
        return "/".join(("elastic", self.job_id) + tuple(str(p)
                                                         for p in parts))

    # -- lifecycle ------------------------------------------------------------
    def start(self):
        """Register this node and begin heartbeating (manager.py:190
        register + TTL refresh, minus etcd)."""
        self.store.set(self._k("nodes", self.node_rank), b"1")
        self._beat()
        self._hb_thread = threading.Thread(target=self._hb_loop, daemon=True,
                                           name="elastic-heartbeat")
        self._hb_thread.start()
        return self

    def _beat(self):
        # monotonically changing value; watchers detect liveness by change,
        # not by decoding it (clock-skew independent)
        with self._beat_lock:
            self._beat_n += 1
            n = self._beat_n
        self.store.set(self._k("hb", self.node_rank), str(n).encode())

    def _hb_loop(self):
        while not self._stop.wait(self.heartbeat_interval):
            try:
                self._beat()
            except Exception:
                return  # store gone: supervisor will notice via watch()

    def stop(self, completed: bool = False):
        self._stop.set()
        if self._hb_thread is not None:
            self._hb_thread.join(timeout=2)
        if completed:
            try:
                self.store.set(self._k("completed"), b"1")
            except Exception:
                pass

    # -- membership -----------------------------------------------------------
    def alive_nodes(self) -> List[int]:
        now = time.monotonic()
        alive = []
        for r in range(self.max_np):
            try:
                raw = self.store.get(self._k("hb", r), wait=False)
            except KeyError:
                continue
            last = self._hb_seen.get(r)
            if last is None or last[0] != raw:
                # value changed → the node beat since we last looked
                self._hb_seen[r] = (raw, now)
                alive.append(r)
            elif now - last[1] <= self.node_timeout:
                alive.append(r)
        return alive

    def watch(self) -> ElasticStatus:
        """One classification step of the reference's watch loop
        (manager.py:126)."""
        try:
            try:
                self.store.get(self._k("completed"), wait=False)
                return ElasticStatus.COMPLETED
            except KeyError:
                pass
            alive = frozenset(self.alive_nodes())
        except Exception:
            return ElasticStatus.ERROR
        if self._last_alive is None:
            self._last_alive = alive
            return ElasticStatus.HOLD
        if alive != self._last_alive:
            self._last_alive = alive
            return ElasticStatus.RESTART
        return ElasticStatus.HOLD

    # -- re-planning ----------------------------------------------------------
    def replan(self) -> Dict:
        """Recompute the topology after a RESTART (reference
        manager.py:130: the trainer list is REWRITTEN on scale-up/down, not
        merely restarted at the old world size).

        Dense re-rank of the currently-alive nodes: returns
        ``{"np": new_world, "nodes": [old ranks alive], "rank_map":
        {old: new}, "my_rank": new rank or None}`` — ``my_rank is None``
        means this node was evicted (or died) and must exit.  The caller
        relaunches its workers with the new world size/endpoints and
        resumes from the newest checkpoint (incubate.checkpoint).
        """
        alive = sorted(self.alive_nodes())
        rank_map = {old: new for new, old in enumerate(alive)}
        return {"np": len(alive), "nodes": alive, "rank_map": rank_map,
                "my_rank": rank_map.get(self.node_rank)}

    # -- convenience ----------------------------------------------------------
    def wait_for_np(self, timeout: float = 60.0) -> bool:
        """Block until all np nodes heartbeat (job-start rendezvous)."""
        deadline = time.time() + timeout
        while time.time() < deadline:
            if len(self.alive_nodes()) >= self.np:
                return True
            time.sleep(self.heartbeat_interval)
        return False
