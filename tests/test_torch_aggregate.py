"""paddle_tpu_torch's cross-host telemetry against ``paddle_tpu``'s,
after the aggregation cases of ``tests/test_liveness.py``: the same
snapshots give the same ``merge_docs`` cluster view and straggler flags
(the ``liveness.straggler{host=}`` gauge included), through threshold,
missing, paceless and stalled hosts and the printed table; a host's
snapshot published through the port's store is read by the JAX
package's ``fetch_cluster`` and the other way round; the publisher's
thread publishes on its interval and at exit, and its stop stays bounded
with no final publish racing a wedged one."""
import threading
import time

import pytest

from paddle_tpu.distributed import store as jax_store_mod
from paddle_tpu.observability import aggregate as jax_agg
from paddle_tpu_torch.distributed.store import TCPStore
from paddle_tpu_torch.observability import aggregate, liveness
from paddle_tpu_torch.observability import registry as reg_mod


def _doc(host, p50, count=10, ts=None, stalled=(), fmt=None,
         metric="train.step_seconds"):
    return {
        "format": fmt or "paddle_tpu-telemetry-v1",
        "host": host, "pid": 1,
        "wall_ts": time.time() if ts is None else ts,
        "beacons": {n: {"count": 1, "inflight": 1, "age_s": 9.9,
                        "deadline_s": 1.0, "stalled": True}
                    for n in stalled},
        "step_times": ({metric: {
            "count": count, "sum": p50 * count, "p50": p50,
            "p95": p50 * 1.1, "p99": p50 * 1.2}} if p50 is not None
            else {}),
        "stalls": {}, "metrics": {},
    }


def _strip(doc):
    """The merged document without its wall-clock fields."""
    out = {k: v for k, v in doc.items() if k != "wall_ts"}
    out["hosts"] = {h: {k: v for k, v in row.items()
                        if k not in ("staleness_s",)}
                    for h, row in doc["hosts"].items()}
    return out


CASES = {
    "straggler": ({0: _doc(0, 0.10), 1: _doc(1, 0.11), 2: _doc(2, 0.30)},
                  4, 25.0),
    "threshold": ({0: _doc(0, 0.10), 1: _doc(1, 0.125)}, 2, 25.0),
    "single": ({0: _doc(0, 0.5)}, 1, None),
    "paceless": ({0: _doc(0, 0.1), 1: _doc(1, 0.3), 2: _doc(2, None)}, 3,
                 None),
    "stalled": ({0: _doc(0, 0.1, stalled=("serve.scheduler_step",)),
                 1: _doc(1, 0.1, metric="serving.decode_step_seconds")},
                2, 10.0),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_merge_docs_equals_jax(case):
    """The same snapshots give the same cluster view, straggler flags and
    table in both packages."""
    docs, world, pct = CASES[case]
    got = aggregate.merge_docs(docs, world, pct=pct)
    want = jax_agg.merge_docs(docs, world, pct=pct, set_gauges=False)
    assert _strip(got) == _strip(want)
    assert aggregate.format_cluster(got).splitlines()[1:] == \
        jax_agg.format_cluster(want).splitlines()[1:]


def test_straggler_gauge_set_per_host():
    docs, world, pct = CASES["straggler"]
    merged = aggregate.merge_docs(docs, world, pct=pct)
    assert merged["stragglers"] == [2] and merged["missing"] == [3]
    snap = reg_mod.default_registry().snapshot()
    series = {s["labels"]["host"]: s["value"]
              for s in snap["liveness.straggler"]["series"]}
    assert series["2"] == 1.0 and series["0"] == 0.0
    assert "STRAGGLER" in aggregate.format_cluster(merged)


def test_host_snapshot_carries_step_times_and_beacons():
    reg_mod.default_registry().histogram(
        "serving.decode_step_seconds").observe(0.0123)
    liveness.enable(start=False)
    try:
        liveness.declare_beacon("test.pub", "suite probe")
        with liveness.beacon("test.pub"):
            doc = aggregate.host_snapshot(0)
    finally:
        liveness.disable()
    assert doc["format"] == "paddle_tpu-telemetry-v1"
    assert doc["step_times"]["serving.decode_step_seconds"]["count"] >= 1
    assert doc["beacons"]["test.pub"]["inflight"] == 1
    assert "serving.decode_step_seconds" in doc["metrics"]


@pytest.mark.parametrize("master_pkg", ["torch", "jax"])
def test_publish_and_merge_across_packages(monkeypatch, master_pkg):
    """A port host and a JAX host publish into one store; either
    package's merge lists both hosts, and the missing third."""
    monkeypatch.setattr(jax_store_mod._native, "load", lambda: None)
    stores = {"torch": TCPStore, "jax": jax_store_mod.TCPStore}
    master = stores[master_pkg]("127.0.0.1", 0, is_master=True,
                                world_size=3)
    aggregate.HostPublisher(TCPStore("127.0.0.1", master.port),
                            host=0, interval=999.0).publish_once()
    jax_agg.HostPublisher(jax_store_mod.TCPStore("127.0.0.1", master.port),
                          host=1, interval=999.0).publish_once()
    for merge in (aggregate.merge_cluster, jax_agg.merge_cluster):
        merged = merge(stores[master_pkg]("127.0.0.1", master.port), 3,
                       set_gauges=False)
        assert sorted(merged["hosts"]) == [0, 1]
        assert merged["missing"] == [2]


def test_publisher_thread_loop_and_final_publish():
    master = TCPStore("127.0.0.1", 0, is_master=True, world_size=1)
    pub = aggregate.HostPublisher(TCPStore("127.0.0.1", master.port),
                                  host=3, interval=0.02)
    pub.start()
    deadline = time.time() + 5.0
    while pub.published < 2 and time.time() < deadline:
        time.sleep(0.01)
    pub.stop()
    assert pub.published >= 3
    docs, missing = aggregate.fetch_cluster(
        TCPStore("127.0.0.1", master.port), 4)
    assert 3 in docs and missing == [0, 1, 2]


class _WedgedStore:
    def __init__(self, delay):
        self.delay = delay
        self.active = 0
        self.max_active = 0
        self._lock = threading.Lock()

    def set(self, key, value):
        with self._lock:
            self.active += 1
            self.max_active = max(self.max_active, self.active)
        time.sleep(self.delay)
        with self._lock:
            self.active -= 1


def test_publisher_stop_bounded_and_final_never_races_wedged_loop():
    store = _WedgedStore(delay=0.6)
    pub = aggregate.HostPublisher(store, host=0, interval=0.01).start()
    deadline = time.time() + 5.0
    while store.active == 0 and time.time() < deadline:
        time.sleep(0.005)
    assert store.active == 1
    t0 = time.time()
    pub.stop(timeout=0.05, final=True)
    assert time.time() - t0 < 0.5
    assert store.max_active == 1


def test_garbage_and_foreign_documents_count_as_missing():
    master = TCPStore("127.0.0.1", 0, is_master=True, world_size=3)
    c = TCPStore("127.0.0.1", master.port)
    c.set(aggregate.KEY_PREFIX + "0", b"not json")
    import json
    c.set(aggregate.KEY_PREFIX + "1",
          json.dumps(_doc(1, 0.1, fmt="other-v9")).encode())
    docs, missing = aggregate.fetch_cluster(c, 3)
    assert docs == {} and missing == [0, 1, 2]
