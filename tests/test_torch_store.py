"""paddle_tpu_torch's TCPStore against ``paddle_tpu``'s, after the store
cases of ``tests/test_chaos.py``: the pure-Python server and client on
the JAX package's wire protocol, a port client against a JAX master and
a JAX client against a port master (set, get, add, wait, barrier), ops
surviving injected socket resets at the ``store.client_op`` site, a typed
exhaustion, an ``add`` whose reply was lost surfacing as
``StoreReplyLostError`` and never reissued, a reconnect after a real
socket death, and wait and barrier timeouts that name what they waited
for."""
import socket
import threading
import time

import pytest

from paddle_tpu.distributed import store as jax_store_mod
from paddle_tpu_torch.distributed.store import (StoreReplyLostError,
                                                TCPStore)
from paddle_tpu_torch.observability.liveness import BEACONS
from paddle_tpu_torch.robustness import faultpoints as fp
from paddle_tpu_torch.robustness.retry import RetryError


@pytest.fixture
def jax_py(monkeypatch):
    """The JAX package's TCPStore on its pure-Python server and client
    (its native library is not built here, and the port never loads
    it)."""
    monkeypatch.setattr(jax_store_mod._native, "load", lambda: None)
    return jax_store_mod.TCPStore


@pytest.fixture
def store():
    s = TCPStore("127.0.0.1", 0, is_master=True, world_size=1)
    yield s
    s.close()


def test_site_and_beacon_declared():
    assert "store.client_op" in fp.SITES and "store.op" in BEACONS


@pytest.mark.parametrize("master,client", [("torch", "jax"),
                                           ("jax", "torch")])
def test_interop_both_ways(jax_py, master, client):
    """One package's master, the other package's client: every op sees
    the other side's writes, byte for byte."""
    cls = {"torch": TCPStore, "jax": jax_py}
    m = cls[master]("127.0.0.1", 0, is_master=True, world_size=2)
    c = cls[client]("127.0.0.1", m.port, world_size=2)
    c.set("k", b"\x00\x01binary\xff")
    assert m.get("k") == b"\x00\x01binary\xff"
    m.set("s", "text")
    assert c.get("s") == b"text"
    assert c.add("n", 5) == 5 and m.add("n", -2) == 3 and c.add("n", 0) == 3
    with pytest.raises(KeyError):
        c.get("absent", wait=False)
    threading.Timer(0.2, lambda: m.set("late", b"1")).start()
    c.wait(["late"], timeout=10)
    assert c.get("late") == b"1"
    done = []
    t = threading.Thread(target=lambda: (m.barrier("b", timeout=10),
                                         done.append(1)))
    t.start()
    c.barrier("b", timeout=10)
    t.join(10)
    assert done == [1]


def test_blocking_get_waits_for_the_key(store):
    c = TCPStore("127.0.0.1", store.port)
    threading.Timer(0.2, lambda: store.set("w", b"v")).start()
    assert c.get("w") == b"v"


def test_op_survives_injected_socket_resets(store):
    plan = fp.FaultPlan().inject("store.client_op", fp.SocketReset(),
                                 first_n=3)
    with fp.chaos(plan):
        store.set("k", b"v")
    assert plan.hits("store.client_op") >= 4
    plan.assert_all_fired()
    assert store.get("k") == b"v"
    plan2 = fp.FaultPlan().inject("store.client_op", fp.SocketReset(),
                                  first_n=2)
    with fp.chaos(plan2):
        assert store.add("cnt", 5) == 5
    assert store.add("cnt", 0) == 5


def test_op_exhaustion_is_typed(store, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_RETRY_TRIES", "3")
    monkeypatch.setenv("PADDLE_TPU_RETRY_BASE_DELAY", "0.001")
    plan = fp.FaultPlan().inject("store.client_op", fp.SocketReset(),
                                 every=1)
    with fp.chaos(plan):
        with pytest.raises(RetryError, match="TCPStore.set"):
            store.set("k2", b"v")
    assert plan.hits("store.client_op") == 3


def test_add_lost_reply_is_typed_not_reissued(store):
    assert store.add("exact", 1) == 1
    client = store._client
    orig = client._read_full

    def broken_read(n):
        client._read_full = orig       # heal after one failure
        raise ConnectionResetError("reply lost (simulated)")

    client._read_full = broken_read
    with pytest.raises(StoreReplyLostError, match="may or may not"):
        store.add("exact", 1)
    assert store.add("exact", 0) == 2


def test_reconnect_after_real_socket_death(store):
    store.set("alive", b"1")
    store._client._sock.shutdown(socket.SHUT_RDWR)
    assert store.get("alive") == b"1"


def test_wait_timeout_names_missing_keys(store):
    store.set("present", b"1")
    t0 = time.monotonic()
    with pytest.raises(TimeoutError) as ei:
        store.wait(["present", "ghost1", "ghost2"], timeout=0.3)
    msg = str(ei.value)
    assert "missing: ['ghost1', 'ghost2']" in msg
    assert "PADDLE_TPU_STORE_TIMEOUT" in msg
    assert time.monotonic() - t0 < 5.0


def test_wait_env_override(store, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_STORE_TIMEOUT", "0.2")
    with pytest.raises(TimeoutError, match="0.2s"):
        store.wait("never-set")


def test_barrier_timeout_names_key_and_counts(store, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_STORE_TIMEOUT", "0.3")
    store.world_size = 2
    with pytest.raises(TimeoutError) as ei:
        store.barrier("sync")
    msg = str(ei.value)
    assert "sync:gen1" in msg and "1 arrival" in msg and "needs 2" in msg


def test_barrier_single_participant_meets(store):
    store.world_size = 1
    store.barrier("ok", timeout=5.0)


def test_connect_to_a_dead_master_times_out():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    t0 = time.monotonic()
    with pytest.raises(OSError):
        TCPStore("127.0.0.1", port, timeout=0.3)
    assert time.monotonic() - t0 < 10.0
