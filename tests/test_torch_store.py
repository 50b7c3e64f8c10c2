"""paddle_tpu_torch's TCPStore against ``paddle_tpu``'s, after the store
cases of ``tests/test_chaos.py``, each case on both of the port's
backends (the native server and client of ``csrc/tcp_store.cpp``, and
the pure-Python pair): the JAX package's wire protocol, a port client
against a JAX master and a JAX client against a port master (set, get,
add, wait, barrier), ops surviving injected socket resets at the
``store.client_op`` site, a typed exhaustion, an ``add`` whose reply was
lost on the way surfacing as ``StoreReplyLostError`` and never reissued,
a reconnect after a real socket death, and wait and barrier timeouts
that name what they waited for."""
import os
import socket
import threading
import time

import pytest

from paddle_tpu.distributed import store as jax_store_mod
from paddle_tpu_torch.distributed import store as port_store_mod
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


BACKENDS = ("native", "python")


@pytest.fixture(params=BACKENDS)
def backend(request, monkeypatch):
    """The port's stores of the test on one backend: the native library
    (it loads here), or the Python pair with the library's loader
    forced to fail."""
    if request.param == "python":
        monkeypatch.setattr(port_store_mod._native, "load", lambda: None)
    return request.param


@pytest.fixture
def store(backend):
    s = TCPStore("127.0.0.1", 0, is_master=True, world_size=1)
    assert s.backend == backend
    yield s
    s.close()


class _ReplyDropProxy:
    """A TCP relay in front of a store's server that, once armed, lets
    the next reply from the server die on the way: the server has done
    the op, the client sees its connection close."""

    def __init__(self, port):
        self._up = port
        self.armed = False
        self._lsock = socket.socket()
        self._lsock.bind(("127.0.0.1", 0))
        self._lsock.listen(8)
        self.port = self._lsock.getsockname()[1]
        threading.Thread(target=self._accept, daemon=True).start()

    def _accept(self):
        while True:
            try:
                conn, _ = self._lsock.accept()
            except OSError:
                return
            up = socket.create_connection(("127.0.0.1", self._up))
            threading.Thread(target=self._pump, args=(conn, up, False),
                             daemon=True).start()
            threading.Thread(target=self._pump, args=(up, conn, True),
                             daemon=True).start()

    def _pump(self, src, dst, replies):
        try:
            while True:
                data = src.recv(65536)
                if not data:
                    break
                if replies and self.armed:
                    self.armed = False
                    break          # the reply is dropped with the link
                dst.sendall(data)
        except OSError:
            pass
        for sk in (src, dst):
            try:
                sk.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            sk.close()

    def close(self):
        self._lsock.close()


def test_site_and_beacon_declared():
    assert "store.client_op" in fp.SITES and "store.op" in BEACONS


@pytest.mark.parametrize("master,client", [("torch", "jax"),
                                           ("jax", "torch")])
def test_interop_both_ways(jax_py, backend, master, client):
    """One package's master, the other package's client: every op sees
    the other side's writes, byte for byte."""
    cls = {"torch": TCPStore, "jax": jax_py}
    m = cls[master]("127.0.0.1", 0, is_master=True, world_size=2)
    c = cls[client]("127.0.0.1", m.port, world_size=2)
    assert [s.backend for s in (m, c) if isinstance(s, TCPStore)] == \
        [backend]
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


def test_blocking_get_waits_for_the_key(store, backend):
    c = TCPStore("127.0.0.1", store.port)
    setter = threading.Timer(0.2, lambda: store.set("w", b"v"))
    setter.start()
    assert c.get("w") == b"v"
    setter.join()
    c.close()


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


def test_add_lost_reply_is_typed_not_reissued(store, backend):
    """The server applies the add, its reply dies on the way: the client
    raises ``StoreReplyLostError`` without a second increment, and its
    next op reconnects."""
    proxy = _ReplyDropProxy(store.port)
    c = TCPStore("127.0.0.1", proxy.port)
    assert c.add("exact", 1) == 1
    proxy.armed = True
    with pytest.raises(StoreReplyLostError, match="may or may not"):
        c.add("exact", 1)
    assert c.add("exact", 0) == 2
    assert store.add("exact", 0) == 2
    c.close()
    proxy.close()


def test_reconnect_after_real_socket_death(store):
    store.set("alive", b"1")
    sk = socket.socket(fileno=os.dup(store._client.fileno()))
    sk.shutdown(socket.SHUT_RDWR)
    sk.close()
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


def test_connect_to_a_dead_master_times_out(backend):
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    t0 = time.monotonic()
    with pytest.raises(OSError):
        TCPStore("127.0.0.1", port, timeout=0.3)
    assert time.monotonic() - t0 < 10.0
