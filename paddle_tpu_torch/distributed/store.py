"""TCPStore (port of ``paddle_tpu/distributed/store.py``): a key-value
store one process serves and every process of a job reaches over TCP,
with ``set``, ``get``, ``add``, ``wait`` and ``barrier``.

The server and the client are the JAX package's pure-Python ones
(``_PyStoreServer``, ``_PyStoreClient``) on the same wire protocol, so a
port client talks to a JAX package's master and the other way round.
Each request is one op byte (1 SET, 2 GET, 3 ADD, 4 WAIT), a
little-endian u32 key length and the key, then for SET a u32 value
length and the value, for ADD a u32 8 and an i64 increment.  Replies:
SET one byte; GET and WAIT a u32 length (``0xFFFFFFFF`` for a missing
key) and the value; ADD the new i64.

The JAX package prefers its native library (``csrc/tcp_store.cpp``,
loaded through ``paddle_tpu.core.native``) and falls back to these
Python classes; the port does not build or load that library
(ROADMAP.md §A5), so it always runs the Python server and client.

Every client op goes through :func:`..robustness.retry.retry_call`
inside the ``store.op`` liveness beacon, after the ``store.client_op``
faultpoint: a transient socket error (real or injected) reconnects and
retries with jittered backoff; an ``add`` whose reply was lost raises
:class:`StoreReplyLostError` and is never reissued.
"""
from __future__ import annotations

import socket
import struct
import threading
import time
from typing import Optional

from ..observability import liveness as _liveness
from ..robustness import retry as _retry
from ..robustness.faultpoints import declare as _declare, faultpoint

__all__ = ["TCPStore", "StoreReplyLostError"]

_declare("store.client_op",
         "raise before a TCPStore client op (socket reset, transient IO)")

# one client op with its whole retry schedule; the default sits above the
# store's own 300 s wait deadline
_liveness.declare_beacon(
    "store.op", "one TCPStore client op (set/get/add) through the "
    "retry policy", deadline=600.0)


class StoreReplyLostError(ConnectionError):
    """A non-idempotent op's request reached the wire but the reply was
    lost: the server may have applied it.  Never retried (a second
    ``add`` would bump a rendezvous counter twice and break
    ``barrier``'s generations); the caller decides."""


def _store_timeout(default: float) -> float:
    """``PADDLE_TPU_STORE_TIMEOUT`` overrides every fixed store timeout
    (wait, barrier) in one place."""
    return _retry.env_float("PADDLE_TPU_STORE_TIMEOUT", default)


class TCPStore:
    """``is_master=True`` starts a server on ``port`` (0: a free port,
    then ``self.port``) and connects to it; otherwise connects to
    ``host:port``, retrying for ``timeout`` seconds."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 is_master: bool = False, world_size: int = 1,
                 timeout: float = 30.0):
        self.host = host
        self.is_master = is_master
        self.world_size = world_size
        self._py_server = None
        # fetched once; the NOOP_BEACON singleton when liveness is off
        self._beacon = _liveness.beacon("store.op")
        if is_master:
            self._py_server = _PyStoreServer(port)
            port = self._py_server.port
        self.port = port
        self._client = _PyStoreClient(host, port, timeout)

    def _op(self, opname: str, fn):
        """One client op through the retry policy: transient socket
        errors retry with jittered backoff, reconnecting the client's
        stream between attempts; anything else propagates at once.
        :class:`StoreReplyLostError` is never retried."""
        def attempt():
            faultpoint("store.client_op", op=opname, store=self)
            return fn()

        def retryable(exc):
            if isinstance(exc, StoreReplyLostError):
                return False
            return _retry.transient(exc)

        def reconnect(exc, attempt_no, delay):
            try:
                self._client.reconnect()
            except OSError:
                pass  # the next attempt surfaces the still-broken link

        with self._beacon:
            return _retry.retry_call(attempt, retry_on=retryable,
                                     on_retry=reconnect,
                                     name="TCPStore.%s" % opname)

    def set(self, key: str, value):
        data = value if isinstance(value, bytes) else str(value).encode()
        return self._op("set", lambda: self._client.set(key, data))

    def get(self, key: str, wait: bool = True) -> bytes:
        """The value of ``key``; ``wait=True`` blocks on the server until
        it exists, ``wait=False`` raises ``KeyError`` if it does not."""
        return self._op("get", lambda: self._client.get(key, wait))

    def add(self, key: str, amount: int = 1) -> int:
        return self._op("add", lambda: self._client.add(key, amount))

    def wait(self, keys, timeout: Optional[float] = None):
        """Block until every key exists.  Polls with exponential backoff
        (0.01 s to 0.5 s) under a deadline (300 s, or per call, or
        ``PADDLE_TPU_STORE_TIMEOUT``); the timeout error names the keys
        still missing."""
        keys = list(keys) if isinstance(keys, (list, tuple)) else [keys]
        if timeout is None:
            timeout = _store_timeout(300.0)
        deadline = time.monotonic() + timeout
        delays = _retry.backoff_delays(base=0.01, cap=0.5)
        pending = list(keys)
        while True:
            pending = [k for k in pending if not self._has_key(k)]
            if not pending:
                return
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise TimeoutError(
                    "TCPStore.wait timed out after %.1fs; keys still "
                    "missing: %r (of %r) — override the deadline with "
                    "PADDLE_TPU_STORE_TIMEOUT" % (timeout, pending, keys))
            time.sleep(min(next(delays), remaining))

    def _has_key(self, key: str) -> bool:
        try:
            self.get(key, wait=False)
            return True
        except KeyError:
            return False

    def barrier(self, key: str = "_barrier",
                timeout: Optional[float] = None):
        """Every one of ``world_size`` participants blocks until all have
        arrived.  Polls with backoff under a 60 s deadline (or
        ``PADDLE_TPU_STORE_TIMEOUT``); a timeout names the generation key
        and how many peers arrived."""
        if timeout is None:
            timeout = _store_timeout(60.0)
        n = self.add(key + ":cnt", 1)
        target = self.world_size
        if n % target == 0:
            self.set(key + f":gen{n // target}", b"1")
        gen = (n + target - 1) // target
        gen_key = key + f":gen{gen}"
        deadline = time.monotonic() + timeout
        delays = _retry.backoff_delays(base=0.01, cap=0.25)
        while True:
            if self._has_key(gen_key):
                return
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                arrived = self.add(key + ":cnt", 0)  # read without a bump
                raise TimeoutError(
                    "TCPStore.barrier(%r) timed out after %.1fs waiting "
                    "for key %r: %d arrival(s) total, generation %d needs "
                    "%d — override the deadline with "
                    "PADDLE_TPU_STORE_TIMEOUT"
                    % (key, timeout, gen_key, arrived, gen, gen * target))
            time.sleep(min(next(delays), remaining))

    def close(self):
        """Close the client's connection and stop a master's server."""
        self._client.close()
        if self._py_server is not None:
            self._py_server.close()
            self._py_server = None


class _PyStoreServer:
    def __init__(self, port):
        self._data = {}
        self._cv = threading.Condition()
        self._sock = socket.socket()
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind(("0.0.0.0", port))
        self._sock.listen(64)
        self.port = self._sock.getsockname()[1]
        threading.Thread(target=self._accept, daemon=True,
                         name="store-accept").start()

    def close(self):
        try:
            self._sock.close()
        except OSError:
            pass

    def _accept(self):
        while True:
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            threading.Thread(target=self._serve, args=(conn,),
                             daemon=True, name="store-serve").start()

    def _serve(self, conn):
        def read_full(n):
            buf = b""
            while len(buf) < n:
                chunk = conn.recv(n - len(buf))
                if not chunk:
                    raise ConnectionError
                buf += chunk
            return buf

        try:
            while True:
                op = read_full(1)[0]
                klen = struct.unpack("<I", read_full(4))[0]
                key = read_full(klen).decode()
                if op == 1:    # SET
                    vlen = struct.unpack("<I", read_full(4))[0]
                    val = read_full(vlen)
                    with self._cv:
                        self._data[key] = val
                        self._cv.notify_all()
                    conn.sendall(b"\x01")
                elif op in (2, 4):  # GET / WAIT
                    with self._cv:
                        if op == 4:
                            self._cv.wait_for(lambda: key in self._data)
                        val = self._data.get(key)
                    if val is None:
                        conn.sendall(struct.pack("<I", 0xFFFFFFFF))
                    else:
                        conn.sendall(struct.pack("<I", len(val)) + val)
                elif op == 3:  # ADD
                    vlen = struct.unpack("<I", read_full(4))[0]
                    inc = struct.unpack("<q", read_full(vlen))[0]
                    with self._cv:
                        cur = struct.unpack(
                            "<q", self._data.get(key, b"\0" * 8))[0]
                        out = cur + inc
                        self._data[key] = struct.pack("<q", out)
                        self._cv.notify_all()
                    conn.sendall(struct.pack("<q", out))
        except (ConnectionError, OSError):
            pass
        finally:
            conn.close()


class _PyStoreClient:
    def __init__(self, host, port, timeout):
        self._host = host
        self._port = port
        self._timeout = timeout
        self._lock = threading.Lock()
        self._sock = self._connect(timeout)

    def _connect(self, timeout):
        deadline = time.time() + timeout
        while True:
            try:
                return socket.create_connection((self._host, self._port),
                                                timeout=5)
            except OSError:
                if time.time() > deadline:
                    raise
                time.sleep(0.1)

    def reconnect(self):
        """Drop the (possibly broken) stream and dial again: the retry
        policy's hook between attempts after a transient error."""
        with self._lock:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = self._connect(min(self._timeout, 5.0))

    def close(self):
        with self._lock:
            try:
                self._sock.close()
            except OSError:
                pass

    def _read_full(self, n):
        buf = b""
        while len(buf) < n:
            chunk = self._sock.recv(n - len(buf))
            if not chunk:
                raise ConnectionError
            buf += chunk
        return buf

    def set(self, key, data):
        with self._lock:
            kb = key.encode()
            self._sock.sendall(bytes([1]) + struct.pack("<I", len(kb)) + kb
                               + struct.pack("<I", len(data)) + data)
            self._read_full(1)

    def get(self, key, wait):
        with self._lock:
            kb = key.encode()
            self._sock.sendall(bytes([4 if wait else 2])
                               + struct.pack("<I", len(kb)) + kb)
            ln = struct.unpack("<I", self._read_full(4))[0]
            if ln == 0xFFFFFFFF:
                raise KeyError(key)
            return self._read_full(ln)

    def add(self, key, amount):
        with self._lock:
            kb = key.encode()
            self._sock.sendall(bytes([3]) + struct.pack("<I", len(kb)) + kb
                               + struct.pack("<I", 8)
                               + struct.pack("<q", amount))
            # the request is on the wire: from here the server may have
            # applied the increment, so a lost reply is not reissued
            try:
                return struct.unpack("<q", self._read_full(8))[0]
            except (ConnectionError, OSError) as e:
                raise StoreReplyLostError(
                    "TCPStore.add(%r, %d): reply lost after the request "
                    "was sent — the increment may or may not have been "
                    "applied; not reissuing" % (key, amount)) from e
