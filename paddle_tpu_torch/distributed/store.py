"""TCPStore (port of ``paddle_tpu/distributed/store.py``): a key-value
store one process serves and every process of a job reaches over TCP,
with ``set``, ``get``, ``add``, ``wait`` and ``barrier``.

Server and client speak the JAX package's wire protocol, so a port
client talks to a JAX package's master and the other way round.  Each
request is one op byte (1 SET, 2 GET, 3 ADD, 4 WAIT), a
little-endian u32 key length and the key, then for SET a u32 value
length and the value, for ADD a u32 8 and an i64 increment.  Replies:
SET one byte; GET and WAIT a u32 length (``0xFFFFFFFF`` for a missing
key) and the value; ADD the new i64.

Two backends speak that wire, chosen as the JAX package chooses
(``paddle_tpu/distributed/store.py:48-160``): the native server and
client of ``csrc/tcp_store.cpp`` (built and loaded by
:mod:`..core.native`) when the library loads, else the pure-Python pair
here.  ``TCPStore.backend`` (``"native"`` or ``"python"``) says which
runs.  Either side of a connection may run either backend or be the JAX
package's.

Every client op goes through :func:`..robustness.retry.retry_call`
inside the ``store.op`` liveness beacon, after the ``store.client_op``
faultpoint: a transient socket error (real or injected) reconnects and
retries with jittered backoff; an ``add`` whose reply was lost raises
:class:`StoreReplyLostError` and is never reissued.
"""
from __future__ import annotations

import ctypes
import errno
import socket
import struct
import threading
import time
from typing import Optional

from ..core import native as _native
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
    ``host:port``, retrying for ``timeout`` seconds.  Server and client
    run on the native library when it loads, else on the Python pair
    (``self.backend``)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 is_master: bool = False, world_size: int = 1,
                 timeout: float = 30.0):
        lib = _native.load()
        self.backend = "python" if lib is None else "native"
        self.host = host
        self.is_master = is_master
        self.world_size = world_size
        self._server = None
        # fetched once; the NOOP_BEACON singleton when liveness is off
        self._beacon = _liveness.beacon("store.op")
        if is_master:
            self._server = (_PyStoreServer(port) if lib is None
                            else _NativeStoreServer(lib, port))
            port = self._server.port
        self.port = port
        self._client = (_PyStoreClient(host, port, timeout) if lib is None
                        else _NativeStoreClient(lib, host, port, timeout))

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
        if self._server is not None:
            self._server.close()
            self._server = None


class _NativeStoreServer:
    """The server of ``csrc/tcp_store.cpp``: an accept thread and one
    thread a connection, in C++."""

    def __init__(self, lib, port):
        self._lib = lib
        self._h = lib.tcp_store_server_create(port)
        if not self._h:
            raise OSError("TCPStore: cannot bind port %d" % port)
        self.port = lib.tcp_store_server_port(self._h)

    def close(self):
        if getattr(self, "_h", None):
            self._lib.tcp_store_server_destroy(self._h)
            self._h = None

    __del__ = close


class _NativeStoreClient:
    """The client of ``csrc/tcp_store.cpp`` behind the Python client's
    interface.  A failed op leaves the C++ client disconnected and says
    whether the request reached the wire whole (error 2) or not (1): an
    ``add`` of the first kind raises :class:`StoreReplyLostError`, every
    other failure a ``ConnectionResetError`` that the retry policy
    retries after :meth:`reconnect`.  :meth:`close` while another thread
    is inside an op wakes it (the op fails) and frees the C++ client
    when the last op leaves; an op after ``close`` raises ``EBADF``, as
    the Python client's closed socket does."""

    _GET_CAP = 1 << 20

    def __init__(self, lib, host, port, timeout):
        self._lib = lib
        self._timeout = timeout
        self._state = threading.Lock()
        self._busy = 0
        self._closed = False
        self._h = lib.tcp_store_client_create_t(
            host.encode(), port, int(max(timeout, 0.0) * 1000))
        if not self._h:
            raise ConnectionRefusedError(
                "TCPStore: cannot connect to %s:%d within %.1fs"
                % (host, port, timeout))
        self._buf_lock = threading.Lock()
        self._buf = ctypes.create_string_buffer(self._GET_CAP)

    def _call(self, fn):
        with self._state:
            if self._closed or not self._h:
                raise OSError(errno.EBADF, "TCPStore client is closed")
            self._busy += 1
        try:
            return fn(self._h)
        finally:
            with self._state:
                self._busy -= 1
                if self._closed and not self._busy:
                    self._free()

    def _free(self):
        if self._h:
            self._lib.tcp_store_client_destroy(self._h)
            self._h = None

    def close(self):
        with self._state:
            if self._closed:
                return
            self._closed = True
            if self._busy:
                self._lib.tcp_store_client_shutdown(self._h)
            else:
                self._free()

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.tcp_store_client_destroy(self._h)

    def fileno(self):
        """The connection's socket (-1 while disconnected)."""
        return self._call(self._lib.tcp_store_client_fd)

    def _lost(self, h, what):
        return ConnectionResetError(
            "TCPStore.%s: the connection failed (%s)" % (
                what, "reply lost" if self._lib.tcp_store_client_last_error(h)
                == 2 else "request not sent"))

    def reconnect(self):
        ms = int(min(self._timeout, 5.0) * 1000)
        if self._call(lambda h: self._lib.tcp_store_client_reconnect(
                h, ms)) != 0:
            raise ConnectionRefusedError("TCPStore: reconnect failed")

    def set(self, key, data):
        def op(h):
            if self._lib.tcp_store_set(h, key.encode(), data, len(data)):
                raise self._lost(h, "set(%r)" % key)
        self._call(op)

    def get(self, key, wait):
        if wait:
            # a blocking get waits on the server until the key exists: it
            # takes a buffer of its own rather than hold the shared one's
            # lock while it waits
            buf = ctypes.create_string_buffer(self._GET_CAP)
            return self._call(lambda h: self._get(h, key, 1, buf))
        with self._buf_lock:
            return self._call(lambda h: self._get(h, key, 0, self._buf))

    def _get(self, h, key, wait, buf):
        while True:
            n = self._lib.tcp_store_get(h, key.encode(), buf, len(buf), wait)
            if n == -1:
                raise KeyError(key)
            if n < 0:
                raise self._lost(h, "get(%r)" % key)
            if n <= len(buf):
                return buf.raw[:n]
            buf = ctypes.create_string_buffer(n)   # again, whole

    def add(self, key, amount):
        def op(h):
            out = self._lib.tcp_store_add(h, key.encode(), amount)
            if out != -(1 << 63):
                return int(out)
            if self._lib.tcp_store_client_last_error(h) == 2:
                raise StoreReplyLostError(
                    "TCPStore.add(%r, %d): reply lost after the request "
                    "was sent — the increment may or may not have been "
                    "applied; not reissuing" % (key, amount))
            raise self._lost(h, "add(%r)" % key)
        return self._call(op)


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
    """After a failed op the stream's state is unknown (a late reply would
    be read as the next op's), so the client drops it: the next op raises
    ``ConnectionResetError`` until :meth:`reconnect`, which the retry
    policy calls."""

    def __init__(self, host, port, timeout):
        self._host = host
        self._port = port
        self._timeout = timeout
        self._lock = threading.Lock()
        self._closed = False
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
            if self._closed:
                raise OSError(errno.EBADF, "TCPStore client is closed")
            self._drop()
            self._sock = self._connect(min(self._timeout, 5.0))

    def _drop(self):
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def close(self):
        with self._lock:
            self._closed = True
            self._drop()

    def fileno(self):
        return -1 if self._sock is None else self._sock.fileno()

    def _stream(self):
        """The connected socket (under ``self._lock``)."""
        if self._sock is None:
            if self._closed:
                raise OSError(errno.EBADF, "TCPStore client is closed")
            raise ConnectionResetError(errno.ENOTCONN,
                                       "TCPStore: not connected")
        return self._sock

    def _io(self, fn):
        """``fn(sock)`` under the lock; a socket error drops the stream."""
        with self._lock:
            sock = self._stream()
            try:
                return fn(sock)
            except OSError:
                self._drop()
                raise

    def _read_full(self, n):
        buf = b""
        while len(buf) < n:
            chunk = self._sock.recv(n - len(buf))
            if not chunk:
                raise ConnectionError
            buf += chunk
        return buf

    def set(self, key, data):
        kb = key.encode()

        def op(sock):
            sock.sendall(bytes([1]) + struct.pack("<I", len(kb)) + kb
                         + struct.pack("<I", len(data)) + data)
            self._read_full(1)
        self._io(op)

    def get(self, key, wait):
        kb = key.encode()

        def op(sock):
            sock.sendall(bytes([4 if wait else 2])
                         + struct.pack("<I", len(kb)) + kb)
            ln = struct.unpack("<I", self._read_full(4))[0]
            if ln == 0xFFFFFFFF:
                raise KeyError(key)
            return self._read_full(ln)
        return self._io(op)

    def add(self, key, amount):
        kb = key.encode()

        def op(sock):
            sock.sendall(bytes([3]) + struct.pack("<I", len(kb)) + kb
                         + struct.pack("<I", 8) + struct.pack("<q", amount))
            # the request is on the wire: from here the server may have
            # applied the increment, so a lost reply is not reissued
            try:
                return struct.unpack("<q", self._read_full(8))[0]
            except (ConnectionError, OSError) as e:
                self._drop()
                raise StoreReplyLostError(
                    "TCPStore.add(%r, %d): reply lost after the request "
                    "was sent — the increment may or may not have been "
                    "applied; not reissuing" % (key, amount)) from e
        return self._io(op)
