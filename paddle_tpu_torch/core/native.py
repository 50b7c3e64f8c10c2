"""The port's native host library (port of ``paddle_tpu/core/native.py``):
the TCP store (``csrc/tcp_store.cpp``) and the shared-memory queue
(``csrc/shm_queue.cpp``), both in ``paddle_tpu_torch/csrc/``, bound
through ``ctypes`` (plain C interface).

At first use :func:`load` builds one library with ``g++`` (``-O2 -fPIC
-std=c++17 -shared -pthread -lrt``) into ``paddle_tpu_torch/_build/``,
and builds it again when a source is newer than it.  The launcher starts
its workers together, so several processes may build at once: each
builds into a temporary file and renames it into place under a file lock
(``fcntl.flock``).  A failed build leaves :func:`load` returning
``None``, as the JAX package's does; :func:`load_error` keeps why, and
every consumer has a pure-Python path (the store's Python pair) or
raises (``io.ShmQueue``).
"""
from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Optional

__all__ = ["load", "available", "load_error", "build_seconds",
           "library_path", "SOURCES"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("tcp_store.cpp", "shm_queue.cpp")
CXXFLAGS = ["-O2", "-fPIC", "-std=c++17", "-Wall"]
LDFLAGS = ["-shared", "-pthread", "-lrt"]

_lib = None            # None: not tried; False: failed; else the CDLL
_error: Optional[str] = None
_build_seconds: Optional[float] = None
_lock = threading.Lock()


def library_path() -> Path:
    return BUILD_DIR / "libpaddle_tpu_torch_native.so"


def _stale(so: Path) -> bool:
    if not so.is_file():
        return True
    built = so.stat().st_mtime
    return any((CSRC / f).stat().st_mtime > built for f in SOURCES)


def _build(so: Path):
    """Build ``so`` unless a fresh one is there: under an exclusive lock on
    a file beside it, into a temporary file renamed into place, so that a
    process never loads a half-written library."""
    global _build_seconds
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "native.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not _stale(so):
            return
        t0 = time.perf_counter()
        fd, tmp = tempfile.mkstemp(prefix=so.name + ".", dir=str(BUILD_DIR))
        os.close(fd)
        try:
            subprocess.run(
                ["g++"] + CXXFLAGS + [str(CSRC / f) for f in SOURCES]
                + ["-o", tmp] + LDFLAGS,
                check=True, capture_output=True, text=True, timeout=300)
            os.replace(tmp, so)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        _build_seconds = time.perf_counter() - t0


def _bind(lib):
    c_void_p, c_char_p, c_int = ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int
    c_ll = ctypes.c_longlong
    for name, res, args in (
            ("tcp_store_server_create", c_void_p, [c_int]),
            ("tcp_store_server_port", c_int, [c_void_p]),
            ("tcp_store_server_destroy", None, [c_void_p]),
            ("tcp_store_client_create", c_void_p, [c_char_p, c_int]),
            ("tcp_store_client_create_t", c_void_p, [c_char_p, c_int, c_int]),
            ("tcp_store_client_destroy", None, [c_void_p]),
            ("tcp_store_client_reconnect", c_int, [c_void_p, c_int]),
            ("tcp_store_client_last_error", c_int, [c_void_p]),
            ("tcp_store_client_fd", c_int, [c_void_p]),
            ("tcp_store_client_shutdown", None, [c_void_p]),
            ("tcp_store_set", c_int, [c_void_p, c_char_p, c_char_p, c_int]),
            ("tcp_store_get", c_ll, [c_void_p, c_char_p, c_char_p, c_ll,
                                     c_int]),
            ("tcp_store_add", c_ll, [c_void_p, c_char_p, c_ll]),
            ("shm_queue_create", c_void_p, [c_char_p, c_ll]),
            ("shm_queue_open", c_void_p, [c_char_p]),
            ("shm_queue_push", c_int, [c_void_p, c_char_p, c_ll]),
            ("shm_queue_pop", c_ll, [c_void_p, c_char_p, c_ll]),
            ("shm_queue_size", c_ll, [c_void_p]),
            ("shm_queue_close", None, [c_void_p]),
            ("shm_queue_unlink", None, [c_void_p]),
            ("shm_queue_destroy", None, [c_void_p])):
        fn = getattr(lib, name)
        fn.restype = res
        fn.argtypes = args
    return lib


def load():
    """The loaded library, or ``None`` when it cannot be built or loaded
    (:func:`load_error` says why)."""
    global _lib, _error
    if _lib is None:
        with _lock:
            if _lib is None:
                so = library_path()
                try:
                    if _stale(so):
                        _build(so)
                    _lib = _bind(ctypes.CDLL(str(so)))
                except subprocess.CalledProcessError as e:
                    _lib, _error = False, "g++ failed: %s" % (
                        e.stderr or e.stdout or str(e)).strip()[-2000:]
                except Exception as e:  # no g++, unwritable dir, bad .so
                    _lib, _error = False, "%s: %s" % (type(e).__name__, e)
    return _lib or None


def available() -> bool:
    """True when the library loads; False when its build or load failed."""
    return load() is not None


def load_error() -> Optional[str]:
    """Why :func:`load` returned ``None`` (``None`` if it did not)."""
    load()
    return _error


def build_seconds() -> Optional[float]:
    """Seconds this process spent compiling the library (``None`` when it
    found a fresh one)."""
    return _build_seconds
