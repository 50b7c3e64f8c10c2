"""The port's native host library (``paddle_tpu_torch/core/native.py``
over its own copies of ``tcp_store.cpp`` and ``shm_queue.cpp``), after
``tests/test_native_runtime.py``: it builds into
``paddle_tpu_torch/_build/`` and leaves the root ``csrc/`` as it was;
its store speaks the JAX package's wire both ways (a port native client
against the JAX package's Python server, a JAX Python client against a
port native server: set, get, add, wait, barrier); a rendezvous of three
processes; the shared-memory queue's round trip in one process and
across processes."""
import hashlib
import multiprocessing as mp
import os
import pathlib
import subprocess
import sys
import threading

import numpy as np
import pytest

from paddle_tpu.distributed import store as jax_store_mod
from paddle_tpu_torch.core import native
from paddle_tpu_torch.distributed.store import TCPStore
from paddle_tpu_torch.io.shm_queue import QueueClosed, ShmQueue

REPO = pathlib.Path(__file__).resolve().parent.parent


def _tree_state(root):
    return {p.name: (p.stat().st_mtime_ns,
                     hashlib.sha256(p.read_bytes()).hexdigest())
            for p in sorted(root.iterdir()) if p.is_file()}


def _package_copy(tmp_path):
    """``core/native.py`` and the two sources in a package tree of their
    own under ``tmp_path`` (the loader places its build by its own path),
    so that building there never races the repository's library that
    other test files load at the same time."""
    pkg = tmp_path / "paddle_tpu_torch"
    (pkg / "core").mkdir(parents=True)
    (pkg / "csrc").mkdir()
    (pkg / "core" / "native.py").write_bytes(
        (REPO / "paddle_tpu_torch" / "core" / "native.py").read_bytes())
    for src in native.SOURCES:
        (pkg / "csrc" / src).write_bytes(
            (REPO / "paddle_tpu_torch" / "csrc" / src).read_bytes())
    return pkg


_LOAD = ("import importlib.util, sys\n"
         "spec = importlib.util.spec_from_file_location('native', sys.argv[1])\n"
         "native = importlib.util.module_from_spec(spec)\n"
         "spec.loader.exec_module(native)\n"
         "assert native.load() is not None, native.load_error()\n"
         "print(native.library_path(), native.build_seconds())\n")


def test_builds_into_the_ports_build_dir_and_leaves_root_csrc(tmp_path):
    """The loader builds into ``<package>/_build/`` from ``<package>/csrc``
    (a fresh build in a package copy); no file of the root ``csrc/`` is
    touched by it or by the repository's own library."""
    before = _tree_state(REPO / "csrc")
    pkg = _package_copy(tmp_path)
    out = subprocess.run([sys.executable, "-c", _LOAD,
                          str(pkg / "core" / "native.py")],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    so, seconds = out.stdout.split()
    assert pathlib.Path(so) == pkg / "_build" / "libpaddle_tpu_torch_native.so"
    assert float(seconds) > 0
    assert native.available() and native.load_error() is None
    assert native.library_path().parent == REPO / "paddle_tpu_torch" / \
        "_build"
    assert _tree_state(REPO / "csrc") == before


def test_concurrent_first_loads_build_once(tmp_path):
    """Two processes that find no library at once both load the one built
    under the lock (the launcher starts its workers together); no
    temporary file is left."""
    pkg = _package_copy(tmp_path)
    procs = [subprocess.Popen([sys.executable, "-c", _LOAD,
                               str(pkg / "core" / "native.py")],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    built = [o.split()[1] != "None" for o, _ in outs]
    assert sorted(built) == [False, True]
    assert sorted(p.name for p in (pkg / "_build").iterdir()) == [
        "libpaddle_tpu_torch_native.so", "native.lock"]


def test_a_failed_build_returns_none_with_its_reason(tmp_path):
    pkg = _package_copy(tmp_path)
    (pkg / "csrc" / "shm_queue.cpp").write_text("this is not C++\n")
    code = _LOAD.replace(
        "assert native.load() is not None, native.load_error()\n",
        "assert native.load() is None and not native.available()\n"
        "print(native.load_error())\n")
    out = subprocess.run([sys.executable, "-c", code,
                          str(pkg / "core" / "native.py")],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "g++ failed" in out.stdout


@pytest.fixture
def jax_py(monkeypatch):
    monkeypatch.setattr(jax_store_mod._native, "load", lambda: None)
    return jax_store_mod.TCPStore


@pytest.mark.parametrize("master,client", [("port_native", "jax_python"),
                                           ("jax_python", "port_native")])
def test_wire_both_ways(jax_py, master, client):
    cls = {"port_native": TCPStore, "jax_python": jax_py}
    m = cls[master]("127.0.0.1", 0, is_master=True, world_size=2)
    c = cls[client]("127.0.0.1", m.port, world_size=2)
    for s in (m, c):
        if isinstance(s, TCPStore):
            assert s.backend == "native"
    c.set("k", b"\x00\x01binary\xff")
    assert m.get("k") == b"\x00\x01binary\xff"
    m.set("s", "text")
    assert c.get("s") == b"text"
    assert c.add("n", 5) == 5 and m.add("n", -2) == 3 and c.add("n", 0) == 3
    with pytest.raises(KeyError):
        c.get("absent", wait=False)
    setter = threading.Timer(0.2, lambda: m.set("late", b"1"))
    setter.start()
    c.wait(["late"], timeout=10)
    setter.join()
    done = []
    t = threading.Thread(target=lambda: (m.barrier("b", timeout=10),
                                         done.append(1)))
    t.start()
    c.barrier("b", timeout=10)
    t.join(10)
    assert done == [1]


def test_native_client_honours_its_connect_deadline():
    """A native client against a dead port with ``timeout=0.5`` raises in
    under a second (JAX's ``tcp_store_client_create_t`` deadline)."""
    import socket
    import time
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    t0 = time.monotonic()
    with pytest.raises(OSError):
        TCPStore("127.0.0.1", port, timeout=0.5)
    assert time.monotonic() - t0 < 1.0


def test_large_value_round_trips():
    """A value past the client's 1 MiB buffer comes back whole."""
    m = TCPStore("127.0.0.1", 0, is_master=True)
    assert m.backend == "native"
    blob = np.random.default_rng(0).bytes(3 << 20)
    m.set("big", blob)
    assert m.get("big") == blob and m.get("big", wait=False) == blob
    m.close()


def _store_rank(port, rank, q):
    try:
        s = TCPStore("127.0.0.1", port, world_size=3)
        s.set("rank%d" % rank, str(rank))
        vals = [s.get("rank%d" % r) for r in range(3)]
        s.barrier("b0", timeout=30)
        q.put((rank, s.backend, vals))
        s.close()
    except BaseException as e:
        q.put((rank, repr(e)))


def test_three_process_rendezvous():
    master = TCPStore("127.0.0.1", 0, is_master=True, world_size=3)
    assert master.backend == "native"
    ctx = mp.get_context("fork")
    q = ctx.Queue()
    procs = [ctx.Process(target=_store_rank, args=(master.port, r, q))
             for r in range(3)]
    for p in procs:
        p.start()
    results = sorted(q.get(timeout=30) for _ in range(3))
    for p in procs:
        p.join(10)
    assert results == [(r, "native", [b"0", b"1", b"2"]) for r in range(3)]
    master.close()


def test_shm_queue_roundtrip():
    q = ShmQueue.create(1 << 20)
    try:
        q.put({"a": np.arange(10), "b": "text"})
        q.put([1, 2, 3])
        item = q.get()
        np.testing.assert_array_equal(item["a"], np.arange(10))
        assert q.get() == [1, 2, 3]
        assert q.qsize() == 0
        with pytest.raises(ValueError, match="capacity"):
            q.put(np.zeros(1 << 20, np.uint8))
        q.close()
        with pytest.raises(QueueClosed):
            q.put(1)
        with pytest.raises(EOFError):
            q.get()
    finally:
        q.destroy()
    assert not os.path.exists("/dev/shm" + q.name)


def _shm_producer(name, n):
    q = ShmQueue.open(name)
    for i in range(n):
        q.put(("item", i, np.full((100,), i)))
    q.destroy()


def test_shm_queue_cross_process():
    q = ShmQueue.create(4 << 20)
    ctx = mp.get_context("fork")
    p = ctx.Process(target=_shm_producer, args=(q.name, 20))
    p.start()
    try:
        got = [q.get() for _ in range(20)]
        assert [g[1] for g in got] == list(range(20))
        np.testing.assert_array_equal(got[7][2], np.full((100,), 7))
    finally:
        p.join(10)
        q.close()
        q.destroy()
    assert p.exitcode == 0
    assert not os.path.exists("/dev/shm" + q.name)


def test_unlinked_queue_serves_forked_children():
    """``unlink`` removes the name at once; a child forked before it keeps
    the inherited handle (the DataLoader's way), and nothing is left in
    ``/dev/shm`` whatever ends the processes."""
    q = ShmQueue.create(1 << 20)
    ctx = mp.get_context("fork")
    p = ctx.Process(target=lambda: q.put(("from child", os.getpid())))
    p.start()
    q.unlink()
    assert not os.path.exists("/dev/shm" + q.name)
    tag, pid = q.get()
    p.join(10)
    assert tag == "from child" and pid == p.pid
    q.close()
    q.destroy()
