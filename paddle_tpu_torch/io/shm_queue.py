"""Shared-memory queue (port of ``paddle_tpu/io/shm_queue.py``): the
ring of ``csrc/shm_queue.cpp`` in a POSIX shared-memory segment
(``/dev/shm/ptq_*``), which the DataLoader's worker processes push
pickled numpy batches into and the training process pops them from.

``ShmQueue.create(capacity)`` makes a segment that this handle owns;
``ShmQueue.open(name)`` maps an existing one by its name.  ``unlink``
removes the name at once: the segment then lives while a process maps
it, so a child ``fork``ed before it keeps using the inherited handle,
and nothing is left in ``/dev/shm`` even if every process dies without
clean-up (the DataLoader's way).  ``put`` / ``get`` move one pickled
object, blocking while the ring is full or empty; ``close`` wakes every
blocked side (a ``put`` then raises, a ``get`` drains what is left and
then raises ``EOFError``); ``destroy`` unmaps the handle and, on the
owner's, removes the segment.  Raises when the native library does not
load (:func:`..core.native.load_error` says why).
"""
from __future__ import annotations

import ctypes
import os
import pickle
import uuid

from ..core import native as _native

__all__ = ["ShmQueue", "QueueClosed"]

#: the prefix of every segment name (``/dev/shm/ptq_<pid>_<hex>``)
PREFIX = "/ptq_"


class QueueClosed(RuntimeError):
    """A ``put`` into a queue that was closed."""


class ShmQueue:
    def __init__(self, name: str = None, capacity: int = 64 << 20,
                 create: bool = True):
        lib = _native.load()
        if lib is None:
            raise RuntimeError("ShmQueue: the native library did not load: "
                               "%s" % _native.load_error())
        self._lib = lib
        self.name = name or "%s%d_%s" % (PREFIX, os.getpid(),
                                         uuid.uuid4().hex[:8])
        self.capacity = int(capacity)
        self._q = (lib.shm_queue_create(self.name.encode(), self.capacity)
                   if create else lib.shm_queue_open(self.name.encode()))
        if not self._q:
            raise OSError("shm_queue %s failed for %s"
                          % ("create" if create else "open", self.name))
        self.owner = create

    @classmethod
    def create(cls, capacity: int = 64 << 20, name: str = None):
        return cls(name, capacity, create=True)

    @classmethod
    def open(cls, name: str):
        return cls(name, create=False)

    def put(self, obj):
        data = pickle.dumps(obj, protocol=4)
        rc = self._lib.shm_queue_push(self._q, data, len(data))
        if rc == -2:
            raise ValueError("ShmQueue: an item of %d bytes exceeds the "
                             "queue's capacity" % len(data))
        if rc != 0:
            raise QueueClosed("ShmQueue %s is closed" % self.name)

    def get(self, max_bytes: int = 1 << 31):
        cap = 1 << 20
        while True:
            buf = ctypes.create_string_buffer(cap)
            n = self._lib.shm_queue_pop(self._q, buf, cap)
            if n == -3:
                if cap >= max_bytes:
                    raise ValueError("ShmQueue: an item exceeds max_bytes "
                                     "%d" % max_bytes)
                cap = min(cap * 4, max_bytes)
                continue
            if n < 0:
                raise EOFError("ShmQueue %s is closed and empty" % self.name)
            return pickle.loads(ctypes.string_at(buf, n))

    def qsize(self) -> int:
        return int(self._lib.shm_queue_size(self._q))

    def close(self):
        if self._q:
            self._lib.shm_queue_close(self._q)

    def unlink(self):
        """Remove the segment's name (the owner's handle only)."""
        if self._q and self.owner:
            self._lib.shm_queue_unlink(self._q)
            self.owner = False

    def destroy(self):
        if self._q:
            self._lib.shm_queue_destroy(self._q)
            self._q = None

    def __getstate__(self):
        return {"name": self.name}

    def __setstate__(self, state):
        self.__dict__.update(ShmQueue.open(state["name"]).__dict__)
