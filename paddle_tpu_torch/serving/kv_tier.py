"""The tiered KV cache (port of ``paddle_tpu/serving/kv_tier.py``): the
host-RAM page tier behind the device pool, and the cluster-wide prefix
index on top of it.

A refcount-0 cached page of the device pool survives until the free list
runs dry and the allocator reclaims it.  Where many requests share
system-prompt templates, those prefix pages should fall to host RAM, not
to recompute.  Three pieces live here:

* :class:`HostPageTier` — a bounded LRU of spilled pages keyed by the
  allocator's chained content digest, so a host hit implies exact-prefix
  equality (no token comparison on the readmit path).  An entry is the
  host copy of one page's rows (int8 or fp8 codes and their f32 scales
  included), what one row of the handoff buffer holds.  Budget:
  ``PADDLE_TPU_KV_HOST_BYTES`` (0 or unset: the tier is off).
* :func:`npz_roundtrip` — the shared host-staging transport: write the
  arrays to a temporary ``.npz``, fire the chaos site with the file's
  path (``TornFile`` truncates it, ``BitFlip`` corrupts it; ``np.load``
  checks the zip CRCs, so both surface as :data:`TRANSPORT_ERRORS`), and
  read them back.  The disaggregated handoff's host staging and the
  tier's fetch use this one function.
* :class:`ClusterPrefixIndex` — every host publishes its resident digest
  set to the TCP store under ``paddle_tpu/kv_index/<host>``;
  :meth:`~ClusterPrefixIndex.publish_once` is what the background thread
  loops over, the store's retry policy covers transient resets, and a
  publish that still fails is logged and skipped: the index never takes
  serving down.

Torch tensors of dtypes numpy lacks (bfloat16, float8) cross the npz
transport as their raw bytes and come back as the same dtype and shape,
bit for bit.

A torn fetch (the ``serve.kv_tier`` faultpoint) aborts the fetch, frees
the chunk's fresh pages refcount-exactly, discards the torn entries from
the tier (each retry fetches strictly fewer pages) and falls back to
recompute through the scheduler's requeue at the queue front.
"""
from __future__ import annotations

import json
import os
import sys
import tempfile
import threading
import time
import zipfile
from collections import OrderedDict
from typing import Dict, Iterable, Optional, Set

import numpy as np
import torch

from ..observability import liveness as _liveness
from ..robustness.faultpoints import declare as _declare, faultpoint

__all__ = [
    "KV_TIER_SITE", "TRANSPORT_ERRORS", "INDEX_KEY_PREFIX", "BUF_NAMES",
    "npz_roundtrip", "HostPageTier", "ClusterPrefixIndex", "fetch_index",
    "host_bytes_default",
]

#: chaos site on the host-tier fetch transport: fires between the staging
#: write and its read-back with ``ctx['path']`` the staging file
KV_TIER_SITE = _declare(
    "serve.kv_tier",
    "fires once per host-tier fetch chunk, between the staged npz write "
    "and its read-back (ctx['path'] = the staging file, so TornFile/"
    "BitFlip model a torn host-tier read)")

#: liveness beacon over one fetch phase (stage, or the import commit)
_liveness.declare_beacon(
    "serve.kv_tier",
    "one host-tier fetch phase (tier read -> npz roundtrip -> stage, or "
    "the ready-polled import commit), interleaved between decode steps",
    deadline=600.0)

#: what one tier or handoff transfer treats as "the transfer failed —
#: requeue and recompute": a reset is an OSError; a torn or bit-flipped
#: staging file reads as EOFError, ValueError or BadZipFile
TRANSPORT_ERRORS = (OSError, EOFError, ValueError, zipfile.BadZipFile)

#: store key prefix; one key per host, the newest digest snapshot wins
INDEX_KEY_PREFIX = "paddle_tpu/kv_index/"

#: digests one host remembers for publication (oldest dropped past it;
#: a dropped digest only costs a remote miss)
INDEX_MAX_DIGESTS = 65536

_FORMAT = "paddle_tpu-kv-index-v1"

#: handoff-buffer array names, in export and stage order (the scale
#: entries are None for an unquantized pool)
BUF_NAMES = ("k", "v", "ks", "vs")


def host_bytes_default() -> int:
    """The env-configured host-tier budget (0: the tier is off).  A
    malformed value disables the tier, loudly, rather than failing the
    engine's construction."""
    raw = os.environ.get("PADDLE_TPU_KV_HOST_BYTES", "").strip()
    if not raw:
        return 0
    try:
        return max(int(float(raw)), 0)
    except ValueError:
        sys.stderr.write("[kv_tier] ignoring unparseable "
                         "PADDLE_TPU_KV_HOST_BYTES=%r\n" % (raw,))
        return 0


def _to_numpy(t):
    """(the tensor's raw bytes as a numpy array, its dtype and shape):
    numpy has no bfloat16 or float8."""
    t = t.detach().contiguous().cpu()
    return t.view(torch.uint8).numpy().reshape(-1), (t.dtype, tuple(t.shape))


def _from_numpy(arr, how):
    dtype, shape = how
    return torch.from_numpy(np.ascontiguousarray(arr)).view(
        dtype).reshape(shape)


def npz_roundtrip(bufs, site, prefix="paddle_tpu_kv_", **ctx):
    """The shared host-staging transport: write ``bufs`` (the ``(k, v, ks,
    vs)`` handoff-buffer tuple of tensors, the scale entries None for an
    unquantized pool) to a temporary ``.npz``, fire the chaos ``site``
    with the file's path, and read it back.  Returns the tensors as they
    went in, on the CPU (the same dtype, shape and bits).  Raises one of
    :data:`TRANSPORT_ERRORS` when the transfer tore."""
    arrays, hows = {}, {}
    for n, a in zip(BUF_NAMES, bufs):
        if a is None:
            continue
        arrays[n], hows[n] = _to_numpy(a)
    fd, path = tempfile.mkstemp(suffix=".npz", prefix=prefix)
    os.close(fd)
    try:
        np.savez(path, **arrays)
        faultpoint(site, path=path, **ctx)
        with np.load(path) as doc:
            out = []
            for n in BUF_NAMES:
                if n not in doc.files:
                    out.append(None)
                    continue
                out.append(_from_numpy(doc[n], hows[n]))
            return tuple(out)
    finally:
        try:
            os.unlink(path)
        except OSError:
            pass


class HostPageTier:
    """Bounded host-RAM store of spilled KV pages, LRU over chained
    content digests.

    An entry is one page's rows as a ``{"k", "v"[, "ks", "vs"]}`` dict of
    host arrays (CPU tensors from the engine).  A page reachable under
    several digests stores one entry a digest sharing the same arrays;
    the ledger prices each entry's bytes, so shared storage is over- and
    never under-counted: the budget is a ceiling.  Thread-safe: the
    allocator spills from whichever thread ran ``alloc()``, the scheduler
    fetches from its loop, a flight dump reads occupancy from its own."""

    def __init__(self, budget_bytes: Optional[int] = None):
        if budget_bytes is None:
            budget_bytes = host_bytes_default()
        self.budget_bytes = max(int(budget_bytes), 0)
        self._lock = threading.Lock()
        # digest -> {"arrays": {name: array}, "nbytes": int}
        self._entries: "OrderedDict" = OrderedDict()
        self._bytes = 0
        self.spilled = 0        # entries admitted (lifetime)
        self.lru_evicted = 0    # entries LRU-evicted over budget
        # called with the list of LRU-evicted digests AFTER _lock is
        # released (the cluster index withdraws them; store I/O never
        # runs under the tier's lock)
        self.evict_hook = None

    @property
    def enabled(self) -> bool:
        return self.budget_bytes > 0

    @staticmethod
    def _entry_bytes(arrays) -> int:
        return sum(int(a.nbytes) for a in arrays.values())

    def put(self, digest, arrays) -> bool:
        """Admit one page's rows under ``digest`` (the newest end of the
        LRU), evicting the oldest entries past the budget.  An entry
        larger than the whole budget is refused."""
        if not self.enabled:
            return False
        nb = self._entry_bytes(arrays)
        if nb > self.budget_bytes:
            return False
        evicted = []
        with self._lock:
            old = self._entries.pop(digest, None)
            if old is not None:
                self._bytes -= old["nbytes"]
            self._entries[digest] = {"arrays": arrays, "nbytes": nb}
            self._bytes += nb
            self.spilled += 1
            while self._bytes > self.budget_bytes:
                d, ev = self._entries.popitem(last=False)
                self._bytes -= ev["nbytes"]
                self.lru_evicted += 1
                evicted.append(d)
        hook = self.evict_hook
        if hook is not None and evicted:
            try:
                hook(evicted)
            except Exception:
                # best-effort: a broken index never fails the spill (the
                # interval publisher republishes the truth)
                pass
        return True

    def get(self, digest):
        """The page's rows under ``digest`` (an LRU touch), or None."""
        with self._lock:
            ent = self._entries.get(digest)
            if ent is None:
                return None
            self._entries.move_to_end(digest)
            return ent["arrays"]

    def __contains__(self, digest) -> bool:
        with self._lock:
            return digest in self._entries

    def discard(self, digest):
        """Drop ``digest``: a digest that fed a torn fetch never feeds the
        retry, so each abort shrinks the next plan."""
        with self._lock:
            ent = self._entries.pop(digest, None)
            if ent is not None:
                self._bytes -= ent["nbytes"]

    def clear(self):
        """Drop everything (``refresh_state`` after a parameter change:
        rows of old weights never splice)."""
        with self._lock:
            self._entries.clear()
            self._bytes = 0

    def digests(self):
        """Resident digests, LRU order (oldest first)."""
        with self._lock:
            return list(self._entries)

    def bytes_used(self) -> int:
        with self._lock:
            return self._bytes

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def state(self) -> Dict[str, int]:
        """JSON-ready occupancy for flight dumps."""
        with self._lock:
            return {"entries": len(self._entries), "bytes": self._bytes,
                    "budget_bytes": self.budget_bytes,
                    "spilled": self.spilled,
                    "lru_evicted": self.lru_evicted}


def _host_id(host: Optional[int]) -> int:
    if host is not None:
        return int(host)
    return int(os.environ.get("PADDLE_TRAINER_ID", "0"))


def _hex(digest) -> str:
    return digest.hex() if isinstance(digest, (bytes, bytearray)) \
        else str(digest)


class ClusterPrefixIndex:
    """Publishes this host's resident chained page digests to the store
    under ``paddle_tpu/kv_index/<host>``, so replicas share one view of
    the cluster's prefix cache.

    :meth:`publish_once` is the unit the background thread loops over
    (tests call it directly); the store client retries transient errors
    itself, and a publish that still fails is logged and skipped.
    :meth:`offer` is cheap and lock-guarded: the engine calls it at
    prefix registration and at spill, from whichever thread ran them."""

    def __init__(self, store, host: Optional[int] = None,
                 interval: Optional[float] = None):
        self.store = store
        self.host = _host_id(host)
        if interval is None:
            v = _liveness._env_float("PADDLE_TPU_KV_INDEX_INTERVAL")
            interval = v if v is not None else 10.0
        self.interval = float(interval)
        self.published = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # guards `_digests` and `published`
        self._lock = threading.Lock()
        # insertion-ordered digest set, oldest dropped past the cap
        self._digests: "OrderedDict" = OrderedDict()

    @property
    def key(self) -> str:
        return INDEX_KEY_PREFIX + str(self.host)

    def offer(self, digests: Iterable):
        """Remember digests now resident on this host (device pool or host
        tier) for the next publication."""
        with self._lock:
            for d in digests:
                h = _hex(d)
                self._digests.pop(h, None)
                self._digests[h] = None
                while len(self._digests) > INDEX_MAX_DIGESTS:
                    self._digests.popitem(last=False)

    def withdraw(self, digests: Iterable):
        """Forget digests (a tier clear, a torn entry's discard, an LRU
        eviction)."""
        with self._lock:
            for d in digests:
                self._digests.pop(_hex(d), None)

    def snapshot_digests(self) -> Set[str]:
        """The hex digest set the next :meth:`publish_once` would ship
        (the router's affinity probe reads it for in-process replicas)."""
        with self._lock:
            return set(self._digests)

    def publish_once(self) -> str:
        with self._lock:
            digests = list(self._digests)
        doc = {"format": _FORMAT, "host": self.host, "pid": os.getpid(),
               "wall_ts": time.time(), "digests": digests}
        self.store.set(self.key, json.dumps(doc, sort_keys=True).encode())
        with self._lock:
            self.published += 1
        return self.key

    def start(self) -> "ClusterPrefixIndex":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._run, name="kv-index-publisher", daemon=True)
            self._thread.start()
        return self

    def stop(self, timeout: float = 5.0, final: bool = True):
        """Stop the loop; ``final=True`` publishes one last snapshot so
        peers hold this host's exit-time residency."""
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout)
            if t.is_alive():
                # wedged inside a store op: a final publish would race it
                # on the same key; skip it and stay bounded
                sys.stderr.write("[kv_tier] index publisher still busy "
                                 "after %.1fs; skipping final publish\n"
                                 % timeout)
                self._thread = None
                return
        self._thread = None
        if final:
            try:
                self.publish_once()
            except Exception as e:
                sys.stderr.write("[kv_tier] final index publish failed: "
                                 "%r\n" % (e,))

    def _run(self):
        while not self._stop.wait(self.interval):
            try:
                self.publish_once()
            except Exception as e:
                # the store's retries gave up, or a torn store: drop this
                # snapshot, keep the loop alive
                sys.stderr.write("[kv_tier] index publish failed "
                                 "(skipping this interval): %r\n" % (e,))


def fetch_index(store, world_size: int) -> Dict[int, Set[str]]:
    """{host: set of hex digests} for every host that published; a host
    that never published (or published garbage) is absent."""
    out: Dict[int, Set[str]] = {}
    for h in range(int(world_size)):
        try:
            raw = store.get(INDEX_KEY_PREFIX + str(h), wait=False)
            doc = json.loads(raw.decode("utf-8"))
            if doc.get("format") != _FORMAT:
                raise ValueError("unknown kv-index format %r"
                                 % doc.get("format"))
            out[h] = set(doc.get("digests", ()))
        except KeyError:
            continue
        except (ValueError, UnicodeDecodeError):
            continue
    return out
