"""Host-side page allocator for :class:`~.cache.PagedKVCache` (port of
``paddle_tpu/serving/pages.py``) — free list, refcounts, prefix hashing,
and copy-on-write decisions.

Everything here is host/numpy state; the device only ever sees the
``(num_slots, max_pages)`` page table: :meth:`PageAllocator.device_table`
keeps ONE device tensor for the allocator's life (a captured decode step
holds its address) and copies the host table into it only when the
table changed.  The allocator is the single source of truth for what a
page means:

* **Ownership** — ``refcount[p]`` counts the SLOTS mapping page ``p``.
  A page with refcount 1 is private to its slot and may be appended
  into in place; a page with refcount > 1 is **immutable** (shared) —
  any append must copy-on-write first (:meth:`~PageAllocator.needs_cow`
  / :meth:`~PageAllocator.remap`), so mutating one sharer never
  perturbs another by construction.
* **Prefix sharing** — prompt pages are content-hashed with a CHAINED
  hash (page ``i``'s digest covers tokens ``[0, (i+1)*page_size)``, so
  equal digests imply equal full prefixes, not just equal pages).  A
  partial tail page gets its own digest (exact-prefix only).  On
  admission :meth:`~PageAllocator.lookup_prefix` walks the chain and
  maps every hit to the existing page (refcount++) instead of
  recomputing it; :meth:`~PageAllocator.register_prefix` publishes a
  freshly prefilled slot's pages.  Registered pages stay safe to share
  while their owner decodes because writes are append-only (rows past
  the registered prefix) and any write to a page that has since been
  shared copy-on-writes away.
* **Reclamation** — when a slot is freed its pages' refcounts drop.  A
  page reaching refcount 0 whose content is hash-registered becomes
  **free-but-cached**: it stays reachable through its digest — so the
  next identical prompt still hits after the first request retired —
  and is reclaimed (hashes purged, then reused) only when the truly-free
  list runs dry, oldest first.  A reused page is never reachable under a
  stale digest.

Page-lifecycle events (``pages.prefix_share``, ``pages.cow_remap``,
``pages.reclaim``) land as instants on the tracer's engine lane, as in
the JAX package.  Its host-tier spill hook and the ``adopt_page`` /
``evict_cached`` entries of its host tier and disaggregated handoff are
not ported (ROADMAP.md §A3, §A6).
"""
from __future__ import annotations

import hashlib
from typing import Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from ..observability import tracing as _tracing

__all__ = ["PageAllocator", "PagePoolExhausted", "prompt_digest_chain"]


class PagePoolExhausted(RuntimeError):
    """No free page — the scheduler must evict a slot (or the caller,
    driving the engine directly, sized the pool too small)."""


def _digest(prev: bytes, tokens: np.ndarray, partial: bool) -> bytes:
    h = hashlib.sha256()
    h.update(prev)
    h.update(np.ascontiguousarray(tokens, np.int32).tobytes())
    if partial:
        h.update(b"|partial")
    return h.digest()


def prompt_digest_chain(ids: np.ndarray, page_size: int) -> List[bytes]:
    """The chained FULL-page digests of a prompt, allocator-free (the
    partial tail is left out: the chain scores whole pages)."""
    ids = np.asarray(ids, np.int32).reshape(-1)
    out, prev = [], b""
    for i in range(len(ids) // page_size):
        prev = _digest(prev, ids[i * page_size:(i + 1) * page_size],
                       partial=False)
        out.append(prev)
    return out


class PageAllocator:
    def __init__(self, num_pages: int, num_slots: int, max_pages: int,
                 page_size: int, tracer=None):
        # page-lifecycle events land on the tracer's engine lane; the
        # no-op tracer costs one empty call an event
        self._tracer = (tracer if tracer is not None
                        else _tracing.default_tracer())
        self.num_pages = int(num_pages)
        self.num_slots = int(num_slots)
        self.max_pages = int(max_pages)
        self.page_size = int(page_size)
        self.table = np.zeros((self.num_slots, self.max_pages), np.int32)
        self.mapped = np.zeros((self.num_slots, self.max_pages), bool)
        self.refcount = np.zeros((self.num_pages,), np.int32)
        # LIFO free list: recently-freed pages are reused first (their
        # bytes are most likely still cache-resident)
        self._free: List[int] = list(range(self.num_pages - 1, -1, -1))
        # free-but-cached: refcount-0 pages still reachable by digest,
        # reclaimed LRU (insertion-ordered dict) when _free runs dry
        self._cached: Dict[int, None] = {}
        self._hash_to_page: Dict[bytes, int] = {}
        self._page_hashes: Dict[int, Set[bytes]] = {}
        self._device_table = None     # the one device copy
        self._table_dirty = True      # host table changed since upload

    # -- pool accounting ---------------------------------------------------

    def pages_free(self) -> int:
        """Allocatable pages: truly free + reclaimable cached."""
        return len(self._free) + len(self._cached)

    def pages_cached(self) -> int:
        """Free-but-cached pages: refcount 0, still reachable by digest."""
        return len(self._cached)

    def pages_used(self) -> int:
        """Pages mapped by at least one slot (cached pages are free)."""
        return self.num_pages - self.pages_free()

    def slot_pages(self, slot: int) -> int:
        return int(self.mapped[slot].sum())

    def unshared_pages(self, slot: int) -> int:
        """Pages ONLY this slot maps — what freeing the slot actually
        returns to the pool (shared pages just drop a reference)."""
        ids = self.table[slot][self.mapped[slot]]
        return int((self.refcount[ids] == 1).sum())

    def mapped_rows_total(self) -> int:
        """Sum over slots of mapped rows — the KV read bound a
        length-aware paged schedule pays per decode step (each slot
        reads its own mapped pages; sharing saves storage, not reads)."""
        return int(self.mapped.sum()) * self.page_size

    # -- allocation / mapping ----------------------------------------------

    def _purge_hashes(self, pid: int):
        for d in self._page_hashes.pop(pid, ()):
            self._hash_to_page.pop(d, None)

    def alloc(self) -> int:
        if self._free:
            pid = self._free.pop()
        elif self._cached:
            # reclaim the oldest cached page: purge its digests so the
            # rewritten page is never reachable under stale content
            pid = next(iter(self._cached))
            del self._cached[pid]
            self._purge_hashes(pid)
            self._tracer.instant("pages.reclaim", page=pid,
                                 cached_left=len(self._cached))
        else:
            raise PagePoolExhausted(
                "page pool exhausted: all %d pages are mapped"
                % self.num_pages)
        self.refcount[pid] = 1
        return pid

    def map(self, slot: int, idx: int, pid: int):
        if self.mapped[slot, idx]:
            raise ValueError("slot %d page-table entry %d already mapped"
                             % (slot, idx))
        self.table[slot, idx] = pid
        self.mapped[slot, idx] = True
        self._table_dirty = True

    def share(self, slot: int, idx: int, pid: int):
        """Map an EXISTING page into a slot (prefix hit): refcount++.
        A free-but-cached page comes back off the reclaim list."""
        if self.refcount[pid] == 0:
            self._cached.pop(pid, None)
        self.refcount[pid] += 1
        self.map(slot, idx, pid)
        self._tracer.instant("pages.prefix_share", page=pid, slot=slot,
                             refcount=int(self.refcount[pid]))

    def _release(self, pid: int):
        self.refcount[pid] -= 1
        if self.refcount[pid] < 0:
            raise AssertionError("page %d refcount underflow" % pid)
        if self.refcount[pid] == 0:
            if self._page_hashes.get(pid):
                # hash-reachable: keep it cached for future prefix hits
                self._cached[pid] = None
            else:
                self._free.append(pid)

    def free_slot(self, slot: int):
        for idx in np.nonzero(self.mapped[slot])[0]:
            self._release(int(self.table[slot, idx]))
        self.table[slot] = 0
        self.mapped[slot] = False
        self._table_dirty = True

    def reset(self):
        """Free every slot AND drop the prefix cache (a hard reset —
        engine.reset() semantics: nothing survives)."""
        for s in range(self.num_slots):
            self.free_slot(s)
        self.drop_prefix_cache()

    def drop_prefix_cache(self):
        """Forget every registered digest and return cached pages to the
        free list.  Called when the model parameters change
        (``engine.refresh_state``): a prefix hit must never map pages
        whose K/V was computed under STALE weights.  Pages still mapped
        by live slots keep decoding with their existing cache — they
        just stop being hash-reachable, so no FUTURE admission shares
        them."""
        self._hash_to_page.clear()
        self._page_hashes.clear()
        self._free.extend(self._cached)
        self._cached.clear()

    # -- copy-on-write -----------------------------------------------------

    def needs_cow(self, slot: int, idx: int) -> bool:
        """True when appending into this entry's page must copy first:
        the page is mapped and some OTHER slot also references it."""
        if not self.mapped[slot, idx]:
            return False
        return int(self.refcount[self.table[slot, idx]]) > 1

    def remap(self, slot: int, idx: int, new_pid: int) -> int:
        """Point ``slot``'s entry at ``new_pid`` (the freshly-copied
        private page), dropping its reference to the shared original.
        Returns the old page id (the copy source)."""
        old = int(self.table[slot, idx])
        self.table[slot, idx] = new_pid
        self._release(old)
        self._table_dirty = True
        self._tracer.instant("pages.cow_remap", slot=slot, old=old,
                             new=int(new_pid))
        return old

    # -- prefix hashing ----------------------------------------------------

    def _prompt_digests(self, ids: np.ndarray
                        ) -> Tuple[List[bytes], Optional[bytes]]:
        """(full-page digests, partial-tail digest or None) for a prompt."""
        ids = np.asarray(ids, np.int32).reshape(-1)
        P = self.page_size
        full = len(ids) // P
        out, prev = [], b""
        for i in range(full):
            prev = _digest(prev, ids[i * P:(i + 1) * P], partial=False)
            out.append(prev)
        tail = None
        if len(ids) % P:
            tail = _digest(prev, ids[full * P:], partial=True)
        return out, tail

    def lookup_prefix(self, ids: np.ndarray) -> Tuple[List[int], int]:
        """Longest shareable prefix of ``ids``: returns (page ids to map,
        tokens covered).  Walks full-page digests while they hit; when
        EVERY full page hit and a partial tail exists, tries the tail
        digest too — a tail hit means the whole prompt is cached."""
        full_digests, tail_digest = self._prompt_digests(ids)
        pages: List[int] = []
        for d in full_digests:
            pid = self._hash_to_page.get(d)
            if pid is None:
                return pages, len(pages) * self.page_size
            pages.append(pid)
        covered = len(pages) * self.page_size
        if tail_digest is not None:
            pid = self._hash_to_page.get(tail_digest)
            if pid is not None:
                pages.append(pid)
                covered = len(ids)
        return pages, covered

    def register_prefix(self, slot: int, ids: np.ndarray):
        """Publish a fully-prefilled slot's prompt pages for sharing.
        Digests already registered (e.g. the shared pages this slot
        itself mapped) are left pointing at their existing page.
        Returns every digest now servable for this prompt."""
        full_digests, tail_digest = self._prompt_digests(ids)
        entries = list(enumerate(full_digests))
        if tail_digest is not None:
            entries.append((len(full_digests), tail_digest))
        servable = []
        for idx, d in entries:
            if d in self._hash_to_page:
                servable.append(d)
                continue
            if not self.mapped[slot, idx]:
                continue
            pid = int(self.table[slot, idx])
            self._hash_to_page[d] = pid
            self._page_hashes.setdefault(pid, set()).add(d)
            servable.append(d)
        return servable

    # -- device mirror -----------------------------------------------------

    def device_table(self, device):
        """The page table as an int64 tensor on ``device`` (the index
        dtype torch's gathers take).  The same tensor every call: the
        host table is copied into it only when it changed since the last
        call.  On a card the copy goes through pinned memory without
        waiting for the stream, so work queued before it (a decode step
        in flight) reads the table it was launched with."""
        dev = torch.device(device)
        t = self._device_table
        if t is None or t.device != dev:
            t = torch.zeros(self.table.shape, dtype=torch.int64, device=dev)
            self._device_table = t
            self._table_dirty = True
        if self._table_dirty:
            host = torch.from_numpy(self.table.astype(np.int64))
            if dev.type == "cuda":
                host = host.pin_memory()
            t.copy_(host, non_blocking=True)
            self._table_dirty = False
        return t
