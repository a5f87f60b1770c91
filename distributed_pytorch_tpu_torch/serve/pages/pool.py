"""Host-side accounting for the paged KV block pool.

The port's copy of ``distributed_pytorch_tpu/serve/pages/pool.py``. The
device side of paging is plain on purpose: per layer one ``(n_pages,
Hkv, page_len, Dh)`` tensor and per-slot page tables, addressed by the
paged decode and prefill (``models/generate.py``). All policy lives
here, on the host, in plain Python:

- **refcounts**: a page's refcount is the number of live slots whose
  page table names it. Shared prefix pages have refcount == number of
  concurrent readers; a slot's private tail pages have refcount 1.
- **free list**: pages that are neither referenced nor resident in the
  prefix index. Allocation pops here first.
- **LRU residency**: a page the prefix index holds stays resident at
  refcount zero (that is the whole point — the NEXT request with the
  same system prompt reuses it), and is reclaimed lazily: when the free
  list is empty, allocation evicts the least-recently-used
  refcount-zero indexed page (``PrefixIndex.evict_lru`` — leaf-first,
  so a chain is always reclaimed from its deepest unused page).
- **typed exhaustion**: when every page is held by a live reader,
  allocation raises :class:`~..types.PagePoolExhausted` with
  ``needed``/``free_pages`` attribution. The engine decides what that
  means (admission back-pressure vs a mid-decode victim).

Every invariant here is host state only, so the policy layer is
unit-tested without a model.
"""

from __future__ import annotations

from typing import List, Optional

from ..types import PagePoolExhausted


class PagePool:
    """Refcount + free-list + LRU-clock bookkeeping over page ids
    ``0..n_pages-1`` (one id spans every layer's K and V buffers)."""

    def __init__(self, n_pages: int, page_len: int):
        if n_pages < 1:
            raise ValueError(f"n_pages must be >= 1, got {n_pages}")
        if page_len < 1:
            raise ValueError(f"page_len must be >= 1, got {page_len}")
        self.n_pages = n_pages
        self.page_len = page_len
        self.refcount: List[int] = [0] * n_pages
        #: resident in the prefix index (refcount-zero pages with this
        #: flag are LRU-evictable, NOT free)
        self.indexed: List[bool] = [False] * n_pages
        self.last_used: List[int] = [0] * n_pages
        self._free: List[int] = list(range(n_pages))[::-1]  # pop() -> 0,1,..
        self._clock = 0
        self.evictions = 0

    # -- introspection -----------------------------------------------------

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def pages_in_use(self) -> int:
        """Pages not on the free list (referenced OR index-resident)."""
        return self.n_pages - len(self._free)

    def occupancy(self) -> float:
        return self.pages_in_use / self.n_pages

    def live_pages(self) -> int:
        """Pages with at least one live reader."""
        return sum(1 for rc in self.refcount if rc > 0)

    # -- lifecycle ---------------------------------------------------------

    def touch(self, pid: int) -> None:
        self._clock += 1
        self.last_used[pid] = self._clock

    def incref(self, pid: int) -> None:
        self.refcount[pid] += 1
        self.touch(pid)

    def decref(self, pid: int) -> None:
        rc = self.refcount[pid] - 1
        if rc < 0:
            raise ValueError(
                f"page {pid} decref below zero — double release "
                f"(refcount bookkeeping bug)")
        self.refcount[pid] = rc
        if rc == 0 and not self.indexed[pid]:
            # a private page with no readers is plain free; an indexed
            # page stays RESIDENT (evictable) so future prefixes hit it
            self._free.append(pid)

    def take_free(self) -> Optional[int]:
        """Pop one page off the free list (refcount set to 1), or None."""
        if not self._free:
            return None
        pid = self._free.pop()
        self.refcount[pid] = 1
        self.touch(pid)
        return pid

    def reclaim(self, pid: int) -> None:
        """Hand an evicted page (refcount 0, just un-indexed by the
        prefix index) directly to a new owner path: refcount to 1."""
        if self.refcount[pid] != 0 or self.indexed[pid]:
            raise ValueError(
                f"page {pid} reclaimed while live (rc="
                f"{self.refcount[pid]}, indexed={self.indexed[pid]}) — "
                f"eviction must never touch a page with readers")
        self.refcount[pid] = 1
        self.touch(pid)

    def release_to_free(self, pid: int) -> None:
        """Return a just-allocated page (refcount 1, unindexed) to the
        free list — the rollback path of a partially failed allocation."""
        if self.refcount[pid] != 1 or self.indexed[pid]:
            raise ValueError(f"page {pid} cannot roll back (rc="
                             f"{self.refcount[pid]})")
        self.refcount[pid] = 0
        self._free.append(pid)

    def exhausted(self, needed: int) -> PagePoolExhausted:
        """The typed exhaustion error (raised by the allocation loop in
        ``PagedSlotPool`` once the free list AND the evictable set are
        both dry)."""
        return PagePoolExhausted(
            f"page pool exhausted: {needed} page(s) needed, "
            f"{len(self._free)} free, {self.live_pages()} of "
            f"{self.n_pages} held by live readers",
            needed=needed, free_pages=len(self._free))
