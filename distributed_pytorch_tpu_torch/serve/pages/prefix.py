"""Radix prefix index: token-id chunks → resident KV pages.

The port's copy of ``distributed_pytorch_tpu/serve/pages/prefix.py``:
the same operations make the same choices (matches, insertions, LRU
evictions) as the JAX index.

A trie whose edges are FULL page-sized token chunks (``page_len`` ids,
keyed by their bytes): the node at depth ``d`` holds the pool page
caching positions ``[d*page_len, (d+1)*page_len)`` of every prompt that
shares that chunk chain. Admission walks the trie over the prompt's
full-page chunks; every match is a page of prefill the engine never
recomputes (refcount++ and straight into the slot's page table).

Two structural rules keep sharing sound:

- **Only full pages are indexed.** A partial tail page is private to
  its slot (decode keeps writing it), so it can never be shared —
  indexing happens at admission over ``prompt_len // page_len`` chunks
  only, and a lookup is additionally capped at
  ``(prompt_len - 1) // page_len`` so at least one real token always
  remains for the tail prefill (logits for the last prompt position
  have to come from somewhere).
- **Indexed pages are immutable.** A page enters the index only after
  its prefill write completes, and every later write lands in some
  slot's private tail page — so a refcount just gates *residency*,
  never consistency.

Eviction is leaf-first LRU over refcount-zero nodes. Safety rests on
two facts: candidates are restricted to CHILDLESS nodes (an interior
page can never be evicted, so no resident descendant is ever stranded),
and because a slot referencing a page at depth ``d`` references the
whole chain above it, ``refcount(parent) >= refcount(child)`` — a page
with live readers is never refcount-zero and so never a candidate.
Among the candidates the least-recently-touched leaf goes first; as a
stale chain's leaves are reclaimed its parents become leaves and follow.
(The candidate scan is linear in the indexed-page count — fine at the
hundreds-of-pages scale the engine runs today; a last_used heap over
refcount-zero leaves is the upgrade path if pools grow to many
thousands of pages.)
"""

from __future__ import annotations

from typing import Dict, List, Optional

from .pool import PagePool


class _Node:
    __slots__ = ("page", "chunk", "parent", "children")

    def __init__(self, page: Optional[int], chunk: Optional[bytes],
                 parent: Optional["_Node"]):
        self.page = page
        self.chunk = chunk
        self.parent = parent
        self.children: Dict[bytes, "_Node"] = {}


class PrefixIndex:
    """The trie plus a ``page id -> node`` map for O(1) eviction."""

    def __init__(self, page_len: int):
        self.page_len = page_len
        self._root = _Node(page=None, chunk=None, parent=None)
        self._nodes: Dict[int, _Node] = {}

    def __len__(self) -> int:
        return len(self._nodes)

    def _chunk(self, tokens, j: int) -> bytes:
        L = self.page_len
        return tokens[j * L:(j + 1) * L].tobytes()

    def match(self, tokens, max_pages: int, pool: PagePool) -> List[int]:
        """Longest resident chain of full-page chunks of ``tokens``
        (np int32), capped at ``max_pages``. Touches every matched page
        (LRU) but does NOT incref — the caller increfs the pages it
        actually admits, so a failed admission cannot leak a count."""
        out: List[int] = []
        node = self._root
        for j in range(max_pages):
            child = node.children.get(self._chunk(tokens, j))
            if child is None:
                break
            out.append(child.page)
            pool.touch(child.page)
            node = child
        return out

    def insert(self, tokens, n_full: int, page_ids: List[int],
               pool: PagePool) -> int:
        """Index the first ``n_full`` full-page chunks of ``tokens``,
        backed by the admitting slot's pages ``page_ids`` (its page
        table prefix). Chunks already resident keep their existing page
        (the newcomer's duplicate stays private and dies with the slot);
        new chunks adopt the slot's page. Returns how many pages were
        newly indexed."""
        node = self._root
        added = 0
        for j in range(n_full):
            chunk = self._chunk(tokens, j)
            child = node.children.get(chunk)
            if child is None:
                pid = page_ids[j]
                if pool.indexed[pid]:
                    raise ValueError(
                        f"page {pid} already indexed — a slot page can "
                        f"back at most one trie node")
                child = _Node(page=pid, chunk=chunk, parent=node)
                node.children[chunk] = child
                self._nodes[pid] = child
                pool.indexed[pid] = True
                pool.touch(pid)
                added += 1
            node = child
        return added

    def evict_lru(self, pool: PagePool) -> Optional[int]:
        """Reclaim the least-recently-used refcount-zero LEAF page:
        remove it from the trie, clear its residency flag, and return
        its id for immediate reuse (refcount handled by the caller via
        ``pool.reclaim``). Returns None when nothing is evictable —
        a page with live readers is NEVER a candidate."""
        best: Optional[int] = None
        for pid, node in self._nodes.items():
            if node.children or pool.refcount[pid] != 0:
                continue
            if best is None or pool.last_used[pid] < pool.last_used[best]:
                best = pid
        if best is None:
            return None
        node = self._nodes.pop(best)
        del node.parent.children[node.chunk]
        pool.indexed[best] = False
        pool.evictions += 1
        return best
