"""PagedSlotPool: the paged, prefix-shared drop-in for ``serve.cache.
SlotPool``.

Counterpart of ``distributed_pytorch_tpu/serve/pages/cache.py`` at the
model's own dtype (``kv_dtype="f32"``, the exact pages). KV memory is a
block pool, per layer ONE ``(n_pages, Hkv, page_len, Dh)`` tensor for K
and V, and each slot addresses its cache through a row of page ids:

- **prefix sharing**: full pages of a prompt are keyed in a radix index
  (:mod:`.prefix`); an admitted request reuses every resident page of
  its longest matching prefix (refcount + 1, no prefill compute for the
  covered tokens) and prefills only the tail;
- **memory elasticity**: a retired request's private pages return to
  the free list at once, its indexed prompt pages stay resident at
  refcount zero until LRU eviction needs them;
- **typed back-pressure**: when every page has a live reader,
  allocation raises :class:`~..types.PagePoolExhausted` and changes
  nothing.

The page tables and lengths live on the host (numpy), so the decode
knows its page count without a device sync; the pool tensors are
allocated once and written in place. Not ported yet: the quantized
pages (``kv_dtype`` ``"q8"``/``"q4"``, ROADMAP.md Queue A item 4.1),
speculative decoding (``ensure_spec_capacity``, ``spec_verify``,
``spec_commit``: item 4.2) and the KV handoff (``extract*``,
``adopt*``: item 4.4).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ...models.generate import decode_step_slots_paged, prefill_partial_paged
from ..types import AdmissionRejected
from .pool import PagePool
from .prefix import PrefixIndex

#: resident storage formats of the JAX pool; only the exact one is ported
KV_DTYPES = ("f32", "q8", "q4")


class PagedSlotPool:
    """Owns the page-pool tensors and the page tables; all allocation,
    refcount and eviction policy is host-side."""

    def __init__(self, model, n_slots: int, max_len: int, *,
                 page_len: int, n_pages: int, prefix_share: bool = True,
                 kv_dtype: str = "f32"):
        if max_len < 1:
            raise ValueError(f"max_len must be >= 1, got {max_len}")
        if kv_dtype not in KV_DTYPES:
            raise ValueError(f"kv_dtype must be one of {KV_DTYPES}, got "
                             f"{kv_dtype!r}")
        if kv_dtype != "f32":
            raise NotImplementedError(
                f"kv_dtype={kv_dtype!r} (block-quantized pages with "
                "per-page scales) is not ported yet (ROADMAP.md Queue A "
                "item 4.1, KV quantization)")
        self.model = model
        self.n_slots = n_slots
        self.max_len = max_len
        self.page_len = page_len
        self.n_pages = n_pages
        self.prefix_share = prefix_share
        self.kv_dtype = kv_dtype
        self.pages_per_slot = -(-max_len // page_len)   # ceil
        dh = model.dim // model.n_heads
        shape = (n_pages, model.n_kv_heads, page_len, dh)
        self.k_pages: List[torch.Tensor] = [
            torch.zeros(shape, dtype=model.dtype, device=model.device)
            for _ in range(model.n_layers)]
        self.v_pages: List[torch.Tensor] = [
            torch.zeros(shape, dtype=model.dtype, device=model.device)
            for _ in range(model.n_layers)]
        self.tables = np.zeros((n_slots, self.pages_per_slot), np.int64)
        self.lengths = np.zeros((n_slots,), np.int64)
        self.owned: List[List[int]] = [[] for _ in range(n_slots)]
        self.pool = PagePool(n_pages, page_len)
        self.index = PrefixIndex(page_len)
        self.admits: Dict[int, int] = {}     # tail bucket -> admits
        self.decode_steps = 0
        # cumulative sharing counters (engine metrics)
        self.prefix_lookups = 0
        self.prefix_hit_pages_total = 0
        self.prefill_tokens_saved_total = 0
        self.prompt_tokens_total = 0

    # -- allocation --------------------------------------------------------

    def _alloc(self, n: int) -> List[int]:
        """``n`` pages: free list first, then LRU eviction of
        refcount-zero indexed pages; all-or-nothing (a partial grab is
        rolled back before the typed exhaustion raise)."""
        out: List[int] = []
        while len(out) < n:
            pid = self.pool.take_free()
            if pid is None:
                evicted = self.index.evict_lru(self.pool)
                if evicted is None:
                    for p in out:
                        self.pool.release_to_free(p)
                    raise self.pool.exhausted(n)
                self.pool.reclaim(evicted)
                pid = evicted
            out.append(pid)
        return out

    # -- host front ends ---------------------------------------------------

    def admit(self, prompt: np.ndarray, slot: int,
              buckets: Tuple[int, ...]):
        """Admit ``prompt`` ((S,) ints) into ``slot``: radix prefix
        lookup, refcount the matched full pages, allocate and prefill
        only the tail, index the prompt's full pages. Returns
        ``(last-position logits (1, vocab), n_hit pages, offset
        tokens)``. Raises :class:`PagePoolExhausted` (no slot state
        changed) when the tail cannot be allocated, and a typed
        :class:`AdmissionRejected` (``reason="tail_too_long"``), before
        any page is touched, when the tail exceeds every bucket."""
        s = int(prompt.shape[0])
        L = self.page_len
        hits: List[int] = []
        if self.prefix_share:
            # at least one real token must remain for the tail prefill:
            # the last prompt position's logits come from it
            hits = self.index.match(prompt, (s - 1) // L, self.pool)
        self.prefix_lookups += 1
        n_hit = len(hits)
        offset = n_hit * L
        tail_len = s - offset
        n_fresh = -(-s // L) - n_hit
        bucket = next((b for b in buckets if b >= tail_len), None)
        if bucket is None:
            raise AdmissionRejected(
                f"prompt tail ({tail_len} token(s) after {n_hit} shared "
                f"page(s)) exceeds the largest prefill bucket "
                f"({max(buckets)})", reason="tail_too_long")
        # incref the matched pages BEFORE allocating: eviction considers
        # refcount-zero pages only, so this request's tail cannot steal
        # its own prefix
        for pid in hits:
            self.pool.incref(pid)
        try:
            fresh = self._alloc(n_fresh)
        except Exception:
            for pid in hits:
                self.pool.decref(pid)
            raise
        row = hits + fresh
        self.tables[slot, :len(row)] = row
        self.tables[slot, len(row):] = 0
        self.owned[slot] = row
        padded = torch.zeros((1, bucket), dtype=torch.long,
                             device=self.model.device)
        padded[0, :tail_len] = torch.from_numpy(
            np.asarray(prompt[offset:], np.int64))
        self.admits[bucket] = self.admits.get(bucket, 0) + 1
        logits, _, _ = prefill_partial_paged(
            self.model, self.k_pages, self.v_pages, self.tables[slot],
            padded, offset, tail_len, page_len=L)
        self.lengths[slot] = s
        if self.prefix_share:
            self.index.insert(prompt, s // L, row, self.pool)
        self.prefix_hit_pages_total += n_hit
        self.prefill_tokens_saved_total += offset
        self.prompt_tokens_total += s
        return logits, n_hit, offset

    def ensure_decode_capacity(self, slot: int) -> None:
        """Grow ``slot``'s page table when its next decode write crosses
        a page boundary. Raises :class:`PagePoolExhausted` (slot state
        unchanged) when no page can be supplied."""
        need_idx = int(self.lengths[slot]) // self.page_len
        row = self.owned[slot]
        if need_idx < len(row):
            return
        pid = self._alloc(1)[0]
        row.append(pid)
        self.tables[slot, need_idx] = pid

    def decode(self, tokens, active: np.ndarray):
        """Advance every active slot one position (inactive rows neither
        write the pool nor advance). Returns (n_slots, vocab) logits."""
        self.decode_steps += 1
        active = np.asarray(active, bool)
        logits, _, _ = decode_step_slots_paged(
            self.model, self.k_pages, self.v_pages, self.tables,
            self.lengths, tokens, active, page_len=self.page_len)
        self.lengths[active] += 1
        return logits

    def release(self, slot: int) -> None:
        """Drop the slot's references (retirement, failure or drain):
        private pages go back to the free list, indexed pages stay
        resident for later prefix hits until LRU-evicted."""
        for pid in self.owned[slot]:
            self.pool.decref(pid)
        self.owned[slot] = []
        self.tables[slot, :] = 0
        self.lengths[slot] = 0

    # -- introspection -----------------------------------------------------

    def prefix_hit_rate(self) -> Optional[float]:
        """Cumulative share of prompt tokens served from resident pages
        (None before the first admission)."""
        if self.prompt_tokens_total == 0:
            return None
        return self.prefill_tokens_saved_total / self.prompt_tokens_total

    def kv_bits(self) -> int:
        """Resident bits per KV element (the model dtype's width)."""
        return self.k_pages[0].element_size() * 8

    def kv_pool_bytes(self) -> int:
        """Resident KV footprint: pages, K and V, all layers."""
        return sum(t.numel() * t.element_size()
                   for t in self.k_pages + self.v_pages)

    def bytes_per_resident_token(self) -> float:
        """Pool bytes per token position the pool can hold."""
        return self.kv_pool_bytes() / float(self.n_pages * self.page_len)

    def page_stats(self) -> Dict:
        return {"n_pages": self.n_pages,
                "page_len": self.page_len,
                "kv_dtype": self.kv_dtype,
                "kv_bits": self.kv_bits(),
                "kv_pool_bytes": self.kv_pool_bytes(),
                "bytes_per_resident_token": self.bytes_per_resident_token(),
                "free_pages": self.pool.free_pages,
                "pages_in_use": self.pool.pages_in_use,
                "pool_occupancy": self.pool.occupancy(),
                "indexed_pages": len(self.index),
                "evictions": self.pool.evictions,
                "prefix_lookups": self.prefix_lookups,
                "prefix_hit_pages": self.prefix_hit_pages_total,
                "prefill_tokens_saved": self.prefill_tokens_saved_total,
                "prefix_hit_rate": self.prefix_hit_rate()}
