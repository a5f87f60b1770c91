"""PagedSlotPool: the paged, prefix-shared drop-in for ``serve.cache.
SlotPool``.

Counterpart of ``distributed_pytorch_tpu/serve/pages/cache.py``. KV
memory is a block pool, per layer ONE ``(n_pages, Hkv, page_len, Dh)``
tensor for K and V, and each slot addresses its cache through a row of
page ids:

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

``kv_dtype`` selects the resident storage (:mod:`.quant`): ``"f32"``
keeps exact pages in the model's dtype; ``"q8"``/``"q4"`` keep
block-quantized pages (int8, or nibble-packed uint8 ``(..., Dh // 2)``)
with per-page-per-block f32 scales, and per-slot f32 tails holding each
slot's partial page, so every element is quantized once, when its page
completes. Speculative decoding scores candidates with
:meth:`PagedSlotPool.spec_verify` (writing nothing) and commits the
accepted prefix with :meth:`PagedSlotPool.spec_commit`, after
:meth:`PagedSlotPool.ensure_spec_capacity` found its pages.

The disaggregated KV-page handoff (``serve/disagg/``) reads a slot's
pages out with :meth:`PagedSlotPool.extract` (f32 host arrays) or
:meth:`PagedSlotPool.extract_quantized` (a quantized pool's resident
codes and scales) and installs them in another pool with
:meth:`PagedSlotPool.adopt` / :meth:`PagedSlotPool.adopt_quantized`,
through the same allocation path admissions use.

The page tables and lengths live on the host (numpy), so the decode
knows its page count without a device sync; the pool tensors are
allocated once and written in place.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ...models.generate import (decode_step_slots_paged,
                                prefill_partial_paged,
                                spec_commit_slots_paged,
                                spec_verify_slots_paged)
from ..types import AdmissionRejected
from .pool import PagePool
from .prefix import PrefixIndex
from .quant import (dequantize_pages_np, num_page_blocks, pack_pages_np,
                    quantize_pages_np, resolve_kv_bits, unpack_pages_np)


class PagedSlotPool:
    """Owns the page-pool tensors and the page tables; all allocation,
    refcount and eviction policy is host-side."""

    def __init__(self, model, n_slots: int, max_len: int, *,
                 page_len: int, n_pages: int, prefix_share: bool = True,
                 kv_dtype: str = "f32"):
        if max_len < 1:
            raise ValueError(f"max_len must be >= 1, got {max_len}")
        self.quant_bits = resolve_kv_bits(kv_dtype)
        self.model = model
        self.n_slots = n_slots
        self.max_len = max_len
        self.page_len = page_len
        self.n_pages = n_pages
        self.prefix_share = prefix_share
        self.kv_dtype = kv_dtype
        self.pages_per_slot = -(-max_len // page_len)   # ceil
        dh = model.dim // model.n_heads
        h_kv, dev, n_layers = model.n_kv_heads, model.device, model.n_layers
        self.page_shape = (h_kv, page_len, dh)
        self.k_scales = self.v_scales = self.k_tail = self.v_tail = None
        if self.quant_bits is None:
            shape, store = (n_pages, h_kv, page_len, dh), model.dtype
        else:
            if self.quant_bits == 4 and dh % 2:
                raise ValueError(
                    f"kv_dtype='q4' packs two nibbles per byte along the "
                    f"head dim, which must be even (got Dh={dh})")
            shape = (n_pages, h_kv, page_len,
                     dh // 2 if self.quant_bits == 4 else dh)
            store = torch.uint8 if self.quant_bits == 4 else torch.int8
            nb = num_page_blocks(h_kv, page_len, dh)
            # scale 1 is the codec's all-zero snap: a never-written page
            # dequantizes to exact zeros
            self.k_scales, self.v_scales = (
                [torch.ones((n_pages, nb), dtype=torch.float32, device=dev)
                 for _ in range(n_layers)] for _ in range(2))
            self.k_tail, self.v_tail = (
                [torch.zeros((n_slots, h_kv, page_len, dh),
                             dtype=torch.float32, device=dev)
                 for _ in range(n_layers)] for _ in range(2))
        self.k_pages: List[torch.Tensor] = [
            torch.zeros(shape, dtype=store, device=dev)
            for _ in range(n_layers)]
        self.v_pages: List[torch.Tensor] = [
            torch.zeros(shape, dtype=store, device=dev)
            for _ in range(n_layers)]
        self.tables = np.zeros((n_slots, self.pages_per_slot), np.int64)
        self.lengths = np.zeros((n_slots,), np.int64)
        self.owned: List[List[int]] = [[] for _ in range(n_slots)]
        self.pool = PagePool(n_pages, page_len)
        self.index = PrefixIndex(page_len)
        self.admits: Dict[int, int] = {}     # tail bucket -> admits
        self.decode_steps = 0
        self.verify_steps = 0
        # cumulative sharing counters (engine metrics)
        self.prefix_lookups = 0
        self.prefix_hit_pages_total = 0
        self.prefill_tokens_saved_total = 0
        self.prompt_tokens_total = 0

    def _quant_kw(self) -> Dict:
        """The quantized pool's extra arguments of the paged ops (none
        for an exact pool)."""
        if self.quant_bits is None:
            return {}
        return dict(kv_bits=self.quant_bits, k_scales=self.k_scales,
                    v_scales=self.v_scales, k_tail=self.k_tail,
                    v_tail=self.v_tail)

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
        kw = self._quant_kw()
        if kw:
            kw["slot"] = slot
        logits = prefill_partial_paged(
            self.model, self.k_pages, self.v_pages, self.tables[slot],
            padded, offset, tail_len, page_len=L, **kw)[0]
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
        logits = decode_step_slots_paged(
            self.model, self.k_pages, self.v_pages, self.tables,
            self.lengths, tokens, active, page_len=self.page_len,
            **self._quant_kw())[0]
        self.lengths[active] += 1
        return logits

    def ensure_spec_capacity(self, slot: int, n_new: int) -> None:
        """Grow ``slot``'s page table so its next ``n_new`` committed
        positions all have pages: called once acceptance is known, so
        only accepted tokens demand pages. All-or-nothing: on
        :class:`PagePoolExhausted` no slot state changed."""
        if n_new <= 0:
            return
        last = int(self.lengths[slot]) + n_new - 1
        row = self.owned[slot]
        missing = last // self.page_len + 1 - len(row)
        if missing <= 0:
            return
        for pid in self._alloc(missing):     # all-or-nothing; may raise
            self.tables[slot, len(row)] = pid
            row.append(pid)

    def spec_verify(self, tokens):
        """Score every row's k+1 candidates ((n_slots, k+1) ints) in one
        batched forward without writing the pool (so a rejection, at a
        page boundary too, never quantizes a partial page). Returns
        (logits (n_slots, k+1, vocab), sk, sv), sk/sv the per-layer f32
        candidate K/V."""
        self.verify_steps += 1
        return spec_verify_slots_paged(
            self.model, self.k_pages, self.v_pages, self.tables,
            self.lengths, tokens, page_len=self.page_len,
            **self._quant_kw())

    def spec_commit(self, sk, sv, commit) -> None:
        """Write each row's accepted prefix (``commit`` (n_slots,) ints,
        0: not speculating) into its pages and advance the host lengths;
        in a quantized pool a page quantizes once, when an accepted
        token completes it."""
        spec_commit_slots_paged(self.k_pages, self.v_pages, self.tables,
                                self.lengths, sk, sv, commit,
                                page_len=self.page_len, **self._quant_kw())
        self.lengths += np.asarray(commit, np.int64)

    # -- the disaggregated KV-page handoff ---------------------------------

    def _gather(self, tensors, ids: torch.Tensor, dtype=None) -> np.ndarray:
        """Pages ``ids`` of every layer's tensor, gathered on the device
        (cast to ``dtype`` there, when given) and copied to the host in
        one transfer: (n_layers, P, ...)."""
        x = torch.stack([t[ids] for t in tensors])
        return (x if dtype is None else x.to(dtype)).cpu().numpy()

    def _handoff_rows(self, slot: int):
        length = int(self.lengths[slot])
        row = self.owned[slot]
        valid_last = length - (len(row) - 1) * self.page_len
        ids = torch.as_tensor(np.asarray(row, np.int64),
                              device=self.model.device)
        return length, valid_last, ids

    def _resident_codes(self, slot: int):
        """A quantized pool's handoff material for ``slot``: ``(length,
        codes, scales, tails)``; codes[j] / scales[j] for K (j = 0) and
        V (j = 1) as (n_layers, P, Hkv, L, Dh) int8 unpacked and
        (n_layers, P, nb) f32; tails (2, n_layers, Hkv, L, Dh) f32, the
        slot's exact partial page zeroed past the length, or None when
        the length is page-aligned."""
        length, valid_last, ids = self._handoff_rows(slot)
        codes, scales = [], []
        for pages, sc in ((self.k_pages, self.k_scales),
                          (self.v_pages, self.v_scales)):
            q = self._gather(pages, ids)
            codes.append(unpack_pages_np(q) if self.quant_bits == 4
                         else q.astype(np.int8, copy=False))
            scales.append(self._gather(sc, ids))
        tails = None
        if valid_last < self.page_len:
            tails = torch.stack([torch.stack([x[slot] for x in self.k_tail]),
                                 torch.stack([x[slot] for x in self.v_tail])]
                                ).cpu().numpy()
            tails[:, :, :, valid_last:, :] = 0.0
        return length, codes, scales, tails

    def extract(self, slot: int) -> Tuple[int, List[np.ndarray],
                                          List[np.ndarray]]:
        """Host copies of ``slot``'s pages in table order, the prefill
        side of the KV-page handoff: ``(length, ks, vs)``, ks/vs per
        layer ``(P, Hkv, page_len, Dh)`` f32 numpy arrays. Only the
        slot's pages cross to the host. Positions past ``length`` in the
        last page are zeroed (a reused page may hold a previous
        occupant's K/V there, which would skew a quantized frame's
        scales).

        In a quantized pool the full pages are dequantized on the host
        and the partial last page comes from the slot's exact f32 tail
        (its pool row was never written), so it carries no quantization
        error."""
        if self.quant_bits is not None:
            length, codes, scales, tails = self._resident_codes(slot)
            out = []
            for j in range(2):
                per_layer = [dequantize_pages_np(q, sc)
                             for q, sc in zip(codes[j], scales[j])]
                if tails is not None:
                    for x, t in zip(per_layer, tails[j]):
                        x[-1] = t
                out.append(per_layer)
            return length, out[0], out[1]
        length, valid_last, ids = self._handoff_rows(slot)
        ks = self._gather(self.k_pages, ids, torch.float32)
        vs = self._gather(self.v_pages, ids, torch.float32)
        if valid_last < self.page_len:
            ks[:, -1, :, valid_last:, :] = 0.0
            vs[:, -1, :, valid_last:, :] = 0.0
        return length, list(ks), list(vs)

    def extract_quantized(self, slot: int):
        """A quantized pool's handoff without a dequantize-requantize
        round trip: ``(length, kqs, vqs)``, each per-layer entry ``(q,
        scales)`` with ``q`` ``(P, Hkv, page_len, Dh)`` int8 unpacked and
        ``scales`` ``(P, nb)`` f32: the pool's resident codes and scales
        for full pages; the partial last page quantized once here from
        the exact zero-padded tail."""
        if self.quant_bits is None:
            raise ValueError("extract_quantized requires a quantized "
                             "pool (kv_dtype='q8'/'q4')")
        length, codes, scales, tails = self._resident_codes(slot)
        if tails is not None:
            for j in range(2):
                for i in range(self.model.n_layers):
                    tq, ts = quantize_pages_np(tails[j, i][None],
                                               self.quant_bits)
                    codes[j][i, -1], scales[j][i, -1] = tq[0], ts[0]
        return length, [(q, sc) for q, sc in zip(codes[0], scales[0])], \
            [(q, sc) for q, sc in zip(codes[1], scales[1])]

    def _adopt_rows(self, slot: int, n: int) -> torch.Tensor:
        pids = self._alloc(n)          # all-or-nothing; may raise
        self.tables[slot, :n] = pids
        self.tables[slot, n:] = 0
        self.owned[slot] = pids
        return torch.as_tensor(np.asarray(pids, np.int64),
                               device=self.model.device)

    def _put(self, tensors, ids: torch.Tensor, host: np.ndarray) -> None:
        """Write ``host`` (n_layers, P, ...) into pages ``ids`` of every
        layer's tensor: one host-to-device copy on the current stream."""
        dev = torch.from_numpy(np.ascontiguousarray(host)).to(
            self.model.device)
        for t, x in zip(tensors, dev):
            t[ids] = x.to(t.dtype)

    def _put_tails(self, slot: int, tails: np.ndarray) -> None:
        dev = torch.from_numpy(np.ascontiguousarray(tails)).to(
            self.model.device)
        for j, bufs in enumerate((self.k_tail, self.v_tail)):
            for t, x in zip(bufs, dev[j]):
                t[slot] = x

    def adopt(self, slot: int, length: int, ks: List[np.ndarray],
              vs: List[np.ndarray]) -> int:
        """Install a handed-off request's pages (``extract``'s f32
        arrays) into ``slot``, the decode side of the handoff. Pages come
        from the admissions' allocation path (free list, then LRU
        eviction), so :class:`~..types.PagePoolExhausted` is raised with
        nothing changed when the pool cannot supply them. Returns the
        page count.

        In a quantized pool the full pages are quantized here (their one
        rounding: extract shipped exact values) and the partial last
        page goes into the slot's f32 tail; on a page-aligned length the
        tail is zeroed, so a previous occupant's tail never shows
        through."""
        n = int(ks[0].shape[0])
        ids = self._adopt_rows(slot, n)
        if self.quant_bits is None:
            self._put(self.k_pages, ids, np.stack(ks))
            self._put(self.v_pages, ids, np.stack(vs))
            self.lengths[slot] = length
            return n
        L = self.page_len
        nfull = length // L
        valid_last = length - (n - 1) * L
        tails = np.zeros((2, self.model.n_layers) + self.page_shape,
                         np.float32)
        for j, (src, pages, scales) in enumerate((
                (ks, self.k_pages, self.k_scales),
                (vs, self.v_pages, self.v_scales))):
            q = np.zeros((self.model.n_layers, n) + self.page_shape, np.int8)
            sc = np.ones((self.model.n_layers, n, scales[0].shape[1]),
                         np.float32)
            for i in range(self.model.n_layers):
                if nfull:
                    q[i, :nfull], sc[i, :nfull] = quantize_pages_np(
                        src[i][:nfull], self.quant_bits)
                if valid_last < L:
                    tails[j, i] = src[i][-1]
                    tails[j, i, :, valid_last:, :] = 0.0
            self._put(pages, ids,
                      pack_pages_np(q) if self.quant_bits == 4 else q)
            self._put(scales, ids, sc)
        self._put_tails(slot, tails)
        self.lengths[slot] = length
        return n

    def adopt_quantized(self, slot: int, length: int, kqs, vqs) -> int:
        """Inverse of :meth:`extract_quantized`: install already-quantized
        ``(q, scales)`` pages as they are, with no rounding; the partial
        last page is also dequantized (exactly, given its codes and
        scales) into the slot's tail, which the decode reads and the
        page's completion quantizes."""
        if self.quant_bits is None:
            raise ValueError("adopt_quantized requires a quantized "
                             "pool (kv_dtype='q8'/'q4')")
        n = int(kqs[0][0].shape[0])
        ids = self._adopt_rows(slot, n)
        L = self.page_len
        valid_last = length - (n - 1) * L
        tails = np.zeros((2, self.model.n_layers) + self.page_shape,
                         np.float32)
        for j, (src, pages, scales) in enumerate((
                (kqs, self.k_pages, self.k_scales),
                (vqs, self.v_pages, self.v_scales))):
            q = np.stack([np.ascontiguousarray(x[0], np.int8) for x in src])
            sc = np.stack([np.asarray(x[1], np.float32) for x in src])
            if valid_last < L:
                for i in range(self.model.n_layers):
                    tails[j, i] = dequantize_pages_np(q[i, -1:],
                                                      sc[i, -1:])[0]
                tails[j, :, :, valid_last:, :] = 0.0
            self._put(pages, ids,
                      pack_pages_np(q) if self.quant_bits == 4 else q)
            self._put(scales, ids, sc)
        self._put_tails(slot, tails)
        self.lengths[slot] = length
        return n

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
        """Resident bits per KV element: the quant width, or the model
        dtype's width for exact pages."""
        if self.quant_bits is not None:
            return self.quant_bits
        return self.k_pages[0].element_size() * 8

    @staticmethod
    def _nbytes(tensors) -> int:
        return sum(t.numel() * t.element_size() for t in tensors)

    def kv_pool_bytes(self) -> int:
        """Resident KV footprint: pages, and in a quantized pool their
        scales and the per-slot tails, K and V, all layers."""
        total = self._nbytes(self.k_pages + self.v_pages)
        if self.quant_bits is not None:
            total += self._nbytes(self.k_scales + self.v_scales
                                  + self.k_tail + self.v_tail)
        return total

    def bytes_per_resident_token(self) -> float:
        """Pool bytes (pages and scales; the tails are per slot, not per
        page) per token position the pool can hold."""
        total = self._nbytes(self.k_pages + self.v_pages)
        if self.quant_bits is not None:
            total += self._nbytes(self.k_scales + self.v_scales)
        return total / float(self.n_pages * self.page_len)

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
