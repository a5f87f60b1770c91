"""Blockwise decode attention: single-token attention over a contiguous
KV cache that visits only the blocks holding resident positions.

Counterpart of ``distributed_pytorch_tpu/ops/decode_attention.py``
(``resident_blocks``, ``dense_decode_attention``,
``blockwise_decode_attention``, ``paged_decode_attention`` with its
quantized pages), plus the speculative verify's attention
(``blockwise_verify_attention``, ``paged_verify_attention``: k+1 query
rows at consecutive positions, each merging the very blocks a decode
step at its position merges). The JAX package writes these with jnp and
a ``fori_loop``, not Pallas, so they are PyTorch ops here too. The
loop's trip count is a host int from ``max(lengths)``.

Numerics: the running max ``m``, normalizer ``l`` and accumulator are
float32 whatever the cache dtype; masked logits take the finite
``_MASK`` sentinel and masked probabilities are exact zeros, so a
fully masked block never makes NaN; p is cast to the cache dtype for
the p@v product.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .flash_attention import _MASK
from .quant import (dequantize_page_blocks, page_block_map,
                    quantize_page_blocks, unpack_page_nibbles)

__all__ = ["DECODE_BLOCK", "blockwise_decode_attention",
           "blockwise_verify_attention", "dense_decode_attention",
           "paged_decode_attention", "paged_verify_attention",
           "resident_blocks"]

#: Block length of a contiguous cache.
DECODE_BLOCK = 128


def resident_blocks(lengths, block_len: int, total_blocks: int) -> int:
    """Number of leading blocks holding any resident position.
    ``lengths`` are the current write positions (host ints, a numpy
    array or a tensor; a tensor costs one device sync)."""
    if isinstance(lengths, torch.Tensor):
        top = int(lengths.max().item())
    else:
        top = int(np.max(np.asarray(lengths)))
    return min(top // block_len + 1, total_blocks)


def dense_decode_attention(hq, k, v, pos_mask, *, scale):
    """Dense full-width decode softmax (the reference of the blockwise
    version). hq (B, H, 1, Dh); k, v (B, Hkv, W, Dh); pos_mask (B, W) or
    (1, W) bool, True where visible. A row with no visible position is
    NaN."""
    b, h, _, dh = hq.shape
    hkv = k.shape[1]
    hq_g = hq.reshape(b, hkv, h // hkv, 1, dh)
    logits = torch.einsum("bngqd,bnkd->bngqk", hq_g, k).to(torch.float32) \
        * scale
    logits = logits.masked_fill(~pos_mask[:, None, None, None, :],
                                float("-inf"))
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bngqk,bnkd->bngqd", probs, v).reshape(b, h, 1, dh)


def blockwise_decode_attention(hq, k, v, idx, *, scale,
                               block_len: Optional[int] = None,
                               n_blocks: Optional[int] = None):
    """Single-token attention over a contiguous cache, blockwise.

    hq (B, H, 1, Dh); k, v (B, Hkv, W, Dh); idx (B,) int tensor of
    current positions (positions ``<= idx[b]`` are visible). ``n_blocks``
    is the host trip count; None derives it from ``idx`` (one sync).
    Returns o (B, H, 1, Dh) in v.dtype."""
    block_len = block_len or DECODE_BLOCK
    b, h, _, dh = hq.shape
    hkv, width = k.shape[1], k.shape[2]
    g = h // hkv
    hq_g = hq.reshape(b, hkv, g, 1, dh)
    q32 = hq_g.to(k.dtype).to(torch.float32)
    total = -(-width // block_len)
    if n_blocks is None:
        n_blocks = resident_blocks(idx, block_len, total)
    carry = _init_carry(hq, hkv, g, dh)
    for j in range(n_blocks):
        lo, hi = j * block_len, min((j + 1) * block_len, width)
        pos = torch.arange(lo, hi, device=hq.device)
        valid = (pos[None, :] <= idx[:, None])[:, None, None, None, :]
        carry = _merge_block(carry, q32, k[:, :, lo:hi], v[:, :, lo:hi],
                             valid, scale)
    return _finish(carry, v.dtype).reshape(b, h, 1, dh)


def _init_carry(hq, hkv: int, g: int, dh: int):
    """Running max (at the ``_MASK`` sentinel), normalizer and
    accumulator of the online softmax, all float32, for the ``S =
    hq.shape[2]`` query rows of hq (B, H, S, Dh)."""
    b, s = hq.shape[0], hq.shape[2]
    m = torch.full((b, hkv, g, s), _MASK, dtype=torch.float32,
                   device=hq.device)
    acc = torch.zeros((b, hkv, g, s, hq.shape[-1]), dtype=torch.float32,
                      device=hq.device)
    return m, torch.zeros_like(m), acc


def _merge_block(carry, q32, k_blk, v_blk, valid, scale):
    """One online-softmax merge of a block of keys: q32 (B, Hkv, g, S,
    Dh) float32, k_blk/v_blk (B, Hkv, L, Dh), valid (B, 1, 1, S, L)."""
    m, l, acc = carry
    # products of the cache dtype accumulated in float32 (the JAX
    # package's preferred_element_type=float32)
    s = torch.einsum("bngqd,bnkd->bngqk", q32,
                     k_blk.to(torch.float32)) * scale
    s = s.masked_fill(~valid, _MASK)
    m_new = torch.maximum(m, s.amax(dim=-1))
    # while m_new is still the sentinel exp(0) would be 1: mask so
    # fully masked blocks contribute exact zeros
    p = torch.exp(s - m_new[..., None]).masked_fill(~valid, 0.0)
    alpha = torch.exp(m - m_new)
    l = alpha * l + p.sum(dim=-1)
    pv = torch.einsum("bngqk,bnkd->bngqd",
                      p.to(v_blk.dtype).to(torch.float32),
                      v_blk.to(torch.float32))
    return m_new, l, alpha[..., None] * acc + pv


def _finish(carry, out_dtype):
    _, l, acc = carry
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    return (acc / l_safe[..., None]).to(out_dtype)


def paged_decode_attention(hq, k_pages, v_pages, tables, idx, new_k,
                           new_v, *, scale, page_len: int,
                           n_blocks: Optional[int] = None,
                           block_pages: int = 1, k_scales=None,
                           v_scales=None, k_tail=None, v_tail=None):
    """Single-token attention over a PAGED pool, ``block_pages`` pages
    per step (one, as the JAX loop, by default).

    hq (B, H, 1, Dh); k_pages/v_pages (n_pages, Hkv, page_len, Dh) pool
    tensors; tables (B, P) int page ids (an entry past a row's length
    may name any page: the position mask hides it); idx (B,) int
    positions; new_k/new_v (B, Hkv, 1, Dh), THIS step's K/V, laid over
    position ``idx[b]`` so a row whose pool write was dropped (an
    inactive slot) still sees its own key, as ``decode_step_slots``
    does. Visits only the ``resident_blocks(idx, block_pages *
    page_len, ceil(P / block_pages))`` blocks that hold resident
    positions (``n_blocks``, a host int; None derives it from ``idx``),
    gathering ``block_pages`` pages of every row per step. With
    ``block_pages * page_len == DECODE_BLOCK`` the online softmax merges
    exactly the blocks of :func:`blockwise_decode_attention`, so a paged
    and a contiguous cache holding the same K/V give the same output,
    bit for bit. Returns o (B, H, 1, Dh) in the pool's dtype.

    **Quantized pool**: with ``k_scales``/``v_scales`` (n_pages, nb)
    f32 the pool holds block-quantized pages (int8 at q8, nibble-packed
    uint8 ``(..., Dh // 2)`` at q4), dequantized as they are gathered;
    ``k_tail``/``v_tail`` (B, Hkv, page_len, Dh) f32 are each slot's
    exact current page, laid wholesale over the page holding ``idx[b]``
    (one page inside its block) before this step's K/V is laid over
    ``idx[b]``. The math is then float32 and the output takes
    ``new_v``'s dtype."""
    b, h, _, dh = hq.shape
    hkv = k_pages.shape[1]
    g = h // hkv
    quant = _page_quant(k_pages, page_len, dh, idx, k_scales, v_scales,
                        k_tail, v_tail)
    kv_dtype = torch.float32 if quant else k_pages.dtype
    q32 = hq.reshape(b, hkv, g, 1, dh).to(kv_dtype).to(torch.float32)
    block_len = block_pages * page_len
    if n_blocks is None:
        n_blocks = resident_blocks(idx, block_len,
                                   -(-tables.shape[1] // block_pages))
    nk = new_k.reshape(b, hkv, 1, dh).to(kv_dtype)
    nv = new_v.reshape(b, hkv, 1, dh).to(kv_dtype)
    carry = _init_carry(hq, hkv, g, dh)
    for j in range(n_blocks):
        k_blk, v_blk = _paged_block(k_pages, v_pages, tables, j,
                                    block_pages, quant)
        n = k_blk.shape[2]
        pos = torch.arange(j * block_len, j * block_len + n,
                           device=hq.device)
        wm = (pos[None, :] == idx[:, None])[:, None, :, None]
        k_blk = torch.where(wm, nk, k_blk)
        v_blk = torch.where(wm, nv, v_blk)
        valid = (pos[None, :] <= idx[:, None])[:, None, None, None, :]
        carry = _merge_block(carry, q32, k_blk, v_blk, valid, scale)
    out_dtype = new_v.dtype if quant else v_pages.dtype
    return _finish(carry, out_dtype).reshape(b, h, 1, dh)


def _page_quant(k_pages, page_len, dh, idx, k_scales, v_scales, k_tail,
                v_tail):
    """What the block gather of a quantized pool needs (None for an
    exact pool)."""
    if k_scales is None:
        return None
    return dict(k_scales=k_scales, v_scales=v_scales, k_tail=k_tail,
                v_tail=v_tail, packed=k_pages.dtype == torch.uint8,
                bmap=page_block_map(k_pages.shape[1], page_len, dh,
                                    device=k_pages.device),
                tail_page=idx // page_len)


def _paged_block(k_pages, v_pages, tables, j, block_pages, quant):
    """Block ``j`` of every row as contiguous rows (B, Hkv, n, Dh): its
    ``block_pages`` pages gathered (and, in a quantized pool, unpacked,
    dequantized and the slot's current page taken from its tail)."""
    pids = tables[:, j * block_pages:(j + 1) * block_pages]
    kb, vb = k_pages[pids], v_pages[pids]
    if quant is not None:
        if quant["packed"]:
            kb, vb = unpack_page_nibbles(kb), unpack_page_nibbles(vb)
        kb = dequantize_page_blocks(kb, quant["k_scales"][pids],
                                    quant["bmap"])
        vb = dequantize_page_blocks(vb, quant["v_scales"][pids],
                                    quant["bmap"])
        page = torch.arange(j * block_pages, j * block_pages
                            + pids.shape[1], device=pids.device)
        it = (page[None, :] == quant["tail_page"][:, None]
              )[:, :, None, None, None]
        kb = torch.where(it, quant["k_tail"][:, None], kb)
        vb = torch.where(it, quant["v_tail"][:, None], vb)
    return _rows(kb), _rows(vb)


def _verify_blocks(hq, q32, blocks, idx, cand_k, cand_v, scale, out_dtype,
                   requant=None):
    """Merge ``blocks`` ((k_blk, v_blk, lo) of the resident cache) for
    the S candidate queries hq (B, H, S, Dh) at positions ``idx + 0 ..
    idx + S - 1``: the candidates' K/V (B, Hkv, S, Dh) are laid over
    positions ``idx .. idx + S - 1`` and row j sees positions ``<= idx +
    j``. Each candidate row runs as a batch entry of its own, with one
    query row, so its products are the decode's very products (a product
    of S query rows reduces in another order on the card). With
    ``requant`` (a quantized pool) a row past the end of a page sees that
    page as the decode would, quantized: the page the candidates complete
    is quantized and dequantized here, from the same values a decode
    would have quantized. Returns o (B, H, S, Dh) in ``out_dtype``."""
    b, h, s, dh = hq.shape
    hkv = cand_k.shape[1]
    g = h // hkv
    # (B, Hkv, g, S, Dh) -> one batch entry per (row, candidate)
    qf = q32.permute(0, 3, 1, 2, 4).reshape(b * s, hkv, g, 1, dh)
    rows = idx[:, None] + torch.arange(s, device=idx.device)[None, :]
    carry = _init_carry(qf.reshape(b * s, h, 1, dh), hkv, g, dh)
    for k_blk, v_blk, lo in blocks:
        n = k_blk.shape[2]
        pos = torch.arange(lo, lo + n, device=idx.device)
        c = pos[None, :] - idx[:, None]                      # (B, n)
        inc = ((c >= 0) & (c < s))[:, None, :, None]
        ci = c.clamp(0, s - 1)[:, None, :, None]
        k_blk = torch.where(inc, torch.take_along_dim(cand_k, ci, dim=2),
                            k_blk)
        v_blk = torch.where(inc, torch.take_along_dim(cand_v, ci, dim=2),
                            v_blk)
        # a copy per (row, candidate): the requantized pages go in place
        kf = k_blk.repeat_interleave(s, dim=0)
        vf = v_blk.repeat_interleave(s, dim=0)
        if requant is not None:
            _requantize_completed(kf, vf, k_blk, v_blk, lo, s, requant)
        valid = (pos[None, None, :] <= rows[:, :, None]).reshape(
            b * s, 1, 1, 1, n)
        carry = _merge_block(carry, qf, kf, vf, valid, scale)
    return _finish(carry, out_dtype).reshape(b, s, h, dh).permute(
        0, 2, 1, 3)


def _requantize_completed(kf, vf, k_blk, v_blk, lo: int, s: int, requant):
    """In the folded rows (B * S, Hkv, n, Dh) of a block starting at
    position ``lo``, lay the quantized-then-dequantized copy of every
    page the candidates complete over the rows past that page. The
    decision is taken on the host, from ``requant["lengths"]``."""
    length = np.asarray(requant["lengths"])
    page_len, n = requant["page_len"], k_blk.shape[2]
    first = length // page_len
    # pages p = first + c (c >= 0) complete when a candidate sits on
    # their last position; rows on later pages read them quantized
    for c in range(-(-(s - 1) // page_len) + 1):
        page = first + c
        rel = page * page_len - lo
        done = (page + 1) * page_len - 1 <= length + s - 1
        rows_b = np.nonzero(done & (rel >= 0) & (rel + page_len <= n))[0]
        if not len(rows_b):
            continue
        dev = kf.device
        span = rel[rows_b][:, None] + np.arange(page_len)[None, :]
        rb = torch.as_tensor(rows_b, device=dev)
        sp = torch.as_tensor(span, device=dev)
        # the entries (b, j) whose candidate lies past the page
        pos = length[rows_b][:, None] + np.arange(s)[None, :]
        later = pos >= (page[rows_b] + 1)[:, None] * page_len
        eb, ej = np.nonzero(later)
        ent = torch.as_tensor(rows_b[eb] * s + ej, device=dev)
        esp = torch.as_tensor(span[eb], device=dev)
        for blk, folded in ((k_blk, kf), (v_blk, vf)):
            pg = blk[rb[:, None], :, sp].permute(0, 2, 1, 3)  # (R,Hkv,L,Dh)
            q, sc = quantize_page_blocks(pg, requant["bits"])
            deq = (q.to(torch.float32) * sc[..., requant["bmap"]])
            folded[ent[:, None], :, esp] = deq[eb].permute(0, 2, 1, 3)


def blockwise_verify_attention(hq, k, v, idx, cand_k, cand_v, *, scale,
                               n_blocks: Optional[int] = None):
    """The speculative verify's attention over a contiguous cache.

    hq (B, H, S, Dh): S candidate queries, row j at position ``idx[b] +
    j``; k, v (B, Hkv, W, Dh) the cache, resident below ``idx``;
    cand_k/cand_v (B, Hkv, S, Dh) the candidates' K/V, laid over
    positions ``idx .. idx + S - 1`` without writing the cache. Row j
    merges the same ``DECODE_BLOCK`` blocks, in the same order and with
    the same products, as :func:`blockwise_decode_attention` at position
    ``idx + j`` over a cache holding those keys. A row past the cache
    width does not see the candidates beyond it (such a row is never
    accepted). Returns o (B, H, S, Dh) in v.dtype."""
    b, h, s, dh = hq.shape
    hkv, width = k.shape[1], k.shape[2]
    q32 = hq.reshape(b, hkv, h // hkv, s, dh).to(k.dtype).to(torch.float32)
    total = -(-width // DECODE_BLOCK)
    if n_blocks is None:
        n_blocks = resident_blocks(idx + s - 1, DECODE_BLOCK, total)
    blocks = ((k[:, :, lo:lo + DECODE_BLOCK], v[:, :, lo:lo + DECODE_BLOCK],
               lo) for lo in range(0, n_blocks * DECODE_BLOCK, DECODE_BLOCK))
    return _verify_blocks(hq, q32, blocks, idx, cand_k.to(k.dtype),
                          cand_v.to(v.dtype), scale, v.dtype)


def paged_verify_attention(hq, k_pages, v_pages, tables, idx, cand_k,
                           cand_v, *, scale, page_len: int,
                           n_blocks: Optional[int] = None,
                           block_pages: int = 1, k_scales=None,
                           v_scales=None, k_tail=None, v_tail=None,
                           lengths=None):
    """The speculative verify's attention over a PAGED pool: the blocks
    of :func:`paged_decode_attention` (``block_pages`` pages each, a
    quantized pool dequantized and each slot's current page from its
    tail) with the S candidates laid over positions ``idx .. idx + S -
    1``, as :func:`blockwise_verify_attention` does. In a quantized pool
    a candidate past the end of a page reads that page quantized, as a
    decode at its position would (``lengths``: ``idx`` on the host; None
    reads it from the device). Returns o (B, H, S, Dh) in the pool's
    dtype, or ``cand_v``'s for a quantized pool."""
    b, h, s, dh = hq.shape
    hkv = k_pages.shape[1]
    quant = _page_quant(k_pages, page_len, dh, idx, k_scales, v_scales,
                        k_tail, v_tail)
    kv_dtype = torch.float32 if quant else k_pages.dtype
    q32 = hq.reshape(b, hkv, h // hkv, s, dh).to(kv_dtype).to(torch.float32)
    block_len = block_pages * page_len
    if n_blocks is None:
        n_blocks = resident_blocks(idx + s - 1, block_len,
                                   -(-tables.shape[1] // block_pages))
    blocks = (_paged_block(k_pages, v_pages, tables, j, block_pages, quant)
              + (j * block_len,) for j in range(n_blocks))
    requant = None
    if quant:
        requant = dict(bits=4 if quant["packed"] else 8, bmap=quant["bmap"],
                       page_len=page_len,
                       lengths=(idx.cpu().numpy() if lengths is None
                                else np.asarray(lengths)))
    return _verify_blocks(hq, q32, blocks, idx, cand_k.to(kv_dtype),
                          cand_v.to(kv_dtype), scale,
                          cand_v.dtype if quant else v_pages.dtype, requant)


def _rows(g):
    """Gathered pages (B, n, Hkv, page_len, Dh) as contiguous rows (B,
    Hkv, n * page_len, Dh)."""
    b, n, h, l, d = g.shape
    return g.permute(0, 2, 1, 3, 4).reshape(b, h, n * l, d)
