"""Autoregressive generation with a KV cache — the inference path.

Counterpart of ``distributed_pytorch_tpu/models/generate.py``: the
contiguous-cache functions, the paged pool's decode and prefill (exact
or block-quantized pages) and the speculative verify and commit over
both pools. The JAX package compiles prefill and a
``lax.scan`` of decode steps into two XLA programs with the cache as an
immutable carry; PyTorch runs eagerly, so here the decode loop is a
Python loop and the cache tensors are preallocated once and written IN
PLACE (one position per step), which saves the copy of the whole cache
that a functional update would make each token.

- Prefill runs the model's own ``attn_fn`` (the flash kernel at or
  above ``DPX_FLASH_MIN_SEQ`` keys with ``make_flash_attn_fn``).
- Decode attends over the cache blockwise
  (``ops.decode_attention.blockwise_decode_attention``), visiting only
  the blocks that hold resident positions.
- A model built with a uniform sliding window decodes through a ROLLING
  cache of W slots (position p at slot p % W).
- Sampling (greedy / temperature / top-k / top-p) draws its noise from
  an explicit ``torch.Generator``.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..nn.attention import dense_attention
from ..ops.decode_attention import (DECODE_BLOCK, blockwise_decode_attention,
                                    blockwise_verify_attention, _rows,
                                    dense_decode_attention,
                                    paged_decode_attention,
                                    paged_verify_attention, resident_blocks)
from ..ops.quant import (dequantize_page_blocks, pack_page_nibbles,
                         page_block_map, quantize_page_blocks,
                         unpack_page_nibbles)
from ..runtime.device import default_generator
from .transformer import TransformerLM


class KVCache(NamedTuple):
    k: List[torch.Tensor]   # per layer (B, Hkv, max_len, Dh)
    v: List[torch.Tensor]
    length: int             # number of valid positions


def init_cache(model: TransformerLM, batch: int, max_len: int,
               dtype=None) -> KVCache:
    dtype = dtype or model.dtype
    shape = (batch, model.n_kv_heads, max_len, model.dim // model.n_heads)

    def zeros():
        return [torch.zeros(shape, dtype=dtype, device=model.device)
                for _ in range(model.n_layers)]
    return KVCache(k=zeros(), v=zeros(), length=0)


def _as_tokens(model: TransformerLM, tokens) -> torch.Tensor:
    return torch.as_tensor(np.asarray(tokens) if not isinstance(
        tokens, torch.Tensor) else tokens).to(model.device, torch.long)


def _roll_into(dst: torch.Tensor, src: torch.Tensor, s: int, w: int) -> None:
    """Write the last min(s, w) positions of ``src`` (B, Hkv, s, Dh) into
    the rolling W-slot ``dst`` so position p sits at slot p % w."""
    keep = min(s, w)
    tail = src[:, :, s - keep:]
    slots = (torch.arange(s - keep, s, device=src.device) % w)
    dst.zero_()
    dst[:, :, slots] = tail.to(dst.dtype)


def prefill(model: TransformerLM, tokens, max_len: int,
            window: Optional[int] = None) -> Tuple[torch.Tensor, KVCache]:
    """Run the prompt (B, S) through the model once, filling a fresh
    cache. Returns (last-position logits (B, vocab), cache of length S).
    With ``window`` the cache is the W-slot rolling buffer."""
    tokens = _as_tokens(model, tokens)
    b, s = tokens.shape
    if s > max_len:
        raise ValueError(f"prompt length {s} exceeds max_len {max_len}")
    cache = init_cache(model, b, window if window is not None else max_len)
    positions = torch.arange(s, device=model.device)
    x = model.embed(tokens, positions)
    for i, blk in enumerate(model.blocks):
        hq, hk, hv = blk.attn.project_qkv(blk.ln1(x))
        # rope rotates BEFORE caching: the cache holds rotated keys
        hq, hk = blk.attn.maybe_rope(hq, hk, positions)
        o = blk.attn.attn_fn(hq, hk, hv, causal=True)
        x = x + blk.attn.project_out(o)
        x = x + blk.mlp(x)
        if window is not None:
            _roll_into(cache.k[i], hk, s, window)
            _roll_into(cache.v[i], hv, s, window)
        else:
            cache.k[i][:, :, :s] = hk
            cache.v[i][:, :, :s] = hv
    logits = model.project_vocab(model.ln_f(x[:, -1:]))[:, 0]
    return logits, cache._replace(length=s)


def decode_step(model: TransformerLM, cache: KVCache, token,
                window: Optional[int] = None,
                blockwise: bool = True) -> Tuple[torch.Tensor, KVCache]:
    """One cached decode step; token (B,) at position ``cache.length``.
    Writes the cache in place and returns (logits (B, vocab), the cache
    advanced by one). ``blockwise=False`` keeps the dense full-width
    softmax (the reference of the blockwise path); the rolling window
    cache always takes it."""
    idx = cache.length
    dev = model.device
    token = _as_tokens(model, token)
    idx_t = torch.tensor([idx], device=dev)
    x = model.embed(token[:, None], idx_t)
    scale = 1.0 / math.sqrt(model.dim // model.n_heads)
    width = cache.k[0].shape[2]
    slots = torch.arange(width, device=dev)
    if window is not None:
        pos_mask = (idx - torch.remainder(idx - slots, window)) >= 0
        write_at = idx % window
    else:
        pos_mask = slots <= idx
        write_at = idx
    for i, blk in enumerate(model.blocks):
        hq, hk, hv = blk.attn.project_qkv(blk.ln1(x))
        hq, hk = blk.attn.maybe_rope(hq, hk, idx_t)
        k, v = cache.k[i], cache.v[i]
        k[:, :, write_at] = hk[:, :, 0]
        v[:, :, write_at] = hv[:, :, 0]
        if blockwise and window is None:
            o = blockwise_decode_attention(
                hq, k, v, idx_t, scale=scale,
                n_blocks=resident_blocks([idx], DECODE_BLOCK,
                                         -(-width // DECODE_BLOCK)))
        else:
            o = dense_decode_attention(hq, k, v, pos_mask[None, :],
                                       scale=scale)
        x = x + blk.attn.project_out(o)
        x = x + blk.mlp(x)
    logits = model.project_vocab(model.ln_f(x))[:, 0]
    return logits, cache._replace(length=idx + 1)


def prefill_partial(model: TransformerLM, tokens, true_len: int,
                    window: Optional[int] = None
                    ) -> Tuple[torch.Tensor, list, list]:
    """Prefill over a RIGHT-PADDED prompt (B, S) whose first ``true_len``
    positions are real — the serving engine's admit. Causality makes the
    pad tail inert. Returns (logits (B, vocab) at position true_len - 1,
    ks, vs) with per-layer (B, Hkv, S, Dh) keys/values, or with
    ``window`` the (B, Hkv, W, Dh) rolling layout (unreached slots
    zero)."""
    tokens = _as_tokens(model, tokens)
    b, s = tokens.shape
    dev = model.device
    positions = torch.arange(s, device=dev)
    x = model.embed(tokens, positions)
    if window is not None:
        j = torch.arange(window, device=dev)
        p_j = true_len - 1 - torch.remainder(true_len - 1 - j, window)
        valid = (p_j >= 0)[None, None, :, None]
        take_at = p_j.clamp(0, s - 1)
    ks, vs = [], []
    for blk in model.blocks:
        hq, hk, hv = blk.attn.project_qkv(blk.ln1(x))
        hq, hk = blk.attn.maybe_rope(hq, hk, positions)
        o = blk.attn.attn_fn(hq, hk, hv, causal=True)
        x = x + blk.attn.project_out(o)
        x = x + blk.mlp(x)
        hk, hv = hk.to(model.dtype), hv.to(model.dtype)
        if window is not None:
            # slot j holds the largest real position = j (mod W)
            hk = torch.where(valid, hk[:, :, take_at], 0)
            hv = torch.where(valid, hv[:, :, take_at], 0)
        ks.append(hk)
        vs.append(hv)
    x_last = model.ln_f(x[:, true_len - 1:true_len])
    return model.project_vocab(x_last)[:, 0], ks, vs


def decode_step_slots(model: TransformerLM, ks, vs, lengths, tokens,
                      window: Optional[int] = None,
                      blockwise: bool = True
                      ) -> Tuple[torch.Tensor, list, list]:
    """One decode step over a SLOT POOL with per-row cache lengths.

    ks/vs: per-layer (B, Hkv, W, Dh) pools, written IN PLACE at each
    row's own position; ``lengths`` (B,) current positions as host ints
    (a list or numpy array: the blockwise trip count ``max(lengths)``
    is then known without a device sync) or a tensor; tokens (B,).
    Returns (logits (B, vocab), ks, vs); advancing ``lengths`` is the
    caller's business."""
    dev = model.device
    if isinstance(lengths, torch.Tensor):
        idx = lengths.to(dev, torch.long)
    else:
        idx = torch.as_tensor(np.asarray(lengths, np.int64), device=dev)
    tokens = _as_tokens(model, tokens)
    bsz = tokens.shape[0]
    x = model.embed(tokens[:, None], idx[:, None])
    scale = 1.0 / math.sqrt(model.dim // model.n_heads)
    width = ks[0].shape[2]
    slots = torch.arange(width, device=dev)[None, :]
    if window is not None:
        pos_mask = (idx[:, None]
                    - torch.remainder(idx[:, None] - slots, window)) >= 0
        write_at = torch.remainder(idx, window)
    else:
        pos_mask = slots <= idx[:, None]
        write_at = idx
    n_blocks = None
    if blockwise and window is None:
        n_blocks = resident_blocks(lengths, DECODE_BLOCK,
                                   -(-width // DECODE_BLOCK))
    rows = torch.arange(bsz, device=dev)
    for i, blk in enumerate(model.blocks):
        hq, hk, hv = blk.attn.project_qkv(blk.ln1(x))
        hq, hk = blk.attn.maybe_rope(hq, hk, idx[:, None, None])
        k, v = ks[i], vs[i]
        k[rows, :, write_at] = hk[:, :, 0].to(k.dtype)
        v[rows, :, write_at] = hv[:, :, 0].to(v.dtype)
        if n_blocks is not None:
            o = blockwise_decode_attention(hq, k, v, idx, scale=scale,
                                           n_blocks=n_blocks)
        else:
            o = dense_decode_attention(hq, k, v, pos_mask, scale=scale)
        x = x + blk.attn.project_out(o)
        x = x + blk.mlp(x)
    return model.project_vocab(model.ln_f(x))[:, 0], ks, vs


def _pool_writes(pages: np.ndarray, n_pages: int, keep: np.ndarray):
    """Which rows write the pool: ``keep`` and a page id inside the pool.
    The JAX package scatters with ``mode="drop"``; an out-of-range id
    here never reaches ``index_put_``."""
    return np.nonzero(keep & (pages >= 0) & (pages < n_pages))[0]


def _quantize_into(pages, scales, dest, src, bits: int) -> None:
    """Quantize the exact f32 pages ``src`` (n, Hkv, L, Dh) once, on the
    wire's block grid, and write them (nibble-packed at q4) with their
    scales into the pool at page ids ``dest`` (n,)."""
    q, sc = quantize_page_blocks(src, bits)
    pages[dest] = pack_page_nibbles(q) if bits == 4 else q
    scales[dest] = sc


def _check_quant_args(kv_bits, *bufs) -> None:
    if kv_bits is not None and any(b is None for b in bufs):
        raise ValueError(f"kv_bits={kv_bits} needs k_scales, v_scales, "
                         "k_tail and v_tail")


def _paged_blocking(lengths, page_len: int, n_table: int, extra: int = 0):
    """``(block_pages, n_blocks)`` of a paged attention over positions
    up to ``max(lengths) + extra``: whole DECODE_BLOCKs of pages where
    the page divides it (the contiguous decode's blocks, so both pools
    sum alike), else one page per block."""
    block_pages = (DECODE_BLOCK // page_len
                   if DECODE_BLOCK % page_len == 0 else 1)
    return block_pages, resident_blocks(
        np.asarray(lengths) + extra, block_pages * page_len,
        -(-n_table // block_pages))


def decode_step_slots_paged(model: TransformerLM, k_pages, v_pages, tables,
                            lengths, tokens, active, *, page_len: int,
                            blockwise: bool = True, kv_bits=None,
                            k_scales=None, v_scales=None, k_tail=None,
                            v_tail=None):
    """One decode step over a PAGED slot pool (``serve/pages/``).

    K/V live in a shared pool, per layer ``(n_pages, Hkv, page_len,
    Dh)``, and row b addresses its cache through ``tables[b]`` (host
    (B, P) ints: position j at page ``tables[b, j // page_len]``, offset
    ``j % page_len``). Shared full pages are safe because decode writes
    only each row's private tail page: this step's K/V at ``lengths[b]``,
    for ``active`` rows only (host bool; inactive rows and out-of-range
    page ids write nothing). The math per row is
    :func:`decode_step_slots`'s, with the pool written in place.

    Attention visits only the resident pages
    (:func:`..ops.decode_attention.paged_decode_attention`, trip count
    from the host ``lengths``), ``DECODE_BLOCK`` positions per step
    where ``page_len`` divides it: the blocks of the contiguous decode,
    whose sums it then repeats bit for bit (one page per step, the JAX
    loop, changed 2 of 8 greedy bf16 streams of the FLAGSHIP-width model
    on an H100). ``blockwise=False`` gathers the whole table and runs
    the dense softmax (the reference). Returns
    ``(logits (B, vocab), k_pages, v_pages)``; page allocation and the
    lengths' advance belong to the caller.

    **Quantized pool** (``kv_bits`` 8 or 4): ``k_pages``/``v_pages``
    hold block-quantized pages and ``k_scales``/``v_scales`` (per layer
    (n_pages, nb) f32) and ``k_tail``/``v_tail`` (per layer (B, Hkv,
    page_len, Dh) f32) their scales and each slot's exact current page.
    The step's K/V goes into the slot's tail; when it lands on the
    page's last position the whole tail page is quantized, once, from
    exact values, into the pool with its scales. Attention dequantizes
    the gathered pages and takes each slot's current page from its
    tail. Returns ``(logits, k_pages, v_pages, k_scales, v_scales,
    k_tail, v_tail)``; requires ``blockwise=True``."""
    if kv_bits is not None and not blockwise:
        raise ValueError("quantized paged KV (kv_bits) requires the "
                         "blockwise decode path")
    _check_quant_args(kv_bits, k_scales, v_scales, k_tail, v_tail)
    dev = model.device
    tables = np.asarray(tables, np.int64)
    lengths = np.asarray(lengths, np.int64)
    active = np.asarray(active, bool)
    n_pages = k_pages[0].shape[0]
    bsz = tables.shape[0]
    idx = torch.as_tensor(lengths, device=dev)
    # an out-of-range id reads a clamped page, as JAX's gather does
    tables_t = torch.as_tensor(np.clip(tables, 0, n_pages - 1), device=dev)
    tokens = _as_tokens(model, tokens)
    x = model.embed(tokens[:, None], idx[:, None])
    scale = 1.0 / math.sqrt(model.dim // model.n_heads)
    # the pool write of each active row: its page holding position idx
    wp = tables[np.arange(bsz), np.minimum(lengths // page_len,
                                           tables.shape[1] - 1)]
    rows = _pool_writes(wp, n_pages, active)
    rows_t = torch.as_tensor(rows, device=dev)
    dest_p = torch.as_tensor(wp[rows], device=dev)
    dest_o = torch.as_tensor(lengths[rows] % page_len, device=dev)
    if kv_bits is not None:
        # every active row writes its own tail; a row whose write fills
        # its page's last position quantizes that page now
        t_rows = np.nonzero(active)[0]
        t_rows_t = torch.as_tensor(t_rows, device=dev)
        t_off = torch.as_tensor(lengths[t_rows] % page_len, device=dev)
        comp = rows[lengths[rows] % page_len == page_len - 1]
        comp_t = torch.as_tensor(comp, device=dev)
        comp_p = torch.as_tensor(wp[comp], device=dev)
    block_pages, n_blocks = _paged_blocking(lengths, page_len,
                                            tables.shape[1])
    width = tables.shape[1] * page_len
    for i, blk in enumerate(model.blocks):
        hq, hk, hv = blk.attn.project_qkv(blk.ln1(x))
        hq, hk = blk.attn.maybe_rope(hq, hk, idx[:, None, None])
        kp, vp = k_pages[i], v_pages[i]
        if kv_bits is not None:
            kt, vt = k_tail[i], v_tail[i]
            kt[t_rows_t, :, t_off] = hk[t_rows_t, :, 0].to(torch.float32)
            vt[t_rows_t, :, t_off] = hv[t_rows_t, :, 0].to(torch.float32)
            if len(comp):
                _quantize_into(kp, k_scales[i], comp_p, kt[comp_t], kv_bits)
                _quantize_into(vp, v_scales[i], comp_p, vt[comp_t], kv_bits)
            o = paged_decode_attention(hq, kp, vp, tables_t, idx, hk, hv,
                                       scale=scale, page_len=page_len,
                                       n_blocks=n_blocks,
                                       block_pages=block_pages,
                                       k_scales=k_scales[i],
                                       v_scales=v_scales[i], k_tail=kt,
                                       v_tail=vt)
        else:
            kp[dest_p, :, dest_o] = hk[rows_t, :, 0].to(kp.dtype)
            vp[dest_p, :, dest_o] = hv[rows_t, :, 0].to(vp.dtype)
            if blockwise:
                o = paged_decode_attention(hq, kp, vp, tables_t, idx, hk,
                                           hv, scale=scale,
                                           page_len=page_len,
                                           n_blocks=n_blocks,
                                           block_pages=block_pages)
            else:
                pos = torch.arange(width, device=dev)
                wm = (pos[None, :] == idx[:, None])[:, None, :, None]
                k = torch.where(wm, hk.to(kp.dtype), _rows(kp[tables_t]))
                v = torch.where(wm, hv.to(vp.dtype), _rows(vp[tables_t]))
                o = dense_decode_attention(hq, k, v,
                                           pos[None, :] <= idx[:, None],
                                           scale=scale)
        x = x + blk.attn.project_out(o)
        x = x + blk.mlp(x)
    logits = model.project_vocab(model.ln_f(x))[:, 0]
    if kv_bits is None:
        return logits, k_pages, v_pages
    return logits, k_pages, v_pages, k_scales, v_scales, k_tail, v_tail


def _dequant_pages(pages, scales, ids, bits: int, bmap):
    """Pool pages ``ids`` (n,) as f32 (n, Hkv, L, Dh)."""
    q = pages[ids]
    if bits == 4:
        q = unpack_page_nibbles(q)
    return dequantize_page_blocks(q, scales[ids], bmap)


def prefill_partial_paged(model: TransformerLM, k_pages, v_pages, table_row,
                          tokens, offset: int, true_len: int, *,
                          page_len: int, kv_bits=None, k_scales=None,
                          v_scales=None, k_tail=None, v_tail=None,
                          slot: Optional[int] = None):
    """Prefill the TAIL of a prompt into pool pages, attending over a
    page-resident shared prefix (``serve/pages/``).

    ``tokens`` (1, S) is the right-padded tail: the prompt minus its
    ``offset`` prefix tokens, whose K/V already sit in the pages
    ``table_row`` (host (P,) ints) names. ``offset`` is page-aligned
    (only full pages are shared) and ``true_len`` >= 1 is the real tail
    length; both are host ints. Tail queries run at global positions
    ``offset + i`` and attend over [the prefix's K/V | the tail's],
    causally, through the model's own attention core (``attn_fn`` with
    ``s_k - s_q = offset``): a dense model computes JAX's masked
    softmax; a flash model dispatches as the contiguous prefill does,
    so a cold admission is that prefill's very computation. The real
    tail positions' K/V go into the slot's own pages (the shared prefix
    pages are never written). Returns ``(logits (1, vocab) at the last
    real position, k_pages, v_pages)``.

    **Quantized pool** (``kv_bits`` 8 or 4, with the scales and tails
    of :func:`decode_step_slots_paged` and the admitted ``slot``): each
    page the tail completes is quantized once, from exact values, into
    the pool with its scales; the partial last page goes exact into the
    slot's f32 tail (zero past ``true_len``). The shared prefix is read
    dequantized; the tail attends over its own exact values, so a cold
    admission sees no quantization. Returns ``(logits, k_pages,
    v_pages, k_scales, v_scales, k_tail, v_tail)``."""
    _check_quant_args(kv_bits, k_scales, v_scales, k_tail, v_tail)
    if kv_bits is not None and slot is None:
        raise ValueError("a quantized prefill needs the admitted slot")
    tokens = _as_tokens(model, tokens)
    s = tokens.shape[1]
    dev = model.device
    table_row = np.asarray(table_row, np.int64)
    n_pages = k_pages[0].shape[0]
    n_prefix = offset // page_len
    positions = torch.arange(offset, offset + s, device=dev)
    # the padded tail may run past max_seq (offset + bucket); its rows
    # are causally inert, so a learned table reads its last row there,
    # as JAX's clamping gather does, instead of indexing out of range
    x = model.embed(tokens, positions.clamp_max(model.max_seq - 1))
    tail_pos = offset + np.arange(true_len)
    pages = table_row[np.minimum(tail_pos // page_len, len(table_row) - 1)]
    keep = _pool_writes(pages, n_pages, np.ones(true_len, bool))
    keep_t = torch.as_tensor(keep, device=dev)
    dest_p = torch.as_tensor(pages[keep], device=dev)
    dest_o = torch.as_tensor(tail_pos[keep] % page_len, device=dev)
    prefix_ids = torch.as_tensor(table_row[:n_prefix], device=dev)
    if kv_bits is not None:
        dh = model.dim // model.n_heads
        bmap = page_block_map(model.n_kv_heads, page_len, dh, device=dev)
        # the tail starts on a page boundary: its c-th complete chunk is
        # the slot's page offset // page_len + c
        n_comp = true_len // page_len
        cidx = np.minimum(n_prefix + np.arange(n_comp), len(table_row) - 1)
        cpages = table_row[cidx]
        cvalid = np.nonzero((cpages >= 0) & (cpages < n_pages))[0]
        cvalid_t = torch.as_tensor(cvalid, device=dev)
        cpages_t = torch.as_tensor(cpages[cvalid], device=dev)
        floor = n_comp * page_len
        n_t = true_len - floor
    for i, blk in enumerate(model.blocks):
        hq, hk, hv = blk.attn.project_qkv(blk.ln1(x))
        hq, hk = blk.attn.maybe_rope(hq, hk, positions)
        kp, vp = k_pages[i], v_pages[i]
        if kv_bits is not None:
            for src, pool, sc, tail in ((hk, kp, k_scales[i], k_tail[i]),
                                        (hv, vp, v_scales[i], v_tail[i])):
                src = src[0].to(torch.float32)          # (Hkv, S, Dh)
                if len(cvalid):
                    chunks = src[:, :floor].reshape(
                        src.shape[0], n_comp, page_len, src.shape[-1]
                    ).transpose(0, 1)
                    _quantize_into(pool, sc, cpages_t, chunks[cvalid_t],
                                   kv_bits)
                tail[slot] = 0.0
                tail[slot, :, :n_t] = src[:, floor:true_len]
        if n_prefix:
            if kv_bits is not None:
                pk = _rows(_dequant_pages(kp, k_scales[i], prefix_ids,
                                          kv_bits, bmap)[None])
                pv = _rows(_dequant_pages(vp, v_scales[i], prefix_ids,
                                          kv_bits, bmap)[None])
                pk, pv = pk.to(hk.dtype), pv.to(hv.dtype)
            else:
                pk = _rows(kp[prefix_ids[None]]).to(hk.dtype)
                pv = _rows(vp[prefix_ids[None]]).to(hv.dtype)
            k_all, v_all = torch.cat([pk, hk], 2), torch.cat([pv, hv], 2)
        else:
            k_all, v_all = hk, hv
        o = blk.attn.attn_fn(hq, k_all, v_all, causal=True)
        if kv_bits is None:
            kp[dest_p, :, dest_o] = hk[0, :, keep_t].transpose(0, 1).to(
                kp.dtype)
            vp[dest_p, :, dest_o] = hv[0, :, keep_t].transpose(0, 1).to(
                vp.dtype)
        x = x + blk.attn.project_out(o)
        x = x + blk.mlp(x)
    x_last = model.ln_f(x[:, true_len - 1:true_len])
    logits = model.project_vocab(x_last)[:, 0]
    if kv_bits is None:
        return logits, k_pages, v_pages
    return logits, k_pages, v_pages, k_scales, v_scales, k_tail, v_tail


# ---------------------------------------------------------------------------
# speculative decoding: the read-only verify and the accepted-prefix commit
# ---------------------------------------------------------------------------

def _verify_inputs(model: TransformerLM, lengths, tokens):
    """(host lengths, idx tensor, tokens (B, S), positions (B, S) and
    the embedded candidates) of a verify."""
    dev = model.device
    lengths = np.asarray(lengths, np.int64)
    idx = torch.as_tensor(lengths, device=dev)
    tokens = _as_tokens(model, tokens)
    positions = idx[:, None] + torch.arange(tokens.shape[1],
                                            device=dev)[None, :]
    # a candidate past max_seq reads the learned table's last row (the
    # JAX package's clamping gather); such a row is never accepted
    x = model.embed(tokens, positions.clamp_max(model.max_seq - 1))
    return lengths, idx, tokens, positions, x


def _verify_layers(model: TransformerLM, x, positions, attend):
    """The verify's forward: per layer the candidates' projections and
    ``attend(i, hq, hk, hv)``; returns (logits (B, S, vocab), sk, sv)
    with sk/sv per-layer (B, Hkv, S, Dh) f32 candidate K/V."""
    sk, sv = [], []
    for i, blk in enumerate(model.blocks):
        hq, hk, hv = blk.attn.project_qkv(blk.ln1(x))
        hq, hk = blk.attn.maybe_rope(hq, hk, positions[:, None, :])
        sk.append(hk.to(torch.float32))
        sv.append(hv.to(torch.float32))
        x = x + blk.attn.project_out(attend(i, hq, hk, hv))
        x = x + blk.mlp(x)
    return model.project_vocab(model.ln_f(x)), sk, sv


def spec_verify_slots(model: TransformerLM, ks, vs, lengths, tokens):
    """Speculative-decoding VERIFY over a contiguous slot pool
    (``serve/spec/``): score all k+1 candidate positions of every row in
    one batched forward, without writing the pool.

    ``tokens`` (B, S) is per row ``[cur, d_1 .. d_k]``: the slot's
    current (emitted, not yet cached) token and its k draft proposals,
    S = k + 1; ``lengths`` (B,) host ints. Row b's query j runs at
    position ``lengths[b] + j`` and attends over the pool below
    ``lengths[b]`` and the candidates up to itself, through
    :func:`..ops.decode_attention.blockwise_verify_attention`: the
    ``DECODE_BLOCK`` blocks a :func:`decode_step_slots` at that position
    merges, in its order (the JAX package's dense softmax over the whole
    width would round otherwise). Nothing is written, so a rejected
    suffix needs no rewind; :func:`spec_commit_slots` writes the
    accepted prefix. Returns ``(logits (B, S, vocab), sk, sv)``: sk/sv
    per-layer (B, Hkv, S, Dh) f32 candidate K/V."""
    lengths, idx, tokens, positions, x = _verify_inputs(model, lengths,
                                                        tokens)
    s = tokens.shape[1]
    scale = 1.0 / math.sqrt(model.dim // model.n_heads)
    n_blocks = resident_blocks(lengths + s - 1, DECODE_BLOCK,
                               -(-ks[0].shape[2] // DECODE_BLOCK))

    def attend(i, hq, hk, hv):
        return blockwise_verify_attention(hq, ks[i], vs[i], idx, hk, hv,
                                          scale=scale, n_blocks=n_blocks)
    return _verify_layers(model, x, positions, attend)


def _commit_rows(lengths, commit):
    """(rows, candidate index j, position) of every accepted position."""
    rows = np.repeat(np.arange(len(commit)), commit)
    js = np.concatenate([np.arange(c) for c in commit]) if len(rows) \
        else np.zeros(0, np.int64)
    return rows, js, lengths[rows] + js


def spec_commit_slots(ks, vs, lengths, sk, sv, commit):
    """Write the ACCEPTED prefix of a verify's candidate K/V into a
    contiguous slot pool, in place: ``commit`` (B,) host ints is each
    row's accepted count e (0: not speculating), so candidates ``0 ..
    e - 1`` land at positions ``lengths .. lengths + e - 1`` and the
    rejected suffix is never written. Returns ``(ks, vs, lengths +
    commit)``."""
    lengths = np.asarray(lengths, np.int64)
    commit = np.asarray(commit, np.int64)
    rows, js, pos = _commit_rows(lengths, commit)
    keep = pos < ks[0].shape[2]
    if keep.any():
        dev = ks[0].device
        r, j, p = (torch.as_tensor(a[keep], device=dev)
                   for a in (rows, js, pos))
        for pool, scratch in zip(ks + vs, sk + sv):
            pool[r, :, p] = scratch[r, :, j].to(pool.dtype)
    return ks, vs, lengths + commit


def spec_verify_slots_paged(model: TransformerLM, k_pages, v_pages, tables,
                            lengths, tokens, *, page_len: int,
                            kv_bits=None, k_scales=None, v_scales=None,
                            k_tail=None, v_tail=None):
    """Paged twin of :func:`spec_verify_slots`: the k+1-position verify
    over a PAGED pool, read-only, through
    :func:`..ops.decode_attention.paged_verify_attention`: the blocks of
    :func:`decode_step_slots_paged`, a quantized pool read dequantized
    and each slot's current page from its exact tail, except for the
    candidates past the end of that page, which read it quantized, as
    the decode at their position does (the JAX package's verify reads it
    exact there). Returns ``(logits (B, S, vocab), sk, sv)``;
    :func:`spec_commit_slots_paged` writes the accepted prefix."""
    _check_quant_args(kv_bits, k_scales, v_scales, k_tail, v_tail)
    lengths, idx, tokens, positions, x = _verify_inputs(model, lengths,
                                                        tokens)
    tables = np.asarray(tables, np.int64)
    n_pages = k_pages[0].shape[0]
    tables_t = torch.as_tensor(np.clip(tables, 0, n_pages - 1),
                               device=model.device)
    scale = 1.0 / math.sqrt(model.dim // model.n_heads)
    block_pages, n_blocks = _paged_blocking(lengths, page_len,
                                            tables.shape[1],
                                            extra=tokens.shape[1] - 1)
    quant = kv_bits is not None

    def attend(i, hq, hk, hv):
        return paged_verify_attention(
            hq, k_pages[i], v_pages[i], tables_t, idx, hk, hv, scale=scale,
            page_len=page_len, n_blocks=n_blocks, block_pages=block_pages,
            k_scales=k_scales[i] if quant else None,
            v_scales=v_scales[i] if quant else None,
            k_tail=k_tail[i] if quant else None,
            v_tail=v_tail[i] if quant else None, lengths=lengths)
    return _verify_layers(model, x, positions, attend)


def spec_commit_slots_paged(k_pages, v_pages, tables, lengths, sk, sv,
                            commit, *, page_len: int, kv_bits=None,
                            k_scales=None, v_scales=None, k_tail=None,
                            v_tail=None):
    """Paged twin of :func:`spec_commit_slots`, in place: position
    ``lengths[b] + j`` (j < ``commit[b]``) lands in page ``tables[b, pos
    // page_len]`` at offset ``pos % page_len``; rejected positions and
    out-of-range page ids write nothing, so a page completes only from
    accepted tokens. In a quantized pool each accepted position goes to
    the slot's exact f32 tail, in order, and a write that fills a page's
    last position quantizes that page once into the pool with its
    scales, as :func:`decode_step_slots_paged` does. Returns ``(k_pages,
    v_pages)`` (with the scales and tails in quant mode); advancing the
    host lengths belongs to the caller."""
    _check_quant_args(kv_bits, k_scales, v_scales, k_tail, v_tail)
    lengths = np.asarray(lengths, np.int64)
    commit = np.asarray(commit, np.int64)
    tables = np.asarray(tables, np.int64)
    n_pages = k_pages[0].shape[0]
    dev = k_pages[0].device
    rows, js, pos = _commit_rows(lengths, commit)
    pages = tables[rows, np.minimum(pos // page_len, tables.shape[1] - 1)]
    if kv_bits is None:
        keep = _pool_writes(pages, n_pages, np.ones(len(rows), bool))
        if len(keep):
            r, j, p, o = (torch.as_tensor(a, device=dev) for a in (
                rows[keep], js[keep], pages[keep], pos[keep] % page_len))
            for pool, scratch in zip(k_pages + v_pages, sk + sv):
                pool[p, :, o] = scratch[r, :, j].to(pool.dtype)
        return k_pages, v_pages
    for j in range(int(commit.max(initial=0))):
        at = np.nonzero(js == j)[0]         # the rows committing j
        wo = pos[at] % page_len
        comp = at[(wo == page_len - 1)
                  & (pages[at] >= 0) & (pages[at] < n_pages)]
        r, o = (torch.as_tensor(a, device=dev) for a in (rows[at], wo))
        rc, pc = (torch.as_tensor(a, device=dev)
                  for a in (rows[comp], pages[comp]))
        for i in range(len(k_pages)):
            for tail, scratch, pool, sc in (
                    (k_tail[i], sk[i], k_pages[i], k_scales[i]),
                    (v_tail[i], sv[i], v_pages[i], v_scales[i])):
                tail[r, :, o] = scratch[r, :, j].to(torch.float32)
                if len(comp):
                    _quantize_into(pool, sc, pc, tail[rc], kv_bits)
    return k_pages, v_pages, k_scales, v_scales, k_tail, v_tail


def _filter_logits(logits, temperature: float, top_k: Optional[int],
                   top_p: Optional[float] = None):
    """Temperature-scaled float32 logits with everything outside the
    top-k / nucleus top-p set at -inf (the JAX package's ``_sample``
    filtering, line for line)."""
    logits = logits.to(torch.float32) / temperature
    if top_k is not None:
        cutoff = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = logits.masked_fill(logits < cutoff, float("-inf"))
    if top_p is not None:
        # keep the smallest probability-sorted prefix whose mass reaches
        # top_p (the token that crosses the threshold stays)
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        keep_sorted = (cum - probs) < top_p
        # clamp: top_p == 0.0 would keep no token and index -1
        kept = keep_sorted.sum(dim=-1, keepdim=True).clamp_min(1)
        cutoff = torch.gather(sorted_logits, -1, kept - 1)
        logits = logits.masked_fill(logits < cutoff, float("-inf"))
    return logits


def _sample(logits, generator: Optional[torch.Generator],
            temperature: float, top_k: Optional[int],
            top_p: Optional[float] = None):
    """Next tokens (B,) from logits (B, vocab). Temperature 0 is greedy
    and draws nothing; otherwise the Gumbel-max trick (what
    ``jax.random.categorical`` does) with one uniform per vocab entry
    drawn from ``generator`` on its own device."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    logits = _filter_logits(logits, temperature, top_k, top_p)
    u = torch.rand(logits.shape, generator=generator,
                   device=generator.device if generator is not None
                   else logits.device, dtype=torch.float32)
    u = u.to(logits.device).clamp_min(torch.finfo(torch.float32).tiny)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)


def _model_window(model: TransformerLM) -> Optional[int]:
    """The model's uniform sliding-window width, or None."""
    widths = {getattr(blk.attn.attn_fn, "window", None)
              for blk in model.blocks}
    if widths == {None} or not len(model.blocks):
        return None
    if len(widths) == 1:
        return next(iter(widths))
    raise ValueError(f"blocks disagree on attention window "
                     f"({sorted(map(str, widths))}); cached decode needs "
                     "a uniform width")


def _check_attn_compatible(model: TransformerLM,
                           allow_custom_attn: bool) -> None:
    """Decode attends over the cache with its own softmax(qk)v: exact for
    dense attention, dense-equivalent kernels and uniform sliding-window
    kernels. Refuse other custom cores unless the caller opts in."""
    if allow_custom_attn:
        return
    for blk in model.blocks:
        f = blk.attn.attn_fn
        if (f is dense_attention or getattr(f, "dense_equivalent", False)
                or getattr(f, "window", None) is not None):
            continue
        raise ValueError(
            "model was built with a custom attn_fn whose semantics the "
            "cached decode path cannot reproduce; pass "
            "allow_custom_attn=True only if the core computes standard "
            "softmax(q k^T * scale) v")


def make_generate_fn(model: TransformerLM, max_new: int, *,
                     temperature: float = 0.0, top_k: Optional[int] = None,
                     top_p: Optional[float] = None,
                     max_len: Optional[int] = None,
                     allow_custom_attn: bool = False,
                     param_shardings=None):
    """Build ``fn(prompt, generator=None) -> (B, max_new) tokens``.
    ``generator`` defaults to one on the model's device seeded 0.

    ``param_shardings``: the producer's params out-shardings (a train
    step's ``out_shardings["params"]``). When set, every call first
    asserts the model's parameters already carry them
    (``parallel.front_door.verify_handoff``): a mismatch raises a typed
    ``HandoffMismatch`` instead of the weights being copied."""
    _check_attn_compatible(model, allow_custom_attn)
    window = _model_window(model)

    def fn(prompt, generator: Optional[torch.Generator] = None):
        if param_shardings is not None:
            from ..parallel.front_door import verify_handoff
            verify_handoff(model, param_shardings, what="generate params")
        prompt = _as_tokens(model, prompt)
        s = prompt.shape[1]
        limit = max_len or (s + max_new)
        if limit > model.max_seq:
            raise ValueError(
                f"cache length {limit} (prompt {s} + max_new {max_new} "
                f"or explicit max_len) exceeds the model's max_seq "
                f"({model.max_seq})")
        if window is None and s + max_new > limit:
            raise ValueError(
                f"max_len {limit} cannot hold prompt ({s}) + max_new "
                f"({max_new}) tokens — the cache would wrap and corrupt")
        if (window is not None and model.pos is not None
                and s + max_new > model.max_seq):
            raise ValueError(
                f"prompt ({s}) + max_new ({max_new}) exceeds max_seq "
                f"({model.max_seq}): learned position embeddings cannot "
                "extrapolate past their table even under a sliding "
                "window (use pos='rope' for unbounded generation)")
        # a window wider than the whole run degenerates to the plain
        # layout size with identical semantics
        w_eff = None if window is None else min(window, s + max_new)
        if generator is None:
            generator = default_generator(model.device, 0)
        with torch.inference_mode():
            logits, cache = prefill(model, prompt, limit, window=w_eff)
            token = _sample(logits, generator, temperature, top_k, top_p)
            out = [token]
            for _ in range(max_new - 1):
                logits, cache = decode_step(model, cache, token,
                                            window=w_eff)
                token = _sample(logits, generator, temperature, top_k,
                                top_p)
                out.append(token)
        return torch.stack(out, dim=1)

    return fn


def generate(model: TransformerLM, prompt, max_new: int, *,
             temperature: float = 0.0, top_k: Optional[int] = None,
             top_p: Optional[float] = None,
             generator: Optional[torch.Generator] = None,
             max_len: Optional[int] = None) -> torch.Tensor:
    """Generate ``max_new`` tokens after ``prompt`` ((B, S) ints).
    Temperature 0 is greedy; otherwise sampling with optional top-k /
    top-p. Returns (B, max_new) int64 on the model's device."""
    return make_generate_fn(model, max_new, temperature=temperature,
                            top_k=top_k, top_p=top_p,
                            max_len=max_len)(prompt, generator)
