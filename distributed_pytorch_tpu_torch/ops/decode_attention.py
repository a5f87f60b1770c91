"""Blockwise decode attention: single-token attention over a contiguous
KV cache that visits only the blocks holding resident positions.

Counterpart of ``distributed_pytorch_tpu/ops/decode_attention.py``
(``resident_blocks``, ``dense_decode_attention``,
``blockwise_decode_attention``, ``paged_decode_attention``; the
quantized pages of the paged variant are not ported yet, ROADMAP.md
Queue A item 4.1). The JAX package writes these with jnp and a
``fori_loop``, not Pallas, so they are PyTorch ops here too. The loop's
trip count is a host int from ``max(lengths)``.

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

__all__ = ["DECODE_BLOCK", "blockwise_decode_attention",
           "dense_decode_attention", "paged_decode_attention",
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
    accumulator of the online softmax, all float32."""
    b = hq.shape[0]
    m = torch.full((b, hkv, g, 1), _MASK, dtype=torch.float32,
                   device=hq.device)
    acc = torch.zeros((b, hkv, g, 1, hq.shape[-1]), dtype=torch.float32,
                      device=hq.device)
    return m, torch.zeros_like(m), acc


def _merge_block(carry, q32, k_blk, v_blk, valid, scale):
    """One online-softmax merge of a block of keys: q32 (B, Hkv, g, 1,
    Dh) float32, k_blk/v_blk (B, Hkv, L, Dh), valid (B, 1, 1, 1, L)."""
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
                           block_pages: int = 1):
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
    bit for bit. Returns o (B, H, 1, Dh) in the pool's dtype (the
    quantized pool's scales and tails are not ported yet: ROADMAP.md
    Queue A item 4.1)."""
    b, h, _, dh = hq.shape
    hkv = k_pages.shape[1]
    g = h // hkv
    q32 = hq.reshape(b, hkv, g, 1, dh).to(k_pages.dtype).to(torch.float32)
    block_len = block_pages * page_len
    if n_blocks is None:
        n_blocks = resident_blocks(idx, block_len,
                                   -(-tables.shape[1] // block_pages))
    nk = new_k.reshape(b, hkv, 1, dh).to(k_pages.dtype)
    nv = new_v.reshape(b, hkv, 1, dh).to(v_pages.dtype)
    carry = _init_carry(hq, hkv, g, dh)
    for j in range(n_blocks):
        pids = tables[:, j * block_pages:(j + 1) * block_pages]
        n = pids.shape[1] * page_len
        pos = torch.arange(j * block_len, j * block_len + n,
                           device=hq.device)
        wm = (pos[None, :] == idx[:, None])[:, None, :, None]
        k_blk = torch.where(wm, nk, _rows(k_pages[pids]))
        v_blk = torch.where(wm, nv, _rows(v_pages[pids]))
        valid = (pos[None, :] <= idx[:, None])[:, None, None, None, :]
        carry = _merge_block(carry, q32, k_blk, v_blk, valid, scale)
    return _finish(carry, v_pages.dtype).reshape(b, h, 1, dh)


def _rows(g):
    """Gathered pages (B, n, Hkv, page_len, Dh) as contiguous rows (B,
    Hkv, n * page_len, Dh)."""
    b, n, h, l, d = g.shape
    return g.permute(0, 2, 1, 3, 4).reshape(b, h, n * l, d)
