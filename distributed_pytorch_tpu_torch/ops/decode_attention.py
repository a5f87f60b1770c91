"""Blockwise decode attention: single-token attention over a contiguous
KV cache that visits only the blocks holding resident positions.

Counterpart of ``distributed_pytorch_tpu/ops/decode_attention.py``
(``resident_blocks``, ``dense_decode_attention``,
``blockwise_decode_attention``; the paged variant waits for the paged
slice). The JAX package writes these with jnp and a ``fori_loop``, not
Pallas, so they are PyTorch ops here too. The loop's trip count is a
host int from ``max(lengths)``.

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
           "dense_decode_attention", "resident_blocks"]

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
    m = torch.full((b, hkv, g, 1), _MASK, dtype=torch.float32,
                   device=hq.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, hkv, g, 1, dh), dtype=torch.float32,
                      device=hq.device)
    for j in range(n_blocks):
        lo, hi = j * block_len, min((j + 1) * block_len, width)
        k_blk, v_blk = k[:, :, lo:hi], v[:, :, lo:hi]
        pos = torch.arange(lo, hi, device=hq.device)
        valid = (pos[None, :] <= idx[:, None])[:, None, None, None, :]
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
        acc = alpha[..., None] * acc + pv
        m = m_new
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    return (acc / l_safe[..., None]).to(v.dtype).reshape(b, h, 1, dh)
