"""Sequence parallelism: ring attention (dense and flash cores, striped
and sliding-window variants) and all-to-all (Ulysses) attention.

Counterpart of ``distributed_pytorch_tpu/parallel/sequence.py``. The
sequence axis is sharded over the ranks of ``group`` (the ``sp`` axis of
the mesh; ``None`` is every rank): each rank calls these functions with
its own (B, H, S/n, Dh) block of q and (B, Hkv, S/n, Dh) blocks of k/v
(Hkv dividing H), and gets its (B, H, S/n, Dh) block of the output.

- :func:`ring_attention` (dense core) and :func:`ring_flash_attention`
  (the flash kernel per hop): k/v blocks go round the ring
  (``comm.primitives.ring_shift``), so at hop t rank ``my`` holds the
  block of rank ``(my - t) % n``. Every one of the n hops runs; a hop
  whose block lies in the causal future is merged at weight zero (its
  lse set to ``_NEG``). With ``window`` only the first
  ``min(n, (window + S_loc - 2) // S_loc + 1)`` hops can meet a query's
  band, and only they run, each with the kernel's banded frontier
  aligned by ``diag_offset = t * S_loc``.
- :func:`striped_ring_flash_attention`: the load-balanced causal ring
  over :func:`stripe_tokens` layout, where every hop is a triangular
  kernel: inclusive (``causal_offset=0``) when the held block comes from
  an earlier rank (``t <= my``), strict (``causal_offset=1``) otherwise.
- :func:`ulysses_attention`: two all-to-alls reshard heads <-> sequence
  around full-sequence attention.

Each flash hop is :func:`_flash_hop` and the partials merge by
:func:`_merge_lse`; :func:`_ring_flash` runs the hops of one rank with a
``shift`` that brings the next block. The rings shift through
``ring_shift`` (whose gradient is the reverse ring, so autograd gives the
reverse ring as ``jax.grad`` does); ``chip_smoke.py`` replays n ranks on
one card through the same ``_ring_flash`` with a shift that indexes the
blocks.

A row with no visible key in a hop (strict striped hops, banded hops)
comes out of the kernel as NaN with the floor lse; it is zeroed before
the merge, so the weight-zero merge and its gradient stay NaN-free.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from ..comm import primitives as prim

_NEG = -1e30  # finite mask value: keeps the online softmax NaN-free


def _block_update(q, k, v, o, m, l, scale, mask):
    """One blockwise accumulation step (online softmax) of the dense
    ring. q (..., Sq, D), k/v (..., Sk, D) broadcasting over the leading
    dims (GQA: q (B, Hkv, g, Sq, D) against k (B, Hkv, 1, Sk, D)); o, m,
    l the running accumulators; ``mask`` (Sq, Sk) of allowed keys."""
    logits = torch.einsum("...qd,...kd->...qk", q, k).to(torch.float32) \
        * scale
    logits = torch.where(mask, logits, _NEG)
    m_new = torch.maximum(m, logits.amax(dim=-1))
    p = torch.exp(logits - m_new[..., None])
    corr = torch.exp(m - m_new)
    l_new = l * corr + p.sum(dim=-1)
    o_new = o * corr[..., None] + torch.einsum(
        "...qk,...kd->...qd", p, v.to(torch.float32))
    return o_new, m_new, l_new


def ring_attention(q, k, v, *, group=None, causal: bool = False,
                   scale: Optional[float] = None):
    """Attention of sequence-sharded q/k/v over the ring of ``group``
    with the dense blockwise core: exact, identical to dense attention
    on the gathered sequence. Returns this rank's output block."""
    n, my = prim.axis_size(group), prim.axis_index(group)
    b, h, s_loc, dh = q.shape
    h_kv = k.shape[1]
    if h % h_kv:
        raise ValueError(f"n_heads {h} not divisible by kv heads {h_kv}")
    g = h // h_kv
    if g > 1:
        q = q.reshape(b, h_kv, g, s_loc, dh)
    scale = scale if scale is not None else 1.0 / math.sqrt(dh)
    acc_shape = (b, h_kv, g, s_loc) if g > 1 else (b, h, s_loc)
    dev = q.device
    o = torch.zeros(acc_shape + (dh,), dtype=torch.float32, device=dev)
    m = torch.full(acc_shape, _NEG, dtype=torch.float32, device=dev)
    l = torch.zeros(acc_shape, dtype=torch.float32, device=dev)
    tri = torch.tril(torch.ones(s_loc, s_loc, dtype=torch.bool, device=dev))
    full = torch.ones_like(tri)
    kt, vt = k, v
    for t in range(n):
        src = (my - t) % n     # the rank whose block this rank holds
        if causal:
            mask = tri if src == my else full if src < my else ~full
        else:
            mask = full
        kb = kt[:, :, None] if g > 1 else kt
        vb = vt[:, :, None] if g > 1 else vt
        o, m, l = _block_update(q, kb, vb, o, m, l, scale, mask)
        kt = prim.ring_shift(kt, group)
        vt = prim.ring_shift(vt, group)
    out = (o / l[..., None]).to(q.dtype)
    return out.reshape(b, h, s_loc, dh) if g > 1 else out


def make_ring_attn_fn(group=None) -> Callable:
    """An ``attn_fn`` for ``MultiHeadAttention`` running
    :func:`ring_attention` over ``group``."""
    def attn_fn(q, k, v, *, causal: bool = False, scale=None):
        return ring_attention(q, k, v, group=group, causal=causal,
                              scale=scale)
    return attn_fn


def _merge_lse(o_acc, lse_acc, o_j, lse_j):
    """The exact softmax merge of two (output, lse) partials over
    disjoint key sets: the one definition for every ring variant."""
    lse_new = torch.logaddexp(lse_acc, lse_j)
    w_acc = torch.exp(lse_acc - lse_new)[..., None]
    w_j = torch.exp(lse_j - lse_new)[..., None]
    return o_acc * w_acc + o_j * w_j, lse_new


def _window_hops(n: int, s_loc: int, window: Optional[int]) -> int:
    """The hops of a ring of n blocks of ``s_loc`` that can meet a
    query's window: hop t's block spans relative offsets
    [t*s_loc - (s_loc-1), t*s_loc + (s_loc-1)], inside the band only
    while t*s_loc - (s_loc-1) < window."""
    if window is None:
        return n
    return min(n, (window + s_loc - 2) // s_loc + 1)


def _flash_hop(q, kt, vt, t: int, my: int, *, causal: bool, scale,
               window: Optional[int] = None, striped: bool = False):
    """Hop t of rank ``my``'s ring: the flash kernel of q against the
    held block (the block of rank ``(my - t) % n``), as (o_j float32,
    lse_j) ready to merge: a causal-future block at lse ``_NEG``, rows
    with no visible key zeroed."""
    from ..ops.flash_attention import flash_attention_with_lse
    s_loc = q.shape[2]
    if striped:
        o_j, lse_j = flash_attention_with_lse(
            q, kt, vt, causal=True, causal_offset=0 if t <= my else 1,
            scale=scale)
    elif window is not None:
        o_j, lse_j = flash_attention_with_lse(
            q, kt, vt, causal=True, window=window, diag_offset=t * s_loc,
            scale=scale)
    else:
        o_j, lse_j = flash_attention_with_lse(
            q, kt, vt, causal=(causal and t == 0), scale=scale)
    o_j = o_j.to(torch.float32)
    if causal and not striped and t > my:
        # the held block is in the causal future: weight zero
        lse_j = torch.full_like(lse_j, _NEG)
    if striped or window is not None:
        no_vis = lse_j <= _NEG / 2
        o_j = torch.where(no_vis[..., None], 0.0, o_j)
        lse_j = torch.where(no_vis, _NEG, lse_j)
    return o_j, lse_j


def _ring_flash(q, k, v, my: int, n: int, shift: Callable, *,
                causal: bool, scale, window: Optional[int] = None,
                striped: bool = False):
    """The hops of rank ``my`` of an n-rank flash ring, merged: the
    module's schedule, with ``shift(t, kt, vt)`` bringing the block held
    at hop t + 1 (``ring_shift`` on a real ring). Returns (o float32,
    lse)."""
    b, h, s_loc, dh = q.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(dh)
    o_acc = torch.zeros((b, h, s_loc, dh), dtype=torch.float32,
                        device=q.device)
    lse_acc = torch.full((b, h, s_loc), _NEG, dtype=torch.float32,
                         device=q.device)
    t_hi = n if striped else _window_hops(n, s_loc, window)
    kt, vt = k, v
    for t in range(t_hi):
        o_j, lse_j = _flash_hop(q, kt, vt, t, my, causal=causal,
                                scale=scale, window=window, striped=striped)
        o_acc, lse_acc = _merge_lse(o_acc, lse_acc, o_j, lse_j)
        if t < t_hi - 1:
            kt, vt = shift(t, kt, vt)
    return o_acc, lse_acc


def _ring_shift_fn(group):
    def shift(t, kt, vt):
        return prim.ring_shift(kt, group), prim.ring_shift(vt, group)
    return shift


def ring_flash_attention(q, k, v, *, group=None, causal: bool = False,
                         scale: Optional[float] = None,
                         window: Optional[int] = None):
    """Ring attention with the flash kernel as the per-hop core: the
    contract of :func:`ring_attention`, O(S_local) attention memory per
    hop, the partials merged through the differentiable (o, lse) of
    ``flash_attention_with_lse``. ``window`` (requires ``causal``) is
    sliding-window attention: the hops past the band never run."""
    if window is not None and not causal:
        raise ValueError("window requires causal=True (sliding-window "
                         "attention is a causal-decoder pattern)")
    n, my = prim.axis_size(group), prim.axis_index(group)
    o, _ = _ring_flash(q, k, v, my, n, _ring_shift_fn(group),
                       causal=causal, scale=scale, window=window)
    return o.to(q.dtype)


def striped_ring_flash_attention(q, k, v, *, group=None,
                                 scale: Optional[float] = None):
    """Causal ring flash attention over :func:`stripe_tokens` layout
    (rank r's local index i is global position ``i * n + r``): every hop
    a triangular kernel, about half the attention work of the contiguous
    causal ring and balanced across ranks. Causal only."""
    n, my = prim.axis_size(group), prim.axis_index(group)
    o, _ = _ring_flash(q, k, v, my, n, _ring_shift_fn(group), causal=True,
                       scale=scale, striped=True)
    return o.to(q.dtype)


def make_ring_flash_attn_fn(group=None, window: Optional[int] = None
                            ) -> Callable:
    """An ``attn_fn`` running :func:`ring_flash_attention` over
    ``group``; ``window`` bakes sliding-window attention into the
    ring."""
    def attn_fn(q, k, v, *, causal: bool = False, scale=None):
        return ring_flash_attention(q, k, v, group=group, causal=causal,
                                    scale=scale, window=window)
    return attn_fn


def ulysses_attention(q, k, v, *, group=None, causal: bool = False,
                      scale: Optional[float] = None, core: str = "flash",
                      window: Optional[int] = None):
    """All-to-all (Ulysses) sequence parallelism: (B, H, S/n, D) --
    all-to-all --> (B, H/n, S, D), full-sequence attention (the flash
    kernel or the dense core), and the all-to-all back. Two collectives
    in place of n hops, O(S) attention memory; q and kv heads must
    divide by the group's size."""
    if core not in ("dense", "flash"):
        raise ValueError(f"unknown ulysses attention core {core!r}")
    if window is not None and not causal:
        raise ValueError("window requires causal=True (sliding-window "
                         "attention is a causal-decoder pattern)")
    from ..nn.attention import dense_attention
    from ..ops.flash_attention import flash_attention
    n = prim.axis_size(group)
    h, h_kv = q.shape[1], k.shape[1]
    if h % n or h_kv % n:
        raise ValueError(
            f"ulysses_attention needs q heads ({h}) and kv heads "
            f"({h_kv}) divisible by the sp axis size {n} — use ring "
            "attention otherwise")
    qh, kh, vh = (prim.all_to_all(t, 1, 2, group=group) for t in (q, k, v))
    attend = flash_attention if core == "flash" else dense_attention
    oh = attend(qh, kh, vh, causal=causal, scale=scale, window=window)
    return prim.all_to_all(oh, 2, 1, group=group)


def stripe_tokens(x, n: int, axis: int = 1):
    """The sequence axis in striped layout for n shards: contiguous
    shard r of the result holds original positions ``{r, r+n, ...}`` in
    order. Stripe once at the data level (tokens, targets and position
    ids, passed to the model as ``positions=``)."""
    s = x.shape[axis]
    if s % n:
        raise ValueError(f"sequence length {s} not divisible by {n} shards")
    c = s // n
    x = x.reshape(*x.shape[:axis], c, n, *x.shape[axis + 1:])
    x = x.transpose(axis, axis + 1)
    return x.reshape(*x.shape[:axis], s, *x.shape[axis + 2:])


def unstripe_tokens(x, n: int, axis: int = 1):
    """The inverse of :func:`stripe_tokens`."""
    s = x.shape[axis]
    if s % n:
        raise ValueError(f"sequence length {s} not divisible by {n} shards")
    c = s // n
    x = x.reshape(*x.shape[:axis], n, c, *x.shape[axis + 1:])
    x = x.transpose(axis, axis + 1)
    return x.reshape(*x.shape[:axis], s, *x.shape[axis + 2:])


__all__ = ["make_ring_attn_fn", "make_ring_flash_attn_fn", "ring_attention",
           "ring_flash_attention", "stripe_tokens",
           "striped_ring_flash_attention", "ulysses_attention",
           "unstripe_tokens"]
