"""Autoregressive generation with a KV cache — the inference path.

Counterpart of ``distributed_pytorch_tpu/models/generate.py`` (the
contiguous-cache functions; paged, speculative and quantized variants
wait for later slices). The JAX package compiles prefill and a
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
                                    dense_decode_attention, resident_blocks)
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
                     allow_custom_attn: bool = False):
    """Build ``fn(prompt, generator=None) -> (B, max_new) tokens``.
    ``generator`` defaults to one on the model's device seeded 0."""
    _check_attn_compatible(model, allow_custom_attn)
    window = _model_window(model)

    def fn(prompt, generator: Optional[torch.Generator] = None):
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
