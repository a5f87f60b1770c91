"""Attention and the pre-norm transformer block.

Counterpart of ``distributed_pytorch_tpu/nn/attention.py``. The layout
at every public function is the JAX package's: q (B, H, S, Dh), k/v
(B, Hkv, S, Dh) with Hkv dividing H (grouped-query attention read
through a grouped einsum, never repeated in memory).
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
from torch import nn

from .core import LayerNorm, Linear, gelu
from .rotary import apply_rope


def dense_attention(q, k, v, *, causal: bool = False,
                    scale: Optional[float] = None,
                    window: Optional[int] = None):
    """Reference attention: softmax(q k^T * scale) v.

    The softmax (max, exp, normalizing sum) runs in float32 whatever the
    input dtype; only the probabilities are cast back to ``v.dtype`` for
    the p@v product. A row with no visible key (causal with s_q > s_k)
    is NaN, as a softmax over an all -inf row is. ``window`` (requires
    ``causal``): row i sees keys (i+off-window, i+off], off = s_k - s_q.
    """
    b, h, s_q, dh = q.shape
    h_kv, s_k = k.shape[-3], k.shape[-2]
    if h % h_kv:
        raise ValueError(f"n_heads {h} not divisible by kv heads {h_kv}")
    if window is not None and not causal:
        raise ValueError("window requires causal=True")
    scale = scale if scale is not None else 1.0 / math.sqrt(dh)
    qg = q.reshape(b, h_kv, h // h_kv, s_q, dh)
    logits = torch.einsum("bngqd,bnkd->bngqk", qg, k).to(torch.float32) \
        * scale
    if causal:
        ones = torch.ones(s_q, s_k, dtype=torch.bool, device=q.device)
        mask = torch.tril(ones, diagonal=s_k - s_q)
        if window is not None:
            mask &= ~torch.tril(ones, diagonal=s_k - s_q - window)
        logits = logits.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bngqk,bnkd->bngqd", probs, v) \
        .reshape(b, h, s_q, dh)


class MultiHeadAttention(nn.Module):
    """Multi-head self-attention with a pluggable core ``attn_fn(q, k,
    v, causal=...)`` (default :func:`dense_attention`) and a fused qkv
    projection laid out ``[q | k | v]``."""

    def __init__(self, dim: int, n_heads: int, *, causal: bool = False,
                 n_kv_heads: Optional[int] = None, rope: bool = False,
                 rope_base: float = 10000.0,
                 attn_fn: Optional[Callable] = None, dtype=torch.float32,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        if dim % n_heads:
            raise ValueError(f"dim {dim} not divisible by n_heads {n_heads}")
        self.dim = dim
        self.n_heads = n_heads
        self.n_kv_heads = n_kv_heads if n_kv_heads is not None else n_heads
        if n_heads % self.n_kv_heads:
            raise ValueError(f"n_heads {n_heads} not divisible by "
                             f"n_kv_heads {self.n_kv_heads}")
        self.head_dim = dim // n_heads
        self.causal = causal
        self.rope = rope
        self.rope_base = rope_base
        self.attn_fn = attn_fn or dense_attention
        kv_dim = self.n_kv_heads * self.head_dim
        self.qkv = Linear(dim, dim + 2 * kv_dim, dtype=dtype, device=device,
                          generator=generator)
        self.out = Linear(dim, dim, dtype=dtype, device=device,
                          generator=generator)

    def project_qkv(self, x):
        """x (B, S, D) -> q (B, H, S, Dh), k, v (B, Hkv, S, Dh), as views
        of the fused projection (last axis contiguous)."""
        b, s, _ = x.shape
        dh, h, hkv = self.head_dim, self.n_heads, self.n_kv_heads
        q, k, v = torch.split(self.qkv(x), [h * dh, hkv * dh, hkv * dh],
                              dim=-1)

        def heads(t, n):
            return t.reshape(b, s, n, dh).transpose(1, 2)
        return heads(q, h), heads(k, hkv), heads(v, hkv)

    def project_out(self, o):
        """o (B, H, S, Dh) -> output projection (B, S, D)."""
        b, h, s, dh = o.shape
        return self.out(o.transpose(1, 2).reshape(b, s, h * dh))

    def maybe_rope(self, q, k, positions=None):
        """Rotate q/k when built with ``rope=True`` (no-op otherwise).
        The cached decode path rotates keys before caching them."""
        if not self.rope:
            return q, k
        if positions is None:
            positions = torch.arange(q.shape[2], device=q.device)
        return (apply_rope(q, positions, self.rope_base),
                apply_rope(k, positions, self.rope_base))

    def forward(self, x, positions=None):
        q, k, v = self.project_qkv(x)
        q, k = self.maybe_rope(q, k, positions)
        return self.project_out(self.attn_fn(q, k, v, causal=self.causal))


class TransformerBlock(nn.Module):
    """Pre-norm block: x + MHA(LN(x)); x + MLP(LN(x)), GELU MLP."""

    def __init__(self, dim: int, n_heads: int, mlp_ratio: int = 4, *,
                 causal: bool = False, n_kv_heads: Optional[int] = None,
                 rope: bool = False, rope_base: float = 10000.0,
                 attn_fn: Optional[Callable] = None, dtype=torch.float32,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.ln1 = LayerNorm(dim, **kw)
        self.attn = MultiHeadAttention(dim, n_heads, causal=causal,
                                       n_kv_heads=n_kv_heads, rope=rope,
                                       rope_base=rope_base, attn_fn=attn_fn,
                                       generator=generator, **kw)
        self.ln2 = LayerNorm(dim, **kw)
        self.fc1 = Linear(dim, mlp_ratio * dim, generator=generator, **kw)
        self.fc2 = Linear(mlp_ratio * dim, dim, generator=generator, **kw)

    def mlp(self, x):
        """LN -> fc1 -> GELU -> fc2 (no residual); shared by forward and
        the cached decode path."""
        return self.fc2(gelu(self.fc1(self.ln2(x))))

    def forward(self, x, positions=None):
        x = x + self.attn(self.ln1(x), positions=positions)
        return x + self.mlp(x)
