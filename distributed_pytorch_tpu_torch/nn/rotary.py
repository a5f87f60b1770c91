"""Rotary position embeddings (RoPE), half-split ("rotate_half") layout.

Counterpart of ``distributed_pytorch_tpu/nn/rotary.py``: dims [0, d/2)
pair with [d/2, d); angles are computed in float32 and the rotated
tensor keeps its dtype.
"""

from __future__ import annotations

import torch


def rope_angles(positions, head_dim: int, base: float = 10000.0):
    """(cos, sin) tables for ``positions`` (any shape P), each
    (P..., head_dim/2) float32: angle(p, i) = p * base^(-2i/d)."""
    if head_dim % 2:
        raise ValueError(f"RoPE needs an even head_dim, got {head_dim}")
    half = head_dim // 2
    inv_freq = base ** (-torch.arange(half, dtype=torch.float32,
                                      device=positions.device) / half)
    ang = positions.to(torch.float32)[..., None] * inv_freq
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, positions, base: float = 10000.0):
    """Rotate head vectors: x (..., H, S, Dh), positions broadcastable to
    (..., S)."""
    cos, sin = rope_angles(positions, x.shape[-1], base)
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
