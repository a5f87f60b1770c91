"""Decoder-only causal transformer LM (inference forward).

Counterpart of ``distributed_pytorch_tpu/models/transformer.py``: tok +
pos embed -> N pre-norm blocks -> LN -> vocab projection, with learned /
rope / no positions, grouped-query attention and tied embeddings.
Rematerialization is a training knob and waits for the training slice.

The model is built on the card unless ``device`` says otherwise; with no
CUDA device and no explicit device it raises. Weights are drawn from
``generator`` (a seeded ``torch.Generator`` on the model's device) or
loaded from a JAX param tree with ``convert.from_jax_params``.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from ..nn.attention import TransformerBlock
from ..nn.core import Embedding, LayerNorm, Linear
from ..runtime.device import DeviceLike, resolve_device


class TransformerLM(nn.Module):
    """Decoder-only causal LM."""

    def __init__(self, vocab: int = 256, dim: int = 128, n_layers: int = 2,
                 n_heads: int = 4, max_seq: int = 512, mlp_ratio: int = 4,
                 n_kv_heads: Optional[int] = None, pos: str = "learned",
                 rope_base: float = 10000.0, tie_embeddings: bool = False,
                 attn_fn: Optional[Callable] = None, dtype=torch.float32,
                 device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if pos not in ("learned", "rope", "none"):
            raise ValueError(f"pos must be learned|rope|none, got {pos!r}")
        device = resolve_device(device)
        self.vocab = vocab
        self.dim = dim
        self.n_layers = n_layers
        self.n_heads = n_heads
        self.n_kv_heads = n_kv_heads if n_kv_heads is not None else n_heads
        self.max_seq = max_seq
        self.dtype = dtype
        self.pos_kind = pos
        kw = dict(dtype=dtype, device=device)
        self.tok = Embedding(vocab, dim, std=dim ** -0.5,
                             generator=generator, **kw)
        self.pos = Embedding(max_seq, dim, std=dim ** -0.5,
                             generator=generator, **kw) \
            if pos == "learned" else None
        self.blocks = nn.ModuleList([
            TransformerBlock(dim, n_heads, mlp_ratio, causal=True,
                             n_kv_heads=n_kv_heads, rope=(pos == "rope"),
                             rope_base=rope_base, attn_fn=attn_fn,
                             generator=generator, **kw)
            for _ in range(n_layers)])
        self.ln_f = LayerNorm(dim, **kw)
        # tied embeddings: the vocab projection reuses the token table
        self.tie_embeddings = tie_embeddings
        self.head = None if tie_embeddings else \
            Linear(dim, vocab, bias=False, generator=generator, **kw)

    @property
    def device(self) -> torch.device:
        return self.tok.weight.device

    def head_weight(self):
        """The (vocab, dim) vocab-projection matrix."""
        return self.tok.weight if self.tie_embeddings else self.head.weight

    def project_vocab(self, x):
        """Hidden states (..., dim) -> logits (..., vocab)."""
        return torch.nn.functional.linear(x, self.head_weight())

    def embed(self, tokens, positions):
        """Token (+ learned position) embedding of ``tokens`` at
        ``positions`` (broadcastable to ``tokens``)."""
        x = self.tok(tokens)
        if self.pos is not None:
            x = x + self.pos(positions)
        return x

    def forward(self, tokens, positions=None):
        """tokens (B, S) int -> logits (B, S, vocab)."""
        tokens = tokens.to(self.device, torch.long)
        if positions is None:
            positions = torch.arange(tokens.shape[1], device=self.device)
        x = self.embed(tokens, positions)
        for blk in self.blocks:
            x = blk(x, positions=positions)
        return self.project_vocab(self.ln_f(x))
