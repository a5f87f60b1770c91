"""Decoder-only causal transformer LM.

Counterpart of ``distributed_pytorch_tpu/models/transformer.py``: tok +
pos embed -> N pre-norm blocks -> LN -> vocab projection, with learned /
rope / no positions, grouped-query attention, tied embeddings and the
per-layer rematerialization policies of training (``remat=``).

The model is built on the card unless ``device`` says otherwise; with no
CUDA device and no explicit device it raises. Weights are drawn from
``generator`` (a seeded ``torch.Generator`` on the model's device) or
loaded from a JAX param tree with ``convert.from_jax_params``.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional, Union

import torch
from torch import nn
from torch.utils import checkpoint as _ckpt

from ..nn.attention import TransformerBlock
from ..nn.core import Embedding, LayerNorm, Linear
from ..runtime import env as _env
from ..runtime.device import DeviceLike, resolve_device

#: Named per-layer rematerialization policies (the JAX package's):
#: ``none`` saves every activation; ``full`` checkpoints the whole block
#: (only its input is saved, the block is recomputed in backward);
#: ``dots_saveable`` saves the outputs of matrix products and recomputes
#: only the elementwise chain (LN, GELU, softmax).
REMAT_POLICIES = ("none", "full", "dots_saveable")

# the matrix products whose outputs ``dots_saveable`` keeps (what
# F.linear and the attention einsums lower to)
_DOT_OPS = frozenset((torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
                      torch.ops.aten.bmm.default,
                      torch.ops.aten.baddbmm.default))


def resolve_remat(remat: Union[bool, str, None]) -> str:
    """Canonical policy name for a ``remat=`` argument: ``False`` ->
    ``none``, ``True`` -> ``full``, ``None`` -> the ``DPX_REMAT``
    registry value; a string must name one of :data:`REMAT_POLICIES`."""
    if remat is None:
        remat = _env.get("DPX_REMAT")
    if remat is False:
        return "none"
    if remat is True:
        return "full"
    if remat not in REMAT_POLICIES:
        raise ValueError(
            f"remat must be a bool or one of {'|'.join(REMAT_POLICIES)}, "
            f"got {remat!r}")
    return remat


def _dots_saveable(ctx, op, *args, **kwargs):
    if op in _DOT_OPS:
        return _ckpt.CheckpointPolicy.MUST_SAVE
    return _ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def apply_remat_policy(fn: Callable, policy: str) -> Callable:
    """Wrap a per-layer forward with the named policy: the one place a
    policy name becomes a ``torch.utils.checkpoint`` call (non-reentrant;
    ``dots_saveable`` through a selective-checkpoint context). Unknown
    names raise; bools and ``None`` resolve through
    :func:`resolve_remat` first."""
    if policy not in REMAT_POLICIES:
        raise ValueError(
            f"unknown remat policy {policy!r}; choose from "
            f"{'|'.join(REMAT_POLICIES)}")
    if policy == "none":
        return fn
    extra = {} if policy == "full" else dict(context_fn=functools.partial(
        _ckpt.create_selective_checkpoint_contexts, _dots_saveable))

    def run(*args, **kwargs):
        # without autograd there is nothing to save or recompute
        if not torch.is_grad_enabled():
            return fn(*args, **kwargs)
        return _ckpt.checkpoint(fn, *args, use_reentrant=False, **extra,
                                **kwargs)
    return run


class TransformerLM(nn.Module):
    """Decoder-only causal LM."""

    def __init__(self, vocab: int = 256, dim: int = 128, n_layers: int = 2,
                 n_heads: int = 4, max_seq: int = 512, mlp_ratio: int = 4,
                 dropout: float = 0.0, n_kv_heads: Optional[int] = None,
                 pos: str = "learned",
                 rope_base: float = 10000.0, tie_embeddings: bool = False,
                 attn_fn: Optional[Callable] = None,
                 remat: Union[bool, str, None] = False, dtype=torch.float32,
                 device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if pos not in ("learned", "rope", "none"):
            raise ValueError(f"pos must be learned|rope|none, got {pos!r}")
        # bools keep the JAX meaning, None defers to DPX_REMAT
        self.remat_policy = resolve_remat(remat)
        device = resolve_device(device)
        self.vocab = vocab
        self.dim = dim
        self.n_layers = n_layers
        self.n_heads = n_heads
        self.n_kv_heads = n_kv_heads if n_kv_heads is not None else n_heads
        self.max_seq = max_seq
        self.dtype = dtype
        self.dropout = float(dropout)
        self.pos_kind = pos
        kw = dict(dtype=dtype, device=device)
        self.tok = Embedding(vocab, dim, std=dim ** -0.5,
                             generator=generator, **kw)
        self.pos = Embedding(max_seq, dim, std=dim ** -0.5,
                             generator=generator, **kw) \
            if pos == "learned" else None
        self.blocks = nn.ModuleList([
            TransformerBlock(dim, n_heads, mlp_ratio, causal=True,
                             dropout=dropout, n_kv_heads=n_kv_heads,
                             rope=(pos == "rope"),
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

    def forward(self, tokens, positions=None, return_hidden: bool = False,
                generator: Optional[torch.Generator] = None):
        """tokens (B, S) int -> logits (B, S, vocab); with
        ``return_hidden`` the post-final-norm hidden states (B, S, dim)
        instead, skipping the vocab projection. Under autograd each
        block runs through the model's remat policy.

        Dropout (``dropout > 0``) acts in training mode given
        ``generator``: it draws one seed per block, and block i's masks
        come from a stream seeded with it (the JAX package's
        ``fold_in(rng, i)``). At ``dropout=0.0`` nothing is drawn."""
        tokens = tokens.to(self.device, torch.long)
        if positions is None:
            positions = torch.arange(tokens.shape[1], device=self.device)
        seeds = [None] * len(self.blocks)
        if generator is not None and self.training and self.dropout > 0.0:
            seeds = torch.randint(2 ** 62, (len(self.blocks),),
                                  generator=generator,
                                  device=generator.device).tolist()
        x = self.embed(tokens, positions)
        for blk, seed in zip(self.blocks, seeds):
            x = apply_remat_policy(blk, self.remat_policy)(
                x, positions=positions, seed=seed)
        x = self.ln_f(x)
        if return_hidden:
            return x
        return self.project_vocab(x)
