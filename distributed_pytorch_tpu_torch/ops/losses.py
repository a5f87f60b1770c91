"""Loss functions.

Counterpart of ``distributed_pytorch_tpu/ops/losses.py``
(``cross_entropy_per_example``, ``cross_entropy`` and
``fused_linear_cross_entropy``). The vocab-parallel loss is not ported
yet (ROADMAP.md, Queue A).
"""

from __future__ import annotations

import torch


def cross_entropy_per_example(logits, labels):
    """Per-example softmax cross-entropy with int class ids: ``logits``
    (..., C), ``labels`` (...). The log-sum-exp is taken in float32
    whatever the logits' dtype; returns float32."""
    lf = logits.to(torch.float32)
    logz = torch.logsumexp(lf, dim=-1)
    true_logit = torch.gather(lf, -1, labels.to(torch.long)[..., None])
    return logz - true_logit[..., 0]


def cross_entropy(logits, labels):
    """Mean cross-entropy (torch ``CrossEntropyLoss()``'s reduction)."""
    return cross_entropy_per_example(logits, labels).mean()


def _mm_f32(a, b):
    """``a @ b`` with float32 sums and a float32 result, whatever the
    inputs' dtype (the JAX package's ``preferred_element_type=f32``).
    On the card a bfloat16 or float16 product stays on the tensor cores
    and only its float32 sums are written (``torch.mm``'s ``out_dtype``);
    elsewhere the inputs are widened to float32, whose products of
    16-bit values are exact."""
    if a.dtype == torch.float32:
        return a @ b
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.to(torch.float32) @ b.to(torch.float32)


class _FusedLinearCE(torch.autograd.Function):
    """Sum over rows of the cross-entropy of ``h @ w.T``, a chunk of
    ``chunk`` rows at a time; the backward recomputes each chunk's
    logits. Saves only ``h``, ``w`` and ``y``."""

    @staticmethod
    def forward(ctx, h, w, y, chunk):
        ctx.save_for_backward(h, w, y)
        ctx.chunk = chunk
        total = torch.zeros((), dtype=torch.float32, device=h.device)
        for i in range(0, h.shape[0], chunk):
            logits = _mm_f32(h[i:i + chunk], w.t())
            true = logits.gather(1, y[i:i + chunk, None])[:, 0]
            total += (torch.logsumexp(logits, dim=-1) - true).sum()
        return total

    @staticmethod
    def backward(ctx, g):
        h, w, y = ctx.saved_tensors
        chunk = ctx.chunk
        dh = torch.empty_like(h)
        dw = torch.zeros(w.shape, dtype=torch.float32, device=w.device)
        for i in range(0, h.shape[0], chunk):
            hc, yc = h[i:i + chunk], y[i:i + chunk]
            # d(logz - true)/d logits = softmax - onehot, times g
            dl = torch.softmax(_mm_f32(hc, w.t()), dim=-1)
            dl[torch.arange(hc.shape[0], device=h.device), yc] -= 1.0
            dl = (dl * g).to(h.dtype)
            dh[i:i + chunk] = _mm_f32(dl, w).to(h.dtype)
            dw += _mm_f32(dl.t(), hc)
        return dh, dw.to(w.dtype), None, None


def fused_linear_cross_entropy(hidden, w, labels, *, chunk_rows: int = 512):
    """Mean cross-entropy of ``softmax(hidden @ w.T)`` against ``labels``
    without holding the whole ``(N, vocab)`` logits: ``chunk_rows`` rows
    at a time in the forward, and again in the backward, which
    recomputes each chunk's logits and accumulates ``dw`` over the
    chunks in float32. Each chunk's logits are the float32 sums of the
    products (see ``_mm_f32``), as the JAX package's are.

    ``hidden``: (..., d); ``w``: (vocab, d), the layout of
    ``TransformerLM.head_weight()`` (the JAX package takes (d, vocab));
    ``labels``: integer ids of shape ``hidden.shape[:-1]``. Returns a
    float32 scalar."""
    d = hidden.shape[-1]
    h = hidden.reshape(-1, d)
    y = labels.reshape(-1).to(device=h.device, dtype=torch.long)
    chunk = max(1, min(int(chunk_rows), h.shape[0]))
    return _FusedLinearCE.apply(h, w, y, chunk) / h.shape[0]
