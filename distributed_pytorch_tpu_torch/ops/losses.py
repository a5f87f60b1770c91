"""Loss functions.

Counterpart of ``distributed_pytorch_tpu/ops/losses.py``
(``cross_entropy_per_example`` and ``cross_entropy``). The fused
vocab-projection loss (``fused_linear_cross_entropy``) and the
vocab-parallel loss are not ported yet (ROADMAP.md, Queue A).
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
