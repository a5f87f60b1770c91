"""Slot-pooled KV cache of the serving engine (contiguous, non-paged).

Counterpart of ``distributed_pytorch_tpu/serve/cache.py``: per layer one
(n_slots, Hkv, width, Dh) buffer for K and V (width = ``max_len``, or the
model's sliding window under the rolling layout) plus per-slot lengths.
The JAX pool counts compiles (one decode program, one admit program per
bucket); PyTorch compiles nothing, so the port counts admits per bucket
and decode steps instead. The pool tensors are allocated once and
written in place; the lengths live on the host, so the blockwise decode
knows its trip count ``max(lengths)`` without a device sync.

A freed slot needs no clearing: the position mask only exposes
positions <= the slot's length, and every such position was written by
the current occupant.

Speculative decoding (``serve/spec/``) scores a row's k+1 candidates
with :meth:`SlotPool.spec_verify`, which writes nothing, and writes only
the accepted prefix with :meth:`SlotPool.spec_commit`.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..models.generate import (decode_step_slots, prefill_partial,
                               spec_commit_slots, spec_verify_slots)


class SlotPool:
    """Owns the pooled cache tensors and the slot programs."""

    def __init__(self, model, n_slots: int, max_len: int,
                 window: Optional[int] = None):
        self.model = model
        self.n_slots = n_slots
        self.max_len = max_len
        self.window = window
        self.width = window if window is not None else max_len
        shape = (n_slots, model.n_kv_heads, self.width,
                 model.dim // model.n_heads)
        self.ks = [torch.zeros(shape, dtype=model.dtype, device=model.device)
                   for _ in range(model.n_layers)]
        self.vs = [torch.zeros(shape, dtype=model.dtype, device=model.device)
                   for _ in range(model.n_layers)]
        self.lengths = np.zeros(n_slots, np.int64)
        self.admits: Dict[int, int] = {}     # bucket -> admits
        self.decode_steps = 0
        self.verify_steps = 0

    def admit(self, tokens_padded, true_len: int, slot: int):
        """Prefill ``tokens_padded`` (1, bucket) into ``slot``; returns the
        last-real-position logits (1, vocab)."""
        bucket = int(tokens_padded.shape[1])
        self.admits[bucket] = self.admits.get(bucket, 0) + 1
        logits, kr, vr = prefill_partial(self.model, tokens_padded, true_len,
                                         window=self.window)
        for pool, rows in ((self.ks, kr), (self.vs, vr)):
            for buf, r in zip(pool, rows):
                if self.window is None:
                    # positions >= true_len hold pad K/V the mask never
                    # exposes
                    buf[slot, :, :bucket] = r[0]
                else:
                    buf[slot] = r[0]
        self.lengths[slot] = true_len
        return logits

    def decode(self, tokens, active):
        """Advance every slot one position; dead slots' lengths freeze and
        their logits are discarded by the caller. tokens (n_slots,) ints,
        active (n_slots,) bool. Returns (n_slots, vocab) logits."""
        self.decode_steps += 1
        logits, _, _ = decode_step_slots(self.model, self.ks, self.vs,
                                         self.lengths, tokens,
                                         window=self.window)
        self.lengths = np.where(np.asarray(active), self.lengths + 1,
                                self.lengths)
        return logits

    def spec_verify(self, tokens):
        """Score every row's k+1 candidates ((n_slots, k+1) ints) in one
        batched forward, without writing the pool. Returns (logits
        (n_slots, k+1, vocab), sk, sv), sk/sv the per-layer f32
        candidate K/V."""
        self.verify_steps += 1
        return spec_verify_slots(self.model, self.ks, self.vs,
                                 self.lengths, tokens)

    def spec_commit(self, sk, sv, commit) -> None:
        """Write each row's accepted prefix (``commit`` (n_slots,) ints,
        0: not speculating) from the verify's K/V and advance the
        lengths by it."""
        _, _, self.lengths = spec_commit_slots(self.ks, self.vs,
                                               self.lengths, sk, sv, commit)

    def release(self, slot: int) -> None:
        """Zero a retired slot's length so the blockwise decode's trip
        count ``max(lengths)`` stops charging for it."""
        self.lengths[slot] = 0
