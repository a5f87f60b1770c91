"""Draft-model state of speculative decoding (``serve/spec/``).

Counterpart of ``distributed_pytorch_tpu/serve/spec/state.py``. The
draft model keeps its KV in its own contiguous :class:`~..cache.SlotPool`,
slot for slot aligned with the target engine's pool: every exit of a
target slot (retirement, typed failure, crash drain) releases the draft
slot through the same path. The invariant the subsystem rests on is

    draft cache length == target cache length, holding the same
    accepted token stream

and it holds by construction: propose runs the draft ``k + 1`` greedy
steps past the shared current token (the extra step writes the key of
the last draft, so a fully accepted iteration leaves the draft cache
complete), and after the target commits ``e`` positions the draft rolls
back to ``length + e`` by rewriting its lengths from the host mirror;
the rejected suffix becomes unreachable under the position mask.

Proposals are argmax and draw no noise, so a request's sampling stream
never depends on the draft: only the speed does.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..cache import SlotPool


@dataclass
class SpecConfig:
    """The draft model and ``draft_len``, the tokens it proposes per
    iteration (k; the verify scores k + 1 positions)."""

    draft_model: Any
    draft_len: int = 4


class SpecState:
    """Owns the draft slot pool and the host-side draft bookkeeping."""

    def __init__(self, cfg: SpecConfig, n_slots: int, max_len: int):
        if cfg.draft_len < 1:
            raise ValueError(
                f"draft_len must be >= 1, got {cfg.draft_len}")
        self.cfg = cfg
        self.pool = SlotPool(cfg.draft_model, n_slots, max_len)
        # the draft's truth: propose advances the pool's lengths k + 1
        # steps past the accepted stream, rollback rewrites them from
        # this mirror
        self.len = np.zeros((n_slots,), np.int64)
        #: slot is speculating (draft prefilled and aligned)
        self.active = np.zeros((n_slots,), bool)

    # -- lifecycle ---------------------------------------------------------

    def admit(self, prompt: np.ndarray, slot: int,
              buckets: Sequence[int]) -> bool:
        """Prefill the whole prompt into the draft slot (its logits are
        discarded: the target's admission token starts the stream).
        Returns False, and the request runs non-speculatively, when no
        bucket fits the whole prompt (the paged target needs a bucket
        for its tail only; the draft shares no prefix)."""
        s = int(prompt.shape[0])
        bucket = next((b for b in buckets if b >= s), None)
        if bucket is None or s + 1 > self.pool.max_len:
            return False
        dev = self.cfg.draft_model.device
        padded = torch.zeros((1, bucket), dtype=torch.long, device=dev)
        padded[0, :s] = torch.from_numpy(np.asarray(prompt, np.int64))
        self.pool.admit(padded, s, slot)
        self.len[slot] = s
        self.active[slot] = True
        return True

    def release(self, slot: int) -> None:
        """Every exit of a target slot funnels here."""
        self.active[slot] = False
        self.len[slot] = 0
        self.pool.release(slot)

    # -- the propose / rollback pair ---------------------------------------

    def propose(self, slots: Sequence[int],
                cur_tokens: np.ndarray) -> np.ndarray:
        """k + 1 sequential greedy draft steps for the speculating
        ``slots`` (the others inactive), from each slot's current token.
        Returns the proposals (len(slots), k) int64; the (k+1)-th step
        emits nothing, it writes the last proposal's key so a fully
        accepted iteration (e = k + 1) leaves the draft cache covering
        every committed position."""
        k = self.cfg.draft_len
        n = self.pool.n_slots
        sl = np.asarray(slots)
        active = np.zeros((n,), bool)
        active[sl] = True
        toks = np.zeros((n,), np.int64)
        toks[sl] = cur_tokens
        dev = self.cfg.draft_model.device
        drafts = np.zeros((len(slots), k), np.int64)
        for j in range(k + 1):
            logits = self.pool.decode(torch.from_numpy(toks).to(dev), active)
            if j < k:
                nxt = torch.argmax(logits, dim=-1).cpu().numpy()
                drafts[:, j] = nxt[sl]
                toks[sl] = drafts[:, j]
        return drafts

    def rollback(self, slots: Sequence[int], commits: np.ndarray) -> None:
        """After the target committed: each slot's draft length becomes
        its pre-propose length + accepted count, dropping the rejected
        suffix (and propose's provisional advances) in one rewrite."""
        if len(slots):
            self.len[np.asarray(slots)] += np.asarray(commits, np.int64)
        self.pool.lengths = self.len.copy()


def accept_greedy(drafts: np.ndarray, logits: np.ndarray,
                  remaining: int,
                  eos: Optional[int]) -> Tuple[List[int], int]:
    """The greedy acceptance rule, host-side and pure.

    ``drafts`` (k,) are the draft's proposals d_1..d_k; ``logits``
    (k+1, vocab) the target's verify scores at positions len..len+k
    (position j scored after reading [cur, d_1..d_j]). With g = argmax
    per position, the longest accepted prefix is the largest m with
    d_j == g[j-1] for all j <= m, and the emitted stream is g[0..m]: m
    accepted drafts plus the bonus token the verify computed for free.
    Every emitted token is the target's own argmax given the tokens
    before it, so the stream is ``generate()``'s greedy stream; the
    draft only decides how many tokens an iteration yields.

    ``remaining`` (the max_new budget) and ``eos`` truncate the
    emission; both retire the request at once, so the cache never
    continues from a truncated commit. Returns ``(tokens, e)`` with
    ``e == len(tokens) >= 1``."""
    k = int(drafts.shape[0])
    g = np.argmax(logits, axis=-1).astype(np.int32)
    m = 0
    while m < k and int(drafts[m]) == int(g[m]):
        m += 1
    e = min(m + 1, int(remaining))
    out = [int(t) for t in g[:e]]
    if eos is not None:
        for j, t in enumerate(out):
            if t == eos:
                out = out[:j + 1]
                break
    return out, len(out)
