"""Speculative decoding for the serving engine.

A draft model proposes ``draft_len`` tokens per engine iteration; the
target scores all k+1 candidate positions in one batched verify that
writes nothing, the longest matching prefix plus the bonus token is
emitted, and only accepted positions are committed: rollback is not
writing, which keeps the greedy stream the target's own and the
quantized pool's quantize-once discipline intact at every ``kv_dtype``.
"""

from .state import SpecConfig, SpecState, accept_greedy

__all__ = ["SpecConfig", "SpecState", "accept_greedy"]
