"""The one traffic generator: a mix file's parameters and the run's seed
in, the cell's inputs out.

Sizes come from the mix's fixed ``size_seed``, so every run of a cell
gets the same set of lengths; ``--seed`` only picks their order and the
token ids. The program receives only what this module returns.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

#: ``--seed`` may exceed 63 bits' worth of signed range; fold it once.
SEED_MOD = 2 ** 63


def rng(seed: int) -> np.random.Generator:
    return np.random.default_rng(int(seed) % SEED_MOD)


def train_rows(mix: dict, cfg: dict, seed: int) -> np.ndarray:
    """``(rows, seq + 1)`` token ids: each row is one example's inputs
    and its next-token labels, handed out by :func:`rank_rows`."""
    return rng(seed).integers(0, cfg["vocab_size"],
                              (mix["rows"], mix["seq"] + 1), dtype=np.int64)


def rank_rows(rows: np.ndarray, batch: int, world: int, rank: int,
              step: int) -> np.ndarray:
    """The rows of rank ``rank``'s batch at step ``step`` (from 0): the
    port's unshuffled sampler gives rank r every ``world``-th row from
    r."""
    idx = rank + world * (step * batch + np.arange(batch))
    return rows[idx]


def _lognormal_lengths(g: np.random.Generator, n: int, spec: dict):
    raw = g.lognormal(np.log(spec["median"]), spec["sigma"], n)
    return np.clip(np.rint(raw), spec["min"], spec["max"]).astype(np.int64)


def serve_sizes(mix: dict) -> Tuple[np.ndarray, np.ndarray]:
    """(prompt lengths, output lengths) of the mix's ``size_set``
    requests, the same for every seed; an output is cut so that prompt +
    output fits ``max_total``."""
    g = np.random.default_rng(mix["size_seed"])
    n = mix["size_set"]
    prompts = _lognormal_lengths(g, n, mix["prompt"])
    outs = _lognormal_lengths(g, n, mix["output"])
    outs = np.minimum(outs, mix["max_total"] - prompts)
    return prompts, outs


def serve_requests(mix: dict, cfg: dict, seed: int
                   ) -> List[Tuple[np.ndarray, int]]:
    """``requests`` requests, ``(prompt ids, tokens to generate)``: the
    size set in one order drawn from the seed, repeated, so that every
    seed's window serves nearly the same sizes. Each prompt is a fresh
    draw, so no two share a prefix beyond chance."""
    prompts, outs = serve_sizes(mix)
    g = rng(seed)
    order = g.permutation(len(prompts))
    return [(g.integers(0, cfg["vocab_size"], int(prompts[i]),
                        dtype=np.int64).astype(np.int32), int(outs[i]))
            for k in range(mix["requests"])
            for i in [order[k % len(order)]]]


def warm_requests(mix: dict, cfg: dict, seed: int
                  ) -> List[Tuple[np.ndarray, int]]:
    """One short request per prompt length the mix warms: a length in
    each prefill bucket its prompts reach."""
    g = rng(seed + 1)
    return [(g.integers(0, cfg["vocab_size"], n, dtype=np.int64
                        ).astype(np.int32), mix["warm_output"])
            for n in mix["warm_prompts"]]
