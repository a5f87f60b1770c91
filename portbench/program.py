"""The program under test, as the drivers reach it: the port's
``TransformerLM`` with the flash attention core, the seed-made weights
loaded into it, and the port's loader feeding the benchmark's rows.

Everything of the port is imported here or in a driver, never in the
reference or the yardstick.
"""

from __future__ import annotations

from importlib import import_module
from typing import Iterator, Tuple

import numpy as np

PORT = "distributed_pytorch_tpu_torch"


def port(module: str):
    """A module of the port by its path under the package (through
    ``import_module``: ``ops.flash_attention`` is also a function name
    on ``ops``)."""
    return import_module(f"{PORT}.{module}")


def check_config(cfg: dict) -> None:
    """The port's ``TransformerLM`` computes GPT-2 exactly when the
    configuration keeps these; refuse one that does not."""
    want = {"activation_function": "gelu_new", "layer_norm_epsilon": 1e-05,
            "tie_word_embeddings": True, "attn_pdrop": 0.0,
            "embd_pdrop": 0.0, "resid_pdrop": 0.0}
    off = {k: cfg.get(k) for k, v in want.items() if cfg.get(k) != v}
    if off:
        raise ValueError(f"configuration departs from what the program "
                         f"runs: {off}")


def build_model(cfg: dict, device, dtype):
    """GPT-2 as the port's ``TransformerLM``: learned positions, tied
    embeddings, the flash core (dense below ``DPX_FLASH_MIN_SEQ`` keys),
    no dropout, no remat."""
    check_config(cfg)
    lm = port("models.transformer")
    flash = port("ops.flash_attention")
    return lm.TransformerLM(
        vocab=cfg["vocab_size"], dim=cfg["n_embd"], n_layers=cfg["n_layer"],
        n_heads=cfg["n_head"], max_seq=cfg["n_positions"], mlp_ratio=4,
        dropout=0.0, pos="learned", tie_embeddings=True,
        attn_fn=flash.make_flash_attn_fn(), remat=False, dtype=dtype,
        device=device)


class Rows:
    """The benchmark's token rows as a map-style dataset: item i is
    (inputs, next-token labels) of row i."""

    def __init__(self, rows: np.ndarray):
        self.rows = rows

    def __getitem__(self, i):
        r = self.rows[i]
        return r[:-1], r[1:]

    def __len__(self):
        return len(self.rows)


def batches(rows: np.ndarray, batch: int, device, rank: int = 0,
            world: int = 1) -> Iterator[Tuple]:
    """Endless device batches through the port's ``data_sampler`` (a
    sampler at world > 1, none at world 1) and loader, unshuffled: batch
    t of rank r holds rows ``r + world * (t * batch + i)`` (see
    ``traffic.rank_rows``). Each is copied to ``device``; past the last
    whole batch the next epoch starts again from the first."""
    loader_mod, sampler_mod = port("data.loader"), port("data.sampler")
    ds = Rows(rows)
    sampler = sampler_mod.data_sampler(ds, world > 1, shuffle=False,
                                       rank=rank, world_size=world)
    loader = loader_mod.DataLoader(ds, batch, sampler=sampler,
                                   drop_last=True)
    epoch = 0
    while True:
        for x, y in loader:
            yield (x.to(device, non_blocking=True),
                   y.to(device, non_blocking=True))
        epoch += 1
        loader.set_epoch(epoch)
