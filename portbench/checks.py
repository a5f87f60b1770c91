"""The numbers that decide ``correct``: what the timed path produced
against the plain reference.

Training (the first three steps of the object the window then drives,
each number the worst over the data-parallel ranks):

* ``grad_norm_gap``: over leaves, the largest gap between the norm of
  the program's first gradient (read back from its AdamW state after
  step 1: ``mu / (1 - b1)``) and the reference's, over the larger of
  the reference's norm of that leaf and of the median leaf;
* ``change_norm_gap``: the same for each leaf's change after the last
  checked step, leaving out leaves whose reference gradient is under a
  thousandth of the median leaf's (they move by round-off alone).

Each step's loss is read too (:func:`loss_gaps`) but not compared: at
the cells' sizes neither the fp8 control nor any fault reads it at
three (control) or ten (fault) times what sound runs read, so no limit
could hold there, and the later steps' losses swing with the sign of
Adam's first updates on gradients near nought, where bfloat16 and
float32 differ.

Serving: ``served_logit_gap_mean``, the mean over a sample of finished
requests' served greedy tokens of the gap by which each token's float32
reference logit lies below the best one at its position. (The widest
gap reads within 3x of the fp8 control's; the mean separates them, and
one altered token moves it past its limit at the sample's size.)
"""

from __future__ import annotations

import statistics
from typing import Dict, Iterable, Sequence

#: A leaf whose reference gradient norm is under this share of the
#: median leaf's has nought to rounding to follow.
STILL_LEAF = 1e-3


def leaf_gap(program: Dict[str, float], reference: Dict[str, float],
             leaves: Iterable[str]) -> float:
    """Worst leaf's ``|norm - ref| / max(ref, median ref)``."""
    leaves = list(leaves)
    med = statistics.median(reference[n] for n in reference)
    return max(abs(program[n] - reference[n]) / max(reference[n], med)
               for n in leaves)


def moving_leaves(ref_grad_norms: Dict[str, float]) -> list:
    med = statistics.median(ref_grad_norms.values())
    return [n for n, g in ref_grad_norms.items() if g >= STILL_LEAF * med]


def train_numbers(ranks: Sequence[dict], reference: dict
                  ) -> Dict[str, float]:
    """``ranks``: each data-parallel rank's readings (one at world 1):
    ``losses`` (one a step), ``grad_norms`` and ``change_norms`` (by
    leaf name). ``reference``: ``losses`` (per step, one per rank) and
    the same norms. Each number is the worst over the ranks."""
    move = moving_leaves(reference["grad_norms"])
    grad_gap = max(leaf_gap(rank["grad_norms"], reference["grad_norms"],
                            reference["grad_norms"]) for rank in ranks)
    change_gap = max(leaf_gap(rank["change_norms"],
                              reference["change_norms"], move)
                     for rank in ranks)
    return {"grad_norm_gap": grad_gap, "change_norm_gap": change_gap}


def loss_gaps(ranks: Sequence[dict], reference: dict) -> list:
    """Each step's worst ``|loss - ref| / |ref|`` over the ranks: read
    and reported, not compared (see the module's docstring)."""
    return [max(abs(rank["losses"][t] - ref_step[i]) / abs(ref_step[i])
                for i, rank in enumerate(ranks))
            for t, ref_step in enumerate(reference["losses"])]


def serve_numbers(gaps: Sequence[float]) -> Dict[str, float]:
    return {"served_logit_gap_mean": sum(gaps) / len(gaps)}
