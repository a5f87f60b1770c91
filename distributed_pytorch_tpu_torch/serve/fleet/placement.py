"""Fleet placement: the prefix-affinity key, the rendezvous hash and
the spill order.

The port's copy of ``distributed_pytorch_tpu/serve/fleet/placement.py``,
the same function of the same inputs. The radix prefix index interns
prompt prefixes one full ``page_len`` chunk at a time
(``serve/pages/prefix.py``); the fleet uses that chunking as its
placement signal: two prompts that would share resident prefix pages
inside a replica hash to the same home replica, so a shared system
prompt lands where its pages already live.

Replica choice is highest-random-weight (rendezvous) hashing: every
(key, replica) pair gets an independent deterministic weight and the key
homes on the largest. Adding or draining one replica re-homes only the
keys that homed (or now home) there; every other key keeps its replica
and its warm prefix pages.

Stdlib and numpy only, no engine imports.
"""

from __future__ import annotations

import hashlib
from typing import Dict, Iterable, Optional, Sequence, Tuple

import numpy as np


def prefix_key(prompt, page_len: int) -> bytes:
    """The placement key of a prompt: the bytes of its first full
    ``page_len`` token chunk — the first radix-trie edge the prefix
    index would intern. Prompts shorter than one full page have no
    internable chunk; they key on their whole token string (routing
    must still be deterministic, there is just no page affinity to
    exploit)."""
    toks = np.asarray(prompt, np.int32).reshape(-1)
    if page_len > 0 and toks.shape[0] >= page_len:
        return toks[:page_len].tobytes()
    return toks.tobytes()


def _weight(key: bytes, rid: int) -> bytes:
    return hashlib.blake2b(key + b"|" + str(int(rid)).encode(),
                           digest_size=8).digest()


def rendezvous(key: bytes, replicas: Sequence[int]) -> int:
    """Home replica of ``key`` over the CURRENT admitting set:
    highest-random-weight hash (max over per-replica digests).
    Deterministic in (key, set); minimal disruption under membership
    change."""
    if not replicas:
        raise ValueError("rendezvous over an empty replica set")
    best_rid, best_w = None, b""
    for rid in replicas:
        w = _weight(key, rid)
        if best_rid is None or w > best_w or (w == best_w
                                              and rid < best_rid):
            best_rid, best_w = int(rid), w
    return best_rid


def least_loaded(loads: Dict[int, Tuple[float, float]],
                 exclude: Iterable[int] = ()) -> Optional[int]:
    """Spill target: the replica with the smallest (queue_depth,
    occupancy) — queue depth first because it is the direct
    back-pressure signal the spill exists to relieve; occupancy breaks
    ties; the id makes the choice total and deterministic. ``None``
    when no candidate remains (the fleet-exhausted case)."""
    skip = set(exclude)
    cands = [(q, occ, rid) for rid, (q, occ) in loads.items()
             if rid not in skip]
    if not cands:
        return None
    return min(cands)[2]


def spill_order(key: bytes, home: int,
                loads: Dict[int, Tuple[float, float]],
                spill_queue: int) -> Sequence[int]:
    """The candidate sequence a request tries, in order. Home first —
    unless its queue depth has already reached ``spill_queue`` AND a
    strictly less-loaded replica exists (proactive spill: don't queue
    behind known back-pressure). Every other admitting replica follows,
    least-loaded first, so reactive spill on ``queue_full`` /
    ``no_free_pages`` walks the fleet before giving up typed."""
    rest = sorted((q, occ, rid) for rid, (q, occ) in loads.items()
                  if rid != home)
    order = [home] + [rid for _, _, rid in rest]
    if (home in loads and rest and loads[home][0] >= spill_queue
            and rest[0][0] < loads[home][0]):
        order = [rest[0][2], home] + [rid for _, _, rid in rest[1:]]
    return order
