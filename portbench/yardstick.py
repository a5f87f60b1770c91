"""The benchmark's yardstick: peaks, operation and byte counts, the
kernel-name classes and the statistics every metric is computed with.

These are frozen copies, kept under the benchmark's own folder so that
a change to the program cannot move the ruler it is measured with:

* :data:`PEAKS` and :func:`model_flops_per_token` from the port's
  ``perfbench/roofline.py`` (the H100 row only), with
  :func:`forward_flops_at` added for a token at its own context;
* :func:`visible_pairs`, :func:`flash_cost` and :func:`flash_bwd_cost`
  from ``chip_smoke.py``;
* :data:`KERNEL_CLASSES` extends ``chip_smoke.py``'s classifier with the
  optimizer's multi-tensor kernels and NCCL.

Stdlib only: nothing here imports torch or the program.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

#: Dense bf16 tensor-core peak (FLOP/s) and HBM rate (B/s) of the card,
#: matched as a substring of ``torch.cuda.get_device_name()``. NVIDIA's
#: data sheet, H100 SXM, without sparsity, at the full 700 W limit.
PEAKS: Dict[str, Tuple[float, float]] = {"H100": (989e12, 3.35e12)}


def peaks(device_kind: str) -> Tuple[float, float]:
    """``(bf16 FLOP/s, HBM B/s)`` of the card named ``device_kind``."""
    for key, val in PEAKS.items():
        if key in device_kind:
            return val
    raise ValueError(f"no peaks for device {device_kind!r}; the table "
                     f"holds {sorted(PEAKS)}")


def model_flops_per_token(dim: int, n_layers: int, vocab: int, seq: int,
                          mlp_ratio: int = 4, causal: bool = True) -> float:
    """Matmul FLOPs per token of one forward over a sequence of ``seq``:
    per layer qkv (6d^2) + out-proj (2d^2) + MLP (2*2*r*d^2), attention's
    two products 4*S*d (halved when causal), and the vocab projection
    2*d*V. A train step counts 3x (backward = 2x forward); recomputed
    work is not counted."""
    per_layer = (8 + 4 * mlp_ratio) * dim * dim
    attn = 4 * seq * dim * (0.5 if causal else 1.0)
    return n_layers * (per_layer + attn) + 2 * dim * vocab


def forward_flops_at(dim: int, n_layers: int, vocab: int, context: int,
                     mlp_ratio: int = 4) -> float:
    """Matmul FLOPs of one token's forward when it attends over
    ``context`` keys (itself included): what serving spends on a prompt
    token at its position or on a decoded token at its length."""
    per_layer = (8 + 4 * mlp_ratio) * dim * dim + 4 * context * dim
    return n_layers * per_layer + 2 * dim * vocab


def visible_pairs(s_q: int, s_k: int, causal: bool = True) -> int:
    """(query, key) pairs a causal (or full) attention row set sees."""
    if not causal:
        return s_q * s_k
    off = s_k - s_q
    return sum(max(0, min(s_k, r + off + 1)) for r in range(s_q))


def flash_cost(b, h, h_kv, s_q, s_k, d, dtype_bytes, causal=True):
    """(FLOPs, bytes) the forward needs for these inputs: 4*D FLOPs per
    visible (query, key) pair; q/k/v read once, O and lse written once."""
    flops = 4.0 * d * visible_pairs(s_q, s_k, causal) * b * h
    nbytes = (dtype_bytes * d * (b * h * s_q * 2 + b * h_kv * s_k * 2)
              + 4 * b * h * s_q)
    return flops, nbytes


def flash_bwd_cost(b, h, h_kv, s_q, s_k, d, dtype_bytes, causal=True):
    """(FLOPs, bytes) per backward function for these inputs, each input
    read once and each output written once:

    - ``dkv``: q.k^T, p^T.dO, dO.v^T, ds^T.q = 8*D FLOPs per visible pair;
      reads q, dO, k, v, lse, delta; writes dK, dV;
    - ``dq``: q.k^T, dO.v^T, ds.k = 6*D; reads the same; writes dQ;
    - ``both``: the whole backward, 14*D; reads q, k, v, O, dO, lse;
      writes dQ, dK, dV."""
    pairs = visible_pairs(s_q, s_k, causal) * b * h
    qsz = dtype_bytes * d * b * h * s_q        # one (B, H, Sq, D) tensor
    kvsz = dtype_bytes * d * b * h_kv * s_k    # one (B, Hkv, Sk, D) tensor
    row = 4 * b * h * s_q                      # one f32 (B, H, Sq) row term
    return {"dkv": (8.0 * d * pairs, 2 * qsz + 2 * kvsz + 2 * row + 2 * kvsz),
            "dq": (6.0 * d * pairs, 2 * qsz + 2 * kvsz + 2 * row + qsz),
            "both": (14.0 * d * pairs,
                     3 * qsz + 2 * kvsz + row + qsz + 2 * kvsz)}


def bound_s(flops: float, nbytes: float, device_kind: str) -> float:
    """The least time the card could take: the larger of operations over
    the bf16 peak and bytes over the memory rate."""
    peak_flops, peak_bw = peaks(device_kind)
    return max(flops / peak_flops, nbytes / peak_bw)


#: Kernel classes by substrings of the (lower-cased) kernel name, first
#: match wins; anything else is ``other`` (elementwise, norms, softmax,
#: the loss, copies).
KERNEL_CLASSES: Tuple[Tuple[str, Tuple[str, ...]], ...] = (
    ("flash_fwd", ("flash_fwd_kernel",)),
    ("flash_bwd_dkv", ("flash_bwd_dkv_kernel",)),
    ("flash_bwd_dq", ("flash_bwd_dq_kernel",)),
    ("nccl", ("nccl",)),
    ("optimizer", ("multi_tensor_apply",)),
    ("gemm", ("gemm", "nvjet", "xmma", "cutlass", "cublas")),
)


def classify(kernel_name: str) -> str:
    """The class of one device operation by its name."""
    low = kernel_name.lower()
    for cls, keys in KERNEL_CLASSES:
        if any(k in low for k in keys):
            return cls
    return "other"


def percentile(values: Iterable[float], q: float) -> Optional[float]:
    """The nearest-rank ``q``-th percentile over all samples: the
    smallest sample with at least q% of the samples at or below it.
    None for no samples."""
    xs = sorted(values)
    if not xs:
        return None
    rank = max(1, math.ceil(q / 100.0 * len(xs)))
    return xs[rank - 1]


def quartile_spread(values: Sequence[float]) -> float:
    """(Q3 - Q1) / median, the quartiles as
    ``statistics.quantiles(values, n=4)`` gives them."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med


def union_seconds(intervals: Iterable[Tuple[float, float]],
                  lo: float, hi: float) -> float:
    """Length of the union of ``(start, end)`` intervals clipped to
    ``[lo, hi]``, in the intervals' unit."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def idle_gaps(intervals: Iterable[Tuple[float, float]], lo: float,
              hi: float) -> List[Tuple[float, float]]:
    """The stretches of ``[lo, hi]`` that no interval covers, as
    ``(start, end)`` pairs in time order."""
    gaps, t = [], lo
    for s, e in sorted(intervals):
        if s > t:
            gaps.append((t, min(s, hi)))
        t = max(t, e)
        if t >= hi:
            break
    if t < hi:
        gaps.append((t, hi))
    return [(s, e) for s, e in gaps if e > s]
