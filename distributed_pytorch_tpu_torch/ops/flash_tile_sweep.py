"""Tile sweep of the bf16 wgmma + TMA flash kernels on the card.

    python -m distributed_pytorch_tpu_torch.ops.flash_tile_sweep

Builds ``csrc/flash_attention_fwd.cu`` at each (k-tile, ring depth) of
:data:`FWD_VARIANTS` and ``csrc/flash_attention_bwd.cu`` at each dK/dV
ring depth of :data:`DKV_VARIANTS` and each dQ ring depth of
:data:`DQ_VARIANTS` (one ``nvcc`` each, all at once),
holds every build to the plain version on a small ragged causal case,
then times each on the device (torch.profiler kernel events of ITERS
launches, after a warm-up: the wrapper's host time per call does not
count) at the serving prefill shape (B=1, H=12, S=2048, D=64) and the FLAGSHIP
train shape (B=8, H=12, S=1024, D=64), bf16, causal. The variants are
timed in ROUNDS rounds, every other one in reverse order, and each line
reports every round and their median, so a drift of the card's clock
shows as a spread. Prints the card's name and power limit, then one JSON
line per variant. Needs one CUDA card and ``nvcc``; exits 2 without a
card.
"""

from __future__ import annotations

import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

from . import _build
from . import flash_attention as tflash

FWD_VARIANTS = [("DPX_SM90_FWD_BK=64", "DPX_SM90_FWD_STAGES=2"),
                ("DPX_SM90_FWD_BK=64", "DPX_SM90_FWD_STAGES=3"),
                ("DPX_SM90_FWD_BK=128", "DPX_SM90_FWD_STAGES=2"),
                ("DPX_SM90_FWD_BK=128", "DPX_SM90_FWD_STAGES=3")]
DKV_VARIANTS = [("DPX_SM90_DKV_STAGES=2",), ("DPX_SM90_DKV_STAGES=3",)]
DQ_VARIANTS = [("DPX_SM90_DQ_STAGES=2",), ("DPX_SM90_DQ_STAGES=3",)]
SHAPES = {"serve": (1, 12, 2048, 64), "train": (8, 12, 1024, 64)}
ITERS = 50
ROUNDS = 5


def _ms(fn) -> float:
    """Device milliseconds per call: kernel events over ITERS calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(ITERS):
            fn()
        torch.cuda.synchronize()
    total_us = sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA)
    return total_us / ITERS / 1e3


def _rel(got, want) -> float:
    return ((got.float() - want.float()).norm() / want.float().norm()).item()


def _check(kind: str) -> float:
    """The current build against the plain version, B=2, H=4, S=333."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, do = (torch.randn(2, 4, 333, 64, device="cuda", generator=gen)
                   .bfloat16() for _ in range(4))
    if kind == "fwd":
        o, _ = tflash.flash_attention_fwd_cuda(q, k, v, causal=True)
        return _rel(o, tflash.flash_attention_fwd_reference(
            q, k, v, causal=True)[0])
    o, lse = tflash.flash_attention_fwd_reference(q, k, v, causal=True)
    run = tflash.FlashBwdLaunch(q, k, v, o, lse, do, causal=True)
    dq, dk, dv = tflash.flash_attention_bwd_reference(q, k, v, o, lse, do,
                                                      causal=True)
    if kind == "dq":
        run.launch_dq()
        return _rel(run.dq, dq)
    run.launch_dkv()
    return max(_rel(run.dk, dk), _rel(run.dv, dv))


def _time(kind: str, inputs) -> dict:
    out = {}
    for shape, (q, k, v, do) in inputs.items():
        if kind == "fwd":
            out[shape] = _ms(lambda: tflash.flash_attention_fwd_cuda(
                q, k, v, causal=True))
        elif shape == "train":
            o, lse = tflash.flash_attention_fwd_cuda(q, k, v, causal=True)
            run = tflash.FlashBwdLaunch(q, k, v, o, lse, do, causal=True)
            out[shape] = _ms(run.launch_dq if kind == "dq"
                             else run.launch_dkv)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_tile_sweep: no CUDA device; this sweep runs on the card",
              file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    jobs = ([("fwd", tflash.KERNEL_SOURCE, d) for d in FWD_VARIANTS]
            + [("dkv", tflash.BWD_KERNEL_SOURCE, d) for d in DKV_VARIANTS]
            + [("dq", tflash.BWD_KERNEL_SOURCE, d) for d in DQ_VARIANTS])
    with ThreadPoolExecutor(len(jobs)) as pool:
        list(pool.map(lambda job: _build.build(job[1], job[2]), jobs))
    gen = torch.Generator(device="cuda").manual_seed(1)
    inputs = {name: tuple(torch.randn(b, h, s, d, device="cuda",
                                      generator=gen).bfloat16()
                          for _ in range(4))
              for name, (b, h, s, d) in SHAPES.items()}
    defaults = dict(tflash.BUILD_DEFINES)
    rounds = {i: [] for i in range(len(jobs))}
    errs = {}
    try:
        for r in range(ROUNDS):
            order = range(len(jobs)) if r % 2 == 0 else range(len(jobs))[::-1]
            for i in order:
                kind, source, defines = jobs[i]
                tflash.BUILD_DEFINES[source] = defines
                if i not in errs:
                    errs[i] = _check(kind)
                rounds[i].append(_time(kind, inputs))
    finally:
        tflash.BUILD_DEFINES.update(defaults)
    worst = 0.0
    for i, (kind, source, defines) in enumerate(jobs):
        ms = {shape: [r[shape] for r in rounds[i]] for shape in rounds[i][0]}
        median = {shape: sorted(t)[len(t) // 2] for shape, t in ms.items()}
        print(json.dumps(dict(kernel=kind, defines=list(defines),
                              rel_err=errs[i], median_ms=median, ms=ms,
                              card=smi)), flush=True)
        worst = max(worst, errs[i])
    return 0 if worst <= 1e-2 else 1


if __name__ == "__main__":
    sys.exit(main())
