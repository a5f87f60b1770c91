"""Two profiler yardsticks of the bf16 flash kernels, timed in turns.

    python -m distributed_pytorch_tpu_torch.ops.flash_yardstick

Times the forward, dK/dV and dQ kernels at the FLAGSHIP train shape
(B=8, H=12, S=1024, D=64, bf16, causal) with two ways of reading device
time from torch.profiler, alternated A B B A in every round:

- ``single``: one call, then one profile over ITERS calls (CPU and CUDA
  activities): the kernel events' device time over ITERS;
- ``warmup``: the same ITERS calls profiled under ``schedule(warmup=1,
  active=1)``, the first cycle traced and discarded (one attempt of
  ``chip_smoke.device_ms``).

Each of the three launches one kernel per call, so a reading is whole
when it saw ITERS kernel events; the lines give every reading with its
event count, and medians over the whole ones.

Both are read twice: on a card that has only built and checked the
kernels, and again after LOAD_S seconds of back-to-back launches of all
three. Each stage prints the card's SM clock, power draw and
temperature as nvidia-smi reads them, so a slower reading can be told
from a slower clock. Prints the card's name and power limit first, then
one JSON line per stage and kernel. Needs one CUDA card and ``nvcc``;
exits 2 without a card.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import torch

from . import flash_attention as tflash

SHAPE = (8, 12, 1024, 64)
ITERS = 20
ROUNDS = 4
LOAD_S = 30.0


def _smi(query: str) -> str:
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()


def _kernel_events(prof):
    from torch.autograd import DeviceType
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)]
    return (sum(e.self_device_time_total for e in events),
            sum(e.count for e in events))


def _single(fn):
    """PR 4's ``device_ms``: (ms per call, kernel events seen)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(ITERS):
            fn()
        torch.cuda.synchronize()
    us, seen = _kernel_events(prof)
    return us / ITERS / 1e3, seen


def _profiled(fn):
    from torch.profiler import ProfilerActivity, profile, schedule
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        for _ in range(2):
            fn()
            torch.cuda.synchronize()
            prof.step()
    return _kernel_events(prof)


def _warmup(fn):
    """One attempt of ``chip_smoke.device_ms``: (ms per call, kernel
    events seen)."""
    fn()
    torch.cuda.synchronize()
    us, seen = _profiled(lambda: [fn() for _ in range(ITERS)])
    return us / ITERS / 1e3, seen


def _kernels():
    gen = torch.Generator(device="cuda").manual_seed(1)
    q, k, v, do = (torch.randn(*SHAPE, device="cuda", generator=gen)
                   .bfloat16() for _ in range(4))
    o, lse = tflash.flash_attention_fwd_cuda(q, k, v, causal=True)
    run = tflash.FlashBwdLaunch(q, k, v, o, lse, do, causal=True)
    want = tflash.flash_attention_fwd_reference(q, k, v, causal=True)[0]
    err = ((o.float() - want.float()).norm() / want.float().norm()).item()
    if not err <= 1e-2:
        raise RuntimeError(f"forward disagrees with the plain version: {err}")
    return {"fwd": lambda: tflash.flash_attention_fwd_cuda(q, k, v,
                                                           causal=True),
            "dkv": run.launch_dkv, "dq": run.launch_dq}


def _stage(name: str, kernels, card: str) -> None:
    """Every reading with the kernel events it saw; the medians count
    only the readings that saw all ITERS launches (the profiler can
    lose events, which reads as a time too short)."""
    readings = {k: {"single": [], "warmup": []} for k in kernels}
    for r in range(ROUNDS):
        order = ("single", "warmup") if r % 2 == 0 else ("warmup", "single")
        for yardstick in order:
            for kernel, fn in kernels.items():
                read = _single if yardstick == "single" else _warmup
                readings[kernel][yardstick].append(read(fn))
    state = _smi("clocks.sm,power.draw,temperature.gpu")
    for kernel, got in readings.items():
        whole = {y: sorted(ms for ms, seen in t if seen == ITERS)
                 for y, t in got.items()}
        print(json.dumps(dict(
            stage=name, kernel=kernel, card=card,
            sm_clock_power_temp=state,
            ms={y: [ms for ms, _ in t] for y, t in got.items()},
            events={y: [seen for _, seen in t] for y, t in got.items()},
            median_ms={y: t[len(t) // 2] if t else None
                       for y, t in whole.items()})), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_yardstick: no CUDA device; this runs on the card",
              file=sys.stderr)
        return 2
    card = _smi("name,power.limit")
    print(card, flush=True)
    kernels = _kernels()
    _stage("fresh", kernels, card)
    end = time.monotonic() + LOAD_S
    while time.monotonic() < end:
        for fn in kernels.values():
            for _ in range(50):
                fn()
        torch.cuda.synchronize()
    _stage("after_load", kernels, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
