#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (``distributed_pytorch_tpu_torch``).

    python3 chip_smoke.py

Needs one CUDA card and the CUDA toolkit (``nvcc``); imports nothing of
JAX or the JAX package. Phases, one JSON line each; any failure exits
non-zero at once:

1. device   — card name and power limit, TF32 off for the reference math;
2. build    — compiles every kernel source of the serving and training
              paths from ``csrc/`` (one nvcc per source, all at once),
              then reads each kernel's registers and spills from ptxas
              and its HGMMA (wgmma) and UTMALDG (TMA load) instruction
              counts from ``cuobjdump --dump-sass``; the bf16 forward,
              dK/dV and dQ kernels must show both and spill nothing;
3. kernel   — the flash forward kernel against its plain PyTorch version
              on the card, bf16 (|diff| <= 2e-2) and f32 (|diff| <= 1e-4),
              with NaN rows identical, over the masking cases and the
              training shape (B=8, S=1024, q/k/v strided views of a fused
              projection, as the model passes them); then its time at the
              serving prefill shape beside its bound, the plain version's
              and SDPA's;
4. bwd_kernel — the dK/dV and dQ kernels against the plain backward
              over the same cases (dO a strided view at the training
              shape) plus an lse cotangent and B > 1 with GQA, f32
              (|diff| <= 1e-4 * max(1, max|ref|)) and bf16 (every 64-row
              tile's ||diff|| / ||ref|| <= 1e-2), gradients finite where
              rows are NaN; then their times (and the forward's) at the
              flagship training shape beside their bounds, the plain
              version's and SDPA's (a yardstick only). Kernel and SDPA
              times (``ms``) are device time per launch from the
              profiler's kernel events; ``call_ms`` is CUDA events around
              back-to-back calls, which the host's time per call (the
              Python wrapper, descriptor encoding) bounds from below;
5. model    — a flagship-width model's prefill logits on the card (f32,
              flash kernel) against the same weights on the CPU (plain
              path), |diff| <= 2e-3;
6. serve    — the flagship-width TransformerLM (vocab 32000, dim 768,
              12 layers, 12 heads, learned positions, max_seq 2048, bf16,
              random weights from a seed) behind ``InferenceEngine``:
              6 requests over prompt lengths 100-1900, half greedy, half
              temperature 0.8 / top-k 50; every request must finish, the
              flash kernel must have launched 12 times per admit whose
              bucket reaches DPX_FLASH_MIN_SEQ, and a greedy stream must
              equal standalone ``generate()``;
7. breakdown — one admit prefill per bucket and one 4-slot decode step,
              host time and the device-busy share from torch.profiler;
8. train_check — one ``make_train_step`` step of a 2-layer flagship-width
              f32 model on the card (kernels) against the same weights on
              the CPU (plain path): loss, every gradient, the params after
              one adamw step;
9. train    — the FLAGSHIP train step (vocab 32000, dim 768, 12 layers,
              12 heads, learned positions, seq 1024, batch 8, bf16,
              adamw(3e-4), plain cross-entropy, random weights from a
              seed) on one fixed token batch: 2 warm-up and 10 timed
              steps, step time, tokens/s and MFU, 12/12/12 kernel launches
              per step, falling losses within 2% per step of dense
              attention, and ``remat="full"`` (24 forward launches per
              step, the same first loss);
10. train_breakdown — one step's device time by kernel class and its
              device-idle share;
11. ddp_api — ``launch`` on the card must run the worker at world >= 1
              (world 0 is the CPU branch: a failure here); rank 0 on
              cuda:0 sees every collective of the helper API as the
              front-door oracle says (the world-1 identities), on CUDA
              tensors, and ``prepare_ddp_model`` returns the model;
12. ddp_min — the reference workload (``examples/min_ddp.py``) at
              default flags on cuda:0, TF32 off: its 8 reduced losses
              equal the same run on the CPU within rtol 1e-5;
13. ddp_world2_cpu — the same workload in two CPU rank processes over
              gloo (per-rank batch 4): the reduced loss (a SUM) over 2
              equals the unshuffled world-1 run within rtol 2e-4 (one
              card, and NCCL runs no two ranks on one device);
14. ddp_train — the FLAGSHIP train config through the helper API
              (``examples/ddp_lm.py``: SyntheticLM, data_sampler,
              DataLoader, prepare_ddp_model, make_train_step, and per
              step wait_for_everyone, reduce, gather): 2 warm-up and 10
              timed steps, 12/12/12 launches per step, finite falling
              losses, step ms, tokens/s and MFU beside the ``train``
              phase's step ms and the difference; then 3 steps of
              ``mixed_precision="bf16"`` from float32 masters (finite
              losses, 12/12/12 launches, masters still float32);
15. resnet_check — ``ResNet18(small_input=True)`` at full width, f32, one
              training forward and backward of 64 CIFAR-shaped images on
              cuda:0 (cuDNN, TF32 off) against the same weights on the
              CPU: logits, every gradient (norm-relative: this model's
              float32 gradients carry up to ~1e-2 of rounding on either
              side) and the new BatchNorm state;
16. resnet_train — ``examples/train_resnet.py`` at world 1 on cuda:0 at
              its defaults (batch 64, 2048 synthetic images, 2 epochs,
              SGD momentum) with ``--eval --ema 0.999``, then a window of
              20 steps at batch 512: step ms, images/s, final loss, eval
              accuracy (raw and EMA weights), peak memory, and one
              step's device busy / idle share; then 3 ``--bf16`` steps
              (finite losses, float32 running stats);
17. lm_stack_check — ``fused_linear_cross_entropy`` at the FLAGSHIP loss
              shape (8192 rows, d 768, vocab 32000), bf16 and f32, against
              the plain cross-entropy of the float32 logits of the same
              inputs: value and both gradients, with the plain bf16
              loss's errors and both losses' device time and peak memory;
18. lm_stack — FLAGSHIP through ``make_train_step`` with the fused loss
              and ``with_clipping(with_schedule(adamw, warmup_cosine(3e-4,
              2, 12)), 1.0)``: 2 warm-up and 10 timed steps, step ms, peak
              memory and 12/12/12 launches per step, beside the same run
              with the plain loss and ``adamw(3e-4)`` and the ``train``
              phase's step ms; then 3 steps each of ``adafactor`` and
              ``adamw_8bit`` (finite losses, optimizer state bytes).

Then the ``kernels`` line (each kernel's design, ``wgmma+tma`` or
``scalar_fma``, as its bf16 path runs it; the forward at both shapes),
the nvidia-smi line and, last, the result line
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

JAX_FLASH = "distributed_pytorch_tpu/ops/flash_attention.py"
CSRC = "distributed_pytorch_tpu_torch/csrc/"
# kernel -> (source in the repo, the TPU kernel it replaces)
KERNELS = {
    "flash_attention_fwd": (CSRC + "flash_attention_fwd.cu",
                            JAX_FLASH + ":166"),
    "flash_attention_bwd_dkv": (CSRC + "flash_attention_bwd.cu",
                                JAX_FLASH + ":326"),
    "flash_attention_bwd_dq": (CSRC + "flash_attention_bwd.cu",
                               JAX_FLASH + ":371"),
}
# dense bf16 tensor-core peak (FLOP/s) and HBM rate (B/s) by card name,
# from NVIDIA's data sheets; the SXM part is the default
PEAKS = {"H100 PCIe": (756e12, 2.0e12), "H100 NVL": (835e12, 3.9e12),
         "H200": (989e12, 4.8e12), "H100": (989e12, 3.35e12)}
TOL = {"bfloat16": 2e-2, "float32": 1e-4}
# backward, bf16: ||got - ref|| / ||ref|| of every 64-row tile (see
# tile_rel_err); f32 keeps TOL scaled by max(1, max|ref|)
BWD_TILE_TOL = 1e-2
FLAGSHIP = dict(vocab=32000, dim=768, n_layers=12, n_heads=12,
                max_seq=2048, pos="learned")
# benchmarks/mfu_transformer.py:72 FLAGSHIP: the serving width at seq 1024
TRAIN = dict(FLAGSHIP, max_seq=1024)
TRAIN_BATCH, TRAIN_SEQ, TRAIN_LR = 8, 1024, 3e-4
WARM_STEPS, TIMED_STEPS, DENSE_STEPS, REMAT_STEPS = 2, 10, 5, 2
PROMPT_LENS = (100, 300, 700, 1024, 1500, 1900)
# the FLAGSHIP train step's attention, with q/k/v and dO laid out as the
# model hands them over (see draw_inputs); checked in both directions
TRAIN_CASE = ("train_b8_qkv_views", TRAIN_BATCH, 12, 12, TRAIN_SEQ,
              TRAIN_SEQ, 64, dict(causal=True))
# (name, b, h, h_kv, s_q, s_k, d, kwargs): the masking cases of both the
# forward and the backward checks
MASK_CASES = [
    ("flagship", 1, 12, 12, 2048, 2048, 64, dict(causal=True)),
    ("ragged_s1000", 1, 12, 12, 1000, 1000, 64, dict(causal=True)),
    ("gqa_h12_hkv4", 1, 12, 4, 1024, 1024, 64, dict(causal=True)),
    ("d128", 1, 8, 8, 1024, 1024, 128, dict(causal=True)),
    ("sq256_sk1024", 1, 12, 12, 256, 1024, 64, dict(causal=True)),
    ("sq_gt_sk_nan_rows", 1, 12, 12, 512, 256, 64, dict(causal=True)),
    ("window256", 1, 12, 12, 2048, 2048, 64, dict(causal=True,
                                                  window=256)),
    ("causal_offset1", 1, 12, 12, 1024, 1024, 64,
     dict(causal=True, causal_offset=1)),
    ("diag_offset512", 1, 12, 12, 1024, 1024, 64,
     dict(causal=True, diag_offset=512)),
]
GREEDY = (0, 3, 4)            # indices of the greedy requests
COMPARE = 3                   # the greedy request held to generate()
MAX_NEW = 32


# kernel -> its bf16 __global__ function, which must run on the tensor
# cores from TMA-fed tiles (every kernel whose bf16 design is wgmma+tma)
SM90_KERNELS = {"flash_attention_fwd": "flash_fwd_kernel_sm90",
                "flash_attention_bwd_dkv": "flash_bwd_dkv_kernel_sm90",
                "flash_attention_bwd_dq": "flash_bwd_dq_kernel_sm90"}
SASS_OPS = ("HGMMA", "UTMALDG")


def emit(**rec):
    print(json.dumps(rec), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def kernel_label(mangled: str) -> str:
    """``flash_fwd_kernel_sm90<bf16,64>`` from a mangled kernel name."""
    m = re.search(r"(?<=\d)(flash_[a-z0-9_]*?kernel(?:_sm90)?)"
                  r"I(f|13__nv_bfloat16)?Li(\d+)E", mangled)
    if not m:
        return mangled
    dtype = {"f": "f32", "13__nv_bfloat16": "bf16", None: "bf16"}[m.group(2)]
    return f"{m.group(1)}<{dtype},{m.group(3)}>"


def ptxas_by_kernel(report: str) -> dict:
    """{kernel: {registers, spill_stores, spill_loads, advice}} from
    nvcc's ``-Xptxas -v`` report; ``advice`` lists ptxas's performance
    advisories for the kernel (e.g. C7515: wgmma products serialized)."""
    out, cur = {}, None
    for line in report.splitlines():
        adv = re.search(r"\((C75\d\d)\)[^']*function '(\w+)'", line)
        if adv:
            rec = out.setdefault(kernel_label(adv.group(2)), {})
            rec.setdefault("advice", []).append(adv.group(1))
            continue
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(\w+)'?", line)
        if m:
            cur = kernel_label(m.group(1))
            out.setdefault(cur, {})
        elif cur and "spill stores" in line:
            n = re.findall(r"(\d+) bytes spill (stores|loads)", line)
            out[cur].update({f"spill_{k}": int(v) for v, k in n})
        elif cur and "Used" in line and "registers" in line:
            out[cur]["registers"] = int(re.search(r"Used (\d+) registers",
                                                  line).group(1))
    return out


def sass_counts(lib: str) -> dict:
    """{kernel: {HGMMA: n, UTMALDG: n}} from ``cuobjdump --dump-sass``."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    proc = subprocess.run([tool, "--dump-sass", lib], capture_output=True,
                          text=True, timeout=300)
    if proc.returncode != 0:
        fail(f"cuobjdump failed on {lib}: {proc.stderr.strip()[:500]}")
    out, cur = {}, None
    for line in proc.stdout.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = kernel_label(m.group(1))
            out[cur] = {op: 0 for op in SASS_OPS}
        elif cur:
            for op in SASS_OPS:
                if re.search(rf"\b{op}\b", line):
                    out[cur][op] += 1
    return out


def phase_build(_build, tflash):
    """Build both sources in parallel; report and check each kernel's
    registers, spills and HGMMA / UTMALDG counts. A library left by an
    earlier run is built again, so ptxas reports on every kernel."""
    t0 = time.perf_counter()
    sources = (tflash.KERNEL_SOURCE, tflash.BWD_KERNEL_SOURCE)
    for src in sources:
        _build.library_path(src).unlink(missing_ok=True)
    with ThreadPoolExecutor(len(sources)) as pool:
        reports = list(pool.map(_build.build, sources))
    for src in sources:
        _build.load(src)
    build_s = time.perf_counter() - t0
    kernels = {}
    for src, report in zip(sources, reports):
        sass = sass_counts(str(_build.library_path(src)))
        for name, regs in ptxas_by_kernel(report).items():
            kernels[name] = dict(source=src, **regs, **sass.get(name, {}))
    emit(phase="build", sources=sorted({v[0] for v in KERNELS.values()}),
         build_s=build_s, kernels=kernels)
    for base in SM90_KERNELS.values():
        found = [k for k in kernels if k.startswith(base + "<")]
        if not found:
            fail(f"build: no {base} in the ptxas report")
        for name in found:
            rec = kernels[name]
            if any(rec.get(op, 0) == 0 for op in SASS_OPS):
                fail(f"build: {name} has no HGMMA or no UTMALDG: {rec}")
            if rec.get("spill_stores", 0) or rec.get("spill_loads", 0):
                fail(f"build: {name} spills: {rec}")
    return kernels


def peaks(name: str):
    for key, val in PEAKS.items():
        if key in name:
            return val
    return PEAKS["H100"]


def cuda_ms(fn, iters: int) -> float:
    """Mean milliseconds per call over ``iters`` calls, CUDA events."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(torch, fn, iters: int = 20) -> float:
    """Device milliseconds per call of ``fn``: the kernel events of
    ``iters`` calls (torch.profiler) over ``iters``. Unlike cuda_ms this
    is not bounded below by the host's time to issue one call, which for
    a ~50 us kernel behind a Python wrapper can be the larger.

    The profiler can lose kernel events, which reads as a time too
    short: every kernel must show a whole multiple of ``iters`` events
    (its launches per call, ``iters`` times). On a shortfall it is
    measured once more, then it fails. (A separate profile of one call
    cannot give the count: it loses its only event at times.)"""
    fn()
    torch.cuda.synchronize()
    for attempt in range(2):
        times, counts, _ = kernel_times_us(
            torch, lambda: [fn() for _ in range(iters)])
        if counts and all(n % iters == 0 for n in counts.values()):
            total = sum(times.values())
            if not total > 0:
                fail("the profiler reported no device time")
            return total / iters / 1e3
        print(f"chip_smoke: device_ms saw {counts} kernel events for "
              f"{iters} calls (attempt {attempt + 1})",
              file=sys.stderr, flush=True)
    fail(f"device_ms: the profiler saw {counts} kernel events, not a "
         f"multiple of {iters} calls each")


def visible_pairs(s_q, s_k, causal=True):
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


def bound(torch, flops, nbytes):
    """(bound_ms, bound_by): the larger of FLOPs over the bf16 dense peak
    and bytes over the memory rate of this card."""
    peak_flops, peak_bw = peaks(torch.cuda.get_device_name(0))
    t_ops, t_bytes = flops / peak_flops * 1e3, nbytes / peak_bw * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def draw_inputs(rng, name, b, h, h_kv, s_q, s_k, d, with_do):
    """Seeded float32 draws of q, k, v (and dO). The TRAIN_CASE draws
    them as the model makes them: one fused qkv projection output
    (B, S, (H + 2 Hkv) D) and the out-projection's input gradient
    (B, S, H, D); every other case draws contiguous (B, heads, S, D)."""
    if name == TRAIN_CASE[0]:
        shapes = [(b, s_q, (h + 2 * h_kv) * d)] + [(b, s_q, h, d)] * with_do
    else:
        shapes = ([(b, h, s_q, d)] + [(b, h_kv, s_k, d)] * 2
                  + [(b, h, s_q, d)] * with_do)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def on_card(torch, base, dtype, device, h, h_kv, d):
    """q, k, v (and dO) of draw_inputs' arrays in ``dtype`` on the card.
    From a fused projection, q/k/v are its (B, heads, S, D) views, split
    and head-transposed as ``nn/attention.py`` does it, and dO is the
    same view of its (B, S, H, D) gradient, as autograd hands dO to the
    backward: none of them contiguous."""
    ts = [torch.from_numpy(x).to(device, dtype) for x in base]
    if ts[0].dim() == 4:
        return ts
    b, s = ts[0].shape[:2]
    qkv = [t.reshape(b, s, -1, d).transpose(1, 2) for t in torch.split(
        ts[0], [h * d, h_kv * d, h_kv * d], dim=-1)]
    out = qkv + [t.transpose(1, 2) for t in ts[1:]]
    if any(t.is_contiguous() for t in out):
        fail("the train case's q/k/v/dO views came out contiguous")
    return out


def phase_kernel(torch, tflash, device):
    rng = np.random.default_rng(0)
    worst = {}
    for name, b, h, h_kv, s_q, s_k, d, kw in MASK_CASES + [TRAIN_CASE]:
        base = draw_inputs(rng, name, b, h, h_kv, s_q, s_k, d, False)
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = on_card(torch, base, dtype, device, h, h_kv, d)
            o, lse = tflash.flash_attention_fwd_cuda(q, k, v, **kw)
            o_ref, lse_ref = tflash.flash_attention_fwd_reference(
                q, k, v, **kw)
            torch.cuda.synchronize()
            nan, nan_ref = torch.isnan(o), torch.isnan(o_ref)
            if not torch.equal(nan, nan_ref):
                fail(f"kernel {name} {dtype}: NaN rows differ")
            err_o = (o.float() - o_ref.float()).masked_fill(nan, 0).abs()
            err = max(err_o.max().item(),
                      (lse - lse_ref).abs().max().item())
            tname = str(dtype).split(".")[-1]
            emit(phase="kernel_check", case=name, dtype=tname,
                 shape=[b, h, h_kv, s_q, s_k, d], q_stride=list(q.stride()),
                 nan_rows=int(nan[..., 0].sum().item()), max_abs_err=err,
                 tol=TOL[tname], **kw)
            if not err <= TOL[tname]:
                fail(f"kernel {name} {tname}: |diff| {err} > {TOL[tname]}")
            worst[tname] = max(worst.get(tname, 0.0), err)

    # time at the flagship prefill shape the serving path gives it
    b, h, s, d = 1, 12, 2048, 64
    q, k, v = (torch.randn(b, h, s, d, device=device, dtype=torch.bfloat16)
               for _ in range(3))
    # ms / library_ms: device time per launch (profiler kernel events);
    # call_ms / library_call_ms: CUDA events around back-to-back calls,
    # which the host's time per call bounds from below
    def kern():
        tflash.flash_attention_fwd_cuda(q, k, v, causal=True)

    def sdpa():
        torch.nn.functional.scaled_dot_product_attention(q, k, v,
                                                         is_causal=True)
    ms, call_ms = device_ms(torch, kern), cuda_ms(kern, 20)
    library_ms, library_call_ms = device_ms(torch, sdpa), cuda_ms(sdpa, 20)
    plain_ms = cuda_ms(lambda: tflash.flash_attention_fwd_reference(
        q, k, v, causal=True), 3)
    flops, nbytes = flash_cost(b, h, h, s, s, d, 2)
    bound_ms, bound_by = bound(torch, flops, nbytes)
    timing = dict(ms=ms, call_ms=call_ms, plain_ms=plain_ms,
                  library_ms=library_ms, library_call_ms=library_call_ms,
                  bound_ms=bound_ms, bound_by=bound_by,
                  flops=flops, bytes=nbytes,
                  shape=[b, h, h, s, s, d], dtype="bfloat16",
                  tflops_per_s=flops / ms / 1e9)
    emit(phase="kernel_time", **timing)
    return worst, timing


def tile_rel_err(torch, got, ref, block=64) -> float:
    """Largest ||got - ref|| / ||ref|| over the 64-row sequence tiles of
    every (batch, head) of a (B, heads, S, D) gradient. A zeroed or
    garbled tile, row or key then counts against its own size, not
    against the tensor's largest element; a tile whose reference is
    exactly zero (rows or keys that nothing sees) must come out zero."""
    diff, ref = got.float() - ref.float(), ref.float()
    pad = (-ref.shape[2]) % block
    if pad:
        diff, ref = (torch.nn.functional.pad(t, (0, 0, 0, pad))
                     for t in (diff, ref))
    b, n, _, d = ref.shape
    dn, rn = (t.reshape(b, n, -1, block * d).norm(dim=-1)
              for t in (diff, ref))
    ratio = torch.nan_to_num(dn / rn, nan=0.0, posinf=float("inf"))
    return ratio.max().item()


def phase_bwd_kernel(torch, tflash, device):
    """The dK/dV and dQ kernels against the plain backward on the card,
    then their times at the flagship training shape.

    Limits: f32 |diff| <= 1e-4 * max(1, max|ref|) (the same f32 math in
    another summation order); bf16 ``tile_rel_err`` <= BWD_TILE_TOL (p
    and ds are rounded to bf16 before their products on both sides, so
    one rounding can differ, and each gradient is rounded to bf16 once:
    a few 1e-3 of each tile's norm)."""
    cases = [(name, b, h, h_kv, s_q, s_k, d, kw, False)
             for name, b, h, h_kv, s_q, s_k, d, kw in MASK_CASES]
    cases += [("g_lse", 1, 12, 12, 1024, 1024, 64, dict(causal=True), True),
              ("b2_gqa_h12_hkv4", 2, 12, 4, 1024, 1024, 64,
               dict(causal=True), False), TRAIN_CASE + (False,)]
    rng = np.random.default_rng(4)
    worst = {}
    for name, b, h, h_kv, s_q, s_k, d, kw, with_lse in cases:
        base = draw_inputs(rng, name, b, h, h_kv, s_q, s_k, d, True)
        g_base = rng.standard_normal((b, h, s_q)).astype(np.float32)
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v, do = on_card(torch, base, dtype, device, h, h_kv, d)
            o, lse = tflash.flash_attention_fwd_reference(q, k, v, **kw)
            # rows with no visible key (NaN O) get zero cotangents, as a
            # caller weighting them to zero gives them
            nan_rows = torch.isnan(o).any(dim=-1)
            if bool(nan_rows.any()):
                do = do.masked_fill(nan_rows[..., None], 0)
            g_lse = (torch.from_numpy(g_base).to(device).masked_fill(
                nan_rows, 0) if with_lse else None)
            got = tflash.flash_attention_bwd_cuda(q, k, v, o, lse, do, g_lse,
                                                  **kw)
            want = tflash.flash_attention_bwd_reference(q, k, v, o, lse, do,
                                                        g_lse, **kw)
            torch.cuda.synchronize()
            tname = str(dtype).split(".")[-1]
            errs, tiles, tols = {}, {}, {}
            for label, g, w in zip(("dq", "dk", "dv"), got, want):
                if not bool(torch.isfinite(g).all()):
                    fail(f"bwd kernel {name} {tname}: {label} not finite")
                errs[label] = (g.float() - w.float()).abs().max().item()
                tiles[label] = tile_rel_err(torch, g, w)
                tols[label] = (BWD_TILE_TOL if tname == "bfloat16" else
                               TOL[tname] * max(1.0,
                                                w.float().abs().max().item()))
            emit(phase="bwd_kernel_check", case=name, dtype=tname,
                 shape=[b, h, h_kv, s_q, s_k, d], g_lse=with_lse,
                 q_stride=list(q.stride()), do_stride=list(do.stride()),
                 nan_rows=int(nan_rows.sum().item()), max_abs_err=errs,
                 tile_rel_err=tiles,
                 limit=("tile_rel_err" if tname == "bfloat16"
                        else "max_abs_err"), tol=tols, **kw)
            checked = tiles if tname == "bfloat16" else errs
            for label in checked:
                if not checked[label] <= tols[label]:
                    fail(f"bwd kernel {name} {tname} {label}: "
                         f"{checked[label]} > {tols[label]}")
            for kern, labels in (("dkv", ("dk", "dv")), ("dq", ("dq",))):
                key = (kern, tname)
                worst[key] = max([worst.get(key, 0.0)]
                                 + [errs[x] for x in labels])

    # time at the flagship training shape
    b, h, s, d = TRAIN_BATCH, TRAIN["n_heads"], TRAIN_SEQ, \
        TRAIN["dim"] // TRAIN["n_heads"]
    q, k, v, do = (torch.randn(b, h, s, d, device=device,
                               dtype=torch.bfloat16) for _ in range(4))
    o, lse = tflash.flash_attention_fwd_cuda(q, k, v, causal=True)
    run = tflash.FlashBwdLaunch(q, k, v, o, lse, do, causal=True)
    # *_ms: device time per launch (profiler); *_call_ms: CUDA events
    # around back-to-back calls (bounded below by the host's time per call)
    calls = dict(
        dkv=run.launch_dkv, dq=run.launch_dq,
        both=lambda: tflash.flash_attention_bwd_cuda(q, k, v, o, lse, do,
                                                     causal=True),
        fwd=lambda: tflash.flash_attention_fwd_cuda(q, k, v, causal=True))
    timing = {}
    for kern, fn in calls.items():
        timing[f"{kern}_ms"] = device_ms(torch, fn)
        timing[f"{kern}_call_ms"] = cuda_ms(fn, 20)
    timing["plain_ms"] = cuda_ms(lambda: tflash.flash_attention_bwd_reference(
        q, k, v, o, lse, do, causal=True), 3)
    # yardstick only: SDPA's backward = its forward + backward minus its
    # forward (one call computes dQ, dK and dV together)
    qs, ks, vs = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    sdpa_fwd_ms = device_ms(torch, lambda: sdpa(qs, ks, vs, is_causal=True))
    sdpa_fwd_bwd_ms = device_ms(torch, lambda: torch.autograd.grad(
        sdpa(qs, ks, vs, is_causal=True), (qs, ks, vs), do))
    timing.update(sdpa_fwd_ms=sdpa_fwd_ms, sdpa_fwd_bwd_ms=sdpa_fwd_bwd_ms,
                  library_bwd_ms=sdpa_fwd_bwd_ms - sdpa_fwd_ms)
    costs = flash_bwd_cost(b, h, h, s, s, d, 2)
    costs["fwd"] = flash_cost(b, h, h, s, s, d, 2)
    for kern, (flops, nbytes) in costs.items():
        bound_ms, bound_by = bound(torch, flops, nbytes)
        timing[f"{kern}_flops"] = flops
        timing[f"{kern}_bytes"] = nbytes
        timing[f"{kern}_bound_ms"] = bound_ms
        timing[f"{kern}_bound_by"] = bound_by
        timing[f"{kern}_tflops_per_s"] = flops / timing[f"{kern}_ms"] / 1e9
    emit(phase="bwd_kernel_time", shape=[b, h, h, s, s, d], dtype="bfloat16",
         causal=True, **timing)
    return worst, timing


def phase_model_check(torch, TransformerLM, make_flash_attn_fn, device):
    """f32 prefill logits of a flagship-width model through the kernel on
    the card against the same weights on the CPU (plain path)."""
    kw = dict(FLAGSHIP, n_layers=2, dtype=torch.float32)
    gpu = TransformerLM(device=device, attn_fn=make_flash_attn_fn(),
                        generator=torch.Generator(device=device)
                        .manual_seed(1), **kw)
    cpu = TransformerLM(device="cpu", attn_fn=make_flash_attn_fn(), **kw)
    cpu.load_state_dict(gpu.state_dict())
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, FLAGSHIP["vocab"], (1, 1024)))
    with torch.inference_mode():
        got = gpu(tokens.to(device)).float().cpu()
        want = cpu(tokens)
    if not bool(torch.isfinite(got).all()):
        fail("model logits are not finite")
    err = (got - want).abs().max().item()
    emit(phase="model_check", layers=kw["n_layers"], seq=1024,
         dtype="float32", max_abs_err=err, tol=2e-3,
         logits_shape=list(got.shape))
    if not err <= 2e-3:
        fail(f"model logits |diff| {err} > 2e-3")


def phase_serve(torch, port, tflash, device):
    from distributed_pytorch_tpu_torch.models.generate import generate
    from distributed_pytorch_tpu_torch.runtime import env
    from distributed_pytorch_tpu_torch.serve import (EngineConfig,
                                                     InferenceEngine,
                                                     SamplingParams,
                                                     aggregate)
    model = port.TransformerLM(
        dtype=torch.bfloat16, device=device,
        attn_fn=tflash.make_flash_attn_fn(),
        generator=torch.Generator(device=device).manual_seed(0), **FLAGSHIP)
    eng = InferenceEngine(model, EngineConfig(n_slots=4, max_len=2048))
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, FLAGSHIP["vocab"], (n,)).astype(np.int32)
               for n in PROMPT_LENS]
    sps = [SamplingParams(max_new_tokens=MAX_NEW) if i in GREEDY else
           SamplingParams(max_new_tokens=MAX_NEW, temperature=0.8, top_k=50)
           for i in range(len(prompts))]
    min_seq = int(env.get("DPX_FLASH_MIN_SEQ"))
    with eng:
        # warm-up request (cuBLAS handles, allocator): not measured
        eng.submit(prompts[COMPARE], SamplingParams(max_new_tokens=2)
                   ).result(timeout=900)
    eng = InferenceEngine(model, EngineConfig(n_slots=4, max_len=2048))

    tflash.reset_launch_counts()
    t0 = time.perf_counter()
    with eng:
        handles = [eng.submit(p, sp, generator=torch.Generator(
            device=device).manual_seed(100 + i))
            for i, (p, sp) in enumerate(zip(prompts, sps))]
        outs = [h.result(timeout=900) for h in handles]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = tflash.LAUNCHES["flash_attention_fwd"]

    st = eng.stats()
    flash_admits = sum(n for bucket, n in st["prefill_admits"].items()
                       if bucket >= min_seq)
    for i, out in enumerate(outs):
        if out.shape != (MAX_NEW,) or not ((0 <= out) & (
                out < FLAGSHIP["vocab"])).all():
            fail(f"request {i}: bad stream {out}")
    if st["completed"] != len(prompts):
        fail(f"only {st['completed']} of {len(prompts)} requests finished")
    if launches != FLAGSHIP["n_layers"] * flash_admits or launches == 0:
        fail(f"flash kernel launched {launches} times for {flash_admits} "
             f"admits at buckets >= {min_seq}")
    ref = generate(model, prompts[COMPARE][None], MAX_NEW)[0].cpu().numpy()
    if not np.array_equal(ref, outs[COMPARE]):
        fail(f"greedy stream of request {COMPARE} differs from generate(): "
             f"{outs[COMPARE].tolist()} vs {ref.tolist()}")
    agg = aggregate([h.metrics for h in handles], wall_s=wall)
    emit(phase="serve", card=torch.cuda.get_device_name(0),
         prompt_lens=list(PROMPT_LENS), buckets=st["prefill_admits"],
         flash_launches=launches, flash_admits=flash_admits,
         greedy_equals_generate=True, ttft_ms_p50=agg["ttft_ms_p50"],
         tpot_ms_p50=agg["tpot_ms_p50"],
         tokens_per_sec=agg["tokens_per_sec"], wall_s=wall,
         decode_steps=st["decode_steps"])
    return model, eng.pool


def kernel_times_us(torch, fn):
    """{kernel name: device microseconds} and {kernel name: events} of
    the kernels ``fn`` runs (torch.profiler), and the host milliseconds
    of the profiled call.

    ``fn`` runs twice: first in a warm-up cycle whose events the
    profiler traces and discards (the first kernel events of a trace
    can be lost: one run read 19 events for 20 launches, and 0 for 1),
    then in the recorded cycle. Only the device-side kernel events
    count: the aten op that launched a kernel also reports that
    kernel's time as its own self device time, so a sum over every
    event counts each aten-launched kernel twice (and a ctypes-launched
    one once)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        fn()
        torch.cuda.synchronize()
        prof.step()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
        prof.step()
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)]
    return ({e.key: e.self_device_time_total for e in events},
            {e.key: e.count for e in events}, wall_ms)


def device_busy_ms(torch, fn) -> float:
    """Device time of ``fn`` summed over its kernels (torch.profiler),
    or None where the profiler reports none."""
    total = sum(kernel_times_us(torch, fn)[0].values())
    return total / 1e3 if total else None


def phase_breakdown(torch, model, pool, kernel_ms):
    """Where the serving time goes: one admit prefill per bucket and one
    4-slot decode step, host clock around work ending in a synchronize,
    and the device-busy share of each from the profiler."""
    from distributed_pytorch_tpu_torch.models.generate import (
        decode_step_slots, prefill_partial)

    def host_ms(fn, reps=5):
        fn()
        torch.cuda.synchronize()
        ts = []
        for _ in range(reps):
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t) * 1e3)
        return sorted(ts)[len(ts) // 2]

    dev = model.device
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, FLAGSHIP["vocab"], (1, 2048))).to(dev)
    lengths = np.asarray([1900, 1500, 1024, 700])
    toks = torch.zeros(4, dtype=torch.long, device=dev)
    out = {}
    with torch.inference_mode():
        for b in (128, 1024, 2048):
            def fn(b=b):
                prefill_partial(model, tokens[:, :b], b)
            wall = host_ms(fn)
            busy = device_busy_ms(torch, fn)
            out[f"prefill_{b}"] = dict(
                wall_ms=wall, device_busy_ms=busy,
                flash_ms=(FLAGSHIP["n_layers"] * kernel_ms
                          if b == 2048 else None))

        def step():
            decode_step_slots(model, pool.ks, pool.vs, lengths, toks)
        wall = host_ms(step)
        out["decode_step_4slots"] = dict(wall_ms=wall,
                                         device_busy_ms=device_busy_ms(
                                             torch, step))
    for rec in out.values():
        busy = rec["device_busy_ms"]
        rec["device_idle_share"] = (None if busy is None
                                    else max(0.0, 1 - busy / rec["wall_ms"]))
    emit(phase="breakdown", **out)


def model_flops_per_token(dim, n_layers, vocab, seq, mlp_ratio=4,
                          causal=True):
    """Analytic matmul FLOPs per token of one forward (a copy of
    ``benchmarks/mfu_transformer.py:model_flops_per_token``, which the
    port cannot import): per layer qkv + out-proj + MLP, attention's two
    products at half the S^2 term when causal, and the vocab projection.
    A train step counts 3x (backward = 2x forward)."""
    per_layer = (8 + 4 * mlp_ratio) * dim * dim
    attn = 4 * seq * dim * (0.5 if causal else 1.0)
    return n_layers * (per_layer + attn) + 2 * dim * vocab


def lm_loss(model, tokens):
    """Next-token cross-entropy of ``tokens`` (B, S + 1), the loss of
    ``benchmarks/mfu_transformer.py`` without fused CE."""
    from distributed_pytorch_tpu_torch.ops.losses import cross_entropy
    return cross_entropy(model(tokens[:, :-1]), tokens[:, 1:]), {}


def train_tokens(torch, seed, batch, device):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, TRAIN["vocab"], (batch, TRAIN_SEQ + 1))).to(device)


GRAD_TOL = 1e-3     # x max|grad| of each tensor, f32 card vs CPU


def phase_train_check(torch, port, tflash, device):
    """One make_train_step step of a 2-layer flagship-width f32 model on
    the card (kernels) and on the CPU (plain path), same weights/batch.

    Tolerances: loss |diff| <= 1e-5 * loss; each gradient |diff| <=
    GRAD_TOL * max|grad| of its tensor (f32, summation order only). After
    one adamw step an element moves by ~lr * sign(grad), so where the
    gradient is rounding noise (below 1e-3 * max|grad|, e.g. the key
    bias, whose gradient is analytically zero) the two sides may step
    apart by up to 2 * lr; elsewhere the params agree to 1e-2 * lr."""
    from distributed_pytorch_tpu_torch.optim import adamw
    from distributed_pytorch_tpu_torch.parallel import make_train_step
    kw = dict(TRAIN, n_layers=2, dtype=torch.float32)
    attn_fn = tflash.make_flash_attn_fn()
    gpu = port.TransformerLM(device=device, attn_fn=attn_fn,
                             generator=torch.Generator(device=device)
                             .manual_seed(5), **kw)
    cpu = port.TransformerLM(device="cpu", attn_fn=attn_fn, **kw)
    cpu.load_state_dict(gpu.state_dict())
    tokens = train_tokens(torch, 5, 1, "cpu")
    tflash.reset_launch_counts()
    losses = {}
    for label, model in (("gpu", gpu), ("cpu", cpu)):
        opt = adamw(TRAIN_LR)
        out = make_train_step(lm_loss, opt)(
            model, opt.init(model.parameters()), tokens.to(model.device))
        losses[label] = out.loss.item()
    launches = dict(tflash.LAUNCHES)
    if any(n != kw["n_layers"] for n in launches.values()):
        fail(f"train_check: kernel launches {launches}, expected "
             f"{kw['n_layers']} each")
    if not abs(losses["gpu"] - losses["cpu"]) <= 1e-5 * abs(losses["cpu"]):
        fail(f"train_check: loss {losses['gpu']} vs CPU {losses['cpu']}")
    grad_ratio, param_err, noisy, noisy_err = 0.0, 0.0, 0, 0.0
    for (name, pg), (_, pc) in zip(gpu.named_parameters(),
                                   cpu.named_parameters()):
        gg, gc = pg.grad.float().cpu(), pc.grad
        scale = gc.abs().max().item()
        ratio = (gg - gc).abs().max().item() / scale
        if not ratio <= GRAD_TOL:
            fail(f"train_check: grad {name} |diff| / max|grad| = {ratio}")
        grad_ratio = max(grad_ratio, ratio)
        dp = (pg.detach().float().cpu() - pc.detach()).abs()
        clear = gc.abs() > 1e-3 * scale
        param_err = max(param_err, dp[clear].max().item())
        far = (dp > 1e-2 * TRAIN_LR) & ~clear
        noisy += int(far.sum().item())
        noisy_err = max(noisy_err, dp.max().item())
    emit(phase="train_check", layers=kw["n_layers"], seq=TRAIN_SEQ,
         dtype="float32", loss_gpu=losses["gpu"], loss_cpu=losses["cpu"],
         max_grad_err_over_max_grad=grad_ratio, grad_tol=GRAD_TOL,
         max_param_err=param_err, param_tol=1e-2 * TRAIN_LR,
         noise_grad_elements_apart=noisy, max_param_err_noise=noisy_err,
         launches=launches)
    if not param_err <= 1e-2 * TRAIN_LR:
        fail(f"train_check: params after one step differ by {param_err}")
    if not noisy_err <= 2 * TRAIN_LR * 1.01:
        fail(f"train_check: a param moved {noisy_err} apart (> 2 lr)")


def phase_train(torch, port, tflash, device):
    """The FLAGSHIP train step through make_train_step; returns what the
    breakdown and the kernels line read."""
    from distributed_pytorch_tpu_torch.optim import adamw
    from distributed_pytorch_tpu_torch.parallel import make_train_step

    def build(attn_fn, remat=False, seed=None):
        gen = (torch.Generator(device=device).manual_seed(seed)
               if seed is not None else None)
        return port.TransformerLM(dtype=torch.bfloat16, device=device,
                                  attn_fn=attn_fn, remat=remat,
                                  generator=gen, **TRAIN)

    def trainer(model):
        opt = adamw(TRAIN_LR)
        step = make_train_step(lm_loss, opt)
        state = [opt.init(model.parameters())]

        def run():
            out = step(model, state[0], tokens)
            state[0] = out.opt_state
            return out.loss
        return run

    tokens = train_tokens(torch, 6, TRAIN_BATCH, device)
    model = build(tflash.make_flash_attn_fn(), seed=0)
    init = {k: v.detach().clone() for k, v in model.state_dict().items()}
    run = trainer(model)

    tflash.reset_launch_counts()
    losses = [run() for _ in range(WARM_STEPS)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses += [run() for _ in range(TIMED_STEPS)]
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / TIMED_STEPS
    launches = dict(tflash.LAUNCHES)
    losses = torch.cat(losses).tolist()
    n_steps = WARM_STEPS + TIMED_STEPS
    per_step = {k: v / n_steps for k, v in launches.items()}
    if any(n != TRAIN["n_layers"] for n in per_step.values()):
        fail(f"train: launches per step {per_step}, expected "
             f"{TRAIN['n_layers']} of each kernel")
    if not all(np.isfinite(losses)):
        fail(f"train: non-finite losses {losses}")
    if not losses[-1] < losses[WARM_STEPS]:
        fail(f"train: loss did not fall over the timed steps: {losses}")

    dense = build(None)
    dense.load_state_dict(init)
    run_dense = trainer(dense)
    dense_losses = torch.cat([run_dense() for _ in range(DENSE_STEPS)]
                             ).tolist()
    del dense, run_dense
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, dense_losses)]
    if not max(rel) <= 0.02:
        fail(f"train: flash losses {losses[:DENSE_STEPS]} vs dense "
             f"{dense_losses} differ by more than 2% per step")

    remat = build(tflash.make_flash_attn_fn(), remat="full")
    remat.load_state_dict(init)
    run_remat = trainer(remat)
    tflash.reset_launch_counts()
    remat_losses = torch.cat([run_remat() for _ in range(REMAT_STEPS)]
                             ).tolist()
    remat_per_step = {k: v / REMAT_STEPS for k, v in tflash.LAUNCHES.items()}
    del remat, run_remat
    torch.cuda.empty_cache()
    if remat_per_step != {"flash_attention_fwd": 2 * TRAIN["n_layers"],
                          "flash_attention_bwd_dkv": TRAIN["n_layers"],
                          "flash_attention_bwd_dq": TRAIN["n_layers"]}:
        fail(f"train: remat='full' launches per step {remat_per_step}")
    remat_diff = abs(remat_losses[0] - losses[0])
    if not remat_diff <= 1e-6 * abs(losses[0]):
        fail(f"train: remat='full' first loss {remat_losses[0]} vs "
             f"{losses[0]}")

    tokens_per_step = TRAIN_BATCH * TRAIN_SEQ
    flops = 3 * model_flops_per_token(TRAIN["dim"], TRAIN["n_layers"],
                                      TRAIN["vocab"], TRAIN_SEQ) \
        * tokens_per_step
    peak_flops, _ = peaks(torch.cuda.get_device_name(0))
    emit(phase="train", card=torch.cuda.get_device_name(0),
         config=dict(TRAIN, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                     dtype="bfloat16", optimizer=f"adamw({TRAIN_LR})",
                     remat="none", loss="cross_entropy"),
         warmup_steps=WARM_STEPS, timed_steps=TIMED_STEPS,
         step_ms=step_s * 1e3, tokens_per_sec=tokens_per_step / step_s,
         flops_per_step=flops, mfu=flops / step_s / peak_flops,
         peak_flops=peak_flops, launches=launches,
         launches_per_step=per_step, losses=losses,
         dense_losses=dense_losses, max_rel_loss_diff_vs_dense=max(rel),
         remat_full_losses=remat_losses,
         remat_full_launches_per_step=remat_per_step,
         remat_full_first_loss_diff=remat_diff,
         peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    return run, step_s * 1e3, launches


KERNEL_CLASSES = (("flash_fwd", ("flash_fwd_kernel",)),
                  ("flash_bwd_dkv", ("flash_bwd_dkv_kernel",)),
                  ("flash_bwd_dq", ("flash_bwd_dq_kernel",)),
                  ("gemm", ("gemm", "nvjet", "xmma", "cutlass", "cublas")))


def phase_train_breakdown(torch, run_step, step_ms):
    """One FLAGSHIP step's device time by kernel class (torch.profiler,
    after a warm-up step) and the share of the unprofiled step the
    device sat idle."""
    times, _, wall_ms = kernel_times_us(torch, run_step)
    by_class = {name: 0.0 for name, _ in KERNEL_CLASSES}
    by_class["other"] = 0.0
    other = {}
    for name, us in times.items():
        low = name.lower()
        cls = next((c for c, keys in KERNEL_CLASSES
                    if any(k in low for k in keys)), "other")
        by_class[cls] += us / 1e3
        if cls == "other":
            other[name] = us / 1e3
    busy = sum(by_class.values())
    if not busy > 0:
        fail("train_breakdown: the profiler reported no device time")
    emit(phase="train_breakdown", device_ms=by_class,
         share={k: v / busy for k, v in by_class.items()},
         device_busy_ms=busy, profiled_wall_ms=wall_ms, step_ms=step_ms,
         device_idle_share=max(0.0, 1 - busy / step_ms),
         top_other_ms=dict(sorted(other.items(), key=lambda kv: -kv[1])[:6]))


def canonical(world: int) -> dict:
    """What rank 0 must observe of the collectives when rank r holds
    (r + 1) * [1, 2, 3]: the shared oracle of the repo's front-door
    contract test (``tests/test_front_door_contract.py``), which this
    script cannot import (the tests import JAX)."""
    stack = np.stack([(r + 1.0) * np.asarray([1.0, 2.0, 3.0], np.float32)
                      for r in range(world)])
    return {"all_reduce_sum": stack.sum(axis=0).tolist(),
            "all_reduce_avg": (stack.sum(axis=0) / world).tolist(),
            "reduce_root": stack.sum(axis=0).tolist(),
            "gather": stack.tolist(),
            "broadcast_src1": stack[min(1, world - 1)].tolist(),
            "invalid_op_raises": True}


def read_json(path):
    with open(path) as f:
        return json.load(f)


def phase_ddp_api(torch):
    """``launch`` on the card: the worker must see world >= 1 (world 0 is
    the CPU branch, a failure here), rank 0 on cuda:0, every collective
    as the oracle says on CUDA tensors, and ``prepare_ddp_model``
    wrapping iff world > 1."""
    import distributed_pytorch_tpu_torch as dist
    from distributed_pytorch_tpu_torch.examples import collectives
    world = dist.device_count()
    if world < 1:
        fail(f"ddp_api: launch would run world {world}, the CPU branch")
    with tempfile.TemporaryDirectory() as out_dir:
        t0 = time.perf_counter()
        dist.launch(collectives.main_worker, out_dir, None)
        wall = time.perf_counter() - t0
        obs = read_json(os.path.join(out_dir, "rank0.json"))
    got = {"all_reduce_sum": obs["all_reduce_sum"],
           "all_reduce_avg": obs["all_reduce_avg"],
           "reduce_root": obs["reduce"], "gather": obs["gather"],
           "broadcast_src1": obs["broadcast_src1"],
           "invalid_op_raises": obs["invalid_op_raises"]}
    checks = {
        "world_size": obs["world_size"] == world,
        "get_device_cuda0": obs.get("get_device") == "cuda:0",
        "outputs_on_cuda0": obs["output_devices"] == ["cuda:0"],
        "canonical": got == canonical(world),
        "all_gather": obs["all_gather"] == canonical(world)["gather"],
        "prepare_ddp_model": obs["prepare_ddp_model_wraps"] == (world > 1),
        "params_rank0": world > 1 or obs["params_after"]
        == obs["params_before"]}
    emit(phase="ddp_api", world=world, backend=obs["backend"],
         get_device=obs.get("get_device"),
         output_devices=obs["output_devices"], checks=checks, wall_s=wall)
    if not all(checks.values()):
        fail(f"ddp_api: {[k for k, ok in checks.items() if not ok]} "
             f"failed: {obs}")


def min_ddp_history(min_ddp, argv, **kw):
    """The primary's reduced losses of one in-process min_ddp run."""
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "history.json")
        min_ddp.main_worker(0, 1, argv, quiet=True, history_path=path, **kw)
        return read_json(path)


def phase_ddp_min(torch):
    """The reference workload at default flags on cuda:0 (TF32 off)
    against the same run on the CPU: the 8 reduced losses within rtol
    1e-5 (float32, summation order only)."""
    from distributed_pytorch_tpu_torch.examples import min_ddp
    t0 = time.perf_counter()
    gpu = min_ddp_history(min_ddp, ["--device", "cuda"])
    wall = time.perf_counter() - t0
    cpu = min_ddp_history(min_ddp, ["--device", "cpu"])
    rel = max(abs(a - b) / abs(b) for a, b in zip(gpu, cpu))
    emit(phase="ddp_min", device="cuda:0", tf32=False, losses_cuda=gpu,
         losses_cpu=cpu, max_rel_diff=rel, rtol=1e-5, cuda_wall_s=wall)
    if len(gpu) != 8 or len(cpu) != 8 or not np.all(np.isfinite(gpu)):
        fail(f"ddp_min: losses {gpu} vs {cpu}")
    if not rel <= 1e-5:
        fail(f"ddp_min: cuda and cpu losses differ by {rel} (rtol 1e-5)")


def phase_ddp_world2_cpu(torch):
    """min_ddp at world 2 (per-rank batch 4) in two CPU rank processes
    over gloo: its reduced losses (a SUM) over 2 against the unshuffled
    world-1 run at batch 8, rtol 2e-4, atol 1e-5. On the CPU because
    this machine has one card, and NCCL runs no two ranks on one
    device."""
    import distributed_pytorch_tpu_torch as dist
    from distributed_pytorch_tpu_torch.examples import min_ddp
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "history.json")
        t0 = time.perf_counter()
        dist.launch_multiprocess(
            min_ddp.main_worker, 2, ["--device", "cpu", "--batch-size", "4"],
            True, path, device="cpu", timeout_s=300)
        wall = time.perf_counter() - t0
        got = [v / 2 for v in read_json(path)]
    want = min_ddp_history(min_ddp, ["--device", "cpu"], shuffle=False)
    ok = len(got) == len(want) == 8 and np.allclose(got, want, rtol=2e-4,
                                                     atol=1e-5)
    emit(phase="ddp_world2_cpu", device="cpu", backend="gloo", world=2,
         why="one card on this machine, and NCCL runs no two ranks on one "
             "device", reduced_over_2=got, world1_unshuffled=want,
         rtol=2e-4, atol=1e-5, wall_s=wall)
    if not ok:
        fail(f"ddp_world2_cpu: {got} vs {want}")


def phase_ddp_train(torch, tflash, train_step_ms):
    """The FLAGSHIP LM trained through the helper API
    (``examples/ddp_lm.py``: SyntheticLM, data_sampler, DataLoader,
    prepare_ddp_model, make_train_step, and per step wait_for_everyone,
    reduce and gather), 2 warm-up and 10 timed steps beside the
    ``train`` phase's step; then 3 steps of the bf16 policy from
    float32 masters."""
    from distributed_pytorch_tpu_torch.examples import ddp_lm
    cfg = ddp_lm.Config(model=dict(TRAIN), seq_len=TRAIN_SEQ,
                        batch_size=TRAIN_BATCH, data_size=2 * TRAIN_BATCH,
                        steps=WARM_STEPS + TIMED_STEPS, warmup=WARM_STEPS,
                        lr=TRAIN_LR, dtype="bfloat16")
    want = {name: TRAIN["n_layers"] for name in tflash.LAUNCHES}
    tflash.reset_launch_counts()
    rec = ddp_lm.main_worker(0, 1, cfg)
    per_step = {k: v / cfg.steps for k, v in tflash.LAUNCHES.items()}
    losses = rec["losses"]
    step_ms = rec["timed_s"] / TIMED_STEPS * 1e3
    tokens_per_step = TRAIN_BATCH * TRAIN_SEQ
    flops = 3 * model_flops_per_token(TRAIN["dim"], TRAIN["n_layers"],
                                      TRAIN["vocab"], TRAIN_SEQ) \
        * tokens_per_step
    peak_flops, _ = peaks(torch.cuda.get_device_name(0))

    mp_cfg = dataclasses.replace(cfg, dtype="float32",
                                 mixed_precision="bf16", steps=3, warmup=0)
    tflash.reset_launch_counts()
    mp_rec = ddp_lm.main_worker(0, 1, mp_cfg)
    mp_per_step = {k: v / mp_cfg.steps for k, v in tflash.LAUNCHES.items()}
    torch.cuda.empty_cache()
    emit(phase="ddp_train", card=torch.cuda.get_device_name(0),
         config=dict(TRAIN, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                     dtype="bfloat16", optimizer=f"adamw({TRAIN_LR})",
                     data=f"SyntheticLM({cfg.data_size}, seed=0)"),
         world=rec["world_size"], device=rec["device"],
         warmup_steps=WARM_STEPS, timed_steps=TIMED_STEPS, step_ms=step_ms,
         train_step_ms=train_step_ms, step_ms_minus_train=step_ms
         - train_step_ms,
         host_ms_per_step=rec["host_ms_per_step"],
         tokens_per_sec=tokens_per_step / step_ms * 1e3,
         mfu=flops / (step_ms / 1e3) / peak_flops,
         launches_per_step=per_step, losses=losses,
         reduced=rec["reduced"], gathered_last=rec["gathered"][-1],
         bf16_policy=dict(losses=mp_rec["losses"],
                          launches_per_step=mp_per_step,
                          param_dtypes=mp_rec["param_dtypes"]))
    if per_step != want:
        fail(f"ddp_train: launches per step {per_step}, expected {want}")
    if not (np.all(np.isfinite(losses)) and rec["reduced"] == losses
            and len(rec["gathered"][-1]) == TRAIN_BATCH):
        fail(f"ddp_train: losses {losses}, reduced {rec['reduced']}")
    if not np.mean(losses[-2:]) < np.mean(losses[:2]):
        fail(f"ddp_train: the loss did not fall: {losses}")
    if mp_per_step != want or not np.all(np.isfinite(mp_rec["losses"])):
        fail(f"ddp_train bf16 policy: launches {mp_per_step}, losses "
             f"{mp_rec['losses']}")
    if mp_rec["param_dtypes"] != ["torch.float32"]:
        fail(f"ddp_train bf16 policy: masters {mp_rec['param_dtypes']}")


RESNET_BATCH = 64
RESNET_LOGIT_TOL = 1e-4     # x max|logit|, f32 card vs CPU
RESNET_STATE_TOL = 1e-5     # x max(1, max|stat|)
# ||grad_gpu - grad_cpu|| / ||grad_cpu|| per tensor: this model's float32
# gradients are ill-conditioned, each side's standing up to 1e-2 to 5e-2
# from float64 on some tensors (tests/test_torch_resnet.py), while a
# wrong layout or normalization misses by ~1
RESNET_GRAD_TOL = 5e-2
RESNET_ARGS = ["--eval", "--ema", "0.999"]
RESNET_BIG = ["--batch-size", "512", "--limit-steps", "20",
              "--data-size", "10240", "--epochs", "1"]


def phase_resnet_check(torch, port, device):
    """One training forward and backward of ResNet18(small_input=True) at
    batch 64 on cuda:0 and on the CPU from the same weights (f32)."""
    from distributed_pytorch_tpu_torch.ops.losses import cross_entropy
    gpu = port.ResNet18(small_input=True, device=device,
                        generator=torch.Generator(device=device)
                        .manual_seed(3))
    cpu = port.ResNet18(small_input=True, device="cpu")
    cpu.load_state_dict(gpu.state_dict())
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.random((RESNET_BATCH, 32, 32, 3),
                                    dtype=np.float32))
    y = torch.from_numpy(rng.integers(0, 10, (RESNET_BATCH,)))
    logits = {}
    for label, model in (("gpu", gpu), ("cpu", cpu)):
        out = model(x)
        cross_entropy(out, y.to(model.device)).backward()
        logits[label] = out.detach().cpu()
    torch.cuda.synchronize()
    if not bool(torch.isfinite(logits["gpu"]).all()):
        fail("resnet_check: logits not finite")
    logit_err = ((logits["gpu"] - logits["cpu"]).abs().max()
                 / logits["cpu"].abs().max()).item()
    grad_err, grad_max_err = {}, 0.0
    for (name, pg), (_, pc) in zip(gpu.named_parameters(),
                                   cpu.named_parameters()):
        d = pg.grad.cpu() - pc.grad
        grad_err[name] = (d.norm() / pc.grad.norm()).item()
        grad_max_err = max(grad_max_err,
                           (d.abs().max() / pc.grad.abs().max()).item())
    state_err = max(((bg.cpu().double() - bc.double()).abs().max()
                     / max(1.0, bc.double().abs().max().item())).item()
                    for (_, bg), (_, bc) in zip(gpu.named_buffers(),
                                                cpu.named_buffers()))
    worst = max(grad_err, key=grad_err.get)
    emit(phase="resnet_check", batch=RESNET_BATCH, image=[32, 32, 3],
         dtype="float32", tf32=False, max_logit_err=logit_err,
         logit_tol=RESNET_LOGIT_TOL, max_grad_rel_err=grad_err[worst],
         worst_grad=worst, grad_tol=RESNET_GRAD_TOL,
         max_grad_err_over_max_grad=grad_max_err, max_state_err=state_err,
         state_tol=RESNET_STATE_TOL,
         count=int(gpu.bn_stem.count.item()))
    if not logit_err <= RESNET_LOGIT_TOL:
        fail(f"resnet_check: logits differ by {logit_err}")
    if not grad_err[worst] <= RESNET_GRAD_TOL:
        fail(f"resnet_check: grad {worst} differs by {grad_err[worst]}")
    if not state_err <= RESNET_STATE_TOL:
        fail(f"resnet_check: BatchNorm state differs by {state_err}")


CONV_KEYS = ("conv", "xmma", "cudnn", "implicit", "wgrad", "dgrad", "fprop",
             "winograd")


def resnet_busy(torch, train_resnet, argv, device):
    """One training step of ``train_resnet``'s model at ``argv``'s batch
    (torch.profiler, after 3 warm-up steps): device ms in all, by class
    (cuDNN convolutions, GEMMs, the rest), and the rest's largest
    kernels."""
    from distributed_pytorch_tpu_torch.data import SyntheticImages
    args = train_resnet.parse_args(argv)
    trainer = train_resnet.make_trainer(args, device)
    data = SyntheticImages(args.batch_size, seed=2)
    batch = (torch.from_numpy(data.images), torch.from_numpy(data.labels))
    for _ in range(3):
        trainer.train_step(batch)
    times, _, _ = kernel_times_us(torch, lambda: trainer.train_step(batch))
    by_class = {"conv": 0.0, "gemm": 0.0, "other": 0.0}
    other = {}
    for name, us in times.items():
        low = name.lower()
        cls = ("conv" if any(k in low for k in CONV_KEYS) else
               "gemm" if "gemm" in low else "other")
        by_class[cls] += us / 1e3
        if cls == "other":
            other[name[:80]] = us / 1e3
    top = dict(sorted(other.items(), key=lambda kv: -kv[1])[:6])
    busy = sum(by_class.values())
    return (busy if busy > 0 else None), by_class, top


def stat_dtype_names(tree):
    """The dtypes of every running mean and var in a JAX-layout state."""
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from stat_dtype_names(val)
        elif key in ("mean", "var"):
            yield str(val.dtype)


def phase_resnet_train(torch, device):
    """train_resnet at world 1 on cuda:0: its defaults with ``--eval --ema
    0.999``, then 20 steps at batch 512, then 3 bf16 steps."""
    from distributed_pytorch_tpu_torch.examples import train_resnet
    base = ["--device", "cuda"] + RESNET_ARGS
    windows = {}
    for label, extra in (("defaults", []), ("batch512", RESNET_BIG)):
        argv = base + extra
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        rec = train_resnet.main_worker(0, 1, argv, quiet=True)
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 1e9
        args = train_resnet.parse_args(argv)
        step_ms = rec["timed_s"] / rec["timed_steps"] * 1e3
        busy, by_class, top = resnet_busy(torch, train_resnet, argv, device)
        windows[label] = dict(
            argv=argv, batch=args.batch_size, steps=len(rec["losses"]),
            timed_steps=rec["timed_steps"], step_ms=step_ms,
            images_per_s=args.batch_size / step_ms * 1e3,
            first_loss=rec["losses"][0], final_loss=rec["losses"][-1],
            eval_acc=rec["eval_acc"], ema_eval_acc=rec["ema_eval_acc"],
            train_acc=rec["train_acc"], peak_memory_gb=peak, wall_s=wall,
            device_busy_ms_per_step=busy, device_ms_by_class=by_class,
            top_other_ms=top,
            device_idle_share=(None if busy is None
                               else max(0.0, 1 - busy / step_ms)))
        if not (np.all(np.isfinite(rec["losses"])) and rec["timed_steps"]
                and len(rec["ema_eval_acc"]) == args.epochs):
            fail(f"resnet_train {label}: {rec['losses']} {rec['eval_acc']}")
        if busy is None:
            fail(f"resnet_train {label}: the profiler reported no device "
                 "time")
        torch.cuda.empty_cache()
    bf16 = train_resnet.main_worker(
        0, 1, ["--device", "cuda", "--bf16", "--epochs", "1",
               "--limit-steps", "3"], quiet=True)
    stat_dtypes = sorted(set(stat_dtype_names(bf16["state"])))
    emit(phase="resnet_train", card=torch.cuda.get_device_name(0),
         config=dict(model="ResNet18(small_input=True)", optimizer=(
             "sgd(0.05, momentum=0.9) + with_ema(0.999)"),
             data="SyntheticImages(seed 0), 32x32x3", dtype="float32",
             tf32=False), windows=windows,
         bf16=dict(losses=bf16["losses"], running_stat_dtypes=stat_dtypes))
    if not (len(bf16["losses"]) == 3 and np.all(np.isfinite(bf16["losses"]))
            and stat_dtypes == ["float32"]):
        fail(f"resnet_train bf16: {bf16['losses']} {stat_dtypes}")


LM_ROWS = TRAIN_BATCH * TRAIN_SEQ
# fused vs the plain loss of the float32 logits of the same inputs: the
# value from float32 sums either way (summation order only); gradients
# in bf16 norm-relative (the softmax gradient and each result rounded to
# bf16 once), in f32 the summation order
FUSED_TOL = {"bfloat16": dict(value=1e-5, grad=1e-2),
             "float32": dict(value=1e-5, grad=1e-4)}


def phase_lm_stack_check(torch, device):
    """fused_linear_cross_entropy at the FLAGSHIP loss shape against the
    plain cross-entropy of float32 logits; both losses' device time (one
    forward and backward) and peak memory at bf16."""
    from distributed_pytorch_tpu_torch.ops.losses import (
        cross_entropy, fused_linear_cross_entropy)
    d, v = TRAIN["dim"], TRAIN["vocab"]
    gen = torch.Generator(device=device).manual_seed(9)
    h0 = torch.randn(LM_ROWS, d, device=device, generator=gen)
    w0 = (torch.rand(v, d, device=device, generator=gen) * 2 - 1) * d ** -0.5
    y = torch.randint(0, v, (LM_ROWS,), device=device, generator=gen)

    def run(fn, h, w):
        h, w = (t.detach().clone().requires_grad_(True) for t in (h, w))
        loss = fn(h, w, y)
        loss.backward()
        return loss.detach(), h.grad, w.grad

    def fused(h, w, y):
        return fused_linear_cross_entropy(h, w, y)

    def plain(h, w, y):
        return cross_entropy(h @ w.t(), y)

    def rel(a, b):
        return ((a.float() - b.float()).norm() / b.float().norm()).item()

    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        tname = str(dtype).split(".")[-1]
        h, w = h0.to(dtype), w0.to(dtype)
        ref = run(plain, h.float(), w.float())
        rec = {}
        for label, fn in (("fused", fused), ("plain", plain)):
            got = run(fn, h, w)
            rec[label] = dict(
                loss=got[0].item(),
                value_rel_err=abs(got[0].item() - ref[0].item())
                / abs(ref[0].item()),
                dh_rel_err=rel(got[1], ref[1]), dw_rel_err=rel(got[2],
                                                               ref[2]))
            del got
        tol = FUSED_TOL[tname]
        rec["tol"] = tol
        f = rec["fused"]
        if not (f["value_rel_err"] <= tol["value"]
                and f["dh_rel_err"] <= tol["grad"]
                and f["dw_rel_err"] <= tol["grad"]):
            fail(f"lm_stack_check {tname}: {rec}")
        out[tname] = rec
        del ref
        torch.cuda.empty_cache()
    h, w = h0.to(torch.bfloat16), w0.to(torch.bfloat16)
    for label, fn in (("fused", fused), ("plain", plain)):
        run(fn, h, w)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        run(fn, h, w)
        torch.cuda.synchronize()
        out["bfloat16"][label].update(
            device_ms=device_busy_ms(torch, lambda: run(fn, h, w)),
            peak_memory_gb=(torch.cuda.max_memory_allocated() - base) / 1e9)
    emit(phase="lm_stack_check", rows=LM_ROWS, dim=d, vocab=v,
         chunk_rows=512, reference="cross_entropy of float32 logits",
         **out)


def state_bytes(torch, state) -> int:
    """Bytes of every tensor in an optimizer state nest."""
    if isinstance(state, torch.Tensor):
        return state.numel() * state.element_size()
    if isinstance(state, (tuple, list)):
        return sum(state_bytes(torch, x) for x in state)
    return 0


def lm_loss_fused(model, tokens):
    """``lm_loss`` through ``fused_linear_cross_entropy`` on the final
    hidden states (``train_transformer_lm.py --fused-ce``)."""
    from distributed_pytorch_tpu_torch.ops.losses import \
        fused_linear_cross_entropy
    hid = model(tokens[:, :-1], return_hidden=True)
    return fused_linear_cross_entropy(hid, model.head_weight(),
                                      tokens[:, 1:]), {}


def phase_lm_stack(torch, port, tflash, device, train_step_ms):
    """FLAGSHIP through make_train_step with the fused loss and the
    clipped, scheduled AdamW, beside the plain loss with adamw; then 3
    steps each of adafactor and adamw_8bit."""
    from distributed_pytorch_tpu_torch import optim
    from distributed_pytorch_tpu_torch.parallel import make_train_step
    tokens = train_tokens(torch, 6, TRAIN_BATCH, device)
    model = port.TransformerLM(dtype=torch.bfloat16, device=device,
                               attn_fn=tflash.make_flash_attn_fn(),
                               generator=torch.Generator(device=device)
                               .manual_seed(0), **TRAIN)
    init = {k: v.detach().clone() for k, v in model.state_dict().items()}
    want = {name: TRAIN["n_layers"] for name in tflash.LAUNCHES}
    n_steps = WARM_STEPS + TIMED_STEPS
    stacks = {
        "fused_clip_schedule": (lm_loss_fused, optim.with_clipping(
            optim.with_schedule(optim.adamw, optim.warmup_cosine(
                TRAIN_LR, WARM_STEPS, n_steps)), 1.0)),
        "plain_adamw": (lm_loss, optim.adamw(TRAIN_LR))}
    runs = {}
    for label, (loss_fn, opt) in stacks.items():
        model.load_state_dict(init)
        step = make_train_step(loss_fn, opt)
        state = opt.init(model.parameters())
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        tflash.reset_launch_counts()
        losses = []
        for i in range(n_steps):
            if i == WARM_STEPS:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            out = step(model, state, tokens)
            state = out.opt_state
            losses.append(out.loss)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) / TIMED_STEPS * 1e3
        per_step = {k: v / n_steps for k, v in tflash.LAUNCHES.items()}
        peak = torch.cuda.max_memory_allocated() / 1e9
        losses = torch.cat(losses).tolist()
        # one more step, profiled: the device's share of the step
        busy = device_busy_ms(torch, lambda: step(model, state, tokens))
        runs[label] = dict(step_ms=step_ms, launches_per_step=per_step,
                           peak_memory_gb=peak, losses=losses,
                           device_busy_ms_per_step=busy,
                           device_idle_share=(None if busy is None else
                                              max(0.0, 1 - busy / step_ms)),
                           opt_state_bytes=state_bytes(torch, state))
        del state, out
        if per_step != want:
            fail(f"lm_stack {label}: launches per step {per_step}")
        if not (np.all(np.isfinite(losses)) and losses[-1] < losses[0]):
            fail(f"lm_stack {label}: losses {losses}")
    others = {}
    for label, opt in (("adafactor", optim.adafactor()),
                       ("adamw_8bit", optim.adamw_8bit(TRAIN_LR))):
        model.load_state_dict(init)
        step = make_train_step(lm_loss_fused, opt)
        state = opt.init(model.parameters())
        losses = []
        for _ in range(3):
            out = step(model, state, tokens)
            state = out.opt_state
            losses.append(out.loss)
        losses = torch.cat(losses).tolist()
        others[label] = dict(losses=losses,
                             opt_state_bytes=state_bytes(torch, state))
        del state, out
        if not np.all(np.isfinite(losses)):
            fail(f"lm_stack {label}: losses {losses}")
    del model
    torch.cuda.empty_cache()
    fused = runs["fused_clip_schedule"]
    emit(phase="lm_stack", card=torch.cuda.get_device_name(0),
         config=dict(TRAIN, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                     dtype="bfloat16", loss="fused_linear_cross_entropy",
                     optimizer=(f"with_clipping(with_schedule(adamw, "
                                f"warmup_cosine({TRAIN_LR}, {WARM_STEPS}, "
                                f"{n_steps})), 1.0)")),
         warmup_steps=WARM_STEPS, timed_steps=TIMED_STEPS,
         step_ms=fused["step_ms"], peak_memory_gb=fused["peak_memory_gb"],
         launches_per_step=fused["launches_per_step"],
         train_step_ms=train_step_ms, runs=runs, optimizers=others)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import distributed_pytorch_tpu_torch as port
    from distributed_pytorch_tpu_torch.ops import _build
    from distributed_pytorch_tpu_torch.ops import flash_attention as tflash

    smi = nvidia_smi()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # bf16 GEMMs accumulate fully in f32, so the batched decode and the
    # standalone generate() round alike
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    device = torch.device("cuda", 0)
    emit(phase="device", nvidia_smi=smi,
         name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda)

    phase_build(_build, tflash)

    worst, timing = phase_kernel(torch, tflash, device)
    bwd_worst, bwd_timing = phase_bwd_kernel(torch, tflash, device)
    phase_model_check(torch, port.TransformerLM, tflash.make_flash_attn_fn,
                      device)
    model, pool = phase_serve(torch, port, tflash, device)
    phase_breakdown(torch, model, pool, timing["ms"])
    del model, pool
    torch.cuda.empty_cache()

    # training runs PyTorch's default bf16 GEMM reduction (the serving
    # phases turned it off so batched and single-row decode round alike)
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = True
    phase_train_check(torch, port, tflash, device)
    run_step, step_ms, launches = phase_train(torch, port, tflash, device)
    phase_train_breakdown(torch, run_step, step_ms)
    del run_step
    torch.cuda.empty_cache()

    # the DDP helper API: launch and the collectives on the card, the
    # reference workload on the card and in two gloo CPU ranks, the
    # FLAGSHIP LM through the API
    phase_ddp_api(torch)
    phase_ddp_min(torch)
    phase_ddp_world2_cpu(torch)
    phase_ddp_train(torch, tflash, step_ms)

    # the ResNet-18 rung (cuDNN; no kernel of the port) and the LM rung's
    # optimizer and loss stack (the three flash kernels)
    phase_resnet_check(torch, port, device)
    phase_resnet_train(torch, device)
    phase_lm_stack_check(torch, device)
    phase_lm_stack(torch, port, tflash, device, step_ms)

    # bf16 at the serving prefill shape (ms, library_ms) and at the
    # FLAGSHIP train shape (train_*), with the design each one ran
    rows = {"flash_attention_fwd": dict(
        max_abs_err=worst["bfloat16"], ms=timing["ms"],
        plain_ms=timing["plain_ms"], bound_ms=timing["bound_ms"],
        bound_by=timing["bound_by"], library_ms=timing["library_ms"],
        tflops_per_s=timing["tflops_per_s"],
        library_ratio=timing["ms"] / timing["library_ms"],
        call_ms=timing["call_ms"], library_call_ms=timing["library_call_ms"],
        train_ms=bwd_timing["fwd_ms"],
        train_call_ms=bwd_timing["fwd_call_ms"],
        train_library_ms=bwd_timing["sdpa_fwd_ms"],
        train_bound_ms=bwd_timing["fwd_bound_ms"],
        train_tflops_per_s=bwd_timing["fwd_tflops_per_s"],
        train_library_ratio=bwd_timing["fwd_ms"] / bwd_timing["sdpa_fwd_ms"])}
    # the plain version and SDPA compute dQ, dK and dV in one call: their
    # times stand beside both kernels together (both_ms), not one alone
    for name, kern in (("flash_attention_bwd_dkv", "dkv"),
                       ("flash_attention_bwd_dq", "dq")):
        rows[name] = dict(
            max_abs_err=bwd_worst[(kern, "bfloat16")],
            ms=bwd_timing[f"{kern}_ms"], plain_ms=bwd_timing["plain_ms"],
            bound_ms=bwd_timing[f"{kern}_bound_ms"],
            bound_by=bwd_timing[f"{kern}_bound_by"],
            library_ms=bwd_timing["library_bwd_ms"],
            tflops_per_s=bwd_timing[f"{kern}_tflops_per_s"],
            library_ratio=(bwd_timing[f"{kern}_ms"]
                           / bwd_timing["library_bwd_ms"]),
            call_ms=bwd_timing[f"{kern}_call_ms"],
            both_ms=bwd_timing["both_ms"],
            plain_and_library_compute="dq+dk+dv")
    for name, row in rows.items():
        row["design"] = tflash.DESIGNS[name][torch.bfloat16]
    print(json.dumps({"kernels": [
        dict(name=name, route="cuda", source=KERNELS[name][0],
             replaces=KERNELS[name][1], launches=launches[name], **row)
        for name, row in rows.items()]}), flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
