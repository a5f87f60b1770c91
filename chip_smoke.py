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
              ``adamw_8bit`` (finite losses, optimizer state bytes);
19. lm_trainer — ``examples/train_transformer_lm.py`` at world 1 at the
              FLAGSHIP width (dim 768, 12 layers, 12 heads, seq 1024,
              batch 8, bf16, flash, the byte vocabulary of 256) on the
              card machine's own Python standard library as ``--text``,
              with ``--prefetch 2 --eval --generate 16 --log``: run 1
              trains 10 steps saving every 5, run 2 resumes to 15, run 3
              trains 15 uninterrupted; runs 2 and 3 must give the same
              losses for steps 10-14, exactly. Step ms, tokens/s and MFU
              (run 3), 12/12/12 launches per step, async save and
              restore wall and the checkpoint's bytes, the prefetch
              worker's host ms per batch beside the unprefetched path's,
              eval nll and the generated bytes; a 4th run (no prefetch,
              ``--trace``) gives one step's device busy time;
20. serve_paged (run after ``breakdown``, on its model) — the model behind
              ``InferenceEngine(n_slots=4, max_len=2048, paged=True)``
              (page_len 16): eight greedy requests of a shared
              1024-token system prompt plus distinct 32-256-token tails,
              32 new tokens each; the streams must equal the contiguous
              engine's token for token, the prefix hit rate must be > 0,
              and after retirement no page may keep a reader and every
              page must return to the free list once the prefix index
              is emptied. TTFT/TPOT p50/p99, tokens/s, peak pages in
              use, pool bytes, and one 4-slot paged decode step's device
              busy / idle share beside the contiguous engine's;
21. serve_kvq — serve_paged's traffic on the paged pool (page 16, 512
              pages) at kv_dtype f32, q8 and q4: the f32 streams must
              equal serve_paged's, the cold request's first token must
              be the same at every width, every element of the pages the
              cold admission completed must dequantize within scale/2
              of the f32 pool's value (the warm tails' pages, computed
              over a quantized prefix, are reported), bytes per resident
              token must be 36,864 / 18,504 / 9,288 with 4,718,592 B of
              tails beside a quantized pool, and the flash forward must
              launch 12 times per admission. TTFT/TPOT p50/p99, the
              greedy divergence from f32, peak pages, and one 4-slot
              decode step's max logit delta, wall and device busy;
22. serve_spec — serve_paged's 8 greedy prompts and 2 sampled ones, 31
              new tokens (1 + 6 (k+1)), ``spec_decode`` with draft_len 4:
              (a) the target as its own draft on the contiguous pool, (b)
              a 2-layer FLAGSHIP-width draft from another seed on the
              paged pool, (c) (a) on the q8 paged pool, each beside the
              same engine without speculation: the greedy streams must
              be equal, token for token (a divergence prints its
              position and the reference's top-2 logit gap there),
              acceptance must be exactly 1.0 in (a) and (c), the
              sampled requests must finish, the flash forward must
              launch for every
              target and draft prefill of >= 1024 keys. Acceptance,
              tokens per iteration, TPOT p50 and decode-loop seconds
              beside the unspeculated run's;
23. serve_int8 — ``quantize_tree`` of the serve model: every int8 weight
              equal to ``quantize_int8`` of the bf16 one, bit for bit;
              first-token logits of 4 prompts within twice the distance
              a random draw of every weight within +-scale/2 of its
              channel moves them; ``quantized_bytes`` beside the bf16
              model's; 4 greedy requests through the engine on both
              models, TPOT and flash launches;
24. serve_disagg — serve_paged's traffic through ``DisaggEngine(n_slots=4)``
              (page 16, 512 pages a pool) at handoff f32, q8 and q4 on
              bf16 pools and q8 on q8 pools (the codes pass through): the
              f32 streams must equal serve_paged's and every first token
              its first token; the booked handoff bytes must equal
              ``kv_wire_bytes`` of each frame, the frames' KV sections and
              688,914,432 / 172,901,376 / 86,787,072 B (f32 / q8 >= 3.5);
              requests 2-8 must hit the prefill side's prefix pages, the
              flash forward launch 12 times per prefill admission, every
              page of both pools be free after the drain and each
              request's queue + prefill + handoff + decode ms sum to its
              TTFT within 1 ms; then a transport cut on its second send
              must fail that request ``PrefillEngineDied`` (engine
              "prefill") while the decoding stream finishes equal.
              Printed: divergence, one-step logit deltas, host ms per
              frame of extract / encode / decode / adopt, decode-step
              wall during a prefill and not, TTFT/TPOT beside
              serve_paged's;
25. serve_fleet — ``FleetRouter`` over two replicas of serve_paged's
              paged config: (a) the 8 requests (affinity hits and spills
              printed) with streams equal serve_paged's; (b) four
              streaming requests' home killed: each fails
              ``ReplicaFailed`` naming it, the prompts resubmitted
              re-home to the survivor with equal streams; 12 flash
              launches per admission in both;
26. serve_lm_example — ``examples/serve_lm.py --disagg`` at its default
              width in a subprocess (300 s limit): exit 0 and six
              request lines with the TTFT decomposition;
27. host_ddp (after ddp_train) — FLAGSHIP through a ``"host"`` group (the
              native ring of ``native/dpxhost.cpp``) at world 1 on
              cuda:0, 1 warm-up and 3 timed steps in each arm:
              grad_reduce mean, quant, q4 and adaptive, the overlapped
              buckets (4) at quant, and ZeRO-1 (``weight_update=
              "sharded"``) at mean and at quant. Each moves the whole
              134,994,432-element f32 gradient bucket to the host and
              back, the quantized arms through ErrorFeedback's grid.
              Per arm: step ms beside ``train``'s, host ms per step of
              device -> host, codec, ring and host -> device, CommStats
              bytes and calls per op, exposed / overlapped seconds,
              12/12/12 flash launches per step, finite falling losses,
              the adaptive chooser's widths; the ZeRO-1 mean arm's
              parameters must equal the replicated mean arm's bit for
              bit;
28. host_ring — ``examples/host_ring.py``: two CPU rank processes over
              the port's ``HostComm`` on a 134,994,432-element bucket:
              all-reduce f32, q8, q4 and reduce_scatter_q8 +
              allgather_q8, wall ms and wire bytes per rank beside
              ``comm/wire.py``'s formulas, results equal on both ranks
              (the legs equal to the q8 ring), the q8 / q4 rings at
              1,048,576 elements equal to ``simulate_quant_ring``, and
              one ~94 MB f32 handoff frame through ``HostCommTransport``.

29. fsdp (after train_breakdown) — FLAGSHIP (``train``'s seeded weights
              and batch, bf16, adamw(3e-4)) in a one-rank NCCL group on
              cuda:0 over ``init_mesh(dp=1)``: the replicated
              ``make_train_step``, then ``make_fsdp_train_step`` (ZeRO-3,
              FSDP2 ``fully_shard`` per block), ``make_zero2_train_step``
              and ``make_zero1_train_step``, 1 warm-up and 5 timed steps
              each: step ms, peak memory, one step's device busy share,
              the optimizer's host ms per step (DTensor dispatch), 12/12/12
              flash launches per step, finite falling losses within 2e-3
              relative of ``train``'s step for step, DTensor optimizer
              state on every rung; then ``vocab_parallel_cross_entropy``
              at tp = 1 on seeded (8, 1024, 32000) logits against the
              dense loss (value and gradient, 1e-5 x max(1, |ref|)) and
              ``make_vocab_parallel_ce_fn`` of the model's hidden states
              against the dense loss of its logits.
30. front_door (after fsdp) — FLAGSHIP through ``front_door.make_step``
              in a one-rank NCCL group over ``init_mesh(dp=1)``:
              ``specs=None``, ZeRO-3 / ZeRO-2 / ZeRO-1 as ``StepSpecs``,
              ``weight_update="sharded"`` and ``FROM_INPUTS`` (replicated
              DTensor parameters, the batch a DTensor over dp, the flash
              kernel on the local shards), 1 warm-up and 5 timed steps
              each: step ms, one step's device busy ms, one build per
              arm, 12/12/12 flash launches per step, finite falling
              losses within 2e-3 relative of ``train``'s; a second
              identical request returns the same step with its builds
              unchanged; the handoff chain — the dp step's
              ``out_shardings`` pinned by ``make_eval_step(like=)`` (two
              eval passes over the batch) and by an ``InferenceEngine``
              with ``EngineConfig(param_shardings=...)`` answering 2
              greedy requests (prompts 600 and 1000: a flash prefill
              each) — with zero ``redistribute`` / ``full_tensor``
              calls; the ZeRO-3 step's tree of shardings pinned by its
              eval (the FSDP2 forward); a CPU copy and a plain model
              against the ZeRO-3 tree refused with ``HandoffMismatch``;
31. ckpt_sharded — FLAGSHIP's parameters and adamw state (after two
              steps) saved by ``CheckpointManager(sharded=True,
              param_specs=fsdp_param_specs(model, 4), axis_sizes={"dp":
              4}, async_save=True)`` through one writer (a grid of 4 on
              disk from one card): the save call's blocking seconds, the
              IO thread's write seconds, bytes, shards; the restore into
              a fresh model and state (seconds, bytes, every member's
              CRC checked, bit-for-bit equal), and a ``Target`` restore
              at dp = 2 rank 0 reading about half the bytes.
``lm_trainer`` also runs the save / resume pair with ``--sharded-ckpt``
(runs 5 and 6): the resumed losses must equal run 3's exactly.

Then the ``kernels`` line (each kernel's design, ``wgmma+tma`` or
``scalar_fma``, as its bf16 path runs it; the forward at both shapes and
its launches in ``serve_kvq``, ``serve_spec``, ``serve_int8``,
``serve_disagg`` and ``serve_fleet``; every row's launches per step in
each ``host_ddp``, ``fsdp`` and ``front_door`` arm), the nvidia-smi
line and, last, the
result line
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import os
import re
import shutil
import subprocess
import sys
import sysconfig
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


DEVICE_MS_ATTEMPTS = 6


def device_ms(torch, fn, iters: int = 20) -> float:
    """Device milliseconds per call of ``fn``: the kernel events of
    ``iters`` calls (torch.profiler) over ``iters``. Unlike cuda_ms this
    is not bounded below by the host's time to issue one call, which for
    a ~50 us kernel behind a Python wrapper can be the larger.

    The profiler can lose kernel events, which reads as a time too
    short: every kernel must show a whole multiple of ``iters`` events
    (its launches per call, ``iters`` times). On a shortfall it is
    measured again, up to DEVICE_MS_ATTEMPTS times in all, then it fails
    (one machine lost 3-4 of 20 events in two profiles running). (A
    separate profile of one call cannot give the count: it loses its
    only event at times.)"""
    fn()
    torch.cuda.synchronize()
    for attempt in range(DEVICE_MS_ATTEMPTS):
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
    return run, step_s * 1e3, launches, losses


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


FSDP_TIMED_STEPS = 5
FSDP_LOSS_RTOL = 2e-3       # each step's loss against train's, relative
VP_CE_TOL = 1e-5            # x max(1, |ref|): vocab-parallel CE, tp = 1


def _timed_optimizer(opt, times):
    """``opt`` whose update adds its host seconds to ``times``."""
    from distributed_pytorch_tpu_torch.optim import Optimizer

    def update(grads, state, params):
        t0 = time.perf_counter()
        out = opt.update(grads, state, params)
        times.append(time.perf_counter() - t0)
        return out
    return Optimizer(opt.init, update)


def fsdp_arm(torch, port, tflash, device, make_step, tokens):
    """1 warm-up and FSDP_TIMED_STEPS timed steps of FLAGSHIP (``train``'s
    seeded weights) through ``make_step(loss_fn, optimizer, model)``: what
    the phase prints about the arm."""
    from distributed_pytorch_tpu_torch.optim import adamw
    model = port.TransformerLM(
        dtype=torch.bfloat16, device=device,
        attn_fn=tflash.make_flash_attn_fn(),
        generator=torch.Generator(device=device).manual_seed(0), **TRAIN)
    opt_s = []
    opt = _timed_optimizer(adamw(TRAIN_LR), opt_s)
    step = make_step(lm_loss, opt, model)
    state = [opt.init(model.parameters())]

    def run():
        out = step(model, state[0], tokens)
        state[0] = out.opt_state
        return out.loss

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tflash.reset_launch_counts()
    losses = [run()]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses += [run() for _ in range(FSDP_TIMED_STEPS)]
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / FSDP_TIMED_STEPS * 1e3
    n = 1 + FSDP_TIMED_STEPS
    per_step = {k: v / n for k, v in tflash.LAUNCHES.items()}
    peak = torch.cuda.max_memory_allocated() / 1e9
    busy = device_busy_ms(torch, run)
    rec = dict(step_ms=step_ms, peak_memory_gb=peak, device_busy_ms=busy,
               device_busy_share=(busy / step_ms if busy else None),
               opt_host_ms_per_step=1e3 * sum(opt_s[1:n]) / (n - 1),
               launches_per_step=per_step,
               losses=torch.cat(losses).float().tolist())
    state_types = sorted({type(t).__name__ for t in state[0].mu})
    rec["state_types"] = state_types
    del model, state, step
    torch.cuda.empty_cache()
    return rec


def phase_fsdp(torch, port, tflash, device, train_losses, train_step_ms):
    """FLAGSHIP through the ZeRO ladder of ``parallel/fsdp.py`` in a
    one-rank NCCL group on the card (one card: world > 1 is proven over
    gloo CPU ranks), beside the replicated ``make_train_step`` of the
    same process; then the vocab-parallel loss at tp = 1. Returns each
    arm's flash launches per step."""
    from distributed_pytorch_tpu_torch.ops.losses import (
        cross_entropy_per_example, make_vocab_parallel_ce_fn,
        vocab_parallel_cross_entropy)
    from distributed_pytorch_tpu_torch.parallel import fsdp, make_train_step
    from distributed_pytorch_tpu_torch.runtime import context, env
    from distributed_pytorch_tpu_torch.runtime.launcher import find_free_port
    env.set("DPX_MASTER_PORT", find_free_port())
    context.init_process_group(0, 1)
    try:
        mesh = context.init_mesh(dp=1)
        tokens = train_tokens(torch, 6, TRAIN_BATCH, device)
        makers = {
            "replicated": lambda f, o, m: make_train_step(f, o),
            "zero3": lambda f, o, m: fsdp.make_fsdp_train_step(
                f, o, mesh, fsdp.fsdp_param_specs(m, 1)),
            "zero2": lambda f, o, m: fsdp.make_zero2_train_step(
                f, o, mesh, m)[0],
            "zero1": lambda f, o, m: fsdp.make_zero1_train_step(
                f, o, mesh, m)[0]}
        arms = {name: fsdp_arm(torch, port, tflash, device, make, tokens)
                for name, make in makers.items()}
        backend = context.get_backend()

        # the vocab-parallel loss at tp = 1 against the dense loss: seeded
        # logits of the FLAGSHIP loss shape, and a model's hidden states
        gen = torch.Generator(device=device).manual_seed(11)
        logits = torch.randn(TRAIN_BATCH, TRAIN_SEQ, TRAIN["vocab"],
                             device=device, generator=gen) * 3
        labels = torch.randint(0, TRAIN["vocab"], (TRAIN_BATCH, TRAIN_SEQ),
                               device=device, generator=gen)
        ce = {}
        for name, fn in (("vocab_parallel", vocab_parallel_cross_entropy),
                         ("dense", cross_entropy_per_example)):
            x = logits.clone().requires_grad_(True)
            loss = fn(x, labels)
            loss.sum().backward()
            ce[name] = (loss.detach(), x.grad)
        ref_loss, ref_grad = ce["dense"]
        loss_err = (ce["vocab_parallel"][0] - ref_loss).abs().max().item()
        grad_err = (ce["vocab_parallel"][1] - ref_grad).abs().max().item()
        model = port.TransformerLM(
            dtype=torch.bfloat16, device=device,
            attn_fn=tflash.make_flash_attn_fn(),
            generator=torch.Generator(device=device).manual_seed(0),
            **TRAIN)
        with torch.no_grad():
            x, y = tokens[:, :-1], tokens[:, 1:]
            fused = make_vocab_parallel_ce_fn(mesh)(
                model(x, return_hidden=True), model.head_weight(), y)
            dense = cross_entropy_per_example(model(x), y)
        # f32 logits against bf16-rounded ones: held on the mean loss,
        # where the rounding averages out
        model_err = abs(fused.mean().item() - dense.mean().item()) \
            / dense.mean().item()
        model_max_err = (fused - dense).abs().max().item()
        del model, logits, ce
        torch.cuda.empty_cache()
    finally:
        context.destroy_process_group()
    ref = train_losses[:1 + FSDP_TIMED_STEPS]
    for rec in arms.values():
        rec["max_rel_loss_diff_vs_train"] = max(
            abs(a - b) / abs(b) for a, b in zip(rec["losses"], ref))
    emit(phase="fsdp", card=torch.cuda.get_device_name(0), backend=backend,
         world=1, mesh=list(mesh.mesh_dim_names),
         config=dict(TRAIN, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                     dtype="bfloat16", optimizer=f"adamw({TRAIN_LR})"),
         warmup_steps=1, timed_steps=FSDP_TIMED_STEPS,
         train_step_ms=train_step_ms, train_losses=ref, arms=arms,
         vocab_parallel_ce=dict(shape=[TRAIN_BATCH, TRAIN_SEQ,
                                       TRAIN["vocab"]],
                                max_loss_err=loss_err, max_grad_err=grad_err,
                                model_mean_rel_err=model_err,
                                model_max_err=model_max_err,
                                tol=VP_CE_TOL))
    want = {k: TRAIN["n_layers"] for k in tflash.LAUNCHES}
    for name, rec in arms.items():
        ls = rec["losses"]
        if rec["launches_per_step"] != want:
            fail(f"fsdp {name}: launches per step "
                 f"{rec['launches_per_step']}, expected {want}")
        if not (np.all(np.isfinite(ls)) and ls[-1] < ls[0]):
            fail(f"fsdp {name}: losses {ls} not finite and falling")
        rel = rec["max_rel_loss_diff_vs_train"]
        if not rel <= FSDP_LOSS_RTOL:
            fail(f"fsdp {name}: losses {ls} vs train's {ref}: {rel} > "
                 f"{FSDP_LOSS_RTOL}")
    for name in ("zero1", "zero2", "zero3"):
        if arms[name]["state_types"] != ["DTensor"]:
            fail(f"fsdp {name}: optimizer state {arms[name]['state_types']}"
                 ", expected DTensors")
    ref_scale = max(1.0, ref_loss.abs().max().item())
    if not (loss_err <= VP_CE_TOL * ref_scale and grad_err <= VP_CE_TOL):
        fail(f"fsdp: vocab-parallel CE at tp=1 differs from the dense CE "
             f"by {loss_err} (loss) / {grad_err} (grad)")
    if not model_err <= 1e-3:
        fail(f"fsdp: make_vocab_parallel_ce_fn at tp=1: mean loss "
             f"{model_err} relative from the dense loss of the logits")
    return {name: rec["launches_per_step"] for name, rec in arms.items()}


FRONT_DOOR_TIMED_STEPS = 5
# the handoff chain's engine: 2 greedy requests of FLAGSHIP's vocabulary
# (prompt lengths whose prefill bucket, 1024, runs the flash kernel)
HANDOFF_PROMPTS, HANDOFF_NEW = (600, 1000), 8


def count_reshards(torch):
    """Wrap ``DTensor.redistribute`` and ``DTensor.full_tensor`` with
    counters; returns (counts, restore)."""
    from torch.distributed.tensor import DTensor
    counts = {"redistribute": 0, "full_tensor": 0}
    saved = {n: getattr(DTensor, n) for n in counts}

    def wrap(name, fn):
        def run(self, *a, **kw):
            counts[name] += 1
            return fn(self, *a, **kw)
        return run
    for n, fn in saved.items():
        setattr(DTensor, n, wrap(n, fn))

    def restore():
        for n, fn in saved.items():
            setattr(DTensor, n, fn)
    return counts, restore


def front_door_arm(torch, port, tflash, device, build, tokens, keep=False):
    """1 warm-up and FRONT_DOOR_TIMED_STEPS timed steps of FLAGSHIP
    (``train``'s seeded weights and batch) through the step that
    ``build(model) -> (step, state, batch)`` makes: what the phase prints
    about the arm, and with ``keep`` the model, step and state too."""
    # the previous arm's (and phase's) garbage is collected here, not
    # inside this arm's timed window
    gc.collect()
    torch.cuda.empty_cache()
    t_arm = time.perf_counter()
    model = port.TransformerLM(
        dtype=torch.bfloat16, device=device,
        attn_fn=tflash.make_flash_attn_fn(),
        generator=torch.Generator(device=device).manual_seed(0), **TRAIN)
    step, state0, batch = build(model, tokens)
    state = [state0]

    def run():
        out = step(model, state[0], batch)
        state[0] = out.opt_state
        return out.loss.reshape(-1)

    torch.cuda.synchronize()
    tflash.reset_launch_counts()
    losses = [run()]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses += [run() for _ in range(FRONT_DOOR_TIMED_STEPS)]
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / FRONT_DOOR_TIMED_STEPS * 1e3
    n = 1 + FRONT_DOOR_TIMED_STEPS
    per_step = {k: v / n for k, v in tflash.LAUNCHES.items()}
    t_busy = time.perf_counter()
    busy = device_busy_ms(torch, run)
    rec = dict(wall_s=time.perf_counter() - t_arm,
               profile_s=time.perf_counter() - t_busy,
               step_ms=step_ms, device_busy_ms=busy,
               device_busy_share=(busy / step_ms if busy else None),
               launches_per_step=per_step, trace_counts={
                   str(k): v for k, v in step.trace_counts.items()},
               losses=torch.cat(losses).float().tolist())
    if keep:
        return rec, (model, step, state[0])
    del model, state, step
    torch.cuda.empty_cache()
    return rec, None


def phase_front_door(torch, port, tflash, device, train_losses,
                     train_step_ms):
    """FLAGSHIP through ``front_door.make_step`` in a one-rank NCCL group:
    ``specs=None``, ZeRO-3/2/1 as ``StepSpecs``, ``weight_update=
    "sharded"`` and ``FROM_INPUTS`` (replicated DTensor parameters, the
    batch a DTensor over dp: the flash kernel on the local shards), each
    against ``train``'s losses; the builder cache; the train -> eval ->
    serve-admit handoff chain with its reshards counted; a mis-placed
    model refused. Returns each arm's flash launches per step."""
    from distributed_pytorch_tpu_torch.optim import adamw
    from distributed_pytorch_tpu_torch.parallel import (
        FROM_INPUTS, HandoffMismatch, StepSpecs, front_door, fsdp,
        handoff_shardings, make_step, shard_batch_spec, shard_params,
        verify_handoff)
    from distributed_pytorch_tpu_torch.parallel.tensor import (
        P, replicated_specs)
    from distributed_pytorch_tpu_torch.runtime import context, env
    from distributed_pytorch_tpu_torch.runtime.launcher import find_free_port
    from distributed_pytorch_tpu_torch.serve import (EngineConfig,
                                                     InferenceEngine,
                                                     SamplingParams)
    env.set("DPX_MASTER_PORT", find_free_port())
    context.init_process_group(0, 1)
    front_door.cache_clear()
    kept = {}
    try:
        mesh = context.init_mesh(dp=1)
        tokens = train_tokens(torch, 6, TRAIN_BATCH, device)

        def plain(**kw):
            def build(model, batch):
                opt = adamw(TRAIN_LR)
                step = make_step(lm_loss, opt, **kw)
                state = (step.init_opt_state(model)
                         if kw.get("weight_update") == "sharded"
                         else opt.init(model.parameters()))
                return step, state, batch
            return build

        def ladder(rung):
            def build(model, batch):
                opt = adamw(TRAIN_LR)
                p = fsdp.fsdp_param_specs(model, 1)
                rep = replicated_specs(model)
                specs = {"zero3": StepSpecs(params=p),
                         "zero2": StepSpecs(params=rep, opt=p, grads=p),
                         "zero1": StepSpecs(params=rep, opt=p,
                                            grads=rep)}[rung]
                step = make_step(lm_loss, opt, mesh=mesh, specs=specs)
                return step, opt.init(model.parameters()), batch
            return build

        def from_inputs(model, batch):
            shard_params(model, replicated_specs(model), mesh)
            opt = adamw(TRAIN_LR)
            step = make_step(lm_loss, opt, specs=FROM_INPUTS)
            return (step, opt.init(model.parameters()),
                    shard_batch_spec(batch, mesh, P("dp")))

        builds = {"dp": plain(), "zero3": ladder("zero3"),
                  "zero2": ladder("zero2"), "zero1": ladder("zero1"),
                  "sharded": plain(weight_update="sharded"),
                  "from_inputs": from_inputs}
        arms = {}
        for name, build in builds.items():
            arms[name], k = front_door_arm(torch, port, tflash, device,
                                           build, tokens,
                                           keep=name in ("dp", "zero3"))
            if k is not None:
                kept[name] = k

        # the builder cache: the same request, the same step, no build
        model, step, state = kept["dp"]
        before = step.compiles
        again = make_step(lm_loss, step.config[2])
        cache = dict(same_object=again is step,
                     compiles_before=before, compiles_after=again.compiles,
                     entries=len(front_door.cache_info()))

        # train -> eval -> serve admit, nothing resharded
        t_chain = time.perf_counter()
        counts, restore = count_reshards(torch)
        try:
            tflash.reset_launch_counts()
            p_sh = handoff_shardings(step)
            verify_handoff(model, p_sh)

            def nll(m, b):
                from distributed_pytorch_tpu_torch.ops.losses import \
                    cross_entropy_per_example
                return cross_entropy_per_example(m(b[:, :-1]),
                                                 b[:, 1:]).mean(-1)
            ev = front_door.make_eval_step(nll, like=step)
            t0 = time.perf_counter()
            ev_nll = ev(model, tokens)
            ev_nll = ev(model, tokens)
            torch.cuda.synchronize()
            eval_ms = (time.perf_counter() - t0) / 2 * 1e3
            eng = InferenceEngine(model, EngineConfig(
                n_slots=2, max_len=TRAIN["max_seq"], param_shardings=p_sh))
            rng = np.random.default_rng(21)
            with eng:
                handles = [eng.submit(
                    rng.integers(0, TRAIN["vocab"], (n,)).astype(np.int32),
                    SamplingParams(max_new_tokens=HANDOFF_NEW))
                    for n in HANDOFF_PROMPTS]
                streams = [len(h.result(timeout=300)) for h in handles]
            chain_launches = dict(tflash.LAUNCHES)
            refused = []
            misplaced = {n: p.detach().cpu()
                         for n, p in list(model.named_parameters())[:2]}
            try:
                verify_handoff(misplaced, p_sh)
            except HandoffMismatch as e:
                refused.append(("cpu_copy", e.path))
            # the ZeRO-3 consumer: its eval pinned to the step's tree
            z_model, z_step, _ = kept["zero3"]
            pinned = handoff_shardings(z_step)
            z_ev = front_door.make_eval_step(nll, like=z_step)
            z_nll = z_ev(z_model, tokens)
            try:
                InferenceEngine(model, EngineConfig(
                    n_slots=2, max_len=TRAIN["max_seq"],
                    param_shardings=pinned))
            except HandoffMismatch as e:
                refused.append(("plain_vs_zero3", e.path))
        finally:
            restore()
        chain = dict(
            param_shardings=str(p_sh), eval_ms=eval_ms,
            eval_traces=ev.trace_counts["n"],
            eval_shape=list(ev_nll.shape),
            eval_nll_mean=float(ev_nll.float().mean()),
            zero3_eval_nll_mean=float(z_nll.float().mean()),
            zero3_pinned_placements=sorted({str(s.placements)
                                            for s in pinned.values()}),
            zero3_eval_pinned_is=z_ev.in_shardings["params"] is pinned,
            streams=streams, launches=chain_launches,
            reshards=dict(counts), refused=refused,
            wall_s=time.perf_counter() - t_chain)
        del model, step, state, kept, z_model, z_step, eng
        torch.cuda.empty_cache()
    finally:
        front_door.cache_clear()
        context.destroy_process_group()
    ref = train_losses[:1 + FRONT_DOOR_TIMED_STEPS]
    for rec in arms.values():
        rec["max_rel_loss_diff_vs_train"] = max(
            abs(a - b) / abs(b) for a, b in zip(rec["losses"], ref))
    emit(phase="front_door", card=torch.cuda.get_device_name(0),
         world=1, backend="nccl",
         config=dict(TRAIN, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                     dtype="bfloat16", optimizer=f"adamw({TRAIN_LR})"),
         warmup_steps=1, timed_steps=FRONT_DOOR_TIMED_STEPS,
         train_step_ms=train_step_ms, train_losses=ref, arms=arms,
         cache=cache, chain=chain)
    want = {k: TRAIN["n_layers"] for k in tflash.LAUNCHES}
    for name, rec in arms.items():
        ls = rec["losses"]
        if rec["launches_per_step"] != want:
            fail(f"front_door {name}: launches per step "
                 f"{rec['launches_per_step']}, expected {want}")
        if not (np.all(np.isfinite(ls)) and ls[-1] < ls[0]):
            fail(f"front_door {name}: losses {ls} not finite and falling")
        if not rec["max_rel_loss_diff_vs_train"] <= FSDP_LOSS_RTOL:
            fail(f"front_door {name}: losses {ls} vs train's {ref}")
        if list(rec["trace_counts"].values()) != [1]:
            fail(f"front_door {name}: builds {rec['trace_counts']}")
    if not (cache["same_object"]
            and cache["compiles_after"] == cache["compiles_before"] == 1):
        fail(f"front_door: builder cache {cache}")
    # two eval forwards and one prefill per request
    fwd = TRAIN["n_layers"] * (2 + len(HANDOFF_PROMPTS))
    if chain["reshards"] != {"redistribute": 0, "full_tensor": 0}:
        fail(f"front_door: the handoff chain resharded: {chain['reshards']}")
    if (chain["streams"] != [HANDOFF_NEW] * len(HANDOFF_PROMPTS)
            or chain["eval_shape"] != [TRAIN_BATCH]
            or chain["eval_traces"] != 1
            or not chain["zero3_eval_pinned_is"]
            or [k for k, _ in refused] != ["cpu_copy", "plain_vs_zero3"]
            or chain_launches.get("flash_attention_fwd") != fwd
            or not np.isfinite(chain["eval_nll_mean"])
            or abs(chain["zero3_eval_nll_mean"] - chain["eval_nll_mean"])
            > 0.05 * chain["eval_nll_mean"]):
        fail(f"front_door: handoff chain {chain}")
    return {name: rec["launches_per_step"] for name, rec in arms.items()}


def phase_ckpt_sharded(torch, port, device):
    """FLAGSHIP's parameters and adamw state (after two ``train``-shaped
    steps) saved as format 2 by one writer at ``dp = 4``
    (``CheckpointManager(sharded=True)``, async), restored whole into a
    fresh model and state, and read at ``dp = 2`` rank 0 (a ``Target``):
    blocking and write seconds, bytes, shards, restore seconds, bytes
    read, every CRC checked, bit-for-bit equality."""
    from distributed_pytorch_tpu_torch.ckpt import (CheckpointManager,
                                                    ReadStats, Target,
                                                    restore_sharded)
    from distributed_pytorch_tpu_torch.ckpt.manager import \
        jax_opt_state_specs
    from distributed_pytorch_tpu_torch.optim import adamw
    from distributed_pytorch_tpu_torch.parallel import fsdp, make_train_step
    from distributed_pytorch_tpu_torch.utils import checkpoint as tck

    def build(seed):
        return port.TransformerLM(
            dtype=torch.bfloat16, device=device,
            generator=torch.Generator(device=device).manual_seed(seed),
            **TRAIN)

    model = build(0)
    opt = adamw(TRAIN_LR)
    step = make_train_step(lm_loss, opt)
    state = opt.init(model.parameters())
    tokens = train_tokens(torch, 6, 2, device)
    for _ in range(2):
        state = step(model, state, tokens).opt_state
    torch.cuda.synchronize()
    tmp = tempfile.mkdtemp(prefix="ckpt_sharded_")
    ck = os.path.join(tmp, "ck")
    try:
        p_specs = fsdp.fsdp_param_specs(model, 4)
        mgr = CheckpointManager(ck, sharded=True, param_specs=p_specs,
                                axis_sizes={"dp": 4}, async_save=True)
        t0 = time.perf_counter()
        mgr.save(2, model, state)
        save_call_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        mgr.wait()
        wait_s = time.perf_counter() - t0
        saved = mgr.saves[-1]
        with open(os.path.join(ck, "step_2", "manifest.json")) as f:
            man = json.load(f)
        n_members = sum(len(lf["shards"]) for t in man["trees"].values()
                        for lf in t["leaves"])
        disk = sum(os.path.getsize(os.path.join(ck, "step_2", n))
                   for n in os.listdir(os.path.join(ck, "step_2")))
        fresh = build(1)
        like = opt.init(fresh.parameters())
        full = ReadStats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = restore_sharded(ck, like_params=fresh, like_opt_state=like,
                              stats=full)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        equal = (all(torch.equal(a, b) for a, b in
                     zip(fresh.parameters(), model.parameters()))
                 and got.opt_state.step == state.step
                 and all(torch.equal(a, b) for a, b in
                         zip(got.opt_state.mu + got.opt_state.nu,
                             state.mu + state.nu)))
        p_tree = tck.jax_params(model, tck._meta)
        p2 = fsdp.fsdp_param_specs(model, 2)
        o2 = jax_opt_state_specs(tck.jax_opt_state(state, model, tck._meta),
                                 p2, p_tree)
        half = ReadStats()
        t0 = time.perf_counter()
        restore_sharded(ck, stats=half, target=Target(
            specs={"params": p2, "opt_state": o2}, axis_sizes={"dp": 2},
            coords={"dp": 0}))
        half_s = time.perf_counter() - t0
        del fresh, like, got
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    n_params = sum(p.numel() for p in model.parameters())
    del model, state, step
    torch.cuda.empty_cache()
    rec = dict(card=torch.cuda.get_device_name(0),
               config=dict(TRAIN, dtype="bfloat16",
                           optimizer=f"adamw({TRAIN_LR})"),
               n_params=n_params, axes={"dp": 4}, writer_world=1,
               save_call_s=save_call_s, snapshot_s=saved["snapshot_s"],
               write_s=saved["duration_s"], wait_s=wait_s,
               bytes=saved["bytes"], shards=saved["shards"],
               moved_bytes=saved["moved_bytes"], disk_bytes=disk,
               restore_s=restore_s, restore_bytes=full.bytes,
               restore_members=full.members,
               crc_verified=full.members == n_members,
               bit_equal=equal, dp2_rank0_s=half_s,
               dp2_rank0_bytes=half.bytes,
               dp2_rank0_share=half.bytes / full.bytes)
    emit(phase="ckpt_sharded", **rec)
    if not (equal and rec["crc_verified"] and saved["shards"] == n_members
            and full.bytes == saved["bytes"]
            and 0.45 <= rec["dp2_rank0_share"] <= 0.55
            and saved["moved_bytes"] == 0):
        fail(f"ckpt_sharded: {rec}")


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


# the host door: FLAGSHIP through a "host" group at world 1 on the card,
# in every gradient-wire arm; then the native ring between two ranks
HOST_TIMED_STEPS = 3
# (arm, make_train_step keywords)
HOST_ARMS = [("mean", dict(grad_reduce="mean")),
             ("quant", dict(grad_reduce="quant")),
             ("q4", dict(grad_reduce="q4")),
             ("adaptive", dict(grad_reduce="adaptive")),
             ("overlap_quant", dict(grad_reduce="quant", overlap=True,
                                    comm_buckets=4)),
             ("sharded_mean", dict(weight_update="sharded")),
             ("sharded_quant", dict(grad_reduce="quant",
                                    weight_update="sharded"))]
HOST_RING_TIMEOUT_S = 600
HOST_RING_PARITY_N = 1 << 20


def host_arm(torch, port, tflash, device, kw, config, tokens, steps):
    """``steps`` steps (the first a warm-up) of one host-door arm on a
    fresh seeded model; what the phase prints about it, and the model."""
    from distributed_pytorch_tpu_torch.optim import adamw
    from distributed_pytorch_tpu_torch.parallel import make_train_step
    from distributed_pytorch_tpu_torch.runtime import context
    comm = context.get_host_comm()
    model = port.TransformerLM(
        dtype=torch.bfloat16, device=device,
        attn_fn=tflash.make_flash_attn_fn(),
        generator=torch.Generator(device=device).manual_seed(0), **config)
    opt = adamw(TRAIN_LR)
    step = make_train_step(lm_loss, opt, **kw)
    state = (step.init_opt_state(model.parameters())
             if hasattr(step, "init_opt_state")
             else opt.init(model.parameters()))
    tflash.reset_launch_counts()
    losses = []
    for i in range(steps):
        if i == 1:
            if device.type == "cuda":
                torch.cuda.synchronize()
            comm.stats.reset()
            host0 = dict(step.host_times)
            t0 = time.perf_counter()
        out = step(model, state, tokens)
        state = out.opt_state
        losses.append(out.loss)
    if device.type == "cuda":
        torch.cuda.synchronize()
    timed = steps - 1
    step_ms = (time.perf_counter() - t0) / timed * 1e3
    chooser = getattr(step, "width_chooser", None)
    stats = comm.stats.summary()
    rec = dict(
        step_ms=step_ms,
        host_ms_per_step={k.replace("_s", "_ms"): (v - host0[k]) / timed
                          * 1e3 for k, v in step.host_times.items()},
        comm_bytes_per_step={op: d["bytes"] / timed
                             for op, d in stats.items()},
        comm_calls_per_step={op: d["calls"] / timed
                             for op, d in stats.items()},
        exposed_s=sum(d["exposed_s"] for d in stats.values()),
        overlapped_s=sum(d["overlapped_s"] for d in stats.values()),
        launches_per_step={k: v / steps for k, v in tflash.LAUNCHES.items()},
        losses=torch.cat(losses).float().tolist(),
        widths=list(chooser.widths) if chooser is not None else None)
    return rec, model


def phase_host_ddp(torch, port, tflash, device, train_step_ms):
    """FLAGSHIP trained through a ``"host"`` group (the native ring of
    ``native/dpxhost.cpp``) at world 1 on ``device``, in every arm of
    HOST_ARMS: each moves the whole gradient bucket to the host and back,
    the quantized arms through ErrorFeedback's grid. Returns each arm's
    flash launches per step."""
    from distributed_pytorch_tpu_torch.runtime import context, env
    from distributed_pytorch_tpu_torch.runtime.launcher import find_free_port
    config, batch, steps = TRAIN, TRAIN_BATCH, 1 + HOST_TIMED_STEPS
    # rank 0 of a 1-rank host group on the card (no socket at world 1)
    env.set("DPX_MASTER_PORT", find_free_port())
    context.init_process_group(0, 1, backend="host")
    try:
        tokens = train_tokens(torch, 6, batch, device)
        arms, launches, ref = {}, {}, None
        for name, kw in HOST_ARMS:
            rec, model = host_arm(torch, port, tflash, device, kw, config,
                                  tokens, steps)
            n_params = sum(p.numel() for p in model.parameters())
            if name == "mean":
                ref = [p.detach().clone() for p in model.parameters()]
            if name == "sharded_mean":
                rec["params_equal_replicated_mean"] = all(
                    torch.equal(a, b.detach())
                    for a, b in zip(ref, model.parameters()))
            arms[name] = rec
            launches[name] = rec["launches_per_step"]
            del model
            if device.type == "cuda":
                torch.cuda.empty_cache()
    finally:
        context.destroy_process_group()
    emit(phase="host_ddp", card=torch.cuda.get_device_name(0),
         config=dict(config, batch=batch, seq=TRAIN_SEQ, dtype="bfloat16",
                     optimizer=f"adamw({TRAIN_LR})"),
         backend="host", world=1, device=str(device), bucket_elems=n_params,
         bucket_bytes_f32=4 * n_params, warmup_steps=1,
         timed_steps=steps - 1, train_step_ms=train_step_ms, arms=arms)
    want = {k: config["n_layers"] for k in tflash.LAUNCHES}
    for name, rec in arms.items():
        if rec["launches_per_step"] != want:
            fail(f"host_ddp {name}: launches per step "
                 f"{rec['launches_per_step']}, expected {want}")
        ls = rec["losses"]
        if not (np.all(np.isfinite(ls)) and ls[-1] < ls[0]):
            fail(f"host_ddp {name}: losses {ls} not finite and falling")
    if not arms["sharded_mean"]["params_equal_replicated_mean"]:
        fail("host_ddp: sharded mean params differ from the replicated "
             "mean's")
    if arms["adaptive"]["widths"] is None or \
            len(arms["adaptive"]["widths"]) != steps:
        fail(f"host_ddp adaptive: widths {arms['adaptive']['widths']}")
    for name in ("quant", "q4", "adaptive", "overlap_quant"):
        if arms[name]["host_ms_per_step"]["codec_ms"] <= 0:
            fail(f"host_ddp {name}: no codec time on the host")
    return launches


def phase_host_ring():
    """examples/host_ring.py: two CPU rank processes over the port's
    HostComm on one FLAGSHIP-sized bucket; per op wall ms and wire bytes
    beside comm/wire.py's formulas, results equal on both ranks, the
    quantized rings at parity_n equal to simulate_quant_ring, and one
    ~94 MB handoff frame through HostCommTransport."""
    from distributed_pytorch_tpu_torch.comm import wire
    from distributed_pytorch_tpu_torch.examples import host_ring
    from distributed_pytorch_tpu_torch.runtime.multiprocess import \
        launch_multiprocess
    n, parity_n = host_ring.FLAGSHIP_PARAMS, HOST_RING_PARITY_N
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        launch_multiprocess(host_ring.main_worker, 2, n, d, parity_n,
                            device="cpu", backend="host",
                            timeout_s=HOST_RING_TIMEOUT_S)
        wall = time.perf_counter() - t0
        recs = [read_json(os.path.join(d, f"rank{r}.json"))
                for r in range(2)]
    xs = [host_ring.rank_bucket(r, parity_n, salt=1) for r in range(2)]
    parity = {f"q{b}": recs[0]["parity"][f"q{b}"] == recs[1]["parity"][
        f"q{b}"] == host_ring.sha(wire.simulate_quant_ring(xs, bits=b)[0][0])
        for b in (8, 4)}
    frame, kv = host_ring.handoff_frame()
    want_sha = host_ring.sha(np.frombuffer(frame, np.uint8))
    ops = recs[0]["ops"]
    checks = {
        "equal_on_both_ranks": all(
            ops[k]["sha256"] == recs[1]["ops"][k]["sha256"] for k in ops),
        "bytes_equal_formulas": all(
            r["ops"][k]["wire_bytes"] == r["ops"][k]["formula_bytes"]
            for r in recs for k in ops),
        "legs_compose_to_the_q8_ring": ops["allreduce_q8"]["sha256"]
        == ops["reduce_scatter_q8+allgather_q8"]["sha256"],
        "parity_q8": parity["q8"], "parity_q4": parity["q4"],
        "handoff_frame": recs[0]["handoff"]["sha256"] == want_sha
        and recs[1]["handoff"]["booked"] == kv}
    emit(phase="host_ring", backend="host", world=2, device="cpu",
         bucket_elems=n, parity_elems=parity_n, wall_s=wall,
         ops={k: {f"rank{r}_{f}": recs[r]["ops"][k][f] for r in range(2)
                  for f in ("wall_ms", "wire_bytes")}
              | {"formula_bytes": v["formula_bytes"]}
              for k, v in ops.items()},
         reduce_scatter_q8_ms=[r["reduce_scatter_q8_ms"] for r in recs],
         allgather_q8_ms=[r["allgather_q8_ms"] for r in recs],
         handoff=dict(recs[1]["handoff"], recv_ms=recs[0]["handoff"][
             "recv_ms"]), checks=checks)
    if not all(checks.values()):
        fail(f"host_ring: {[k for k, ok in checks.items() if not ok]} "
             f"failed")


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


# the trainer's FLAGSHIP-width flags; the byte corpus is the card
# machine's standard library (real text, nothing downloaded)
LM_TRAINER = ["--device", "cuda", "--dim", "768", "--n-layers", "12",
              "--n-heads", "12", "--seq-len", "1024", "--batch-size", "8",
              "--bf16", "--flash", "--log-every", "5"]
LM_TRAINER_RUN = ["--prefetch", "2", "--eval", "--generate", "16"]


def phase_lm_trainer(torch, tflash, device, train_step_ms):
    """``train_transformer_lm.main_worker`` at world 1: save at 10 steps,
    resume to 15, against 15 uninterrupted steps; then a traced run; then
    the same save / resume pair with ``--sharded-ckpt``."""
    from distributed_pytorch_tpu_torch.examples import train_transformer_lm
    tmp = tempfile.mkdtemp(prefix="lm_trainer_")
    ck = os.path.join(tmp, "ck")
    base = LM_TRAINER + ["--text", sysconfig.get_paths()["stdlib"]]

    def run(tag, extra):
        t0 = time.perf_counter()
        rec = train_transformer_lm.main_worker(
            0, 1, base + extra + ["--log", os.path.join(tmp, tag)],
            quiet=True)
        rec["wall_s"] = time.perf_counter() - t0
        torch.cuda.empty_cache()
        return rec

    try:
        r1 = run("run1", LM_TRAINER_RUN + ["--steps", "10", "--save", ck,
                                           "--save-every", "5"])
        r2 = run("run2", LM_TRAINER_RUN + ["--steps", "15", "--save", ck,
                                           "--resume"])
        tflash.reset_launch_counts()
        r3 = run("run3", LM_TRAINER_RUN + ["--steps", "15"])
        launches = dict(tflash.LAUNCHES)
        r4 = run("run4", ["--steps", "11", "--trace",
                          os.path.join(tmp, "trace")])
        sck = os.path.join(tmp, "sck")
        r5 = run("run5", LM_TRAINER_RUN + ["--steps", "10", "--save", sck,
                                           "--save-every", "5",
                                           "--sharded-ckpt"])
        r6 = run("run6", LM_TRAINER_RUN + ["--steps", "15", "--save", sck,
                                           "--resume", "--sharded-ckpt"])
        with open(r4["trace_path"]) as f:
            events = json.load(f)["traceEvents"]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    busy_ms = sum(e.get("dur", 0) for e in events
                  if e.get("cat") == "kernel") / 1e3 / r4["trace_steps"]
    steps = 15
    eval_batches = r3["eval_batches"]
    per_step = {"flash_attention_fwd":
                (launches["flash_attention_fwd"] - 12 * eval_batches) / steps,
                "flash_attention_bwd_dkv":
                launches["flash_attention_bwd_dkv"] / steps,
                "flash_attention_bwd_dq":
                launches["flash_attention_bwd_dq"] / steps}
    step_ms = r3["timed_s"] / r3["timed_steps"] * 1e3
    tokens_per_step = 8 * 1024
    flops = 3 * model_flops_per_token(768, 12, 256, 1024) * tokens_per_step
    peak_flops, _ = peaks(torch.cuda.get_device_name(0))
    resumed, uninterrupted = r2["losses"], r3["losses"][10:15]
    gen = bytes(r3["generated"]).decode(errors="replace")
    saves = r1["ckpt_saves"]
    s_saves = r5["ckpt_saves"]
    sharded_resumed = r6["losses"]
    emit(phase="lm_trainer", card=torch.cuda.get_device_name(0),
         argv=base + LM_TRAINER_RUN, train_windows=len(r3["losses"]),
         step_ms=step_ms, timed_steps=r3["timed_steps"],
         train_step_ms=train_step_ms,
         tokens_per_sec=tokens_per_step / step_ms * 1e3,
         mfu=flops / (step_ms / 1e3) / peak_flops, flops_per_step=flops,
         device_busy_ms_per_step=busy_ms,
         device_idle_share=max(0.0, 1 - busy_ms / step_ms),
         traced_steps=r4["trace_steps"], launches=launches,
         launches_per_step=per_step, eval_batches=eval_batches,
         losses_run1=r1["losses"], losses_run2=resumed,
         losses_run3=r3["losses"], resume_start_step=r2["start_step"],
         resume_max_abs_diff=max(abs(a - b) for a, b in
                                 zip(resumed, uninterrupted)),
         save_call_s=r1["save_call_s"],
         save_write_s=[x["duration_s"] for x in saves],
         save_snapshot_s=[x["snapshot_s"] for x in saves],
         checkpoint_bytes=saves[-1]["bytes"], restore_s=r2["restore_s"],
         prefetch_worker_ms_per_batch=r3["prefetch_worker_ms_per_batch"],
         prefetch_wait_ms_per_batch=r3["data_ms_per_batch"],
         unprefetched_ms_per_batch=r4["data_ms_per_batch"],
         eval_nll=r3["eval_nll"], generated=gen,
         sharded=dict(losses_run5=r5["losses"],
                      losses_run6=sharded_resumed,
                      resume_start_step=r6["start_step"],
                      resume_max_abs_diff=max(
                          abs(a - b) for a, b in zip(sharded_resumed,
                                                     uninterrupted)),
                      save_call_s=r5["save_call_s"],
                      save_write_s=[x["duration_s"] for x in s_saves],
                      save_snapshot_s=[x["snapshot_s"] for x in s_saves],
                      checkpoint_bytes=s_saves[-1]["bytes"],
                      shards=s_saves[-1]["shards"],
                      restore_s=r6["restore_s"]),
         wall_s=[r["wall_s"] for r in (r1, r2, r3, r4, r5, r6)])
    if any(n != 12 for n in per_step.values()):
        fail(f"lm_trainer: launches per step {per_step}")
    if r2["start_step"] != 10 or resumed != uninterrupted:
        fail(f"lm_trainer: resumed losses {resumed} vs uninterrupted "
             f"{uninterrupted}")
    if (r6["start_step"] != 10 or sharded_resumed != uninterrupted
            or r5["losses"] != r3["losses"][:10] or len(s_saves) != 3):
        fail(f"lm_trainer --sharded-ckpt: run 5 {r5['losses']}, resumed "
             f"{sharded_resumed} vs uninterrupted {uninterrupted}, saves "
             f"{s_saves}")
    if not (np.all(np.isfinite(r1["losses"] + r3["losses"]))
            and np.isfinite(r3["eval_nll"])
            and len(r3["generated"]) == 16 and r1["losses"] == r3["losses"][:10]
            and len(saves) == 3 and saves[-1]["bytes"] > 0):
        fail(f"lm_trainer: run 1 {r1['losses']} run 3 {r3['losses']} "
             f"eval {r3.get('eval_nll')} saves {saves}")
    return per_step


SYSTEM_PROMPT, PAGED_TAILS = 1024, (32, 64, 96, 128, 160, 192, 224, 256)


def paged_traffic():
    """The serve_paged traffic: one shared 1024-token system prompt and
    eight distinct tails, as (S,) int32 prompts, and the generator that
    made them (it goes on to draw the warm-up prompts)."""
    rng = np.random.default_rng(5)
    system = rng.integers(0, FLAGSHIP["vocab"], SYSTEM_PROMPT)
    return [np.concatenate([system, rng.integers(
        0, FLAGSHIP["vocab"], n)]).astype(np.int32)
        for n in PAGED_TAILS], rng


def phase_serve_paged(torch, model):
    """The serve phase's model behind the paged engine: a shared system
    prompt, eight tails, greedy; against the contiguous engine."""
    from distributed_pytorch_tpu_torch.models.generate import \
        decode_step_slots
    from distributed_pytorch_tpu_torch.serve import (EngineConfig,
                                                     InferenceEngine,
                                                     SamplingParams,
                                                     aggregate)
    from distributed_pytorch_tpu_torch.serve.cache import SlotPool
    from distributed_pytorch_tpu_torch.serve.pages import PagedSlotPool
    prompts, rng = paged_traffic()
    sp = SamplingParams(max_new_tokens=MAX_NEW)

    def serve(paged):
        cfg = EngineConfig(n_slots=4, max_len=2048, paged=paged)
        with InferenceEngine(model, cfg) as eng:   # warm-up, not measured
            eng.submit(rng.integers(0, FLAGSHIP["vocab"], 300),
                       SamplingParams(max_new_tokens=2)).result(timeout=900)
        eng = InferenceEngine(model, cfg)
        peak = [0]

        def watch(tok, i):
            if paged:
                peak[0] = max(peak[0], eng.pool.pool.pages_in_use)
        t0 = time.perf_counter()
        with eng:
            hs = [eng.submit(p, sp, on_token=watch) for p in prompts]
            outs = [h.result(timeout=900) for h in hs]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        return eng, hs, outs, wall, peak[0]

    eng, hs, outs, wall, peak = serve(True)
    ceng, chs, couts, cwall, _ = serve(False)
    agg = aggregate([h.metrics for h in hs], wall_s=wall)
    cagg = aggregate([h.metrics for h in chs], wall_s=cwall)
    ps = eng.stats()["pages"]
    pool = eng.pool.pool
    live_after = pool.live_pages()
    resident = pool.pages_in_use
    while (pid := eng.pool.index.evict_lru(pool)) is not None:
        pool.reclaim(pid)
        pool.release_to_free(pid)
    free_after_drain = pool.free_pages
    same = [bool(np.array_equal(a, b)) for a, b in zip(outs, couts)]
    first_diff = [None if ok else int(np.argmax(a != b))
                  for ok, a, b in zip(same, outs, couts)]

    # one 4-slot decode step of each pool, after four admissions
    buckets = eng.buckets
    ppool = PagedSlotPool(model, 4, 2048, page_len=ps["page_len"],
                          n_pages=ps["n_pages"])
    cpool = SlotPool(model, 4, 2048)
    toks = torch.zeros(4, dtype=torch.long, device=model.device)
    active = np.ones(4, bool)
    with torch.inference_mode():
        for slot, p in enumerate(prompts[:4]):
            ppool.admit(p, slot, buckets)
            padded = torch.zeros((1, 2048), dtype=torch.long,
                                 device=model.device)
            padded[0, :len(p)] = torch.from_numpy(p.astype(np.int64))
            cpool.admit(padded[:, :2048], len(p), slot)

        def paged_step():
            for slot in range(4):
                ppool.ensure_decode_capacity(slot)
            ppool.decode(toks, active)

        def contiguous_step():
            decode_step_slots(model, cpool.ks, cpool.vs, cpool.lengths,
                              toks)

        steps = {label: step_times(torch, fn) for label, fn in (
            ("paged", paged_step), ("contiguous", contiguous_step))}
    del ppool, cpool
    torch.cuda.empty_cache()
    emit(phase="serve_paged", card=torch.cuda.get_device_name(0),
         system_prompt=SYSTEM_PROMPT, tails=list(PAGED_TAILS),
         max_new=MAX_NEW, streams_equal_contiguous=same,
         first_differing_token=first_diff,
         ttft_ms_p50=agg["ttft_ms_p50"], ttft_ms_p99=agg["ttft_ms_p99"],
         tpot_ms_p50=agg["tpot_ms_p50"], tpot_ms_p99=agg["tpot_ms_p99"],
         tokens_per_sec=agg["tokens_per_sec"], wall_s=wall,
         contiguous=dict(ttft_ms_p50=cagg["ttft_ms_p50"],
                         ttft_ms_p99=cagg["ttft_ms_p99"],
                         tpot_ms_p50=cagg["tpot_ms_p50"],
                         tpot_ms_p99=cagg["tpot_ms_p99"],
                         tokens_per_sec=cagg["tokens_per_sec"],
                         wall_s=cwall),
         prefix_hit_pages=[h.metrics["prefix_hit_pages"] for h in hs],
         prefill_tokens_saved=ps["prefill_tokens_saved"],
         prefix_hit_rate=ps["prefix_hit_rate"], peak_pages_in_use=peak,
         n_pages=ps["n_pages"], page_len=ps["page_len"],
         kv_pool_bytes=ps["kv_pool_bytes"],
         bytes_per_resident_token=ps["bytes_per_resident_token"],
         live_pages_after=live_after, resident_pages_after=resident,
         free_pages_after_index_drain=free_after_drain,
         prefill_admits=eng.stats()["prefill_admits"],
         decode_step_4slots=steps)
    if not all(same):
        fail(f"serve_paged: streams differ from the contiguous engine "
             f"({same})")
    if not (ps["prefix_hit_rate"] or 0) > 0:
        fail(f"serve_paged: no prefix hits {ps}")
    if live_after != 0 or free_after_drain != ps["n_pages"]:
        fail(f"serve_paged: {live_after} live pages after retirement, "
             f"{free_after_drain} of {ps['n_pages']} free after draining "
             "the index")
    return outs, {k: agg[k] for k in ("ttft_ms_p50", "ttft_ms_p99",
                                      "tpot_ms_p50", "tpot_ms_p99")}


def run_engine(torch, tflash, model, cfg, prompts, sps, gens=None):
    """One warm-up request (not measured), then ``prompts`` through a
    fresh engine of ``cfg``, the flash launch count set to 0 just before
    and read just after. Returns the engine, handles, streams, wall
    seconds, host seconds inside the decode loop (``_decode_all``: the
    batched decode and, speculating, propose + verify + commit), peak
    pages in use and flash launches."""
    from distributed_pytorch_tpu_torch.serve import (InferenceEngine,
                                                     SamplingParams)
    with InferenceEngine(model, cfg) as eng:
        eng.submit(prompts[0][:300], SamplingParams(max_new_tokens=2)
                   ).result(timeout=900)
    eng = InferenceEngine(model, cfg)
    peak, decode_s = [0], [0.0]
    inner = eng._decode_all

    def timed_decode():
        t = time.perf_counter()
        inner()
        decode_s[0] += time.perf_counter() - t
    eng._decode_all = timed_decode

    def watch(tok, i):
        if cfg.paged:
            peak[0] = max(peak[0], eng.pool.pool.pages_in_use)
    tflash.reset_launch_counts()
    t0 = time.perf_counter()
    with eng:
        hs = [eng.submit(p, sp, on_token=watch,
                         generator=None if gens is None else gens[i])
              for i, (p, sp) in enumerate(zip(prompts, sps))]
        outs = [h.result(timeout=900) for h in hs]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return dict(eng=eng, handles=hs, outs=outs, wall=wall,
                decode_s=decode_s[0], peak=peak[0],
                launches=tflash.LAUNCHES["flash_attention_fwd"])


def slo(torch, run) -> dict:
    from distributed_pytorch_tpu_torch.serve import aggregate
    agg = aggregate([h.metrics for h in run["handles"]], wall_s=run["wall"])
    return {k: agg[k] for k in ("ttft_ms_p50", "ttft_ms_p99", "tpot_ms_p50",
                                "tpot_ms_p99", "tokens_per_sec")}


def step_times(torch, fn) -> dict:
    """Median host ms of 5 calls ending in a synchronize, and the
    device-busy ms of one (torch.profiler)."""
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(5):
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t) * 1e3)
    wall_ms = sorted(ts)[2]
    busy = device_busy_ms(torch, fn)
    return dict(wall_ms=wall_ms, device_busy_ms=busy,
                device_idle_share=(None if busy is None
                                   else max(0.0, 1 - busy / wall_ms)))


KVQ_WIDTHS = ("f32", "q8", "q4")
PAGE_LEN, N_PAGES = 16, 512
# scale/2 plus the codec's own float32 rounding: the quantize multiplies
# by fl(levels / amax), not by 1 / fl(amax / levels) (at most 2^-23
# apart, relative), and the product and the dequantized value round once
# each (2^-24 each): at most 127 x 2^-22 of a scale, 127 x 2^-21 of
# scale/2
HALF_SCALE_SLACK = 127 * 2.0 ** -21


def kvq_arithmetic(n_slots=4, page_len=PAGE_LEN):
    """Bytes per resident token of each width and the f32 tails beside a
    quantized pool, by FLAGSHIP's shapes: 12 layers x K,V x 768 x 2 B at
    bf16; a page of 12 heads x 16 x 64 = 12 blocks of 1024, one f32 scale
    each per tensor; four slots of one f32 page per layer and tensor."""
    layers, dim = FLAGSHIP["n_layers"], FLAGSHIP["dim"]
    elems = dim * page_len
    scales = 4 * -(-elems // 1024)
    return ({"f32": layers * 2 * dim * 2,
             "q8": layers * 2 * (elems + scales) / page_len,
             "q4": layers * 2 * (elems // 2 + scales) / page_len},
            n_slots * layers * 2 * elems * 4)


def dequant_pages(torch, pool, layer, ids):
    """K and V of pool pages ``ids`` of ``layer`` as float32, and the
    per-element scale/2 of a quantized pool (None for an exact one)."""
    from distributed_pytorch_tpu_torch.ops.quant import (
        dequantize_page_blocks, page_block_map, unpack_page_nibbles)
    if pool.quant_bits is None:
        return ([pool.k_pages[layer][ids].float(),
                 pool.v_pages[layer][ids].float()], None)
    dh = FLAGSHIP["dim"] // FLAGSHIP["n_heads"]
    bmap = page_block_map(FLAGSHIP["n_heads"], pool.page_len, dh,
                          device=ids.device)
    out, half = [], []
    for pages, scales in ((pool.k_pages[layer], pool.k_scales[layer]),
                          (pool.v_pages[layer], pool.v_scales[layer])):
        q = pages[ids]
        if pool.quant_bits == 4:
            q = unpack_page_nibbles(q)
        out.append(dequantize_page_blocks(q, scales[ids], bmap))
        half.append(scales[ids][..., bmap] / 2)
    return out, half


def phase_serve_kvq(torch, tflash, model, paged_outs):
    """serve_paged's traffic on the paged pool at f32, q8 and q4."""
    from distributed_pytorch_tpu_torch.serve import (EngineConfig,
                                                     SamplingParams)
    from distributed_pytorch_tpu_torch.serve.pages import PagedSlotPool
    prompts, _ = paged_traffic()
    sps = [SamplingParams(max_new_tokens=MAX_NEW)] * len(prompts)
    runs = {kv: run_engine(torch, tflash, model, EngineConfig(
        n_slots=4, max_len=2048, paged=True, page_len=PAGE_LEN,
        n_pages=N_PAGES, kv_dtype=kv), prompts, sps) for kv in KVQ_WIDTHS}
    ref = runs["f32"]["outs"]
    f32_same = [bool(np.array_equal(a, b)) for a, b in zip(ref, paged_outs)]
    n_layers = FLAGSHIP["n_layers"]
    want_bpt, want_tails = kvq_arithmetic()
    rec = {}
    # the pages the cold admission (request 0: the system prompt and its
    # tail) completed: both pools computed them from the same values
    full = len(prompts[0]) // PAGE_LEN
    fpool = runs["f32"]["eng"].pool
    cold_ids = fpool.index.match(prompts[0], full, fpool.pool)
    for kv, run in runs.items():
        pool, st = run["eng"].pool, run["eng"].stats()
        ps = st["pages"]
        r = dict(slo(torch, run), peak_pages_in_use=run["peak"],
                 flash_launches=run["launches"],
                 admits=sum(st["prefill_admits"].values()),
                 bytes_per_resident_token=ps["bytes_per_resident_token"],
                 kv_pool_bytes=ps["kv_pool_bytes"], kv_bits=ps["kv_bits"],
                 cold_first_token=int(run["outs"][0][0]),
                 greedy_divergence_rate=float(np.mean(
                     [a != b for x, y in zip(run["outs"], ref)
                      for a, b in zip(x, y)])),
                 streams_equal_f32=[bool(np.array_equal(a, b))
                                    for a, b in zip(run["outs"], ref)])
        if pool.quant_bits is not None:
            r["tails_bytes"] = (ps["kv_pool_bytes"]
                                - ps["bytes_per_resident_token"]
                                * N_PAGES * PAGE_LEN)
            ids = pool.index.match(prompts[0], full, pool.pool)
            indexed = [p for p, f in enumerate(pool.pool.indexed) if f]
            warm = torch.as_tensor(sorted(set(indexed) - set(ids)),
                                   device=model.device)
            ids_t = torch.as_tensor(ids, device=model.device)
            ratio = {"cold": 0.0, "warm": 0.0}
            for layer in range(n_layers):
                for which, ids_x in (("cold", ids_t), ("warm", warm)):
                    if not ids_x.numel():
                        continue
                    exact = dequant_pages(torch, fpool, layer, ids_x)[0]
                    got, half = dequant_pages(torch, pool, layer, ids_x)
                    for e, g, h in zip(exact, got, half):
                        ratio[which] = max(ratio[which], float(
                            ((g - e).abs() / h).max()))
            r.update(same_cold_pages=ids == cold_ids,
                     resident_cold_pages=len(ids),
                     resident_warm_pages=int(warm.numel()),
                     cold_max_err_over_half_scale=ratio["cold"],
                     warm_max_err_over_half_scale=ratio["warm"])
        rec[kv] = r

    # one 4-slot decode step of each width after the same four admits:
    # the logits' distance from the exact pool's, and the step's times
    pools = {kv: PagedSlotPool(model, 4, 2048, page_len=PAGE_LEN,
                               n_pages=N_PAGES, kv_dtype=kv)
             for kv in KVQ_WIDTHS}
    active = np.ones(4, bool)
    step = {}
    with torch.inference_mode():
        first = None
        for kv, pool in pools.items():
            lg = torch.cat([pool.admit(p, slot, (2048,))[0]
                            for slot, p in enumerate(prompts[:4])])
            if first is None:
                first = lg.argmax(-1)
            for slot in range(4):
                pool.ensure_decode_capacity(slot)
            step[kv] = pool.decode(first, active).float()

            def fn(pool=pool):
                for slot in range(4):
                    pool.ensure_decode_capacity(slot)
                pool.decode(first, active)
            rec[kv]["decode_step_4slots"] = step_times(torch, fn)
    for kv in ("q8", "q4"):
        rec[kv]["one_step_max_logit_delta"] = float(
            (step[kv] - step["f32"]).abs().max())
    del pools
    torch.cuda.empty_cache()
    emit(phase="serve_kvq", card=torch.cuda.get_device_name(0),
         system_prompt=SYSTEM_PROMPT, tails=list(PAGED_TAILS),
         max_new=MAX_NEW, page_len=PAGE_LEN, n_pages=N_PAGES,
         f32_streams_equal_serve_paged=f32_same,
         want_bytes_per_resident_token=want_bpt, want_tails_bytes=want_tails,
         half_scale_slack=HALF_SCALE_SLACK, **rec)
    if not all(f32_same):
        fail(f"serve_kvq: f32 streams differ from serve_paged's {f32_same}")
    for kv, r in rec.items():
        if r["bytes_per_resident_token"] != want_bpt[kv]:
            fail(f"serve_kvq: {kv} holds {r['bytes_per_resident_token']} B "
                 f"per resident token, not {want_bpt[kv]}")
        if r["flash_launches"] != n_layers * r["admits"]:
            fail(f"serve_kvq: {kv}: {r['flash_launches']} flash launches "
                 f"for {r['admits']} admits")
        if kv == "f32":
            continue
        if r["tails_bytes"] != want_tails:
            fail(f"serve_kvq: {kv} tails {r['tails_bytes']} B, not "
                 f"{want_tails}")
        if r["cold_first_token"] != rec["f32"]["cold_first_token"]:
            fail(f"serve_kvq: {kv} changed the cold request's first token")
        if not (r["same_cold_pages"] and r["resident_cold_pages"] > 0):
            fail(f"serve_kvq: {kv} holds other cold pages than f32")
        if not r["cold_max_err_over_half_scale"] <= 1 + HALF_SCALE_SLACK:
            fail(f"serve_kvq: {kv} resident element off its f32 value by "
                 f"{r['cold_max_err_over_half_scale']} x scale/2")
    return {kv: run["launches"] for kv, run in runs.items()}


SPEC_K = 4
# 1 + 6 (k + 1): no speculative iteration is cut short by the budget
SPEC_MAX_NEW = 1 + 6 * (SPEC_K + 1)


def top2_gap(torch, model, context) -> float:
    """Top-1 minus top-2 logit of ``model`` after ``context`` (a prefill
    of the whole context on the card): how near a tie a diverging token
    was."""
    from distributed_pytorch_tpu_torch.models.generate import prefill
    with torch.inference_mode():
        logits = prefill(model, torch.as_tensor(
            context[None].astype(np.int64), device=model.device),
            len(context))[0][0].float()
    top = torch.topk(logits, 2).values
    return float(top[0] - top[1])


def phase_serve_spec(torch, tflash, port, model):
    """Speculative decoding of serve_paged's greedy requests plus two
    sampled ones: (a) self-draft on the contiguous pool, (b) a 2-layer
    draft from another seed on the paged pool, (c) (a) on the q8 paged
    pool; each beside the same engine without speculation."""
    from distributed_pytorch_tpu_torch.serve import (EngineConfig,
                                                     SamplingParams)
    greedy, _ = paged_traffic()
    rng = np.random.default_rng(7)
    sampled = [rng.integers(0, FLAGSHIP["vocab"], n).astype(np.int32)
               for n in PROMPT_LENS[:2]]
    prompts = greedy + sampled
    sps = ([SamplingParams(max_new_tokens=SPEC_MAX_NEW)] * len(greedy)
           + [SamplingParams(max_new_tokens=SPEC_MAX_NEW, temperature=0.8,
                             top_k=50)] * len(sampled))
    draft2 = port.TransformerLM(
        dtype=torch.bfloat16, device=model.device,
        attn_fn=tflash.make_flash_attn_fn(),
        generator=torch.Generator(device=model.device).manual_seed(1),
        **dict(FLAGSHIP, n_layers=2))
    cases = {"a_self_contiguous": (dict(), model),
             "b_draft2_paged": (dict(paged=True), draft2),
             "c_self_paged_q8": (dict(paged=True, kv_dtype="q8"), model)}
    rec, launches, bad = {}, {}, []
    for name, (pool_kw, draft) in cases.items():
        kw = dict(n_slots=4, max_len=2048, **pool_kw)
        if pool_kw:
            kw.update(page_len=PAGE_LEN, n_pages=N_PAGES)

        def gens():
            return [torch.Generator(device=model.device).manual_seed(200 + i)
                    for i in range(len(prompts))]
        base = run_engine(torch, tflash, model, EngineConfig(**kw), prompts,
                          sps, gens())
        spec = run_engine(torch, tflash, model, EngineConfig(
            spec_decode=True, draft_model=draft, draft_len=SPEC_K, **kw),
            prompts, sps, gens())
        st = spec["eng"].stats()["spec"]
        diverged = []
        for i, (got, want) in enumerate(zip(spec["outs"][:len(greedy)],
                                            base["outs"][:len(greedy)])):
            if np.array_equal(got, want):
                continue
            t = int(np.argmax(got != want))
            gap = top2_gap(torch, model, np.concatenate(
                [greedy[i], want[:t]]))
            diverged.append(dict(request=i, position=t, top2_gap=gap))
        want_launches = len(greedy) * (FLAGSHIP["n_layers"]
                                       + draft.n_layers)
        rec[name] = dict(
            acceptance_rate=st["acceptance_rate"],
            tokens_per_iteration=st["tokens_per_iteration"],
            proposed=st["proposed"], accepted=st["accepted"],
            verify_steps=st["verify_steps"],
            draft_layers=draft.n_layers,
            greedy_streams_equal=len(greedy) - len(diverged),
            divergences=diverged,
            sampled_tokens=[len(o) for o in spec["outs"][len(greedy):]],
            tpot_ms_p50=slo(torch, spec)["tpot_ms_p50"],
            decode_loop_s=spec["decode_s"], wall_s=spec["wall"],
            flash_launches=spec["launches"],
            want_flash_launches=want_launches,
            no_spec=dict(tpot_ms_p50=slo(torch, base)["tpot_ms_p50"],
                         decode_loop_s=base["decode_s"],
                         wall_s=base["wall"]))
        launches[name] = spec["launches"]
        if spec["launches"] != want_launches:
            bad.append(f"{name}: {spec['launches']} flash launches, "
                       f"want {want_launches}")
        if diverged:
            bad.append(f"{name}: greedy streams diverged from the "
                       f"unspeculated engine's: {diverged}")
        if any(n != SPEC_MAX_NEW for n in rec[name]["sampled_tokens"]):
            bad.append(f"{name}: sampled requests did not finish")
        if name[0] in "ac" and st["acceptance_rate"] != 1.0:
            bad.append(f"{name}: self-draft acceptance "
                       f"{st['acceptance_rate']} != 1.0")
        del base, spec
    del draft2
    torch.cuda.empty_cache()
    emit(phase="serve_spec", card=torch.cuda.get_device_name(0),
         draft_len=SPEC_K, max_new=SPEC_MAX_NEW, greedy=len(greedy),
         sampled=len(sampled), **rec)
    if bad:
        fail("serve_spec: " + "; ".join(bad))
    return launches


def phase_serve_int8(torch, tflash, model):
    """``quantize_tree`` of the serve model: its weights, its logits and
    bytes beside the bf16 model's, and 4 greedy requests through the
    engine."""
    import copy
    from distributed_pytorch_tpu_torch.models.generate import prefill
    from distributed_pytorch_tpu_torch.ops.quant import (
        is_quantized, quantize_int8, quantize_tree, quantized_bytes)
    from distributed_pytorch_tpu_torch.runtime import env
    from distributed_pytorch_tpu_torch.serve import (EngineConfig,
                                                     SamplingParams)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, FLAGSHIP["vocab"], (n,)).astype(np.int32)
               for n in PROMPT_LENS][:4]
    qmodel = quantize_tree(copy.deepcopy(model))
    n_q = n_elems = 0
    mismatched = []
    for (name, mod), qmod in zip(model.named_modules(), qmodel.modules()):
        if not is_quantized(qmod):
            continue
        q, s = quantize_int8(mod.weight, qmod.weight_axis)
        if not (torch.equal(q, qmod.weight_q)
                and torch.equal(s, qmod.weight_scale)):
            mismatched.append(name)
        n_q += 1
        n_elems += q.numel()

    # the yardstick of the tolerance: the same model with every weight
    # moved by an independent uniform draw within +-scale/2 of its
    # channel (the int8 grid's error bound, drawn at random, seeded)
    noisy = copy.deepcopy(model)
    gen = torch.Generator(device=model.device).manual_seed(3)
    with torch.no_grad():
        for mod, qmod in zip(noisy.modules(), qmodel.modules()):
            if is_quantized(qmod):
                u = torch.rand(mod.weight.shape, generator=gen,
                               device=model.device) - 0.5
                mod.weight.copy_((mod.weight.float() + u * qmod.weight_scale
                                  .unsqueeze(qmod.weight_axis)).to(
                                      mod.weight.dtype))
    deltas, noise = [], []
    with torch.inference_mode():
        for p in prompts:
            tok = torch.as_tensor(p[None].astype(np.int64),
                                  device=model.device)
            ref = prefill(model, tok, len(p))[0].float()
            deltas.append(float((prefill(qmodel, tok, len(p))[0].float()
                                 - ref).abs().max()))
            noise.append(float((prefill(noisy, tok, len(p))[0].float()
                                - ref).abs().max()))
    del noisy
    tol = 2 * max(noise)
    sps = [SamplingParams(max_new_tokens=MAX_NEW)] * len(prompts)
    min_seq = int(env.get("DPX_FLASH_MIN_SEQ"))
    runs = {}
    for label, m in (("bf16", model), ("int8", qmodel)):
        run = run_engine(torch, tflash, m, EngineConfig(n_slots=4,
                                                        max_len=2048),
                         prompts, sps)
        st = run["eng"].stats()
        runs[label] = dict(run, flash_admits=sum(
            n for b, n in st["prefill_admits"].items() if b >= min_seq))
    same = [bool(np.array_equal(a, b)) for a, b in
            zip(runs["int8"]["outs"], runs["bf16"]["outs"])]
    qb, bb = quantized_bytes(qmodel), quantized_bytes(model)
    emit(phase="serve_int8", card=torch.cuda.get_device_name(0),
         quantized_tensors=n_q, quantized_elements=n_elems,
         weights_equal_quantize_int8=not mismatched,
         quantized_bytes=qb, bf16_bytes=bb, bytes_ratio=qb / bb,
         first_token_max_logit_delta=deltas,
         noise_yardstick_max_logit_delta=noise, tolerance=tol,
         streams_equal_bf16=same,
         int8=dict(slo(torch, runs["int8"]),
                   decode_loop_s=runs["int8"]["decode_s"],
                   flash_launches=runs["int8"]["launches"]),
         bf16=dict(slo(torch, runs["bf16"]),
                   decode_loop_s=runs["bf16"]["decode_s"],
                   flash_launches=runs["bf16"]["launches"]))
    if mismatched:
        fail(f"serve_int8: int8 weights differ from quantize_int8 of the "
             f"bf16 weights: {mismatched}")
    if not max(deltas) <= tol:
        fail(f"serve_int8: first-token logits off by {deltas} > {tol}")
    for label, run in runs.items():
        want = FLAGSHIP["n_layers"] * run["flash_admits"]
        if run["launches"] != want or want == 0:
            fail(f"serve_int8: {label}: {run['launches']} flash launches "
                 f"for {run['flash_admits']} admits at buckets >= "
                 f"{min_seq}")
        if any(len(o) != MAX_NEW for o in run["outs"]):
            fail(f"serve_int8: {label}: a request did not finish")
    del qmodel
    torch.cuda.empty_cache()
    return runs["int8"]["launches"]


# -- PR-9 phases: disaggregated serving and the fleet -------------------------

HANDOFF_CASES = (("f32", "f32"), ("q8", "f32"), ("q4", "f32"), ("q8", "q8"))
# the KV bytes of serve_paged's 8 prompts at each handoff width: 584 pages
# (66-80 per prompt) x 12 layers x K,V = 14,016 page tensors of 12 heads x
# 16 x 64 = 12,288 values; f32 4 B each, q8 1 B + 12 f32 scales, q4 half a
# byte + 12 f32 scales
HANDOFF_BYTES = {"f32": 688_914_432, "q8": 172_901_376, "q4": 86_787_072}
SERVE_LM_TIMEOUT_S = 300


def handoff_arithmetic():
    pe = FLAGSHIP["dim"] * PAGE_LEN
    n = FLAGSHIP["n_layers"] * 2 * sum(
        -(-(SYSTEM_PROMPT + t) // PAGE_LEN) for t in PAGED_TAILS)
    return {"f32": n * pe * 4, "q8": n * (pe + 4 * -(-pe // 1024)),
            "q4": n * (pe // 2 + 4 * -(-pe // 1024))}


class _Timed:
    """Wrap ``obj.name`` (a method or a module function) so every call's
    host ms lands in ``sink``; ``sync`` first drains the calling
    thread's CUDA stream, so the call's own time is read, not the queued
    work before it. ``spans`` keeps (start, end) monotonic pairs."""

    def __init__(self, torch, obj, name, sink, sync=False, spans=None,
                 after_sync=False):
        self.obj, self.name = obj, name
        self.orig = getattr(obj, name)
        orig = self.orig

        def call(*a, **k):
            if sync:
                torch.cuda.current_stream().synchronize()
            t0 = time.perf_counter()
            out = orig(*a, **k)
            if after_sync:
                torch.cuda.current_stream().synchronize()
            t1 = time.perf_counter()
            sink.append((t1 - t0) * 1e3)
            if spans is not None:
                spans.append((t0, t1))
            return out
        setattr(obj, name, call)

    def restore(self):
        setattr(self.obj, self.name, self.orig)


def quantiles(xs):
    xs = sorted(xs)
    if not xs:
        return None
    return dict(n=len(xs), p50=xs[len(xs) // 2],
                p99=xs[min(len(xs) - 1, int(round(0.99 * (len(xs) - 1))))],
                mean=sum(xs) / len(xs))


def run_disagg(torch, tflash, model, width, kv, prompts, sp):
    """One DisaggEngine run of ``prompts`` at handoff ``width`` over pools
    of ``kv_dtype`` ``kv``, the flash count set to 0 just before and read
    just after, with per-frame host ms of extract, encode, decode_frame
    and adopt, and each decode step's wall beside the prefills' spans."""
    from distributed_pytorch_tpu_torch.serve import (DisaggConfig,
                                                     DisaggEngine)
    from distributed_pytorch_tpu_torch.serve.disagg import (LocalTransport,
                                                            frames)

    class Recording(LocalTransport):
        """Keeps each frame's KV section length, read off its bytes."""

        def __init__(self):
            super().__init__()
            self.kv_sections = []

        def send(self, frame, kv_bytes):
            hdr = np.frombuffer(frame, np.int64, 12)
            n_t = int(hdr[4]) * 2 * int(hdr[5])
            self.kv_sections.append(
                (len(frame) - 8 * 12 - 4 * (1 + n_t) - 4 * int(hdr[10]),
                 int(hdr[11]), int(hdr[4]), int(hdr[5]),
                 int(hdr[6] * hdr[7] * hdr[8])))
            super().send(frame, kv_bytes)

    cfg = DisaggConfig(n_slots=4, max_len=2048, page_len=PAGE_LEN,
                       n_pages=N_PAGES, handoff_width=width, kv_dtype=kv)
    transport = Recording()
    eng = DisaggEngine(model, cfg, transport=transport)
    host = {k: [] for k in ("extract", "encode", "decode_frame", "adopt")}
    step_ms, step_spans, prefill_spans, admit_ms = [], [], [], []
    matched = eng.prefill.pool.quant_bits is not None \
        and eng.prefill.pool.quant_bits == eng.prefill.bits
    wraps = [
        _Timed(torch, eng.prefill.pool, "admit", admit_ms,
               spans=prefill_spans, after_sync=True),
        _Timed(torch, eng.prefill.pool,
               "extract_quantized" if matched else "extract",
               host["extract"], sync=True),
        _Timed(torch, frames, "encode_frame_quantized" if matched
               else "encode_frame", host["encode"]),
        _Timed(torch, frames, "decode_frame", host["decode_frame"]),
        _Timed(torch, eng.decode.pool,
               "adopt_quantized" if (kv != "f32" and kv == width)
               else "adopt", host["adopt"]),
        _Timed(torch, eng.decode.pool, "decode", step_ms,
               spans=step_spans, after_sync=True)]
    tflash.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        with eng:
            hs = [eng.submit(p, sp) for p in prompts]
            outs = [h.result(timeout=900) for h in hs]
    finally:
        for w in wraps:
            w.restore()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = tflash.LAUNCHES["flash_attention_fwd"]
    busy = [ms for ms, (a, b) in zip(step_ms, step_spans)
            if any(a < pe and b > ps for ps, pe in prefill_spans)]
    idle = [ms for ms, (a, b) in zip(step_ms, step_spans)
            if not any(a < pe and b > ps for ps, pe in prefill_spans)]
    return dict(eng=eng, handles=hs, outs=outs, wall=wall,
                launches=launches, transport=transport, host=host,
                admit_ms=admit_ms, step_during_prefill=busy,
                step_idle=idle)


def one_step_deltas(torch, model, prompts):
    """serve_paged's first four prompts admitted into one exact pool, one
    4-slot decode step there; the same pages handed to another exact pool
    through an f32 / q8 / q4 frame, the same step there: the largest
    logit difference of each width from the unsplit step."""
    from distributed_pytorch_tpu_torch.serve.disagg import (decode_frame,
                                                            encode_frame)
    from distributed_pytorch_tpu_torch.serve.pages import PagedSlotPool
    src = PagedSlotPool(model, 4, 2048, page_len=PAGE_LEN, n_pages=N_PAGES)
    active = np.ones(4, bool)
    out = {}
    with torch.inference_mode():
        lg = torch.cat([src.admit(p, slot, (2048,))[0]
                        for slot, p in enumerate(prompts[:4])])
        first = lg.argmax(-1)
        handed = [src.extract(slot) for slot in range(4)]
        for slot in range(4):
            src.ensure_decode_capacity(slot)
        ref = src.decode(first, active).float()
        for width, bits in (("f32", None), ("q8", 8), ("q4", 4)):
            dst = PagedSlotPool(model, 4, 2048, page_len=PAGE_LEN,
                                n_pages=N_PAGES)
            for slot, (length, ks, vs) in enumerate(handed):
                fr = decode_frame(encode_frame(slot, length, lg[slot].float()
                                               .cpu().numpy(), ks, vs,
                                               bits)[0])
                dst.adopt(slot, fr.length, fr.ks, fr.vs)
                dst.ensure_decode_capacity(slot)
            out[width] = float((dst.decode(first, active).float()
                                - ref).abs().max())
            del dst
    del src, handed
    torch.cuda.empty_cache()
    return out


def phase_serve_disagg(torch, tflash, model, paged_outs, paged_slo):
    """serve_paged's traffic through DisaggEngine at handoff f32, q8 and q4
    on exact pools and q8 on q8 pools, then a prefill death mid-handoff."""
    from distributed_pytorch_tpu_torch.serve import (DisaggConfig,
                                                     DisaggEngine,
                                                     PrefillEngineDied,
                                                     SamplingParams,
                                                     aggregate)
    from distributed_pytorch_tpu_torch.serve.disagg import (LocalTransport,
                                                            TransportSevered,
                                                            kv_wire_bytes)
    prompts, rng = paged_traffic()
    sp = SamplingParams(max_new_tokens=MAX_NEW)
    n_layers = FLAGSHIP["n_layers"]
    pe = FLAGSHIP["dim"] * PAGE_LEN
    with DisaggEngine(model, DisaggConfig(       # warm-up, not measured
            n_slots=4, max_len=2048, page_len=PAGE_LEN,
            n_pages=N_PAGES)) as eng:
        eng.submit(rng.integers(0, FLAGSHIP["vocab"], 300),
                   SamplingParams(max_new_tokens=2)).result(timeout=900)
    want_bytes = handoff_arithmetic()
    bad, rec, launches = [], {}, {}
    for width, kv in HANDOFF_CASES:
        label = width if kv == "f32" else f"{width}_on_{kv}_pool"
        run = run_disagg(torch, tflash, model, width, kv, prompts, sp)
        eng, hs = run["eng"], run["handles"]
        st = eng.stats()
        bits = {"f32": None, "q8": 8, "q4": 4}[width]
        formula = sum(kv_wire_bytes(n_layers, -(-len(p) // PAGE_LEN), pe,
                                    bits) for p in prompts)
        sections = run["transport"].kv_sections
        section_bytes = sum(x[0] for x in sections)
        booked = st["handoff"]["bytes_sent"]
        admits = sum(st["prefill"]["prefill_admits"].values())
        hits = [h.metrics["prefix_hit_pages"] for h in hs]
        decomp, sums = [], []
        for h in hs:
            m = h.metrics
            parts = [m[k] for k in ("queue_ms", "prefill_ms", "handoff_ms",
                                    "decode_ms")]
            decomp.append(dict(zip(("queue_ms", "prefill_ms", "handoff_ms",
                                    "decode_ms"), parts),
                               ttft_ms=m["ttft_ms"]))
            sums.append(abs(sum(parts) - m["ttft_ms"]))
        ppool, dpool = eng.prefill.pool, eng.decode.pool
        live = (ppool.pool.live_pages(), dpool.pool.live_pages())
        while (pid := ppool.index.evict_lru(ppool.pool)) is not None:
            ppool.pool.reclaim(pid)
            ppool.pool.release_to_free(pid)
        free = (ppool.pool.free_pages, dpool.pool.free_pages)
        agg = aggregate([h.metrics for h in hs], wall_s=run["wall"])
        same = [bool(np.array_equal(a, b))
                for a, b in zip(run["outs"], paged_outs)]
        r = dict(handoff_width=width, kv_dtype=kv,
                 streams_equal_serve_paged=same,
                 first_tokens_equal=[int(a[0]) == int(b[0]) for a, b in
                                     zip(run["outs"], paged_outs)],
                 greedy_divergence_rate=float(np.mean(
                     [a != b for x, y in zip(run["outs"], paged_outs)
                      for a, b in zip(x, y)])),
                 handoff_bytes_booked=booked, handoff_bytes_formula=formula,
                 kv_section_bytes=section_bytes,
                 frames=st["handoff"]["frames_sent"],
                 prefix_hit_pages=hits, flash_launches=run["launches"],
                 prefill_admits=admits, live_pages_after=live,
                 free_pages_after_index_drain=free,
                 decomposition=decomp, decomposition_max_gap_ms=max(sums),
                 host_ms_per_frame={k: quantiles(v)
                                    for k, v in run["host"].items()},
                 prefill_admit_ms=quantiles(run["admit_ms"]),
                 decode_step_ms_during_prefill=quantiles(
                     run["step_during_prefill"]),
                 decode_step_ms_idle=quantiles(run["step_idle"]),
                 wall_s=run["wall"],
                 **{k: agg[k] for k in ("ttft_ms_p50", "ttft_ms_p99",
                                        "tpot_ms_p50", "tpot_ms_p99",
                                        "tokens_per_sec", "handoff_ms_p50",
                                        "handoff_ms_p99", "prefill_ms_p50")})
        rec[label] = r
        launches[label] = run["launches"]
        if width == "f32" and not all(same):
            bad.append(f"{label}: streams differ from serve_paged's {same}")
        if not all(r["first_tokens_equal"]):
            bad.append(f"{label}: a first token differs")
        if not (booked == formula == section_bytes == want_bytes[width]
                == HANDOFF_BYTES[width]) or any(
                    x[0] != x[1] or x[1] != kv_wire_bytes(x[2], x[3], x[4],
                                                          bits)
                    for x in sections):
            bad.append(f"{label}: handoff bytes booked {booked}, formula "
                       f"{formula}, sections {section_bytes}, want "
                       f"{HANDOFF_BYTES[width]}")
        if hits[0] != 0 or not all(n > 0 for n in hits[1:]):
            bad.append(f"{label}: prefill-side prefix hits {hits}")
        if run["launches"] != n_layers * admits or admits != len(prompts):
            bad.append(f"{label}: {run['launches']} flash launches for "
                       f"{admits} prefill admissions")
        if live != (0, 0) or free != (ppool.n_pages, dpool.n_pages):
            bad.append(f"{label}: live pages {live}, free {free} after the "
                       f"drain")
        if max(sums) > 1.0:
            bad.append(f"{label}: the decomposition misses TTFT by "
                       f"{max(sums)} ms")
        del run, eng, hs
        torch.cuda.empty_cache()
    ratio = rec["f32"]["handoff_bytes_booked"] / rec["q8"][
        "handoff_bytes_booked"]
    if ratio < 3.5:
        bad.append(f"f32 / q8 handoff bytes {ratio} < 3.5")

    # victim-only failure: the transport dies on its second send
    class SeverSecond(LocalTransport):
        def send(self, frame, kv_bytes):
            if self.frames_sent == 1:
                raise TransportSevered("handoff channel cut (test double)")
            super().send(frame, kv_bytes)

    eng = DisaggEngine(model, DisaggConfig(
        n_slots=4, max_len=2048, page_len=PAGE_LEN, n_pages=N_PAGES),
        transport=SeverSecond())
    with eng:
        ha = eng.submit(prompts[0], sp)
        while not ha.tokens:
            time.sleep(0.005)
        hb = eng.submit(prompts[1], sp)
        try:
            hb.result(timeout=900)
            victim = "no error"
        except PrefillEngineDied as e:
            victim = dict(error="PrefillEngineDied", engine=e.engine,
                          request_id=e.request_id)
        out_a = ha.result(timeout=900)
    survivor_equal = bool(np.array_equal(out_a, paged_outs[0]))
    rec["victim_only"] = dict(victim=victim, survivor_equal=survivor_equal,
                              decode_live_pages_after=eng.decode.pool.pool
                              .live_pages())
    if not (isinstance(victim, dict) and victim["engine"] == "prefill"
            and victim["request_id"] == hb.request_id and survivor_equal):
        bad.append(f"victim-only failure: victim {victim}, survivor equal "
                   f"{survivor_equal}")
    del eng
    torch.cuda.empty_cache()
    rec["one_step_max_logit_delta"] = one_step_deltas(torch, model, prompts)
    emit(phase="serve_disagg", card=torch.cuda.get_device_name(0),
         system_prompt=SYSTEM_PROMPT, tails=list(PAGED_TAILS),
         max_new=MAX_NEW, page_len=PAGE_LEN, n_pages=N_PAGES,
         want_handoff_bytes=HANDOFF_BYTES, f32_over_q8=ratio,
         f32_over_q4=rec["f32"]["handoff_bytes_booked"]
         / rec["q4"]["handoff_bytes_booked"],
         monolithic_paged=paged_slo, **rec)
    if bad:
        fail("serve_disagg: " + "; ".join(bad))
    return launches


def divergence(torch, model, prompts, outs, refs):
    """Where each stream first leaves its reference, with the reference's
    top-2 logit gap there (how near a tie the flipped token was)."""
    out = []
    for i, (p, a, b) in enumerate(zip(prompts, outs, refs)):
        if not np.array_equal(a, b):
            t = int(np.argmax(a != b))
            out.append(dict(request=i, position=t, top2_gap=top2_gap(
                torch, model, np.concatenate([p, b[:t]]).astype(np.int32))))
    return out


#: the kill case's four prompts: tails 64-160, whose warm (prefix-hit)
#: and cold admissions serve_paged already holds to one stream (a warm
#: request may re-home to a replica where the prompt is cold, or back)
KILL_PROMPTS = slice(1, 5)


def phase_serve_fleet(torch, tflash, model, paged_outs):
    """FleetRouter over 2 replicas of serve_paged's EngineConfig on the
    card: (a) the 8 requests with prefix affinity, (b) 4 streaming
    requests' home killed, the prompts resubmitted to the survivor."""
    from distributed_pytorch_tpu_torch.serve import (EngineConfig,
                                                     FleetConfig,
                                                     FleetRouter,
                                                     ReplicaFailed,
                                                     SamplingParams,
                                                     aggregate)
    prompts, _ = paged_traffic()
    sp = SamplingParams(max_new_tokens=MAX_NEW)
    n_layers = FLAGSHIP["n_layers"]
    bad, rec = [], {}

    def admits(fleet):
        return sum(sum(r.engine.stats()["prefill_admits"].values())
                   for r in fleet._replicas.values())

    fleet = FleetRouter(model, FleetConfig(n_replicas=2, engine=EngineConfig(
        n_slots=4, max_len=2048, paged=True, page_len=PAGE_LEN,
        n_pages=N_PAGES)))
    home = fleet.home_of(prompts[0])
    tflash.reset_launch_counts()
    t0 = time.perf_counter()
    with fleet:
        hs = [fleet.submit(p, sp) for p in prompts]
        outs = [h.result(timeout=900) for h in hs]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        st = fleet.stats()
        launches_a, admits_a = tflash.LAUNCHES["flash_attention_fwd"], \
            admits(fleet)
        same = [bool(np.array_equal(a, b)) for a, b in zip(outs, paged_outs)]
        agg = aggregate([h.metrics for h in hs], wall_s=wall)
        rec["routing"] = dict(
            home=home, replicas=[h.replica for h in hs],
            affinity_hits=st["affinity_hits"], spills=st["spills"],
            streams_equal_serve_paged=same,
            diverged=divergence(torch, model, prompts, outs, paged_outs),
            prefix_hit_pages=[h.metrics["prefix_hit_pages"] for h in hs],
            flash_launches=launches_a, prefill_admits=admits_a,
            **{k: agg[k] for k in ("ttft_ms_p50", "ttft_ms_p99",
                                   "tpot_ms_p50", "tpot_ms_p99",
                                   "tokens_per_sec")}, wall_s=wall)
        if not all(same):
            bad.append(f"routing: streams differ from serve_paged's {same}")
        if launches_a != n_layers * admits_a or admits_a != len(prompts):
            bad.append(f"routing: {launches_a} flash launches for "
                       f"{admits_a} admissions")

        # (b) kill the home of four streaming requests
        tflash.reset_launch_counts()
        before = admits(fleet)
        victims = [fleet.submit(p, sp) for p in prompts[KILL_PROMPTS]]
        homes = {h.replica for h in victims}
        deadline = time.monotonic() + 300
        while not all(h.tokens for h in victims):
            if time.monotonic() > deadline:
                fail("serve_fleet: the four requests never all streamed")
            time.sleep(0.005)
        killed = victims[0].replica
        fleet.kill_replica(killed)
        errors = []
        for h in victims:
            try:
                h.result(timeout=900)
                errors.append("no error")
            except ReplicaFailed as e:
                errors.append(dict(replica=e.replica,
                                   request_id=e.request_id,
                                   streamed=len(h.tokens)))
        again = [fleet.submit(p, sp) for p in prompts[KILL_PROMPTS]]
        outs_b = [h.result(timeout=900) for h in again]
        torch.cuda.synchronize()
        launches_b, admits_b = tflash.LAUNCHES["flash_attention_fwd"], \
            admits(fleet) - before
        same_b = [bool(np.array_equal(a, b))
                  for a, b in zip(outs_b, paged_outs[KILL_PROMPTS])]
        rec["kill"] = dict(
            homes=sorted(homes), killed=killed, errors=errors,
            rehomed=[h.replica for h in again], streams_equal=same_b,
            prefix_hit_pages=[h.metrics["prefix_hit_pages"] for h in again],
            diverged=divergence(torch, model, prompts[KILL_PROMPTS], outs_b,
                                paged_outs[KILL_PROMPTS]),
            flash_launches=launches_b, prefill_admits=admits_b,
            live=fleet.stats()["live"])
        if homes != {killed} or any(
                not (isinstance(e, dict) and e["replica"] == killed)
                for e in errors):
            bad.append(f"kill: homes {homes}, errors {errors}")
        if any(h.replica == killed for h in again) or not all(same_b):
            bad.append(f"kill: re-homed to {[h.replica for h in again]}, "
                       f"streams equal {same_b}")
        if launches_b != n_layers * admits_b:
            bad.append(f"kill: {launches_b} flash launches for {admits_b} "
                       "admissions")
        # printed, not gated: prompt 0, cold in serve_paged, admitted
        # warm on the survivor (why the kill case leaves it out)
        h0 = fleet.submit(prompts[0], sp)
        out0 = h0.result(timeout=900)
        rec["warm_prompt0"] = dict(
            prefix_hit_pages=h0.metrics["prefix_hit_pages"],
            equal=bool(np.array_equal(out0, paged_outs[0])),
            diverged=divergence(torch, model, prompts[:1], [out0],
                                paged_outs[:1]))
    del fleet
    torch.cuda.empty_cache()
    emit(phase="serve_fleet", card=torch.cuda.get_device_name(0),
         replicas=2, page_len=PAGE_LEN, n_pages=N_PAGES, **rec)
    if bad:
        fail("serve_fleet: " + "; ".join(bad))
    return dict(routing=launches_a, kill=launches_b)


def phase_serve_lm_example():
    """The port's examples/serve_lm.py --disagg on the card at its default
    width, in a subprocess with a time limit."""
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    try:
        # ``-m`` puts the working directory, the checkout, on sys.path
        proc = subprocess.run(
            [sys.executable, "-m",
             "distributed_pytorch_tpu_torch.examples.serve_lm", "--disagg"],
            cwd=root, capture_output=True, text=True,
            timeout=SERVE_LM_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        fail(f"serve_lm_example: no exit within {SERVE_LM_TIMEOUT_S} s")
    wall = time.perf_counter() - t0
    done = [ln for ln in proc.stdout.splitlines() if " done: " in ln]
    emit(phase="serve_lm_example", rc=proc.returncode, wall_s=wall,
         request_lines=done,
         split=[ln for ln in proc.stdout.splitlines()
                if ln.startswith("split:")])
    if proc.returncode != 0 or len(done) != 6 or not all(
            "handoff B" in ln and "prefill" in ln and "decode" in ln
            for ln in done):
        fail(f"serve_lm_example: rc {proc.returncode}\n"
             f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")


# ---------------------------------------------------------------------------
# sequence, expert and pipeline parallelism (one card: world 1, a one-rank
# NCCL group where a mesh is needed; world > 1 is proven over gloo CPU
# ranks by the tests)
# ---------------------------------------------------------------------------

# benchmarks/mfu_transformer.py:90 LONGCTX: FLAGSHIP's widths at seq 4096
LONGCTX = dict(vocab=32000, dim=768, n_layers=12, n_heads=12, max_seq=4096,
               pos="learned")
LONG_BATCH, LONG_SEQ = 2, 4096
LONG_CORES = ("flash", "striped", "ulysses")
LONG_TIMED_STEPS = 3
SP_LOSS_RTOL = 2e-3           # each step's loss against the flash model's
LONG_EXAMPLE = ["--device", "cuda", "--dim", "768", "--n-layers", "12",
                "--n-heads", "12", "--seq-len", "4096", "--batch-size", "2",
                "--bf16", "--steps", "4"]
# the ring replay: 4 virtual ranks at LONGCTX's attention shape
RING_N, RING_WINDOW = 4, 1024
RING_SHAPE = (LONG_BATCH, 12, LONG_SEQ, 64)
RING_CORES = {"causal": dict(), "window": dict(window=RING_WINDOW),
              "striped": dict(striped=True)}
RING_FWD_LAUNCHES = {"causal": RING_N * RING_N, "window": RING_N * 2,
                     "striped": RING_N * RING_N}
# the MoE LM: FLAGSHIP's widths, 8 experts, top-1, capacity 2.0
MOE_LM = dict(TRAIN, n_experts=8, top_k=1, capacity_factor=2.0,
              router="tokens")
MOE_AUX_COEF = 0.01
MOE_TIMED_STEPS = 3
MOE_EXAMPLE = ["--device", "cuda", "--dim", "768", "--n-layers", "12",
               "--n-heads", "12", "--seq-len", "1024", "--batch-size", "8",
               "--n-experts", "8", "--bf16", "--steps", "4"]
# the pipeline: FLAGSHIP's 12 blocks on one stage, 4 microbatches
PIPE_MICRO, PIPE_STEPS = 4, 3
PIPE_LOSS_RTOL, PIPE_GRAD_RTOL = 2e-3, 1e-2


def one_rank_group(torch):
    """A one-rank NCCL group and ``init_mesh`` over it (every axis of
    size 1)."""
    from distributed_pytorch_tpu_torch.runtime import context, env
    from distributed_pytorch_tpu_torch.runtime.launcher import find_free_port
    env.set("DPX_MASTER_PORT", find_free_port())
    context.init_process_group(0, 1)
    return context.init_mesh(dp=1)


def train_arm(torch, tflash, step, model, state, batch, steps):
    """1 warm-up and ``steps`` timed steps of ``step``: step ms, peak
    memory, flash launches per step, the losses and the last metrics."""
    st = [state]

    def run():
        out = step(model, st[0], batch)
        st[0] = out.opt_state
        return out

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tflash.reset_launch_counts()
    outs = [run()]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs += [run() for _ in range(steps)]
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / steps * 1e3
    per_step = {k: v / (1 + steps) for k, v in tflash.LAUNCHES.items()}
    metrics = {k: float(v.detach().float().mean())
               for k, v in outs[-1].metrics.items()}
    return dict(step_ms=step_ms,
                peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
                launches_per_step=per_step, metrics=metrics,
                losses=[float(o.loss) for o in outs])


def phase_long_context(torch, port, tflash, device):
    """LONGCTX through ``make_spmd_train_step`` (DTensor parameters and a
    batch placed ``P("dp", "sp")``) with ``make_gspmd_ring_attn_fn`` at
    sp 1 for each core, beside the same model with ``make_flash_attn_fn``;
    then ``examples/train_long_context.py`` at LONGCTX's widths. Returns
    each core's flash launches per step."""
    from distributed_pytorch_tpu_torch.examples import train_long_context
    from distributed_pytorch_tpu_torch.ops.losses import \
        cross_entropy_per_example
    from distributed_pytorch_tpu_torch.optim import adamw
    from distributed_pytorch_tpu_torch.parallel import (
        make_spmd_train_step, shard_batch_spec, shard_params)
    from distributed_pytorch_tpu_torch.parallel.sequence import stripe_tokens
    from distributed_pytorch_tpu_torch.parallel.spmd import \
        make_gspmd_ring_attn_fn
    from distributed_pytorch_tpu_torch.parallel.tensor import (
        P, transformer_lm_param_specs)
    from distributed_pytorch_tpu_torch.runtime import context

    toks = torch.from_numpy(np.random.default_rng(13).integers(
        0, LONGCTX["vocab"], (LONG_BATCH, LONG_SEQ + 1))).to(device)
    mesh = one_rank_group(torch)
    arms = {}
    try:
        for core in ("reference",) + LONG_CORES:
            attn_fn = (tflash.make_flash_attn_fn() if core == "reference"
                       else make_gspmd_ring_attn_fn(mesh, core=core))
            # sp 1: the striped layout of one shard is the identity
            positions = (stripe_tokens(torch.arange(LONG_SEQ, device=device),
                                       1, axis=0)
                         if core == "striped" else None)
            model = port.TransformerLM(
                dtype=torch.bfloat16, device=device, attn_fn=attn_fn,
                generator=torch.Generator(device=device).manual_seed(0),
                **LONGCTX)
            model = shard_params(model, transformer_lm_param_specs(model),
                                 mesh)

            def loss_fn(m, batch, positions=positions):
                x, y = batch
                return cross_entropy_per_example(
                    m(x, positions=positions), y).mean(), {}

            opt = adamw(TRAIN_LR)
            step = make_spmd_train_step(loss_fn, opt, donate=False)
            batch = shard_batch_spec((toks[:, :-1], toks[:, 1:]), mesh,
                                     P("dp", "sp"))
            arms[core] = train_arm(torch, tflash, step, model,
                                   opt.init(model.parameters()), batch,
                                   LONG_TIMED_STEPS)
            del model, step, batch
            torch.cuda.empty_cache()
        backend = context.get_backend()
    finally:
        context.destroy_process_group()
    ref = arms["reference"]["losses"]
    for core in LONG_CORES:
        arms[core]["max_rel_loss_diff_vs_flash"] = max(
            abs(a - b) / abs(b) for a, b in zip(arms[core]["losses"], ref))
    tflash.reset_launch_counts()
    t0 = time.perf_counter()
    ex = train_long_context.main_worker(0, 1, LONG_EXAMPLE, quiet=True)
    ex["wall_s"] = time.perf_counter() - t0
    ex["launches"] = dict(tflash.LAUNCHES)
    torch.cuda.empty_cache()
    emit(phase="long_context", card=torch.cuda.get_device_name(0),
         backend=backend, world=1, sp=1,
         config=dict(LONGCTX, batch=LONG_BATCH, seq=LONG_SEQ,
                     dtype="bfloat16", optimizer=f"adamw({TRAIN_LR})"),
         warmup_steps=1, timed_steps=LONG_TIMED_STEPS, arms=arms,
         loss_rtol=SP_LOSS_RTOL, example=ex)
    want = {k: LONGCTX["n_layers"] for k in tflash.LAUNCHES}
    for core, rec in arms.items():
        if rec["launches_per_step"] != want:
            fail(f"long_context {core}: launches per step "
                 f"{rec['launches_per_step']}, expected {want}")
        if not np.all(np.isfinite(rec["losses"])):
            fail(f"long_context {core}: losses {rec['losses']}")
        if core != "reference" and not (
                rec["max_rel_loss_diff_vs_flash"] <= SP_LOSS_RTOL):
            fail(f"long_context {core}: losses {rec['losses']} vs the "
                 f"flash model's {ref}")
    if not (len(ex["history"]) == 3 and np.all(np.isfinite(ex["history"]))):
        fail(f"long_context: the example's losses {ex['history']}")
    return {core: arms[core]["launches_per_step"] for core in LONG_CORES}


def replay_ring(torch, seq, q, k, v, n, **kw):
    """``parallel.sequence``'s ring of n ranks replayed on one card: rank
    ``my``'s hops through ``_ring_flash`` with a shift that hands it the
    block rank ``(my - t - 1) % n`` holds; the ranks' outputs and lse
    concatenated along the sequence."""
    s_loc = q.shape[2] // n

    def blocks(t):
        return [t[:, :, r * s_loc:(r + 1) * s_loc] for r in range(n)]
    qs, ks, vs = blocks(q), blocks(k), blocks(v)
    outs, lses = [], []
    for my in range(n):
        def shift(t, kt, vt, my=my):
            src = (my - t - 1) % n
            return ks[src], vs[src]
        o, lse = seq._ring_flash(qs[my], ks[my], vs[my], my, n, shift,
                                 causal=True, scale=None, **kw)
        outs.append(o.to(q.dtype))
        lses.append(lse)
    return torch.cat(outs, dim=2), torch.cat(lses, dim=2)


def phase_ring_hops(torch, tflash, device):
    """The flash ring's hops of 4 virtual ranks at LONGCTX's attention
    shape, through the module's own hop loop: the causal ring, the
    window-1024 ring and the striped ring (compared after unstriping),
    bf16 and f32, o / lse / dq / dk / dv against the full-sequence
    kernel on the same mask. Returns each core's launches of each
    kernel (bf16)."""
    from distributed_pytorch_tpu_torch.parallel import sequence as seq
    results, launches = {}, {}
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[-1]
        gen = torch.Generator(device=device).manual_seed(17)
        q, k, v, do = (torch.randn(RING_SHAPE, generator=gen, device=device)
                       .to(dtype) for _ in range(4))
        dl = torch.randn(RING_SHAPE[:3], generator=gen, device=device)
        for core, kw in RING_CORES.items():
            window = kw.get("window")
            leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
            o_ref, lse_ref = tflash.flash_attention_with_lse(
                *leaves, causal=True, window=window)
            ((o_ref.float() * do.float()).sum()
             + (lse_ref * dl).sum()).backward()
            ref = [o_ref.detach(), lse_ref.detach()] + [
                t.grad for t in leaves]
            leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
            tflash.reset_launch_counts()
            if core == "striped":
                qs, ks, vs = (seq.stripe_tokens(t, RING_N, axis=2)
                              for t in leaves)
                o, lse = replay_ring(torch, seq, qs, ks, vs, RING_N, **kw)
                o = seq.unstripe_tokens(o, RING_N, axis=2)
                lse = seq.unstripe_tokens(lse, RING_N, axis=2)
            else:
                o, lse = replay_ring(torch, seq, *leaves, RING_N, **kw)
            fwd = tflash.LAUNCHES["flash_attention_fwd"]
            ((o.float() * do.float()).sum() + (lse * dl).sum()).backward()
            torch.cuda.synchronize()
            if dtype == torch.bfloat16:
                launches[core] = dict(tflash.LAUNCHES)
            got = [o.detach(), lse.detach()] + [t.grad for t in leaves]
            errs = {}
            for name, g, r in zip(("o", "lse", "dq", "dk", "dv"), got, ref):
                scale = max(1.0, r.float().abs().max().item())
                errs[name] = dict(
                    max_abs_err=(g.float() - r.float()).abs().max().item(),
                    scale=scale, finite=bool(torch.isfinite(g).all()))
                if dtype == torch.bfloat16 and name != "lse":
                    errs[name]["tile_rel_err"] = tile_rel_err(torch, g, r)
            results[f"{core}_{dname}"] = dict(fwd_launches=fwd, errs=errs)
    emit(phase="ring_hops", card=torch.cuda.get_device_name(0),
         ranks=RING_N, shape=list(RING_SHAPE), window=RING_WINDOW,
         tol=dict(bfloat16_tile_rel=BWD_TILE_TOL,
                  float32_scaled=TOL["float32"], lse_scaled=TOL["float32"]),
         results=results, launches=launches)
    for key, rec in results.items():
        core = key.rsplit("_", 1)[0]
        if rec["fwd_launches"] != RING_FWD_LAUNCHES[core]:
            fail(f"ring_hops {key}: {rec['fwd_launches']} forward launches,"
                 f" expected {RING_FWD_LAUNCHES[core]}")
        for name, e in rec["errs"].items():
            if not e["finite"]:
                fail(f"ring_hops {key}: {name} not finite")
            if "tile_rel_err" in e:
                ok = e["tile_rel_err"] <= BWD_TILE_TOL
            else:
                ok = e["max_abs_err"] <= TOL["float32"] * e["scale"]
            if not ok:
                fail(f"ring_hops {key}: {name} {e}")
    return launches


def phase_moe_lm(torch, port, tflash, device):
    """``MoETransformerLM`` at FLAGSHIP's widths (8 experts, top-1,
    capacity 2.0, the flash attn_fn) through ``make_spmd_train_step`` on
    DTensors of ``model.param_specs()`` (ep 1); the first loss against
    the same weights with dense attention; then
    ``examples/train_moe_lm.py``. Returns the launches per step."""
    from distributed_pytorch_tpu_torch.examples import train_moe_lm
    from distributed_pytorch_tpu_torch.ops.losses import \
        cross_entropy_per_example
    from distributed_pytorch_tpu_torch.optim import adamw
    from distributed_pytorch_tpu_torch.parallel import (
        make_spmd_train_step, shard_batch_spec, shard_params)
    from distributed_pytorch_tpu_torch.parallel.tensor import P
    from distributed_pytorch_tpu_torch.runtime import context

    def loss_fn(m, batch):
        x, y = batch
        logits, aux, metrics = m.forward_with_metrics(x)
        nll = cross_entropy_per_example(logits, y).mean()
        return nll + MOE_AUX_COEF * aux, {
            "nll": nll, "drop_rate": metrics["drop_rate"],
            "max_expert_load": metrics["expert_load"].max()}

    def build(attn_fn):
        return port.models.MoETransformerLM(
            dtype=torch.bfloat16, device=device, attn_fn=attn_fn,
            generator=torch.Generator(device=device).manual_seed(0),
            **MOE_LM)

    toks = train_tokens(torch, 14, TRAIN_BATCH, device)
    dense = build(None)
    with torch.no_grad():
        dense_loss = float(loss_fn(dense, (toks[:, :-1], toks[:, 1:]))[0])
    del dense
    torch.cuda.empty_cache()
    mesh = one_rank_group(torch)
    try:
        model = build(tflash.make_flash_attn_fn())
        model = shard_params(model, model.param_specs(), mesh)
        opt = adamw(TRAIN_LR)
        step = make_spmd_train_step(loss_fn, opt, donate=False)
        batch = shard_batch_spec((toks[:, :-1], toks[:, 1:]), mesh,
                                 P("dp", None))
        rec = train_arm(torch, tflash, step, model,
                        opt.init(model.parameters()), batch,
                        MOE_TIMED_STEPS)
        del model, step, batch
        torch.cuda.empty_cache()
    finally:
        context.destroy_process_group()
    rec["dense_first_loss"] = dense_loss
    rec["first_loss_rel_diff"] = abs(rec["losses"][0] - dense_loss) \
        / abs(dense_loss)
    tflash.reset_launch_counts()
    t0 = time.perf_counter()
    ex = train_moe_lm.main_worker(0, 1, MOE_EXAMPLE, quiet=True)
    ex["wall_s"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    emit(phase="moe_lm", card=torch.cuda.get_device_name(0), world=1, ep=1,
         config=dict(MOE_LM, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                     dtype="bfloat16", optimizer=f"adamw({TRAIN_LR})",
                     loss=f"nll + {MOE_AUX_COEF} aux"),
         warmup_steps=1, timed_steps=MOE_TIMED_STEPS, loss_rtol=SP_LOSS_RTOL,
         example=ex, **rec)
    want = {k: MOE_LM["n_layers"] for k in tflash.LAUNCHES}
    if rec["launches_per_step"] != want:
        fail(f"moe_lm: launches per step {rec['launches_per_step']}, "
             f"expected {want}")
    if not np.all(np.isfinite(rec["losses"])):
        fail(f"moe_lm: losses {rec['losses']}")
    if not rec["first_loss_rel_diff"] <= SP_LOSS_RTOL:
        fail(f"moe_lm: first loss {rec['losses'][0]} vs dense attention's "
             f"{dense_loss}")
    if not (len(ex["history"]) == 3 and np.all(np.isfinite(ex["history"]))):
        fail(f"moe_lm: the example's losses {ex['history']}")
    return rec["launches_per_step"]


def phase_pipeline(torch, port, tflash, device):
    """FLAGSHIP's 12 blocks stacked on one stage (pp 1), the embedding
    and head outside, 4 microbatches of the batch of 8, under 1F1B and
    GPipe: the loss and every stacked gradient against the unpipelined
    blocks'. Returns each schedule's launches per step."""
    from distributed_pytorch_tpu_torch.ops.losses import \
        cross_entropy_per_example
    from distributed_pytorch_tpu_torch.parallel.pipeline import (
        make_pipeline_train_fn, make_stage_fn, stack_layer_params)
    from distributed_pytorch_tpu_torch.runtime import context

    model = port.TransformerLM(
        dtype=torch.bfloat16, device=device,
        attn_fn=tflash.make_flash_attn_fn(),
        generator=torch.Generator(device=device).manual_seed(0), **TRAIN)
    toks = train_tokens(torch, 15, TRAIN_BATCH, device)
    with torch.no_grad():
        x = model.embed(toks[:, :-1], torch.arange(TRAIN_SEQ, device=device))
    y_tok = toks[:, 1:]

    def loss_fn(h, tgt):
        logits = model.project_vocab(model.ln_f(h))
        return cross_entropy_per_example(logits, tgt).mean(dim=-1)

    # the unpipelined blocks
    h = x
    for blk in model.blocks:
        h = blk(h)
    ref_loss = loss_fn(h, y_tok).mean()
    ref_loss.backward()
    ref_loss = float(ref_loss)
    stack = stack_layer_params(model.blocks)
    ref_grads = {n: torch.stack([dict(b.named_parameters())[n].grad
                                 for b in model.blocks])
                 for n, _ in stack.named_parameters()}
    del h
    model.zero_grad(set_to_none=True)
    params = dict(stack.named_parameters())
    stage_fn = make_stage_fn(stack)
    arms = {}
    for schedule in ("1f1b", "gpipe"):
        fn = make_pipeline_train_fn(context.get_mesh(), stage_fn, loss_fn,
                                    PIPE_MICRO, schedule=schedule)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        tflash.reset_launch_counts()
        loss, grads = fn(params, x, y_tok)
        torch.cuda.synchronize()
        per_step = dict(tflash.LAUNCHES)
        t0 = time.perf_counter()
        for _ in range(PIPE_STEPS):
            fn(params, x, y_tok)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) / PIPE_STEPS * 1e3
        leaf = {n: ((grads[n].float() - r.float()).norm()
                    / r.float().norm().clamp_min(1e-30)).item()
                for n, r in ref_grads.items()}
        arms[schedule] = dict(
            loss=float(loss), loss_rel_diff=abs(float(loss) - ref_loss)
            / abs(ref_loss), max_leaf_rel_err=max(leaf.values()),
            worst_leaf=max(leaf, key=leaf.get), step_ms=step_ms,
            peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
            launches_per_step=per_step)
        del grads
        torch.cuda.empty_cache()
    del model, stack, params, x
    torch.cuda.empty_cache()
    emit(phase="pipeline", card=torch.cuda.get_device_name(0), stages=1,
         microbatches=PIPE_MICRO,
         config=dict(TRAIN, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                     dtype="bfloat16"),
         ref_loss=ref_loss, loss_rtol=PIPE_LOSS_RTOL,
         grad_rtol=PIPE_GRAD_RTOL, timed_steps=PIPE_STEPS, arms=arms)
    layers = TRAIN["n_layers"] * PIPE_MICRO
    want = {"gpipe": {k: layers for k in tflash.LAUNCHES},
            "1f1b": dict({k: layers for k in tflash.LAUNCHES},
                         flash_attention_fwd=2 * layers)}
    for schedule, rec in arms.items():
        if rec["launches_per_step"] != want[schedule]:
            fail(f"pipeline {schedule}: launches {rec['launches_per_step']},"
                 f" expected {want[schedule]}")
        if not (rec["loss_rel_diff"] <= PIPE_LOSS_RTOL
                and rec["max_leaf_rel_err"] <= PIPE_GRAD_RTOL):
            fail(f"pipeline {schedule}: loss {rec['loss']} vs {ref_loss}, "
                 f"worst leaf {rec['worst_leaf']} "
                 f"{rec['max_leaf_rel_err']}")
    return {s: rec["launches_per_step"] for s, rec in arms.items()}


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
    del pool
    torch.cuda.empty_cache()
    paged_outs, paged_slo = phase_serve_paged(torch, model)
    # the paged pool quantized, speculative decoding, int8 weights
    kvq_launches = phase_serve_kvq(torch, tflash, model, paged_outs)
    spec_launches = phase_serve_spec(torch, tflash, port, model)
    int8_launches = phase_serve_int8(torch, tflash, model)
    # disaggregated prefill/decode and the multi-replica fleet, then the
    # serving example's entry point
    disagg_launches = phase_serve_disagg(torch, tflash, model, paged_outs,
                                         paged_slo)
    fleet_launches = phase_serve_fleet(torch, tflash, model, paged_outs)
    phase_serve_lm_example()
    del model
    torch.cuda.empty_cache()

    # training runs PyTorch's default bf16 GEMM reduction (the serving
    # phases turned it off so batched and single-row decode round alike)
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = True
    phase_train_check(torch, port, tflash, device)
    run_step, step_ms, launches, train_losses = phase_train(
        torch, port, tflash, device)
    phase_train_breakdown(torch, run_step, step_ms)
    del run_step
    torch.cuda.empty_cache()
    # the ZeRO ladder (FSDP2 ZeRO-3, ZeRO-2, ZeRO-1) in a one-rank NCCL
    # group, and the vocab-parallel loss at tp = 1
    fsdp_launches = phase_fsdp(torch, port, tflash, device, train_losses,
                               step_ms)
    # the front door (every engine, the builder cache, the handoff chain)
    # and the sharded checkpoint of FLAGSHIP's state
    front_door_launches = phase_front_door(torch, port, tflash, device,
                                           train_losses, step_ms)
    phase_ckpt_sharded(torch, port, device)

    # the DDP helper API: launch and the collectives on the card, the
    # reference workload on the card and in two gloo CPU ranks, the
    # FLAGSHIP LM through the API
    phase_ddp_api(torch)
    phase_ddp_min(torch)
    phase_ddp_world2_cpu(torch)
    phase_ddp_train(torch, tflash, step_ms)
    # the host door: FLAGSHIP over the native group in every wire arm,
    # then the native ring between two rank processes
    host_launches = phase_host_ddp(torch, port, tflash, device, step_ms)
    phase_host_ring()

    # the ResNet-18 rung (cuDNN; no kernel of the port) and the LM rung's
    # optimizer and loss stack (the three flash kernels)
    phase_resnet_check(torch, port, device)
    phase_resnet_train(torch, device)
    phase_lm_stack_check(torch, device)
    phase_lm_stack(torch, port, tflash, device, step_ms)

    # the LM trainer example end to end: checkpoint and resume, device
    # prefetch, eval, generation and a trace
    trainer_per_step = phase_lm_trainer(torch, tflash, device, step_ms)

    # sequence parallelism (LONGCTX through the sp island, then the ring's
    # hops of 4 virtual ranks), the MoE LM, the pipeline schedules
    long_launches = phase_long_context(torch, port, tflash, device)
    ring_launches = phase_ring_hops(torch, tflash, device)
    moe_launches = phase_moe_lm(torch, port, tflash, device)
    pipe_launches = phase_pipeline(torch, port, tflash, device)

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
        train_library_ratio=bwd_timing["fwd_ms"] / bwd_timing["sdpa_fwd_ms"],
        serve_kvq_launches=kvq_launches, serve_spec_launches=spec_launches,
        serve_int8_launches=int8_launches,
        serve_disagg_launches=disagg_launches,
        serve_fleet_launches=fleet_launches)}
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
        row["lm_trainer_launches_per_step"] = trainer_per_step[name]
        row["host_ddp_launches_per_step"] = {
            arm: per_step[name] for arm, per_step in host_launches.items()}
        row["fsdp_launches_per_step"] = {
            arm: per_step[name] for arm, per_step in fsdp_launches.items()}
        row["front_door_launches_per_step"] = {
            arm: per_step[name]
            for arm, per_step in front_door_launches.items()}
        row["long_context_launches_per_step"] = {
            core: per_step[name] for core, per_step in long_launches.items()}
        row["ring_hops_launches"] = {
            core: counts[name] for core, counts in ring_launches.items()}
        row["moe_lm_launches_per_step"] = moe_launches[name]
        row["pipeline_launches_per_step"] = {
            s: per_step[name] for s, per_step in pipe_launches.items()}
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
