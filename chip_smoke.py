#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (``distributed_pytorch_tpu_torch``).

    python3 chip_smoke.py

Needs one CUDA card and the CUDA toolkit (``nvcc``); imports nothing of
JAX or the JAX package. Phases, one JSON line each; any failure exits
non-zero at once:

1. device   — card name and power limit, TF32 off for the reference math;
2. build    — compiles every kernel of the serving path from ``csrc/``;
3. kernel   — the flash forward kernel against its plain PyTorch version
              on the card, bf16 (|diff| <= 2e-2) and f32 (|diff| <= 1e-4),
              with NaN rows identical, over the masking cases; then its
              time beside its bound, the plain version's and SDPA's;
4. model    — a flagship-width model's prefill logits on the card (f32,
              flash kernel) against the same weights on the CPU (plain
              path), |diff| <= 2e-3;
5. serve    — the flagship-width TransformerLM (vocab 32000, dim 768,
              12 layers, 12 heads, learned positions, max_seq 2048, bf16,
              random weights from a seed) behind ``InferenceEngine``:
              6 requests over prompt lengths 100-1900, half greedy, half
              temperature 0.8 / top-k 50; every request must finish, the
              flash kernel must have launched 12 times per admit whose
              bucket reaches DPX_FLASH_MIN_SEQ, and a greedy stream must
              equal standalone ``generate()``;
6. breakdown — one admit prefill per bucket and one 4-slot decode step,
              host time and the device-busy share from torch.profiler.

Then the ``kernels`` line, the nvidia-smi line and, last, the result line
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

REPLACES = "distributed_pytorch_tpu/ops/flash_attention.py:166"
SOURCE = "distributed_pytorch_tpu_torch/csrc/flash_attention_fwd.cu"
# dense bf16 tensor-core peak (FLOP/s) and HBM rate (B/s) by card name,
# from NVIDIA's data sheets; the SXM part is the default
PEAKS = {"H100 PCIe": (756e12, 2.0e12), "H100 NVL": (835e12, 3.9e12),
         "H200": (989e12, 4.8e12), "H100": (989e12, 3.35e12)}
TOL = {"bfloat16": 2e-2, "float32": 1e-4}
FLAGSHIP = dict(vocab=32000, dim=768, n_layers=12, n_heads=12,
                max_seq=2048, pos="learned")
PROMPT_LENS = (100, 300, 700, 1024, 1500, 1900)
GREEDY = (0, 3, 4)            # indices of the greedy requests
COMPARE = 3                   # the greedy request held to generate()
MAX_NEW = 32


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


def flash_cost(b, h, h_kv, s_q, s_k, d, dtype_bytes, causal=True):
    """(FLOPs, bytes) the forward needs for these inputs: 4*D FLOPs per
    visible (query, key) pair; q/k/v read once, O and lse written once."""
    if causal:
        off = s_k - s_q
        pairs = sum(max(0, min(s_k, r + off + 1)) for r in range(s_q))
    else:
        pairs = s_q * s_k
    flops = 4.0 * d * pairs * b * h
    nbytes = (dtype_bytes * d * (b * h * s_q * 2 + b * h_kv * s_k * 2)
              + 4 * b * h * s_q)
    return flops, nbytes


def phase_kernel(torch, tflash, device):
    cases = [
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
    rng = np.random.default_rng(0)
    worst = {}
    for name, b, h, h_kv, s_q, s_k, d, kw in cases:
        base = [rng.standard_normal(shape).astype(np.float32)
                for shape in ((b, h, s_q, d), (b, h_kv, s_k, d),
                              (b, h_kv, s_k, d))]
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = (torch.from_numpy(x).to(device, dtype) for x in base)
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
                 shape=[b, h, h_kv, s_q, s_k, d], nan_rows=int(
                     nan[..., 0].sum().item()), max_abs_err=err,
                 tol=TOL[tname], **kw)
            if not err <= TOL[tname]:
                fail(f"kernel {name} {tname}: |diff| {err} > {TOL[tname]}")
            worst[tname] = max(worst.get(tname, 0.0), err)
    if not any(c[0] == "sq_gt_sk_nan_rows" for c in cases):
        fail("the NaN-row case is missing")

    # time at the flagship prefill shape the serving path gives it
    b, h, s, d = 1, 12, 2048, 64
    q, k, v = (torch.randn(b, h, s, d, device=device, dtype=torch.bfloat16)
               for _ in range(3))
    ms = cuda_ms(lambda: tflash.flash_attention_fwd_cuda(q, k, v,
                                                         causal=True), 20)
    plain_ms = cuda_ms(lambda: tflash.flash_attention_fwd_reference(
        q, k, v, causal=True), 3)
    library_ms = cuda_ms(lambda: torch.nn.functional
                         .scaled_dot_product_attention(q, k, v,
                                                       is_causal=True), 20)
    flops, nbytes = flash_cost(b, h, h, s, s, d, 2)
    peak_flops, peak_bw = peaks(torch.cuda.get_device_name(0))
    t_ops, t_bytes = flops / peak_flops * 1e3, nbytes / peak_bw * 1e3
    timing = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                  bound_ms=max(t_ops, t_bytes),
                  bound_by="operations" if t_ops >= t_bytes else "bytes",
                  flops=flops, bytes=nbytes,
                  shape=[b, h, h, s, s, d], dtype="bfloat16",
                  tflops_per_s=flops / ms / 1e9)
    emit(phase="kernel_time", **timing)
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
    return launches, model, eng.pool


def device_busy_ms(torch, fn) -> float:
    """Device time of ``fn`` summed over its kernels (torch.profiler),
    or None where the profiler reports none."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    total = sum(getattr(e, "self_device_time_total",
                        getattr(e, "self_cuda_time_total", 0))
                for e in prof.key_averages())
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

    t0 = time.perf_counter()
    report = _build.build(tflash.KERNEL_SOURCE)
    _build.load(tflash.KERNEL_SOURCE)
    emit(phase="build", source=SOURCE, build_s=time.perf_counter() - t0,
         ptxas=[ln.split("info    :")[-1].strip()
                for ln in report.splitlines()
                if "registers" in ln or "spill" in ln])

    worst, timing = phase_kernel(torch, tflash, device)
    phase_model_check(torch, port.TransformerLM, tflash.make_flash_attn_fn,
                      device)
    launches, model, pool = phase_serve(torch, port, tflash, device)
    phase_breakdown(torch, model, pool, timing["ms"])

    print(json.dumps({"kernels": [{
        "name": "flash_attention_fwd", "route": "cuda", "source": SOURCE,
        "replaces": REPLACES, "launches": launches,
        "max_abs_err": worst["bfloat16"], "ms": timing["ms"],
        "plain_ms": timing["plain_ms"], "bound_ms": timing["bound_ms"],
        "bound_by": timing["bound_by"],
        "library_ms": timing["library_ms"]}]}), flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
