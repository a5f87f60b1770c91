"""Serve an LM with continuous batching: the serving front door, live.

Counterpart of the JAX package's ``examples/serve_lm.py``, with its
flags and defaults. Builds a small ``TransformerLM`` (seeded random
weights), starts ``serve.InferenceEngine``, submits concurrent requests
with mixed prompts, sampling settings and priorities, streams the tokens
to stdout as they come (per-token callbacks), then prints each request's
SLO record and the engine's stats.

    python -m distributed_pytorch_tpu_torch.examples.serve_lm \\
        [--requests N] [--max-new N] [--slots N] [--temperature T] \\
        [--metrics-log FILE] [--paged] [--shared-prefix N] [--disagg] \\
        [--handoff-width W] [--device {cuda,cpu}]

``--metrics-log`` appends the per-request TTFT/TPOT events and the
periodic engine snapshots as line-JSON (``utils.logging.MetricsLogger``).
``--paged`` serves from the paged, prefix-shared KV pool
(``serve/pages/``); ``--shared-prefix N`` gives every request the same
N-token system prompt, so the per-request lines show its pages computed
once and hit afterwards. ``--disagg`` (default ``DPX_SERVE_DISAGG``)
runs the disaggregated split (``serve/disagg/``): separate prefill and
decode engines joined by the KV-page handoff, ``--handoff-width``
f32|q8|q4 choosing the frame's wire; the per-request lines then print
the TTFT decomposition (queue / prefill / handoff / decode) and the
handoff bytes. The model runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from distributed_pytorch_tpu_torch.models import TransformerLM
from distributed_pytorch_tpu_torch.ops.flash_attention import \
    make_flash_attn_fn
from distributed_pytorch_tpu_torch.runtime import env as _env
from distributed_pytorch_tpu_torch.runtime.device import (default_generator,
                                                          resolve_device)
from distributed_pytorch_tpu_torch.serve import (DisaggConfig, DisaggEngine,
                                                 EngineConfig,
                                                 InferenceEngine,
                                                 SamplingParams)
from distributed_pytorch_tpu_torch.utils.logging import MetricsLogger


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="continuous-batching LM serving")
    p.add_argument("--requests", type=int, default=6)
    p.add_argument("--max-new", type=int, default=24)
    p.add_argument("--slots", type=int, default=3)
    p.add_argument("--max-len", type=int, default=128)
    p.add_argument("--temperature", type=float, default=0.8)
    p.add_argument("--metrics-log", type=str, default=None)
    p.add_argument("--paged", action="store_true",
                   help="paged, prefix-shared KV cache (serve/pages/)")
    p.add_argument("--shared-prefix", type=int, default=0,
                   help="give every request the same N-token system "
                        "prompt (shows prefix sharing with --paged)")
    p.add_argument("--disagg", action="store_true",
                   default=bool(_env.get("DPX_SERVE_DISAGG")),
                   help="disaggregated prefill/decode split "
                        "(serve/disagg/; default DPX_SERVE_DISAGG)")
    p.add_argument("--handoff-width", type=str, default=None,
                   choices=("f32", "q8", "q4"),
                   help="wire width of the KV-page handoff frame "
                        "(default DPX_HANDOFF_WIDTH)")
    p.add_argument("--device", default=None, choices=("cuda", "cpu"),
                   help="Run on the CPU, or on the card (default).")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    model = TransformerLM(vocab=61, dim=64, n_layers=2, n_heads=4,
                          n_kv_heads=2, pos="rope", max_seq=256,
                          attn_fn=make_flash_attn_fn(), device=device,
                          generator=default_generator(device, 0))
    logger = MetricsLogger(path=args.metrics_log) if args.metrics_log \
        else None
    if args.disagg:
        cfg = DisaggConfig(n_slots=args.slots, max_len=args.max_len,
                           metrics=logger, log_every=8,
                           handoff_width=args.handoff_width)
        eng = DisaggEngine(model, cfg)
    else:
        cfg = EngineConfig(n_slots=args.slots, max_len=args.max_len,
                           metrics=logger, log_every=8, paged=args.paged)
        eng = InferenceEngine(model, cfg)
    rng = np.random.default_rng(0)
    shared = rng.integers(0, 61, (args.shared_prefix,)).astype(np.int32) \
        if args.shared_prefix else None

    def stream(rid):
        def cb(tok, i):
            print(f"  [req {rid}] token {i}: {tok}", flush=True)
        return cb

    with eng:
        handles = []
        for i in range(args.requests):
            prompt = rng.integers(0, 61, (int(rng.integers(4, 20)),)
                                  ).astype(np.int32)
            if shared is not None:
                prompt = np.concatenate([shared, prompt])
            sp = SamplingParams(
                max_new_tokens=args.max_new,
                # a mix of greedy and sampled requests
                temperature=0.0 if i % 2 == 0 else args.temperature,
                top_k=None if i % 2 == 0 else 8,
                priority=0 if i == args.requests - 1 else 5)
            h = eng.submit(prompt, sp,
                           generator=default_generator(device, i),
                           on_token=stream(i))
            handles.append(h)
            print(f"submitted req {h.request_id}: prompt_len "
                  f"{len(prompt)}, max_new {sp.max_new_tokens}, "
                  f"T={sp.temperature}, priority {sp.priority}")
        for h in handles:
            toks = h.result(timeout=300)
            m = h.metrics
            line = (f"req {h.request_id} done: {len(toks)} tokens, "
                    f"TTFT {m['ttft_ms']:.1f} ms")
            if m["tpot_ms"]:
                line += f", TPOT {m['tpot_ms']:.2f} ms"
            if args.disagg:
                line += (f" [queue {m['queue_ms']:.1f} + prefill "
                         f"{m['prefill_ms']:.1f} + handoff "
                         f"{m['handoff_ms']:.1f} + decode "
                         f"{m['decode_ms']:.1f} ms; "
                         f"{m['handoff_bytes']} handoff B, "
                         f"prefix hit {m['prefix_hit_pages']} pages]")
            elif args.paged:
                line += (f", prefix hit {m['prefix_hit_pages']} pages "
                         f"({m['prefill_tokens_saved']} prefill tokens "
                         f"saved)")
            print(line)
        st = eng.stats()
        if args.disagg:
            print(f"split: {st['decode']['decode_steps']} decode steps "
                  f"(prefill side {st['prefill']['decode_steps']}), "
                  f"prefill admits {st['prefill']['prefill_admits']}, "
                  f"{st['handoff']['frames_sent']} frames / "
                  f"{st['handoff']['bytes_sent']} handoff bytes "
                  f"({st['handoff_width']})")
        else:
            print(f"engine: {st['iterations']} iterations, "
                  f"{st['tokens_emitted']} tokens, {st['decode_steps']} "
                  f"decode steps, prefill admits {st['prefill_admits']}")
        if args.paged and not args.disagg:
            ps = st["pages"]
            hr = ps["prefix_hit_rate"]
            print(f"pages: {ps['pages_in_use']}/{ps['n_pages']} in use "
                  f"(page_len {ps['page_len']}), hit rate "
                  f"{hr if hr is None else round(hr, 3)}, "
                  f"{ps['evictions']} evictions")
    if device.type == "cuda":
        torch.cuda.synchronize()
    if logger is not None:
        logger.close()
        print(f"metrics -> {args.metrics_log}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
