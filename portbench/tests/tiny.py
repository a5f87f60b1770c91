"""A tiny benchmark root for CPU tests: a GPT-2 of the same form at a
size a test run holds, its mixes, limits and cells, written as files
only beside a copy of the real metric readers."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from portbench import harness

TINY = {
    "source": "test", "model_type": "gpt2", "activation_function": "gelu_new",
    "n_embd": 32, "n_layer": 2, "n_head": 4, "n_positions": 64, "n_ctx": 64,
    "vocab_size": 101, "layer_norm_epsilon": 1e-05, "initializer_range": 0.02,
    "attn_pdrop": 0.0, "embd_pdrop": 0.0, "resid_pdrop": 0.0,
    "tie_word_embeddings": True, "reduced": [],
    "assumed": {"train": {"mixed_precision": "bf16",
                          "adamw": {"lr": 3e-4, "b1": 0.9, "b2": 0.999,
                                    "eps": 1e-08, "weight_decay": 0.01}},
                "serve": {"weights": "bfloat16"}},
}
TRAIN_MIX = {"driver": "train", "batch": 4, "seq": 16, "rows": 64,
             "checked_steps": 3, "trace_steps": 2}
#: Serving's metrics, as a serving cell would list them: no serving cell
#: is in BENCHMARK.json yet (see PERF.md), the harness serves the tiny one.
SERVE_E2E = [{"name": "serve_tokens_per_s", "unit": "tokens/s",
              "better": "higher", "bound": 0.25, "source": "host_clock",
              "workloads": ["tiny.serve"]}]
SERVE_PER_LAYER = [
    {"name": n, "unit": u, "better": b, "source": s, "layer": layer,
     "moves": "serve_tokens_per_s", "workloads": ["tiny.serve"]}
    for n, u, b, s, layer in (
        ("serve_mfu", "%", "higher", "host_clock", "serving step"),
        ("device_idle_share.serve", "%", "lower", "device_trace", "device"),
        ("serve_ttft_p95_ms", "ms", "lower", "host_clock",
         "serving front door"),
        ("serve_tpot_p95_ms", "ms", "lower", "host_clock", "decode path"))]
DDP_MIX = dict(TRAIN_MIX, driver="ddp_train", launch_timeout_s=300)
SERVE_MIX = {"driver": "serve_closed", "clients": 3, "n_slots": 3,
             "max_len": 64, "page_len": 8, "requests": 64, "size_set": 24,
             "size_seed": 1,
             "prompt": {"median": 12, "sigma": 0.4, "min": 4, "max": 30},
             "output": {"median": 6, "sigma": 0.4, "min": 2, "max": 10},
             "max_total": 64, "warm_prompts": [4, 16, 30], "warm_output": 2,
             "warm_s": 0.2, "trace_s": 0.3,
             "sample_tokens": 20, "drain_s": 60}
#: The tiny cells' limits, set as the cells' own are: from the program's
#: readings over seeds 1-4 (gradient 0.0044, change 0.027) and the
#: control's over seeds 1-3 (fp8 gradient >= 0.018; half the batch:
#: gradient >= 0.48, change >= 0.22; a frozen state: change 1);
#: serving at initializer_range 0.5, where the program's mean gap reads
#: under 0.002 and the fp8 control's over 0.05.
LIMITS = {"tiny.train": {"grad_norm_gap": 0.009, "change_norm_gap": 0.08},
          "tiny.serve": {"served_logit_gap_mean": 0.05}}
LIMITS["tiny.ddp"] = LIMITS["tiny.train"]
#: Serving's tiny configuration: random weights at GPT-2's 0.02 give a
#: 32-wide model logits too flat for any precision to reorder.
TINY_SERVE = dict(TINY, initializer_range=0.5)


def write(path: Path, obj) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(obj, indent=1))


def make_root(root: Path) -> Path:
    """Files only: two configurations, three mixes, three limits, the
    metric readers, and a BENCHMARK.json naming three cells (one of four
    CPU ranks over gloo) and every metric the real one names."""
    real = harness.load_benchmark()
    pb = root / "portbench"
    write(pb / "configs" / "tiny.json", TINY)
    write(pb / "configs" / "tiny_serve.json", TINY_SERVE)
    write(pb / "mixes" / "tiny_train.json", TRAIN_MIX)
    write(pb / "mixes" / "tiny_serve.json", SERVE_MIX)
    write(pb / "mixes" / "tiny_ddp.json", DDP_MIX)
    for cell, lim in LIMITS.items():
        write(pb / "limits" / f"{cell}.json", lim)
    shutil.copytree(harness.HERE / "metrics", pb / "metrics")
    cells = {"tiny.train": ("tiny_train", "train", "tiny"),
             "tiny.serve": ("tiny_serve", "serve", "tiny_serve"),
             "tiny.ddp": ("tiny_ddp", "train", "tiny")}

    def retarget(m):
        """The real metric on the tiny cells of its kind."""
        m = dict(m)
        if "workloads" in m:
            ddp = "gpt2-xl.ddp4" in m["workloads"]
            one = any(w != "gpt2-xl.ddp4" for w in m["workloads"])
            m["workloads"] = ["tiny.train"] * one + ["tiny.ddp"] * ddp
        return m
    bench = dict(real,
                 configs=[{"name": n, "source": "test",
                           "file": f"portbench/configs/{n}.json",
                           "reduced": [], "why": "test"}
                          for n in ("tiny", "tiny_serve")],
                 workloads=[{"name": c, "config": n, "traffic": t,
                             "chips": 4 if c == "tiny.ddp" else 1,
                             "why": "test"}
                            for c, (t, _, n) in cells.items()],
                 end_to_end=[retarget(m) for m in real["end_to_end"]]
                 + SERVE_E2E,
                 per_layer=[retarget(m) for m in real["per_layer"]]
                 + SERVE_PER_LAYER)
    write(root / "BENCHMARK.json", bench)
    return root
