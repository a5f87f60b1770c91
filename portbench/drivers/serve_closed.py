"""Serving cells: the port's ``InferenceEngine`` (its own loop thread,
the paged pool) fed by a closed loop of clients.

Each client sends its next request when its last one has finished, so
the engine holds as many requests as there are clients. Set-up makes
the weights from the seed, starts the engine, sends one short request
per prefill bucket the mix reaches, then runs the loop for ``warm_s``
seconds before the window opens. The window counts every token streamed
in it; latencies are taken on the client's side (submit, and each
token's arrival through the engine's ``on_token`` callback) for the
requests sent in it. After the window the clients stop, every request
sent is waited for, and a sample of the finished ones, drawn from the
seed with the longest among them, is held against the reference.
"""

from __future__ import annotations

import gc
import queue
import threading
import time
from typing import List

import numpy as np

from .. import checks, program, traffic, weights as W, yardstick
from ..harness import Outcome, Run
from ..reference import gpt2 as ref
from ..trace import Capture


class ClosedLoop:
    """``clients`` clients over ``requests`` in order (wrapping), each
    sending its next request when the engine settles its last. One
    dispatcher thread submits; the engine's thread only queues
    completions."""

    def __init__(self, engine, requests, clients: int, params_cls):
        self.engine, self.requests = engine, requests
        self.clients, self.params_cls = clients, params_cls
        self.records: List[dict] = []
        self._done: "queue.Queue[dict]" = queue.Queue()
        self._open = True
        self._next = 0
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="portbench-clients")

    def _submit(self) -> None:
        prompt, n_out = self.requests[self._next % len(self.requests)]
        self._next += 1
        rec = {"prompt": prompt, "n_out": n_out, "times": [],
               "error": None, "handle": None}
        times = rec["times"]
        rec["submit"] = time.perf_counter()
        try:
            h = self.engine.submit(
                prompt, self.params_cls(max_new_tokens=n_out,
                                        temperature=0.0),
                on_token=lambda tok, i: times.append(time.perf_counter()))
        except Exception as e:  # noqa: BLE001 - a refusal is a failure
            rec["error"] = e
            self.records.append(rec)
            self._done.put(rec)
            return
        rec["handle"] = h
        self.records.append(rec)
        h.future.add_done_callback(lambda f: self._done.put(rec))

    def _run(self) -> None:
        for _ in range(self.clients):
            self._submit()
        inflight = self.clients
        while inflight:
            rec = self._done.get()
            inflight -= 1
            h = rec["handle"]
            if h is not None and h.future.exception() is not None:
                rec["error"] = h.future.exception()
            if self._open:
                self._submit()
                inflight += 1

    def start(self) -> None:
        self._thread.start()

    def close(self, timeout: float) -> bool:
        """Send nothing more and wait for every request sent; False if
        some did not finish within ``timeout`` seconds."""
        self._open = False
        self._thread.join(timeout)
        return not self._thread.is_alive()


def prefill_flops(cfg: dict, n: int) -> float:
    """A prompt of ``n`` tokens: each position at its own context, the
    vocabulary projected at the last one only."""
    d, L, V = cfg["n_embd"], cfg["n_layer"], cfg["vocab_size"]
    return sum(yardstick.forward_flops_at(d, L, 0, c)
               for c in range(1, n + 1)) + 2.0 * d * V


def decode_flops(cfg: dict, context: int) -> float:
    return yardstick.forward_flops_at(cfg["n_embd"], cfg["n_layer"],
                                      cfg["vocab_size"], context)


def window_readings(cfg: dict, records: List[dict], t0: float, t1: float,
                    traced=None):
    """Tokens streamed in [t0, t1], the model FLOPs done for them, and
    the latencies of the requests sent in the window; in a traced run,
    the latencies only of requests that did not live into the traced
    stretch ``traced`` after the window (the profiler slows the host
    there)."""
    tokens, flops = 0, 0.0
    ttft, tpot, sent, failed = [], [], [], 0
    for rec in records:
        times, p = rec["times"], len(rec["prompt"])
        for k, t in enumerate(times):
            if t0 <= t <= t1:
                tokens += 1
                flops += prefill_flops(cfg, p) if k == 0 \
                    else decode_flops(cfg, p + k)
        if not t0 <= rec["submit"] < t1:
            continue
        sent.append(rec)
        ok = rec["error"] is None and len(times) == rec["n_out"]
        failed += not ok
        if traced is not None and times and not (
                times[-1] < traced[0] or rec["submit"] > traced[1]):
            continue
        ttft.append(times[0] - rec["submit"] if times and ok
                    else float("inf"))
        if ok and len(times) >= 2:
            tpot.append((times[-1] - times[0]) / (len(times) - 1))
    return {"tokens": tokens, "flops": flops, "ttft_s": ttft,
            "tpot_s": tpot, "sent": sent, "failed": failed}


def sample(records: List[dict], seed: int, min_tokens: int) -> List[dict]:
    """Finished requests to check: the longest output first, then others
    drawn from the seed until ``min_tokens`` served tokens are held."""
    done = [r for r in records if r["error"] is None
            and r["handle"] is not None
            and len(r["handle"].tokens) == r["n_out"]]
    if not done:
        return []
    longest = max(range(len(done)),
                  key=lambda i: (done[i]["n_out"], len(done[i]["prompt"])))
    order = [longest] + [int(i) for i in traffic.rng(seed).permutation(
        len(done)) if i != longest]
    out, n = [], 0
    for i in order:
        if n >= min_tokens:
            break
        out.append(done[i])
        n += done[i]["n_out"]
    return out


def build_engine(r: Run):
    import torch
    cfg, mix = r.config, r.mix
    dtype = getattr(torch, cfg["assumed"]["serve"]["weights"])
    dev = torch.device(r.device)
    weights = W.make(cfg, r.seed, dev, dtype)
    model = program.build_model(cfg, dev, dtype)
    W.load_into_port(model, weights)
    del weights
    model.eval()
    eng_mod = program.port("serve.engine")
    engine = eng_mod.InferenceEngine(model, eng_mod.EngineConfig(
        n_slots=mix["n_slots"], max_len=mix["max_len"], paged=True,
        page_len=mix["page_len"]))
    return model, engine


def served(cfg: dict, recs: List[dict], seed: int, device, mm=ref.exact_mm,
           pick_mm=None) -> List[float]:
    """Per served token of ``recs``, the reference's gap (see
    ``reference.gpt2.served_gaps``)."""
    import torch
    ref.strict_float32()
    dtype = getattr(torch, cfg["assumed"]["serve"]["weights"])
    weights = W.make(cfg, seed, device, dtype)
    gaps: List[float] = []
    for rec in recs:
        prompt = torch.as_tensor(rec["prompt"].astype(np.int64), device=device)
        toks = torch.as_tensor(np.asarray(rec["handle"].tokens, np.int64),
                               device=device)
        gaps += ref.served_gaps(weights, cfg, prompt, toks, mm,
                                pick_mm).tolist()
    return gaps


def run(r: Run) -> Outcome:
    import torch
    cfg, mix = r.config, r.mix
    on_card = torch.cuda.is_available() and r.device == "cuda"
    params_cls = program.port("serve.types").SamplingParams
    model, engine = build_engine(r)
    engine.start()
    try:
        warm = [engine.submit(p, params_cls(max_new_tokens=n,
                                            temperature=0.0))
                for p, n in traffic.warm_requests(mix, cfg, r.seed)]
        for h in warm:
            h.result(timeout=mix["drain_s"])
        loop = ClosedLoop(engine, traffic.serve_requests(mix, cfg, r.seed),
                          mix["clients"], params_cls)
        loop.start()
        time.sleep(mix["warm_s"])
        t0 = time.perf_counter()
        time.sleep(r.seconds)
        t1 = time.perf_counter()
        cap, traced = None, None
        if r.trace:
            # after the window, with the clients still sending
            cap = Capture()
            cap.start(all_threads=True)
            ts = time.perf_counter()
            time.sleep(mix["trace_s"])
            cap.stop(sync=False)
            traced = (ts, time.perf_counter())
        drained = loop.close(mix["drain_s"])
    finally:
        engine.shutdown(wait=True)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    summary = cap.summarize() if cap is not None else None
    win = window_readings(cfg, loop.records, t0, t1, traced)
    window_s = t1 - t0
    end_to_end = {"serve_tokens_per_s": win["tokens"] / window_s,
                  "setup_s": t0 - r.t_start}
    context = {"kind": "serve", "window_s": window_s,
               "window_flops": win["flops"], "ttft_s": win["ttft_s"],
               "tpot_s": win["tpot_s"],
               "device_kind": (torch.cuda.get_device_name(0) if on_card
                               else "cpu")}
    del model, engine
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    recs = context["sample"] = sample(win["sent"], r.seed,
                                      mix["sample_tokens"])
    t_ref = time.perf_counter()
    gaps = served(cfg, recs, r.seed, torch.device(r.device))
    context["reference_s"] = time.perf_counter() - t_ref
    numbers = checks.serve_numbers(gaps if gaps else [float("inf")])
    return Outcome(end_to_end=end_to_end, context=context, numbers=numbers,
                   attempted=len(win["sent"]),
                   failed=win["failed"] + (not drained),
                   memory_peak_bytes=peak, trace=summary)
