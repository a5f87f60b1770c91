"""Training cells on one card: the port's train step, built by the front
door (``parallel/front_door.py`` ``make_step``, the DDP engine at world
1), over the port's loader, timed for the window.

Set-up makes the weights and the rows from the seed, builds the step,
and drives it through the mix's ``checked_steps`` on the first rows:
that is the warm-up, and what the reference follows. The same model,
optimizer state, step and loader then run the window. Once the window
has closed and the memory peak is read, the program's state is freed
and the reference runs the checked steps in float32.

:class:`Trainer`, :func:`window` and :func:`reference_readings` serve
the data-parallel driver too, one rank at a time.
"""

from __future__ import annotations

import contextlib
import gc
import time
from typing import List

from .. import checks, program, traffic, weights as W, yardstick
from ..harness import Outcome, Run
from ..reference import gpt2 as ref
from ..trace import Capture

SPAN_LOADER, SPAN_STEP = "portbench.loader", "portbench.step"
#: At world > 1 the ranks agree to stop through an all-reduced flag,
#: read this many steps late so that reading it never waits.
STOP_LAG = 2


def lm_loss(model, batch):
    """Mean next-token cross-entropy, the port's plain loss."""
    x, y = batch
    return program.port("ops.losses").cross_entropy(model(x), y), {}


class Trainer:
    """One training object: model, optimizer state, step and feed. At
    world > 1 (inside a rank the port's launcher started) the model is
    wrapped by ``prepare_ddp_model`` and the step is ``make_train_step``
    with its gradient all-reduce, fed through ``data_sampler``."""

    def __init__(self, r: Run, rank: int = 0, world: int = 1):
        import torch
        #: set-up's phases, each as seconds from the run's start
        self.stamps = {}
        self.t_start = r.t_start
        self.stamp("enter")
        cfg, mix = r.config, r.mix
        hp = cfg["assumed"]["train"]
        self.adam = hp["adamw"]
        self.world = world
        dist = program.port("api")
        self.device = dist.get_device() if world > 1 \
            else torch.device(r.device)
        weights = W.make(cfg, r.seed, self.device, torch.float32)
        self.stamp("weights")
        model = program.build_model(cfg, self.device, torch.float32)
        W.load_into_port(model, weights)
        self.stamp("model")
        # each port parameter's GPT-2 name and its initial value there
        self.names: List[str] = []
        self.initial = []
        by_port = {W.port_name(n)[0]: n for n in weights}
        for pname, _ in model.named_parameters():
            gname = by_port[pname]
            _, transposed = W.port_name(gname)
            self.names.append(gname)
            self.initial.append(weights[gname].t() if transposed
                                else weights[gname])
        a = self.adam
        self.opt = program.port("optim").adamw(
            a["lr"], b1=a["b1"], b2=a["b2"], eps=a["eps"],
            weight_decay=a["weight_decay"])
        if world > 1:
            self.model = dist.prepare_ddp_model(model, device_ids=[rank])
            self.step = program.port("parallel").make_train_step(
                lm_loss, self.opt, mixed_precision=hp["mixed_precision"])
        else:
            self.model = model
            self.step = program.port("parallel.front_door").make_step(
                lm_loss, self.opt, mixed_precision=hp["mixed_precision"])
        self.state = self.opt.init(self.model.parameters())
        self.feed = program.batches(traffic.train_rows(mix, cfg, r.seed),
                                    mix["batch"], self.device, rank, world)
        self.stamp("built")

    def stamp(self, name: str) -> None:
        self.stamps[name] = time.perf_counter() - self.t_start

    def one(self):
        out = self.step(self.model, self.state, next(self.feed))
        self.state = out.opt_state
        return out.loss

    def checked_steps(self, n: int) -> dict:
        """Drive the first ``n`` steps and read what the reference is
        compared on: each loss, each leaf's first gradient (from the
        AdamW state after step 1) and its change after step ``n``, the
        leaves as ``weights.parts`` cuts them."""
        losses, grad_norms = [], {}
        for t in range(1, n + 1):
            losses.append(self.one())
            if t == 1:
                scale = 1.0 - self.adam["b1"]
                grad_norms = {n: float(part.norm()) / scale
                              for g, mu in zip(self.names, self.state.mu)
                              for n, part in W.parts(g, mu, True)}
        change = {n: float(part.norm()) for g, p, w0 in
                  zip(self.names, self.model.parameters(), self.initial)
                  for n, part in W.parts(g, p.detach() - w0, True)}
        self.initial = None
        self.stamp("checked")
        return {"losses": [float(x) for x in losses],
                "grad_norms": grad_norms, "change_norms": change}

    def free(self) -> None:
        import torch
        self.model = self.state = self.step = self.feed = None
        self.opt = self.initial = None
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()


def reference_readings(r: Run, mm=ref.exact_mm, first=None,
                       world: int = 1, ranks=None) -> dict:
    """The reference over the checked steps' rows, one part per rank
    (``first`` rows of each part, or only the parts of ``ranks``, where
    a fault is planted)."""
    import torch
    cfg, mix = r.config, r.mix
    dev = torch.device(r.device)
    ref.strict_float32()
    weights = W.make(cfg, r.seed, dev, torch.float32)
    rows = traffic.train_rows(mix, cfg, r.seed)
    steps = []
    for t in range(mix["checked_steps"]):
        parts = []
        for rank in (range(world) if ranks is None else ranks):
            part = torch.from_numpy(traffic.rank_rows(
                rows, mix["batch"], world, rank, t)[:first]).to(dev)
            parts.append((part[:, :-1], part[:, 1:]))
        steps.append(parts)
    res = ref.train(weights, cfg, steps, cfg["assumed"]["train"]["adamw"],
                    mm)
    del weights, steps
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return res


def flops_per_step(cfg: dict, mix: dict, world: int = 1) -> float:
    return 3 * yardstick.model_flops_per_token(
        cfg["n_embd"], cfg["n_layer"], cfg["vocab_size"], mix["seq"]) \
        * mix["batch"] * mix["seq"] * world


def window(tr: Trainer, r: Run) -> dict:
    """Run the window: steps until ``seconds`` have passed on the host
    clock, the last one finished on the device. At world > 1 every rank
    stops after the same step: the first whose all-reduced flag, read
    :data:`STOP_LAG` steps late, says some rank's time is up. With
    ``--trace 1`` the mix's ``trace_steps`` further steps are traced
    after the window has closed, the benchmark's spans marking the
    loader and the step, so that the window's own numbers carry no
    profiler."""
    import torch
    on_card = torch.cuda.is_available() and tr.device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    loader_s: List[float] = []
    losses, flags = [], []

    def one(span):
        a = time.perf_counter()
        with span(SPAN_LOADER):
            batch = next(tr.feed)
        loader_s.append(time.perf_counter() - a)
        with span(SPAN_STEP):
            out = tr.step(tr.model, tr.state, batch)
        tr.state = out.opt_state
        losses.append(out.loss)

    untraced = lambda name: contextlib.nullcontext()  # noqa: E731
    steps = 0
    sync()
    t0 = time.perf_counter()
    while True:
        one(untraced)
        steps += 1
        up = time.perf_counter() - t0 >= r.seconds
        if tr.world > 1:
            flag = torch.full((1,), int(up), device=tr.device)
            torch.distributed.all_reduce(flag,
                                         op=torch.distributed.ReduceOp.MAX)
            flags.append(flag)
            up = len(flags) > STOP_LAG and bool(flags[-1 - STOP_LAG].item())
        if up:
            break
    sync()
    t1 = time.perf_counter()
    window_loader = loader_s[:]
    summary = None
    if r.trace:
        cap = Capture()
        cap.start()
        for _ in range(r.mix["trace_steps"]):
            one(torch.profiler.record_function)
        cap.stop()
        summary = cap.summarize()
    finite = torch.isfinite(torch.cat(losses)).tolist()
    return {"t0": t0, "t1": t1, "steps": steps, "loader_s": window_loader,
            "nonfinite": finite.count(False), "trace": summary}


def context_of(r: Run, w: dict, device_kind: str, world: int = 1) -> dict:
    """What the per-layer readers read from a training window."""
    cfg, mix = r.config, r.mix
    return {"kind": "train", "steps": w["steps"],
            "window_s": w["t1"] - w["t0"],
            "flops_per_step": flops_per_step(cfg, mix, world),
            "loader_s": w["loader_s"], "traced_steps": mix["trace_steps"],
            "batch": mix["batch"], "seq": mix["seq"],
            "heads": cfg["n_head"], "head_dim": cfg["n_embd"] // cfg["n_head"],
            "device_kind": device_kind, "chips": world,
            "setup_stamps": w.get("setup_stamps")}


def run(r: Run) -> Outcome:
    import torch
    on_card = torch.cuda.is_available() and r.device == "cuda"
    tr = Trainer(r)
    readings = tr.checked_steps(r.mix["checked_steps"])
    setup_peak = torch.cuda.max_memory_allocated() if on_card else 0
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    w = dict(window(tr, r), setup_stamps=tr.stamps)
    window_s = w["t1"] - w["t0"]
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    mix = r.mix
    tokens = w["steps"] * mix["batch"] * mix["seq"]
    end_to_end = {"train_tokens_per_s": tokens / window_s,
                  "train_peak_mem_gib": peak / 2 ** 30,
                  "setup_s": w["t0"] - r.t_start}
    context = context_of(r, w, torch.cuda.get_device_name(0) if on_card
                         else "cpu")
    tr.free()
    t_ref = time.perf_counter()
    context["readings"] = readings
    context["reference"] = reference_readings(r)
    context["reference_s"] = time.perf_counter() - t_ref
    numbers = checks.train_numbers([readings], context["reference"])
    context["loss_gaps"] = checks.loss_gaps([readings], context["reference"])
    return Outcome(end_to_end=end_to_end, context=context, numbers=numbers,
                   attempted=w["steps"], failed=w["nonfinite"],
                   memory_peak_bytes=max(setup_peak, peak), trace=w["trace"])
