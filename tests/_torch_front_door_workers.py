"""Rank workers of ``test_torch_front_door.py``, spawned by
``launch_multiprocess`` over gloo CPU ranks (or the native host group).

They import the port, torch and numpy only: the weights (JAX param trees
of numpy arrays, loaded with ``convert.from_jax_params``) and the
batches come in as arguments. Rank 0 writes what the ranks saw to
``<out_dir>/<name>.pt``.
"""

import os

import numpy as np
import torch

#: the MLP of the spec matrix (the JAX suite's ``_setup(hidden=64,
#: in_dim=8)``) and its global batch
MLP = dict(in_dim=8, hidden_dim=64, n_classes=4)
LR = 1e-3
EPS = 1e-6                # _torch_fsdp_workers.EPS says why
STEPS = 5
#: the LM of the handoff chain
LM = dict(vocab=64, dim=32, n_layers=2, n_heads=2, pos="rope", max_seq=64)

#: (name, wire, weight_update) — the dp points of the matrix
DP_POINTS = [("mean-replicated", "mean", "replicated"),
             ("quant-replicated", "quant", "replicated"),
             ("q4-replicated", "q4", "replicated"),
             ("adaptive-replicated", "adaptive", "replicated"),
             ("mean-sharded", "mean", "sharded"),
             ("quant-sharded", "quant", "sharded")]
RUNGS = ("zero3", "zero2", "zero1")


def mlp(params_np):
    from distributed_pytorch_tpu_torch import from_jax_params
    from distributed_pytorch_tpu_torch.models import DummyModel
    return from_jax_params(params_np, DummyModel(device="cpu", **MLP))


def lm(params_np, **over):
    from distributed_pytorch_tpu_torch import TransformerLM, from_jax_params
    return from_jax_params(params_np,
                           TransformerLM(device="cpu", **dict(LM, **over)))


def mlp_loss(model, batch):
    from distributed_pytorch_tpu_torch.ops.losses import cross_entropy
    x, y = batch
    return cross_entropy(model(x), y), {}


def lm_loss(model, tokens):
    from distributed_pytorch_tpu_torch.ops.losses import cross_entropy
    logits = model(tokens[:, :-1])
    return cross_entropy(logits.reshape(-1, LM["vocab"]),
                         tokens[:, 1:].reshape(-1)), {}


def adamw():
    from distributed_pytorch_tpu_torch import optim
    return optim.adamw(LR, eps=EPS)


def rows(batch, index, n):
    """Rank ``index``'s rows of a global batch (numpy arrays)."""
    def cut(a):
        k = a.shape[0] // n
        return torch.from_numpy(a[index * k:(index + 1) * k])
    return tuple(cut(a) for a in batch) if isinstance(batch, tuple) \
        else cut(batch)


def _pmean_losses(step, model, state, batch, steps=STEPS):
    """The global mean loss of each step (each rank's loss averaged over
    the ranks, on either group)."""
    from distributed_pytorch_tpu_torch.comm.collectives import all_reduce
    losses = []
    for _ in range(steps):
        out = step(model, state, batch)
        state = out.opt_state
        losses.append(float(all_reduce(
            out.loss.detach().float().mean().reshape(1), "avg")[0]))
    return losses, state


def _count_reshards():
    """Wrap ``DTensor.redistribute`` and ``DTensor.full_tensor`` with
    counters; returns (counts, restore)."""
    from torch.distributed.tensor import DTensor
    counts = {"redistribute": 0, "full_tensor": 0}
    saved = {n: getattr(DTensor, n) for n in counts}

    def wrap(name, fn):
        def run_(self, *a, **kw):
            counts[name] += 1
            return fn(self, *a, **kw)
        return run_
    for n, fn in saved.items():
        setattr(DTensor, n, wrap(n, fn))

    def restore():
        for n, fn in saved.items():
            setattr(DTensor, n, fn)
    return counts, restore


def matrix_worker(rank, world, out_dir, mlp_params, batch, lm_params,
                  tokens):
    """The spec matrix over the ranks (every dp point, the ladder,
    FROM_INPUTS), the handoff chain and the handoff surface."""
    import distributed_pytorch_tpu_torch as dist
    from distributed_pytorch_tpu_torch.ops.flash_attention import \
        make_flash_attn_fn
    from distributed_pytorch_tpu_torch.parallel import (
        FROM_INPUTS, HandoffMismatch, StepSpecs, front_door, fsdp,
        handoff_shardings, make_step, shard_batch_spec, shard_params,
        verify_handoff)
    from distributed_pytorch_tpu_torch.parallel.tensor import (
        P, replicated_specs)
    from distributed_pytorch_tpu_torch.runtime import context
    from distributed_pytorch_tpu_torch.serve import (EngineConfig,
                                                     InferenceEngine,
                                                     SamplingParams)

    dist.init_process_group(rank, world)
    mesh = context.get_mesh()
    local = rows(batch, rank, world)
    rec = {"dp": {}, "ladder": {}}

    for name, wire, wu in DP_POINTS:
        model = mlp(mlp_params)
        opt = adamw()
        step = make_step(mlp_loss, opt, wire=wire, weight_update=wu,
                         donate=False)
        state = (step.init_opt_state(model) if wu == "sharded"
                 else opt.init(model.parameters()))
        losses, _ = _pmean_losses(step, model, state, local)
        rec["dp"][name] = {
            "losses": losses, "trace_counts": dict(step.trace_counts),
            "widths": (list(step.width_chooser.widths)
                       if step.width_chooser is not None else None),
            "in_eq_out": (step.in_shardings["params"]
                          == step.out_shardings["params"]
                          and step.in_shardings["opt"]
                          == step.out_shardings["opt"])}

    for rung in RUNGS:
        model = mlp(mlp_params)
        opt = adamw()
        p_specs, _, axes = fsdp.shard_layouts(model, None, n_shards=world,
                                              min_size=64)
        rep = replicated_specs(model)
        specs = {"zero3": StepSpecs(params=p_specs),
                 "zero2": StepSpecs(params=rep, opt=p_specs,
                                    grads=p_specs),
                 "zero1": StepSpecs(params=rep, opt=p_specs,
                                    grads=rep)}[rung]
        step = make_step(mlp_loss, opt, mesh=mesh, specs=specs,
                         donate=False)
        losses, _ = _pmean_losses(step, model, opt.init(model.parameters()),
                                  local)
        rec["ladder"][rung] = {
            "losses": losses, "compiles": step.compiles, "axes": axes,
            "opt_eq": step.out_shardings["opt"] == step.in_shardings["opt"],
            "params_eq": (step.out_shardings["params"]
                          == step.in_shardings["params"]),
            "verify": verify_handoff(model, handoff_shardings(step))
            is model}

    # FROM_INPUTS: replicated DTensor parameters, the batch over dp
    model = shard_params(mlp(mlp_params), replicated_specs(mlp(mlp_params)),
                         mesh)
    opt = adamw()
    step = make_step(mlp_loss, opt, specs=FROM_INPUTS, donate=False)
    g = shard_batch_spec(tuple(torch.from_numpy(a) for a in batch), mesh,
                         P("dp"))
    state = opt.init(model.parameters())
    losses = []
    for _ in range(STEPS):
        out = step(model, state, g)
        state = out.opt_state
        losses.append(float(out.loss))
    rec["from_inputs"] = {"losses": losses, "compiles": step.compiles,
                          "loss_dim": out.loss.dim()}
    # the flash path of a TransformerLM on DTensors (the CPU plain
    # kernels), one step, and a sequence-sharded batch refused
    tm = lm(lm_params, attn_fn=make_flash_attn_fn(min_seq_flash=0))
    tm = shard_params(tm, replicated_specs(tm), mesh)
    opt = adamw()
    lstep = make_step(lm_loss, opt, specs=FROM_INPUTS, donate=False)
    tok = torch.from_numpy(tokens)
    out = lstep(tm, opt.init(tm.parameters()),
                shard_batch_spec(tok, mesh, P("dp")))
    rec["from_inputs_lm"] = float(out.loss)
    # the same batch sharded along the sequence: the flash kernel runs
    # on the gathered sequence, two steps from the same weights
    tm = lm(lm_params, attn_fn=make_flash_attn_fn(min_seq_flash=0))
    tm = shard_params(tm, replicated_specs(tm), mesh)
    seq = shard_batch_spec(tok, mesh, P(None, "dp"))
    state = opt.init(tm.parameters())
    rec["seq_sharded"] = []
    for _ in range(2):
        out = lstep(tm, state, seq)
        state = out.opt_state
        rec["seq_sharded"].append(float(out.loss))

    # the handoff chain: train -> eval -> serve admit, nothing resharded
    counts, restore = _count_reshards()
    try:
        model = lm(lm_params)
        opt = adamw()
        step = make_step(lm_loss, opt)
        state = opt.init(model.parameters())
        mine = rows(tokens, rank, world)
        out = step(model, state, mine)
        out = step(model, out.opt_state, mine)
        p_sh = handoff_shardings(step)
        verify_handoff(model, p_sh)
        ev = front_door.make_eval_step(lambda m, b: m(b).argmax(-1),
                                       like=step)
        pred = ev(model, tok)
        pred = ev(model, tok)
        eng = InferenceEngine(model, EngineConfig(n_slots=2, max_len=64,
                                                  param_shardings=p_sh))
        with eng:
            toks = eng.submit(np.arange(5, dtype=np.int32) % LM["vocab"],
                              SamplingParams(max_new_tokens=4)
                              ).result(timeout=120)
        rec["chain"] = {"compiles": step.compiles,
                        "pred_shape": tuple(pred.shape),
                        "eval_traces": ev.trace_counts["n"],
                        "eval_pinned": ev.in_shardings["params"] is p_sh,
                        "tokens": len(toks), "reshards": dict(counts)}
        # a model that does not carry the pinned shardings is refused
        bad = lm(lm_params)
        bad = shard_params(bad, fsdp.fsdp_param_specs(bad, world), mesh)
        refused = []
        try:
            InferenceEngine(bad, EngineConfig(n_slots=2, max_len=64,
                                              param_shardings=p_sh))
        except HandoffMismatch as e:
            refused.append(("engine", e.path))
        from distributed_pytorch_tpu_torch.models.generate import \
            make_generate_fn
        try:
            make_generate_fn(bad, 2, param_shardings=p_sh)(
                np.zeros((1, 4), np.int64))
        except HandoffMismatch as e:
            refused.append(("generate", e.path))
        try:
            ev(bad, tok)
        except HandoffMismatch as e:
            refused.append(("eval", e.path))
        rec["refused"] = refused

        # the ZeRO-3 consumer half: the eval pins the step's tree and
        # runs the FSDP2 forward on it
        counts.update(redistribute=0, full_tensor=0)
        model = mlp(mlp_params)
        opt = adamw()
        p_specs, _, _ = fsdp.shard_layouts(model, None, n_shards=world,
                                           min_size=64)
        z3 = make_step(mlp_loss, opt, mesh=mesh,
                       specs=StepSpecs(params=p_specs), donate=False)
        z3(model, opt.init(model.parameters()), local)
        pinned = handoff_shardings(z3)
        ev = front_door.make_eval_step(lambda m, b: m(b[0]).argmax(-1),
                                       like=z3)
        x = tuple(torch.from_numpy(a) for a in batch)
        pred = ev(model, x)
        pred = ev(model, x)
        rec["zero3_eval"] = {
            "tree": isinstance(pinned, dict),
            "placements": {k: str(v.placements) for k, v in pinned.items()},
            "pinned_is": ev.in_shardings["params"] is pinned,
            "pred_shape": tuple(pred.shape),
            "traces": ev.trace_counts["n"], "reshards": dict(counts)}
        try:
            verify_handoff(mlp(mlp_params), pinned)
            rec["zero3_plain_refused"] = None
        except HandoffMismatch as e:
            rec["zero3_plain_refused"] = e.path
    finally:
        restore()
    if rank == 0:
        torch.save(rec, os.path.join(out_dir, "matrix.pt"))
    dist.cleanup()


def host_worker(rank, world, out_dir, mlp_params, batch):
    """The host door: ``make_step`` dispatches to the host engines
    (uncached, no sharding contract) at every wire and weight update."""
    import distributed_pytorch_tpu_torch as dist
    from distributed_pytorch_tpu_torch.parallel import front_door, make_step

    dist.init_process_group(rank, world)
    local = rows(batch, rank, world)
    rec = {}
    for name, wire, wu in (("mean", "mean", "replicated"),
                           ("sharded", "mean", "sharded")):
        model = mlp(mlp_params)
        opt = adamw()
        step = make_step(mlp_loss, opt, wire=wire, weight_update=wu)
        state = (step.init_opt_state(model) if wu == "sharded"
                 else opt.init(model.parameters()))
        losses, _ = _pmean_losses(step, model, state, local)
        rec[name] = {"losses": losses,
                     "front_door_step": isinstance(
                         step, front_door.FrontDoorStep),
                     "host_times": hasattr(step, "host_times"),
                     "again_same": make_step(mlp_loss, opt, wire=wire,
                                             weight_update=wu) is step}
    rec["cached"] = len(front_door.cache_info())
    try:
        make_step(mlp_loss, adamw(), weight_update="sharded",
                  pad_multiple=1024)
        rec["pad_multiple"] = None
    except ValueError as e:
        rec["pad_multiple"] = str(e)
    if rank == 0:
        torch.save(rec, os.path.join(out_dir, "host.pt"))
    dist.cleanup()
