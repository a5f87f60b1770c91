"""Rank workers of the sharded-training tests (``test_torch_fsdp.py``,
``test_torch_tensor_parallel.py``), spawned by ``launch_multiprocess``
over gloo CPU ranks.

They import the port, torch and numpy only: the weights (a JAX param
tree of numpy arrays, converted by ``convert.from_jax_params``) and the
token batches come in as arguments. Rank 0 writes what the ranks saw to
``<out_dir>/<name>.pt``.
"""

import os

import torch

#: the small LM of these tests (vocab 256, dim 64, two
#: layers, four heads, seq 32)
LM = dict(vocab=256, dim=64, n_layers=2, n_heads=4, max_seq=32)
LR = 3e-4                 # FLAGSHIP's and the LM trainer's adamw lr
#: adamw's eps in the comparisons: at torch's default of 1e-8 Adam divides
#: an element whose gradient cancels to ~1e-9 (the key bias's is
#: analytically zero) by ~eps, which turns the last-ulp rounding of its
#: sum (~1e-10, different in each summation order: the whole batch's or
#: two halves', the port's or JAX's) into ~1e-2 lr of update; at 1e-6
#: that is ~1e-4 lr, and every element with a gradient above 1e-6 still
#: takes Adam's normalised step
EPS = 1e-6
SGD_LR = 0.05
CLIP = 0.5
AF_LR = 1e-2


def build(params_np, **over):
    from distributed_pytorch_tpu_torch import TransformerLM, from_jax_params
    model = TransformerLM(device="cpu", **dict(LM, **over))
    return from_jax_params(params_np, model)


def lm_loss(model, batch):
    from distributed_pytorch_tpu_torch.ops.losses import cross_entropy
    x, y = batch
    return cross_entropy(model(x), y), {}


def optimizer(name):
    from distributed_pytorch_tpu_torch import optim
    return {"adamw": lambda: optim.adamw(LR, eps=EPS),
            "sgd": lambda: optim.sgd(SGD_LR, 0.9),
            "clip_sgd": lambda: optim.with_clipping(optim.sgd(SGD_LR, 0.9),
                                                    CLIP),
            "adafactor": lambda: optim.adafactor(AF_LR),
            "adamw8bit": lambda: optim.adamw_8bit(LR)}[name]()


def local(batch, index, n):
    """Rank ``index``'s slice of a global (x, y) batch of numpy arrays,
    among ``n`` data ranks."""
    x, y = batch
    k = x.shape[0] // n
    return (torch.from_numpy(x[index * k:(index + 1) * k]),
            torch.from_numpy(y[index * k:(index + 1) * k]))


def params_np(model):
    """The model's parameters as the JAX tree of numpy float32 arrays,
    gathered where sharded (every rank calls it)."""
    from distributed_pytorch_tpu_torch.parallel import fsdp
    from distributed_pytorch_tpu_torch.parallel.tensor import tree_map
    tree, _ = fsdp.gather_state(model)
    return tree_map(lambda t: t.float().numpy(), tree)


def placements_str(t):
    return str(tuple(t.placements)) if hasattr(t, "placements") else "plain"


def state_layout(model, opt_state, specs, axes):
    """Per moment list of ``opt_state`` (adamw's ``mu``, ``nu``), each
    leaf's placements beside the ones ``opt_state_specs`` and
    ``convert.spec_placements`` give it."""
    from distributed_pytorch_tpu_torch.convert import spec_placements
    from distributed_pytorch_tpu_torch.parallel import fsdp
    from distributed_pytorch_tpu_torch.parallel.tensor import specs_by_param
    slots = [slot for slot, _ in specs_by_param(model, specs)]
    want = fsdp.opt_state_specs(opt_state, specs, model)
    out = {}
    for field in ("mu", "nu"):
        got = [placements_str(t) for t in getattr(opt_state, field)]
        exp = [str(spec_placements(spec, slot, axes))
               for spec, slot in zip(getattr(want, field), slots)]
        out[field] = (got, exp)
    return out


def _run(step, model, opt_state, batches, index, n, after=()):
    """Train on every batch; the global mean loss per step (the mean of
    the ranks' local means) and the params after the steps in
    ``after``."""
    from distributed_pytorch_tpu_torch.comm import primitives as prim
    losses, snaps = [], {}
    for i, batch in enumerate(batches):
        out = step(model, opt_state, local(batch, index, n))
        opt_state = out.opt_state
        losses.append(float(prim.pmean(out.loss.detach().float())))
        if i + 1 in after:
            snaps[i + 1] = params_np(model)
    return losses, opt_state, snaps


# (case, rung, optimizer, steps, mixed_precision)
LADDER = [("rep", "rep", "adamw", 4, "off"),
          ("zero1", "zero1", "adamw", 4, "off"),
          ("zero2", "zero2", "adamw", 4, "off"),
          ("zero3", "zero3", "adamw", 4, "off"),
          ("zero3_tp1", "zero3_tp1", "adamw", 4, "off"),
          ("zero3_sgd", "zero3", "sgd", 4, "off"),
          ("zero3_clip_sgd", "zero3", "clip_sgd", 4, "off"),
          ("rep_adafactor", "rep", "adafactor", 4, "off"),
          ("zero3_adafactor", "zero3", "adafactor", 4, "off"),
          ("rep_bf16", "rep", "adamw", 2, "bf16"),
          ("zero3_bf16", "zero3", "adamw", 2, "bf16")]


def ladder_worker(rank, world, out_dir, params, batches):
    """Every case of :data:`LADDER` from the same weights and batches,
    then ``adamw_8bit`` on each rung (which must refuse)."""
    import distributed_pytorch_tpu_torch as dist
    from distributed_pytorch_tpu_torch.parallel import (fsdp,
                                                        make_train_step,
                                                        tensor)
    from distributed_pytorch_tpu_torch.runtime import context

    dist.init_process_group(rank, world)
    mesh = context.init_mesh(dp=world)
    rec = {"world": world, "mesh": mesh.mesh_dim_names}

    def make(rung, opt, model, mp):
        if rung == "rep":
            return make_train_step(lm_loss, opt, mixed_precision=mp), None
        if rung == "zero1":
            return fsdp.make_zero1_train_step(lm_loss, opt, mesh, model,
                                              mixed_precision=mp)
        if rung == "zero2":
            return fsdp.make_zero2_train_step(lm_loss, opt, mesh, model,
                                              mixed_precision=mp)
        base = None
        if rung == "zero3_tp1":
            # the tensor-parallel forward on a one-rank tp axis of a
            # two-rank world: every tp collective is the identity
            tensor.tensor_parallel_lm(model, mesh)
            base = tensor.transformer_lm_param_specs(model)
        specs = fsdp.fsdp_param_specs(model, world, base_specs=base)
        return fsdp.make_fsdp_train_step(lm_loss, opt, mesh, specs,
                                         mixed_precision=mp), specs

    for case, rung, opt_name, steps, mp in LADDER:
        model = build(params)
        opt = optimizer(opt_name)
        step, specs = make(rung, opt, model, mp)
        state = opt.init(model.parameters())
        losses, state, snaps = _run(step, model, state, batches[:steps],
                                    rank, world, after=(1, steps))
        r = {"losses": losses, "params": snaps}
        if specs is not None and opt_name == "adamw" and rung != "zero3_tp1":
            r["state_layout"] = state_layout(model, state, specs, ("dp",))
        if rung == "zero3":
            r["param_placements"] = [placements_str(p)
                                     for p in model.parameters()]
            r["fsdp_specs"] = specs
        rec[case] = r

    rec["adamw8bit"] = {}
    for rung in ("zero1", "zero2", "zero3"):
        model = build(params)
        opt = optimizer("adamw8bit")
        step, _ = make(rung, opt, model, "off")
        try:
            step(model, opt.init(model.parameters()),
                 local(batches[0], rank, world))
            rec["adamw8bit"][rung] = None
        except NotImplementedError as e:
            rec["adamw8bit"][rung] = str(e)
    if rank == 0:
        torch.save(rec, os.path.join(out_dir, "ladder.pt"))


def tp_worker(rank, world, out_dir, params, tied_params, batch, labels):
    """tp = ``world``: the vocab-parallel loss against the dense CE
    (value, gradient, an unowned label), the Megatron forward and
    backward of ``tensor_parallel_lm`` (untied and tied) against the
    unsharded model's, and the collectives of one split forward."""
    import distributed_pytorch_tpu_torch as dist
    from distributed_pytorch_tpu_torch.ops.losses import (
        cross_entropy_per_example, make_vocab_parallel_ce_fn,
        vocab_parallel_cross_entropy)
    from distributed_pytorch_tpu_torch.parallel import tensor
    from distributed_pytorch_tpu_torch.runtime import context

    dist.init_process_group(rank, world)
    mesh = context.init_mesh(tp=world)
    rec = {}
    v = labels["logits"].shape[-1]
    logits = torch.from_numpy(labels["logits"])
    ids = torch.from_numpy(labels["ids"])
    mine = logits.chunk(world, dim=-1)[rank].clone().requires_grad_(True)
    loss = vocab_parallel_cross_entropy(mine, ids)
    loss.sum().backward()
    rec["ce"] = loss.detach().numpy()
    grads = dist.all_gather(mine.grad.contiguous())
    rec["ce_grad"] = torch.cat(list(grads.unbind(0)), dim=-1).numpy()
    bad = ids.clone()
    bad[0, 0] = v + 3          # no shard owns it
    bad[0, 1] = -100           # padding
    rec["ce_unowned"] = vocab_parallel_cross_entropy(
        logits.chunk(world, dim=-1)[rank], bad).numpy()
    rec["rank_and_size"] = (context.get_rank(), context.get_world_size())

    x, y = (torch.from_numpy(batch[0]), torch.from_numpy(batch[1]))
    for name, p_np, over in (("untied", params, {}),
                             ("tied", tied_params,
                              {"tie_embeddings": True})):
        model = tensor.tensor_parallel_lm(build(p_np, **over), mesh)
        rec[f"{name}_placements"] = {
            n: placements_str(p) for n, p in model.named_parameters()}
        out = model(x)
        hidden = model(x, return_hidden=True)
        ce = make_vocab_parallel_ce_fn(mesh)(hidden, model.head_weight(), y)
        (ce.mean() + cross_entropy_per_example(out, y).mean()).backward()
        rec[f"{name}_logits"] = out.detach().numpy()
        rec[f"{name}_vp_ce"] = ce.detach().numpy()
        rec[f"{name}_grads"] = {
            n: (p.grad.full_tensor() if hasattr(p.grad, "full_tensor")
                else p.grad).numpy()
            for n, p in model.named_parameters()}
    # the collectives of one split forward, and of forward + backward
    from distributed_pytorch_tpu_torch.comm import primitives as prim
    counts = {}

    def counting(name, fn):
        def run(*a, **kw):
            counts[name] = counts.get(name, 0) + 1
            return fn(*a, **kw)
        return run
    saved = {n: getattr(prim, n) for n in ("psum", "all_gather",
                                           "reduce_scatter")}
    model = tensor.tensor_parallel_lm(build(params), mesh)
    try:
        for n, fn in saved.items():
            setattr(prim, n, counting(n, fn))
        with torch.no_grad():
            model(x)
        rec["forward_collectives"] = dict(counts)
        counts.clear()
        model(x).sum().backward()
        rec["train_collectives"] = dict(counts)
    finally:
        for n, fn in saved.items():
            setattr(prim, n, fn)
    if rank == 0:
        torch.save(rec, os.path.join(out_dir, "tp.pt"))


def fsdp_tp_worker(rank, world, out_dir, params, batches):
    """One dp2 x tp2 run: ``tensor_parallel_lm``, then ZeRO-3 with
    ``fsdp_param_specs(..., base_specs=transformer_lm_param_specs)``,
    adamw, the vocab-parallel loss; each dp rank trains on its half of
    every global batch."""
    import distributed_pytorch_tpu_torch as dist
    from distributed_pytorch_tpu_torch.ops.losses import \
        make_vocab_parallel_ce_fn
    from distributed_pytorch_tpu_torch.parallel import fsdp, tensor
    from distributed_pytorch_tpu_torch.runtime import context

    dist.init_process_group(rank, world)
    mesh = context.init_mesh(dp=2, tp=world // 2)
    model = tensor.tensor_parallel_lm(build(params), mesh)
    specs = fsdp.fsdp_param_specs(
        model, 2, base_specs=tensor.transformer_lm_param_specs(model))
    ce = make_vocab_parallel_ce_fn(mesh)

    def loss_fn(m, batch):
        x, y = batch
        return ce(m(x, return_hidden=True), m.head_weight(), y).mean(), {}

    opt = optimizer("adamw")
    step = fsdp.make_fsdp_train_step(loss_fn, opt, mesh, specs)
    dp_index = mesh["dp"].get_local_rank()
    losses, state, snaps = _run(step, model, opt.init(model.parameters()),
                                batches, dp_index, 2,
                                after=(len(batches),))
    rec = {"losses": losses, "params": snaps[len(batches)],
           "specs": specs,
           "placements": {n: placements_str(p)
                          for n, p in model.named_parameters()},
           "state_placements": [placements_str(t) for t in state.mu]}
    if rank == 0:
        torch.save(rec, os.path.join(out_dir, "fsdp_tp.pt"))
