"""Rank workers of ``test_torch_sequence_ranks.py``, ``test_torch_moe.py``
and ``test_torch_pipeline.py``, spawned by ``launch_multiprocess`` over
gloo CPU ranks.

They import the port, torch and numpy only: weights (JAX param trees of
numpy arrays, loaded with ``convert.from_jax_params``) and inputs come
in as arguments. Rank 0 writes what the ranks saw to
``<out_dir>/<name>.pt``.
"""

import os

import torch

#: the JAX suite's dp x tp x sp LM (``tests/test_sequence_parallel.py::
#: test_dp_tp_sp_mesh_train_step``)
SP_LM = dict(vocab=32, dim=16, n_layers=2, n_heads=2, max_seq=8)
SP_LR, SP_STEPS = 1e-3, 4
#: (name, core, kwargs of the core, the data's kv heads): the cores at sp 4
CORES = [("dense_causal_gqa", "dense", dict(causal=True), 2),
         ("dense_full", "dense", dict(causal=False), 4),
         ("flash_causal", "flash", dict(causal=True), 4),
         ("flash_full", "flash", dict(causal=False), 4),
         ("flash_window20", "flash", dict(causal=True, window=20), 4),
         ("striped", "striped", dict(), 4),
         ("ulysses_causal", "ulysses", dict(causal=True), 4)]
#: the MoE LM of the ep runs
MOE_LM = dict(vocab=61, dim=32, n_layers=2, n_heads=4, n_experts=4,
              max_seq=16, top_k=2, capacity_factor=1.0, n_shared_experts=1)
MOE_LR, MOE_STEPS, MOE_AUX = 1e-3, 3, 0.01
#: adamw's eps in the ep comparisons (``_torch_fsdp_workers.EPS`` says
#: why: the k bias's gradient is analytically zero)
MOE_EPS = 1e-6


def _save(rank, out_dir, name, rec):
    if rank == 0:
        torch.save(rec, os.path.join(out_dir, f"{name}.pt"))


def _gather(t):
    """Every rank's ``t`` (a tensor) as a list in rank order."""
    import torch.distributed as tdist
    out = [None] * tdist.get_world_size()
    tdist.all_gather_object(out, t.detach().clone())
    return out


def _core(name, q, k, v, causal=True, window=None):
    from distributed_pytorch_tpu_torch.parallel import sequence as seq
    if name == "dense":
        return seq.ring_attention(q, k, v, causal=causal)
    if name == "flash":
        return seq.ring_flash_attention(q, k, v, causal=causal,
                                        window=window)
    if name == "striped":
        return seq.striped_ring_flash_attention(q, k, v)
    return seq.ulysses_attention(q, k, v, causal=causal)


def sp_lm(params_np, attn_fn=None):
    from distributed_pytorch_tpu_torch import TransformerLM, from_jax_params
    return from_jax_params(params_np, TransformerLM(device="cpu",
                                                    attn_fn=attn_fn,
                                                    **SP_LM))


def lm_loss(model, batch):
    from distributed_pytorch_tpu_torch.ops.losses import \
        cross_entropy_per_example
    x, y = batch
    return cross_entropy_per_example(model(x), y).mean(), {}


def seq_worker(rank, world, out_dir, data, lm_params, tokens):
    """World 4: the point-to-point primitives and their gradients, every
    core at sp 4 (this rank's sequence block, its output and q/k/v
    gradients), Ulysses' head refusal, and dp 2 x sp 2 ``FROM_INPUTS``
    steps of the JAX suite's LM."""
    import distributed_pytorch_tpu_torch as dist
    from distributed_pytorch_tpu_torch.comm import primitives as prim
    from distributed_pytorch_tpu_torch.optim import adamw
    from distributed_pytorch_tpu_torch.parallel import (
        FROM_INPUTS, make_step, shard_batch_spec, shard_params)
    from distributed_pytorch_tpu_torch.parallel import sequence as seq
    from distributed_pytorch_tpu_torch.parallel.spmd import \
        make_gspmd_ring_attn_fn
    from distributed_pytorch_tpu_torch.parallel.tensor import (
        P, transformer_lm_param_specs)
    from distributed_pytorch_tpu_torch.runtime import context

    dist.init_process_group(rank, world)
    rec = {"prim": {}, "cores": {}}
    # the primitives: values, and the gradient of sum(w * out)
    perms = {"ring+1": lambda x: prim.ring_shift(x),
             "ring-1": lambda x: prim.ring_shift(x, shift=-1),
             "ring+2": lambda x: prim.ring_shift(x, shift=2),
             "line+1": lambda x: prim.line_shift(x, shift=1),
             "line-1": lambda x: prim.line_shift(x, shift=-1),
             "perm": lambda x: prim.ppermute(x, [(0, 2), (2, 0), (1, 3)]),
             "all_to_all": lambda x: prim.all_to_all(x, 1, 0)}
    for name, fn in perms.items():
        x = (torch.arange(8.0).reshape(2, 4) + 100 * rank) \
            .requires_grad_(True)
        out = fn(x)
        w = torch.arange(out.numel(), dtype=torch.float32) \
            .reshape(out.shape) + 1000 * rank
        (out * w).sum().backward()
        rec["prim"][name] = (_gather(out), _gather(x.grad))
    # every core at sp 4 on this rank's block
    s_loc = data["q"].shape[2] // world
    for name, core, kw, h_kv in CORES:
        arrs = {k: torch.from_numpy(v) for k, v in data.items()}
        arrs["k"], arrs["v"] = arrs["k"][:, :h_kv], arrs["v"][:, :h_kv]
        if core == "striped":
            arrs = {k: seq.stripe_tokens(v, world, axis=2)
                    for k, v in arrs.items()}
        q, k, v, do = (arrs[n][:, :, rank * s_loc:(rank + 1) * s_loc]
                       .clone() for n in ("q", "k", "v", "do"))
        for t in (q, k, v):
            t.requires_grad_(True)
        o = _core(core, q, k, v, **kw)
        (o * do).sum().backward()
        rec["cores"][name] = [_gather(t) for t in (o, q.grad, k.grad,
                                                   v.grad)]
    try:
        x = torch.zeros(1, 2, 4, 8)
        seq.ulysses_attention(x, x, x)
        rec["ulysses_heads"] = None
    except ValueError as e:
        rec["ulysses_heads"] = str(e)
    # dp 2 x sp 2: the JAX suite's LM on a batch placed P("dp", "sp")
    mesh = context.init_mesh(dp=2, sp=2)
    batch_np = (tokens, tokens)
    rec["mesh_step"] = {}
    for core in ("dense", "flash"):
        model = sp_lm(lm_params, make_gspmd_ring_attn_fn(mesh, core=core))
        model = shard_params(model, transformer_lm_param_specs(model), mesh)
        opt = adamw(SP_LR)
        step = make_step(lm_loss, opt, specs=FROM_INPUTS, donate=False)
        batch = shard_batch_spec(tuple(torch.from_numpy(t)
                                       for t in batch_np), mesh,
                                 P("dp", "sp"))
        state = opt.init(model.parameters())
        losses = []
        for _ in range(SP_STEPS):
            out = step(model, state, batch)
            state = out.opt_state
            losses.append(float(out.loss))
        rec["mesh_step"][core] = {
            "losses": losses,
            "qkv_placements": str(tuple(
                model.blocks[0].attn.qkv.weight.placements)),
            "batch_placements": str(tuple(batch[0].placements))}
    # dp 4 x sp 1: the step leaves the one-rank sp axis out of its mesh;
    # the ring is then the sp axis's own one-rank group, not the world
    mesh = context.init_mesh(dp=4)
    model = sp_lm(lm_params, make_gspmd_ring_attn_fn(mesh, core="flash"))
    model = shard_params(model, transformer_lm_param_specs(model), mesh)
    opt = adamw(SP_LR)
    step = make_step(lm_loss, opt, specs=FROM_INPUTS, donate=False)
    batch = shard_batch_spec(tuple(torch.from_numpy(t) for t in batch_np),
                             mesh, P("dp", "sp"))
    rec["dp4_sp1_loss"] = float(step(model, opt.init(model.parameters()),
                                     batch).loss)
    _save(rank, out_dir, "seq", rec)


def example_worker(rank, world, out_dir, module, argv, init_params):
    """An example's ``main_worker`` at ``world`` ranks; rank 0 saves its
    record."""
    import importlib
    mod = importlib.import_module(
        f"distributed_pytorch_tpu_torch.examples.{module}")
    rec = mod.main_worker(rank, world, argv, quiet=True,
                          init_params=init_params)
    _save(rank, out_dir, module, rec)


def moe_lm(params_np, **over):
    from distributed_pytorch_tpu_torch import from_jax_params
    from distributed_pytorch_tpu_torch.models import MoETransformerLM
    return from_jax_params(params_np, MoETransformerLM(
        device="cpu", **dict(MOE_LM, **over)))


def moe_loss(model, batch):
    from distributed_pytorch_tpu_torch.ops.losses import \
        cross_entropy_per_example
    x, y = batch
    logits, aux, metrics = model.forward_with_metrics(x)
    nll = cross_entropy_per_example(logits, y).mean()
    return nll + MOE_AUX * aux, {"drop_rate": metrics["drop_rate"]}


def moe_train(model, batch, steps=MOE_STEPS):
    """``steps`` adamw steps of the ``FROM_INPUTS`` step: the losses, the
    drop rates and the final parameters (whole)."""
    from distributed_pytorch_tpu_torch.optim import adamw
    from distributed_pytorch_tpu_torch.parallel import make_spmd_train_step
    opt = adamw(MOE_LR, eps=MOE_EPS)
    step = make_spmd_train_step(moe_loss, opt, donate=False)
    state = opt.init(model.parameters())
    losses, drops = [], []
    for _ in range(steps):
        out = step(model, state, batch)
        state = out.opt_state
        losses.append(float(out.loss))
        drops.append(float(out.metrics["drop_rate"]))
    params = {n: (p.full_tensor() if hasattr(p, "full_tensor") else p)
              .detach().numpy().copy() for n, p in model.named_parameters()}
    return losses, drops, params


def moe_grads(model, batch):
    """The loss, the drop rate and every whole gradient of one forward
    and backward of ``moe_loss``."""
    from torch.distributed.tensor.experimental import implicit_replication
    with implicit_replication():
        loss, m = moe_loss(model, batch)
        loss.backward()

    def whole(t):
        return (t.full_tensor() if hasattr(t, "full_tensor") else t) \
            .detach().numpy().copy()
    return {"loss": float(whole(loss)),
            "drop_rate": float(whole(m["drop_rate"])),
            "grads": {n: whole(p.grad) for n, p in model.named_parameters()}}


def moe_ep_worker(rank, world, out_dir, params_np, tokens, dp, ep):
    """dp x ep = ``world``: the MoE LM with ``param_specs()`` placed on
    the mesh (each rank E/ep experts) trained ``MOE_STEPS`` steps on a
    batch split over dp; the collectives of one forward and of one
    forward and backward; every expert weight's local shape."""
    import distributed_pytorch_tpu_torch as dist
    from torch.distributed.tensor.experimental import implicit_replication
    from distributed_pytorch_tpu_torch.comm import primitives as prim
    from distributed_pytorch_tpu_torch.parallel import (shard_batch_spec,
                                                        shard_params)
    from distributed_pytorch_tpu_torch.parallel.tensor import P
    from distributed_pytorch_tpu_torch.runtime import context

    dist.init_process_group(rank, world)
    mesh = context.init_mesh(dp=dp, ep=ep)
    batch_t = (torch.from_numpy(tokens[:, :-1]),
               torch.from_numpy(tokens[:, 1:]))
    rec = {}
    model = moe_lm(params_np)
    model = shard_params(model, model.param_specs(), mesh)
    rec["local_fc1"] = tuple(model.blocks[0].moe.fc1.weight.to_local().shape)
    rec["fc1_placements"] = str(tuple(
        model.blocks[0].moe.fc1.weight.placements))
    batch = shard_batch_spec(batch_t, mesh, P("dp", None))
    rec["local_tokens"] = tuple(batch[0].to_local().shape)
    rec["losses"], rec["drops"], rec["params"] = moe_train(model, batch)
    rec["experts"] = moe_grads(shard_params(
        moe_lm(params_np, router="experts"), model.param_specs(), mesh),
        batch)
    counts = {}
    names = ("psum", "all_gather", "reduce_scatter", "all_to_all")
    real = {name: getattr(prim, name) for name in names}

    def counting(name):
        def call(*a, **kw):
            counts[name] = counts.get(name, 0) + 1
            return real[name](*a, **kw)
        return call
    for name in names:
        setattr(prim, name, counting(name))
    try:
        with implicit_replication(), torch.no_grad():
            model.forward_with_metrics(batch[0])
        rec["forward_collectives"] = dict(counts)
        counts.clear()
        with implicit_replication():
            loss, _ = moe_loss(model, batch)
            loss.backward()
        rec["train_collectives"] = dict(counts)
    finally:
        for name in names:
            setattr(prim, name, real[name])
    _save(rank, out_dir, "moe_ep", rec)


def pipe_worker(rank, world, out_dir, stacked_np, x, t, cases):
    """Each (pp, schedule, batch rows, as DTensor) case: this stage's
    slice of the stack (or the stack as a DTensor over pp), the pipelined
    step's loss and every stage's gradients gathered in stage order."""
    import distributed_pytorch_tpu_torch as dist
    from torch.distributed.tensor import Shard, distribute_tensor
    from distributed_pytorch_tpu_torch import from_jax_params
    from distributed_pytorch_tpu_torch.nn.attention import TransformerBlock
    from distributed_pytorch_tpu_torch.parallel.pipeline import (
        make_pipeline_train_fn, make_stage_fn, stack_layer_params)
    from distributed_pytorch_tpu_torch.runtime import context

    dist.init_process_group(rank, world)
    n_layers = next(iter(stacked_np["ln1"].values())).shape[0]
    dim = x.shape[-1]
    blocks = [TransformerBlock(dim, 2, causal=True, device="cpu")
              for _ in range(n_layers)]
    stack = from_jax_params(stacked_np, stack_layer_params(blocks))
    full = {n: p.detach() for n, p in stack.named_parameters()}
    stage_fn = make_stage_fn(stack)

    def per_example_mse(y, tgt):
        return ((y - tgt) ** 2).mean(dim=tuple(range(1, y.dim())))

    rec, meshes = {}, {}
    for pp, schedule, rows, as_dtensor in cases:
        if pp not in meshes:
            meshes[pp] = context.init_mesh(dp=world // pp, pp=pp)
        mesh = meshes[pp]
        sub = mesh["pp"]
        stage = sub.get_local_rank()
        per = n_layers // pp
        if as_dtensor:
            params = {n: distribute_tensor(p, sub, [Shard(0)])
                      for n, p in full.items()}
        else:
            params = {n: p[stage * per:(stage + 1) * per].clone()
                      for n, p in full.items()}
        fn = make_pipeline_train_fn(mesh, stage_fn, per_example_mse, 4,
                                    schedule=schedule)
        loss, grads = fn(params, torch.from_numpy(x[:rows]),
                         torch.from_numpy(t[:rows]))
        local = {n: (g.to_local() if hasattr(g, "to_local") else g)
                 .detach().clone() for n, g in grads.items()}
        gathered = [None] * world
        torch.distributed.all_gather_object(gathered, local)
        # ranks in stage order within dp row 0 (mesh order: dp, pp)
        rec[(pp, schedule, rows, as_dtensor)] = {
            "loss": float(loss),
            "grads": {n: torch.cat([g[n] for g in gathered[:pp]]).numpy()
                      for n in local},
            "dtensor_grads": as_dtensor and all(
                hasattr(g, "to_local") for g in grads.values())}
    _save(rank, out_dir, "pipe", rec)
