"""Tensor parallelism: the spec trees of the JAX package and the Megatron
forward of ``TransformerLM`` over the ``tp`` axis of the mesh.

Counterpart of ``distributed_pytorch_tpu/parallel/tensor.py``
(``transformer_lm_param_specs``, ``shard_params``, ``replicated_specs``).
A spec tree has the JAX params tree's shape, a :class:`P` (the port's
``PartitionSpec``, equal to JAX's leaf for leaf) at each leaf, over the
JAX layout's dimensions and the JAX axis names; ``convert.spec_placements``
maps a leaf onto the placement of the port's parameter.

On the TPU the layout is the program: GSPMD inserts the collectives. Here
:func:`shard_params` places each parameter as a DTensor on the mesh's
axes of more than one rank (:func:`layout_mesh`, where
``spmd.shard_batch_spec`` places the batch), and
:func:`tensor_parallel_lm` places them on the ``tp`` axis and makes the
model's forward the Megatron one over the ``tp`` group, on each rank's
local shards (plain tensors: the flash kernels never see a DTensor):

- qkv and fc1 column-parallel, out and fc2 row-parallel: one all-reduce
  of the (B, S, D) activations forward after each row-parallel product,
  and one of its input's gradient backward before each column-parallel
  one;
- the fused qkv keeps the contiguous ``[q | k | v]`` column split of the
  JAX spec (``qkv.w`` ``P(None, "tp")``), so tp rank r holds columns, not
  heads: its heads' q, k and v come from **one all-gather of the
  (B, S, D + 2 kv_dim) projection per layer** forward and **one
  reduce-scatter of its gradient** backward;
- the vocab projection column-parallel: ``model(x)`` all-gathers the
  (B, S, V) logits; the loss of ``ops.losses.make_vocab_parallel_ce_fn``
  on ``model(x, return_hidden=True)`` reduces (B, S)-sized scalars
  instead. Tied embeddings shard the token table over the vocab: its
  lookup is masked per rank and all-reduced.

Embeddings (untied), LayerNorms and the row-parallel biases replicate;
their gradients are equal on every tp rank.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F
from torch import nn

from ..comm import primitives as prim
from ..convert import jax_param_slots, spec_placements
from ..models.transformer import apply_remat_policy
from ..nn.core import gelu
from ..ops.quant import is_quantized
from ..optim import jax_perm, mark_jax_perm


class P(tuple):
    """A ``PartitionSpec``: per dimension of a JAX-layout leaf, the mesh
    axis (or tuple of axes) sharding it, or ``None``. Equal to JAX's
    ``PartitionSpec`` of the same entries."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __getnewargs__(self):
        return tuple(self)

    def __repr__(self):
        return "P(" + ", ".join(map(repr, self)) + ")"


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nests of dicts, lists, tuples and
    NamedTuples (a :class:`P` and ``None`` are leaves), the trees of
    ``rest`` walked alongside ``tree``."""
    if tree is None or isinstance(tree, P):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v, *(r[i] for r in rest))
                            for i, v in enumerate(tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    out = []
    tree_map(out.append, tree)
    return out


class LeafShape:
    """The shape of a JAX-layout leaf (what a spec rule reads)."""

    def __init__(self, shape):
        self.shape = tuple(int(d) for d in shape)
        self.size = 1
        for d in self.shape:
            self.size *= d

    def __repr__(self):
        return f"LeafShape{self.shape}"


def jax_layout(params):
    """``params`` as a JAX-layout tree of :class:`LeafShape`: a module
    through its ``jax_param_slots`` (a Linear W read as (in, out)), a
    tree of arrays or tensors leaf by leaf."""
    if isinstance(params, nn.Module):
        ps = list(params.parameters())
        return tree_map(lambda s: LeafShape(s.to_jax(ps[s.index]).shape),
                        jax_param_slots(params))
    return tree_map(lambda x: LeafShape(x.shape), params)


def transformer_lm_param_specs(model, tp_axis: str = "tp") -> Dict[str, Any]:
    """The spec tree of a ``TransformerLM``'s params (the JAX tree's
    shape): qkv and fc1 column-parallel, out and fc2 row-parallel, the
    vocab projection sharded over the vocab (with tied embeddings the
    token table takes that sharding), the rest replicated."""
    t = tp_axis

    def block_specs():
        return {
            "ln1": {"scale": P(), "bias": P()},
            "attn": {
                "qkv": {"w": P(None, t), "b": P(t)},     # column (heads)
                "out": {"w": P(t, None), "b": P()},      # row
            },
            "ln2": {"scale": P(), "bias": P()},
            "fc1": {"w": P(None, t), "b": P(t)},          # column
            "fc2": {"w": P(t, None), "b": P()},           # row
        }

    specs = {
        "tok": {"emb": P()},
        "blocks": [block_specs() for _ in range(model.n_layers)],
        "ln_f": {"scale": P(), "bias": P()},
    }
    if model.head is not None:
        specs["head"] = {"w": P(None, t)}                 # vocab-sharded
    else:
        specs["tok"] = {"emb": P(t, None)}
    if model.pos is not None:
        specs["pos"] = {"emb": P()}
    return specs


def replicated_specs(params):
    """An all-replicated spec tree shaped like ``params`` (a module or a
    JAX-layout tree)."""
    return tree_map(lambda _: P(), jax_layout(params))


def specs_by_param(model, specs) -> list:
    """The spec of each of ``model.parameters()``, in that order."""
    out = [None] * len(list(model.parameters()))
    tree_map(lambda slot, spec: out.__setitem__(slot.index, (slot, spec)),
             jax_param_slots(model), specs)
    return out


def spec_axes(specs) -> tuple:
    """The mesh axes a spec tree names, in the order they appear."""
    axes = []
    for spec in tree_leaves(specs):
        for part in tuple(spec or ()):
            for name in (part if isinstance(part, tuple) else (part,)):
                if name is not None and name not in axes:
                    axes.append(name)
    return tuple(axes)


def sub_mesh(mesh, axes):
    """The sub-mesh of ``mesh`` over ``axes``, kept in the mesh's own
    dimension order (the mesh itself when that is all of it)."""
    names = tuple(n for n in mesh.mesh_dim_names if n in axes)
    missing = [a for a in axes if a not in mesh.mesh_dim_names]
    if missing:
        raise ValueError(f"the mesh {mesh.mesh_dim_names} has no axis "
                         f"{missing}")
    if names == tuple(mesh.mesh_dim_names):
        return mesh
    return mesh[names if len(names) > 1 else names[0]]


def layout_mesh(mesh):
    """The sub-mesh every layout lives on: the axes of ``mesh`` with more
    than one rank (``dp`` when there are none). Parameters and batches
    placed on it share one mesh, so DTensor computes between them
    whatever axes each names; a one-rank axis places nothing, and
    DTensor's sharding propagation slows steeply with the mesh's
    dimensions."""
    names = tuple(mesh.mesh_dim_names or ())
    axes = tuple(n for i, n in enumerate(names) if mesh.size(i) > 1)
    if not axes:
        axes = ("dp",) if "dp" in names else names[:1]
    return sub_mesh(mesh, axes)


def layout_placements(spec, slot, mesh, sub) -> tuple:
    """``convert.spec_placements`` of ``spec`` over ``mesh``, kept for the
    dimensions of its sub-mesh ``sub`` (:func:`layout_mesh`; the axes
    left out have one rank, where every placement is the same)."""
    names = tuple(mesh.mesh_dim_names)
    full = spec_placements(spec, slot, names)
    return tuple(full[names.index(n)] for n in sub.mesh_dim_names)


def shard_params(model: nn.Module, specs, mesh) -> nn.Module:
    """Place ``model``'s parameters onto ``mesh`` per the spec tree: each
    becomes a DTensor on :func:`layout_mesh`'s sub-mesh, in place, the
    module's parameters replaced; returns the module. A parameter
    shared by several modules is placed once."""
    return _place(model, specs, mesh, layout_mesh(mesh))


def _place(model: nn.Module, specs, mesh, sub) -> nn.Module:
    from torch.distributed.tensor import distribute_tensor
    placed = {}
    for (slot, spec), p in zip(specs_by_param(model, specs),
                               model.parameters()):
        placed[id(p)] = mark_jax_perm(nn.Parameter(
            distribute_tensor(p.detach(), sub,
                              layout_placements(spec, slot, mesh, sub)),
            requires_grad=p.requires_grad), jax_perm(p))
    for mod in model.modules():
        for name, p in list(mod._parameters.items()):
            if p is not None and id(p) in placed:
                mod._parameters[name] = placed[id(p)]
    return model


# ---------------------------------------------------------------------------
# The Megatron forward over the tp group
# ---------------------------------------------------------------------------

class _TP:
    """The tp group of a model (group, size, this rank's index) and its
    collectives; with one rank each is the identity (a one-rank tp axis
    of a larger world has nothing to exchange)."""

    def __init__(self, group, size: int, rank: int):
        self.group, self.size, self.rank = group, size, rank

    def psum(self, x):
        return x if self.size == 1 else prim.psum(x, self.group)

    def all_gather(self, x):
        """The ranks' ``x`` concatenated along the last axis."""
        if self.size == 1:
            return x
        return prim.all_gather(x, axis=x.dim() - 1, tiled=True,
                               group=self.group)

    def reduce_scatter(self, x):
        """The sum over the ranks, this rank's piece of the last axis."""
        if self.size == 1:
            return x
        return prim.reduce_scatter(x, scatter_axis=x.dim() - 1,
                                   group=self.group)


class _CopyToTP(torch.autograd.Function):
    """Identity forward; the gradient summed over the tp group backward
    (a replicated input entering column-parallel work)."""

    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x

    @staticmethod
    def backward(ctx, g):
        return ctx.tp.psum(g.contiguous()), None


class _ReduceFromTP(torch.autograd.Function):
    """The sum over the tp group forward (partial products of a
    row-parallel layer); identity backward."""

    @staticmethod
    def forward(ctx, x, tp):
        return tp.psum(x)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromTP(torch.autograd.Function):
    """The tp ranks' pieces concatenated along the last axis forward
    (for a replicated consumer); this rank's piece of the gradient
    backward."""

    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp, ctx.n = tp, x.shape[-1]
        return tp.all_gather(x)

    @staticmethod
    def backward(ctx, g):
        r, n = ctx.tp.rank, ctx.n
        return g[..., r * n:(r + 1) * n], None


class _HeadLocalQKV(torch.autograd.Function):
    """The column-sharded ``[q | k | v]`` projection to this rank's
    heads: forward, all-gather the (B, S, D + 2 kv_dim) pieces and cut
    out this rank's q, k and v columns; backward, the gradients placed
    into a zero (B, S, D + 2 kv_dim) tensor and reduce-scattered back to
    the pieces (every column belongs to one rank's heads)."""

    @staticmethod
    def forward(ctx, y, tp, q_dim, kv_dim):
        full = tp.all_gather(y)
        qn, kvn = q_dim // tp.size, kv_dim // tp.size
        q0, k0 = tp.rank * qn, q_dim + tp.rank * kvn
        v0 = q_dim + kv_dim + tp.rank * kvn
        ctx.tp, ctx.cols, ctx.shape = tp, (q0, qn, k0, v0, kvn), full.shape
        return (full[..., q0:q0 + qn], full[..., k0:k0 + kvn],
                full[..., v0:v0 + kvn])

    @staticmethod
    def backward(ctx, dq, dk, dv):
        q0, qn, k0, v0, kvn = ctx.cols
        full = dq.new_zeros(ctx.shape)
        full[..., q0:q0 + qn] = dq
        full[..., k0:k0 + kvn] = dk
        full[..., v0:v0 + kvn] = dv
        return ctx.tp.reduce_scatter(full), None, None, None


def _local(p):
    """A parameter's local shard as a plain tensor (differentiable: its
    gradient lands on the DTensor parameter in the same placement)."""
    from torch.distributed.tensor import DTensor
    return p.to_local() if isinstance(p, DTensor) else p


def _layer_norm(ln, x):
    return F.layer_norm(x, (ln.dim,), _local(ln.scale), _local(ln.bias),
                        ln.eps)


def _tp_embed(model, tokens, positions):
    tp = model._tp
    table = _local(model.tok.weight)
    if model.tie_embeddings and tp.size > 1:
        # the table is sharded over the vocab: each rank looks up the ids
        # it owns and the rows are summed over the group
        v_loc = table.shape[0]
        loc = tokens - tp.rank * v_loc
        own = (loc >= 0) & (loc < v_loc)
        rows = F.embedding(loc.clamp(0, v_loc - 1), table)
        x = _ReduceFromTP.apply(
            torch.where(own[..., None], rows, torch.zeros_like(rows)), tp)
    else:
        x = F.embedding(tokens, table)
    if model.pos is not None:
        x = x + F.embedding(positions, _local(model.pos.weight))
    return x


def _tp_block_forward(self, x, positions=None, seed=None):
    """``TransformerBlock.forward`` over the tp group (module docstring)."""
    tp, attn = self._tp, self.attn
    gen = None
    if seed is not None and self.training and self.drop.rate > 0.0:
        gen = torch.Generator(device=x.device).manual_seed(seed)
    b, s, _ = x.shape
    dh = attn.head_dim
    y = F.linear(_CopyToTP.apply(_layer_norm(self.ln1, x), tp),
                 _local(attn.qkv.weight), _local(attn.qkv.bias))
    q, k, v = _HeadLocalQKV.apply(y, tp, attn.n_heads * dh,
                                  attn.n_kv_heads * dh)

    def heads(t):
        return t.reshape(b, s, -1, dh).transpose(1, 2)
    q, k, v = heads(q), heads(k), heads(v)
    q, k = attn.maybe_rope(q, k, positions)
    o = attn.attn_fn(q, k, v, causal=attn.causal)
    o = o.transpose(1, 2).reshape(b, s, -1)
    h = _ReduceFromTP.apply(F.linear(o, _local(attn.out.weight)), tp) \
        + _local(attn.out.bias)
    x = x + self.drop(h, generator=gen)
    m = gelu(F.linear(_CopyToTP.apply(_layer_norm(self.ln2, x), tp),
                      _local(self.fc1.weight), _local(self.fc1.bias)))
    m = _ReduceFromTP.apply(F.linear(m, _local(self.fc2.weight)), tp) \
        + _local(self.fc2.bias)
    return x + self.drop(m, generator=gen)


def _tp_lm_forward(self, tokens, positions=None, return_hidden=False,
                   generator=None):
    """``TransformerLM.forward`` over the tp group: logits all-gathered
    over the vocab, or the (replicated) hidden states."""
    tokens = tokens.to(self.device, torch.long)
    if positions is None:
        positions = torch.arange(tokens.shape[1], device=self.device)
    seeds = [None] * len(self.blocks)
    if generator is not None and self.training and self.dropout > 0.0:
        seeds = torch.randint(2 ** 62, (len(self.blocks),),
                              generator=generator,
                              device=generator.device).tolist()
    x = _tp_embed(self, tokens, positions)
    for blk, seed in zip(self.blocks, seeds):
        x = apply_remat_policy(blk, self.remat_policy)(
            x, positions=positions, seed=seed)
    x = _layer_norm(self.ln_f, x)
    if return_hidden:
        return x
    w = _local(self.tok.weight if self.tie_embeddings else self.head.weight)
    return _GatherFromTP.apply(F.linear(_CopyToTP.apply(x, self._tp), w),
                               self._tp)


def tensor_parallel_lm(model, mesh, tp_axis: str = "tp"):
    """``model`` (a ``TransformerLM``) split over the ``tp_axis`` of
    ``mesh``: its parameters placed per
    :func:`transformer_lm_param_specs` (DTensors on the tp sub-mesh) and
    its forward and its blocks' the Megatron ones (module docstring).
    In place; returns the model. Apply it before ``fully_shard`` (the
    FSDP layout then adds the ``dp`` axis). The heads, kv heads, the qkv
    width, the MLP width and the vocab must divide by the tp size; the
    decode paths of ``models/generate.py`` are not split."""
    import types
    sub = mesh[tp_axis]
    size = sub.size()
    tp = _TP(sub.get_group() if size > 1 else None, size,
             sub.get_local_rank() if size > 1 else 0)
    if any(is_quantized(m) for m in model.modules()):
        raise ValueError("tensor_parallel_lm takes float weights, not the "
                         "int8 ones of ops.quant.quantize_tree")
    blk = model.blocks[0]
    widths = {"n_heads": model.n_heads, "n_kv_heads": model.n_kv_heads,
              "mlp width": blk.fc1.out_dim, "vocab": model.vocab}
    bad = {k: v for k, v in widths.items() if v % size}
    if bad:
        raise ValueError(f"tp={size} does not divide {bad}")
    _place(model, transformer_lm_param_specs(model, tp_axis), mesh,
           sub_mesh(mesh, (tp_axis,)))
    model._tp = tp
    model.forward = types.MethodType(_tp_lm_forward, model)
    for b in model.blocks:
        b._tp = tp
        b.forward = types.MethodType(_tp_block_forward, b)
    return model
