"""Loss functions.

Counterpart of ``distributed_pytorch_tpu/ops/losses.py``
(``cross_entropy_per_example``, ``cross_entropy``,
``fused_linear_cross_entropy``, ``vocab_parallel_cross_entropy`` and
``make_vocab_parallel_ce_fn``).
"""

from __future__ import annotations

import torch


def cross_entropy_per_example(logits, labels):
    """Per-example softmax cross-entropy with int class ids: ``logits``
    (..., C), ``labels`` (...). The log-sum-exp is taken in float32
    whatever the logits' dtype; returns float32."""
    lf = logits.to(torch.float32)
    logz = torch.logsumexp(lf, dim=-1)
    true_logit = torch.gather(lf, -1, labels.to(torch.long)[..., None])
    return logz - true_logit[..., 0]


def cross_entropy(logits, labels):
    """Mean cross-entropy (torch ``CrossEntropyLoss()``'s reduction)."""
    return cross_entropy_per_example(logits, labels).mean()


def _mm_f32(a, b):
    """``a @ b`` with float32 sums and a float32 result, whatever the
    inputs' dtype (the JAX package's ``preferred_element_type=f32``).
    On the card a bfloat16 or float16 product stays on the tensor cores
    and only its float32 sums are written (``torch.mm``'s ``out_dtype``);
    elsewhere the inputs are widened to float32, whose products of
    16-bit values are exact."""
    if a.dtype == torch.float32:
        return a @ b
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.to(torch.float32) @ b.to(torch.float32)


class _FusedLinearCE(torch.autograd.Function):
    """Sum over rows of the cross-entropy of ``h @ w.T``, a chunk of
    ``chunk`` rows at a time; the backward recomputes each chunk's
    logits. Saves only ``h``, ``w`` and ``y``."""

    @staticmethod
    def forward(ctx, h, w, y, chunk):
        ctx.save_for_backward(h, w, y)
        ctx.chunk = chunk
        total = torch.zeros((), dtype=torch.float32, device=h.device)
        for i in range(0, h.shape[0], chunk):
            logits = _mm_f32(h[i:i + chunk], w.t())
            true = logits.gather(1, y[i:i + chunk, None])[:, 0]
            total += (torch.logsumexp(logits, dim=-1) - true).sum()
        return total

    @staticmethod
    def backward(ctx, g):
        h, w, y = ctx.saved_tensors
        chunk = ctx.chunk
        dh = torch.empty_like(h)
        dw = torch.zeros(w.shape, dtype=torch.float32, device=w.device)
        for i in range(0, h.shape[0], chunk):
            hc, yc = h[i:i + chunk], y[i:i + chunk]
            # d(logz - true)/d logits = softmax - onehot, times g
            dl = torch.softmax(_mm_f32(hc, w.t()), dim=-1)
            dl[torch.arange(hc.shape[0], device=h.device), yc] -= 1.0
            dl = (dl * g).to(h.dtype)
            dh[i:i + chunk] = _mm_f32(dl, w).to(h.dtype)
            dw += _mm_f32(dl.t(), hc)
        return dh, dw.to(w.dtype), None, None


def fused_linear_cross_entropy(hidden, w, labels, *, chunk_rows: int = 512):
    """Mean cross-entropy of ``softmax(hidden @ w.T)`` against ``labels``
    without holding the whole ``(N, vocab)`` logits: ``chunk_rows`` rows
    at a time in the forward, and again in the backward, which
    recomputes each chunk's logits and accumulates ``dw`` over the
    chunks in float32. Each chunk's logits are the float32 sums of the
    products (see ``_mm_f32``), as the JAX package's are.

    ``hidden``: (..., d); ``w``: (vocab, d), the layout of
    ``TransformerLM.head_weight()`` (the JAX package takes (d, vocab));
    ``labels``: integer ids of shape ``hidden.shape[:-1]``. Returns a
    float32 scalar."""
    d = hidden.shape[-1]
    h = hidden.reshape(-1, d)
    y = labels.reshape(-1).to(device=h.device, dtype=torch.long)
    chunk = max(1, min(int(chunk_rows), h.shape[0]))
    return _FusedLinearCE.apply(h, w, y, chunk) / h.shape[0]


def _tp_of(axis_name: str, group):
    """(group, size, index) of the vocab's tp group: ``group`` itself,
    or the ``axis_name`` dimension of the live mesh; (None, 1, 0) where
    the mesh has no such axis or it is one rank wide."""
    from ..comm import primitives as prim
    if group is None:
        from ..runtime import context
        mesh = context.get_mesh()
        if axis_name not in (mesh.mesh_dim_names or ()) \
                or mesh[axis_name].size() == 1:
            return None, 1, 0
        group = mesh[axis_name].get_group()
    return group, prim.axis_size(group), prim.axis_index(group)


class _VocabParallelCE(torch.autograd.Function):
    """Per-row CE of vocab-sharded logits (see
    :func:`vocab_parallel_cross_entropy`). Forward: one all-reduce MAX
    of the row maxima (no gradient flows through it), one all-reduce SUM
    of the stacked (sum-exp, owned target logit, ownership count).
    Backward: ``(softmax_local - onehot_local) * dloss``, local."""

    @staticmethod
    def forward(ctx, logits_local, labels, tp):
        from ..comm import primitives as prim
        group, size, index = tp
        v_loc = logits_local.shape[-1]
        lf = logits_local.to(torch.float32)
        gmax = lf.amax(dim=-1)
        if size > 1:
            gmax = prim.pmax(gmax, group)
        loc = labels.to(device=lf.device, dtype=torch.long) - index * v_loc
        in_shard = (loc >= 0) & (loc < v_loc)
        loc_c = loc.clamp(0, v_loc - 1)
        tgt_local = lf.gather(-1, loc_c[..., None])[..., 0]
        e = torch.exp(lf - gmax[..., None])
        sums = torch.stack([e.sum(dim=-1),
                            torch.where(in_shard, tgt_local,
                                        torch.zeros_like(tgt_local)),
                            in_shard.to(torch.float32)])
        if size > 1:
            sums = prim.psum(sums, group)
        denom, tgt, owned = sums.unbind(0)
        loss = torch.log(denom) + gmax - tgt
        loss = torch.where(owned > 0, loss,
                           torch.full_like(loss, float("nan")))
        ctx.save_for_backward(e, denom, loc_c, in_shard, owned > 0)
        ctx.dtype = logits_local.dtype
        return loss

    @staticmethod
    def backward(ctx, g):
        e, denom, loc_c, in_shard, owned = ctx.saved_tensors
        grad = e / denom[..., None]
        grad.scatter_add_(-1, loc_c[..., None],
                          -in_shard.to(grad.dtype)[..., None])
        # a row no shard owns is NaN forward and passes no gradient
        g = torch.where(owned, g, torch.zeros_like(g))
        return (grad * g[..., None]).to(ctx.dtype), None, None


def vocab_parallel_cross_entropy(logits_local, labels, *,
                                 axis_name: str = "tp", group=None):
    """Per-example CE from VOCAB-SHARDED logits: this rank holds the
    contiguous ``(..., V/n)`` slice of ids ``[r V/n, (r+1) V/n)`` of the
    n-rank tp group (``group``, or the ``axis_name`` axis of the live
    mesh; with neither, or one rank, the logits are the whole vocab);
    ``labels`` are global ids. The Megatron-LM vocab-parallel loss: the
    full logits are never gathered, two row-sized collectives replace
    the (..., V) all-gather (an all-reduce MAX for the stabilizer, one
    all-reduce SUM of the local sum-exp, the owned target logit and the
    ownership count), and the backward is local. A label no shard owns
    (an out-of-range id such as -100 padding) gives NaN, as the gathered
    loss does. Returns float32 of ``labels``' shape."""
    return _VocabParallelCE.apply(logits_local, labels,
                                  _tp_of(axis_name, group))


def make_vocab_parallel_ce_fn(mesh, *, dp: str = "dp", tp: str = "tp"):
    """``fn(hidden, head_w, labels) -> per-example CE`` with the vocab
    projection inside the tp group: ``hidden`` (B, S, D) replicated over
    tp (``TransformerLM(..., return_hidden=True)`` of a
    ``parallel.tensor.tensor_parallel_lm`` model), ``head_w`` the
    vocab-sharded (V, D) head (``model.head_weight()``: its DTensor, or
    this rank's (V/n, D) rows), ``labels`` (B, S) global ids. Each rank
    computes its (B, S, V/n) float32 logits only; the gradient of
    ``hidden`` is summed over the tp group. ``dp`` names the batch axis,
    as in the JAX package: each rank already holds its own batch."""
    from torch.distributed.tensor import DTensor
    from ..parallel.tensor import _CopyToTP, _TP
    del dp
    sub = mesh[tp]
    size = sub.size()
    group = sub.get_group() if size > 1 else None
    rank = sub.get_local_rank() if size > 1 else 0

    def fn(hidden, head_w, labels):
        w = head_w.to_local() if isinstance(head_w, DTensor) else head_w
        h = _CopyToTP.apply(hidden, _TP(group, size, rank))
        d = h.shape[-1]
        logits = _mm_f32(h.reshape(-1, d), w.t())
        return _VocabParallelCE.apply(
            logits.reshape(h.shape[:-1] + (w.shape[0],)), labels,
            (group, size, rank))
    return fn
