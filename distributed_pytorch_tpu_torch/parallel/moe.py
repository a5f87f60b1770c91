"""Expert parallelism: the Switch / GShard mixture-of-experts layer.

Counterpart of ``distributed_pytorch_tpu/parallel/moe.py``
(``MoELayer``, ``moe_param_specs``). Routing is dense tensor algebra,
as there: one-hot dispatch and combine tensors (N, E, C) with a fixed
per-expert capacity C, and the expert FFN as batched products over the
(E, C, D) dispatched blocks. Dispatch, combine and the expert FFN run
in float32 whatever the parameters' dtype.

Two routers. **Token-choice** (``router="tokens"``, top-k: 1 = Switch,
2 = GShard): each token goes to its k most probable experts, first
choices queueing ahead of second choices for the capacity (GShard
priority); overflow is dropped (the block's residual carries it); the
gates renormalize over the chosen experts when k > 1. **Expert-choice**
(``router="experts"``): each expert takes its top-capacity tokens by
score (exact balance, no auxiliary loss; a token's output depends on
the other tokens of the batch). Ties rank the lower index first, as
``jax.lax.top_k`` does (a stable descending sort). Metrics of
:meth:`MoELayer.forward_with_metrics`: ``aux_loss`` (Switch load
balancing over first choices), ``z_loss`` (ST-MoE router z-loss),
``drop_rate`` and ``expert_load`` (the share of kept dispatches per
expert).

**Layouts.** Plain tensors run the whole layer on this rank. DTensor
inputs (a ``FROM_INPUTS`` step, parameters placed by
``tensor.shard_params(model, model.param_specs(), mesh)``) run as an
island, the counterpart of the partitioner's program, on the local
tensors, with routing, capacity and the metrics those of the whole
batch (the JAX package's numbers in every layout):

- each rank routes its own tokens: those of its batch shard over the
  token axis (the mesh axis that shards the batch's first dimension,
  ``dp``; any other sharding of x is gathered first). The queue
  positions are global: **one all-gather of the (K, E) choice counts**
  gives each rank its tokens' offsets (expert-choice all-gathers the
  (N, E) router scores instead, to pick each expert's top tokens of
  the whole batch), and **one all-reduce of E + 1 sums** the aux and
  z losses;
- expert weights sharded over ``ep`` (``P("ep", ...)``) keep E/ep
  experts on each rank, and a rank dispatches its tokens to those
  experts only (the tokens are replicated over ep). Over the token
  axis, **a reduce-scatter of the dispatched (E/ep, C, D) blocks**
  along the capacity slots hands each rank C/dp slots of every expert
  (the slots' tokens from every rank), the expert FFN runs on those,
  and **an all-gather** brings the outputs back for the combine; over
  ep, **one all-reduce** of the (N/dp, D) routed output sums the
  ranks' experts. Backward: the all-gather and the reduce-scatter
  swap, and two all-reduces over ep sum the gradients of the tokens
  and of the router probabilities that entered the routed branch
  (Megatron's copy / reduce pair);
- the weights' local gradients are those of this rank's tokens: they
  leave the island ``Partial`` over the token axis, and the step sums
  them as any data-parallel gradient. The experts' ``tp`` hidden
  (``P("ep", None, "tp")``) is gathered: the island does not split it.
"""

from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..comm import primitives as prim
from ..nn.core import Linear, gelu


class ExpertLinear(nn.Module):
    """A bank of E affine maps: ``weight`` (E, in, out) and ``bias``
    (E, out), the JAX package's layout (no transpose)."""

    def __init__(self, n_experts: int, in_dim: int, out_dim: int, *,
                 dtype=torch.float32, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        bound = 1.0 / math.sqrt(in_dim)
        w = torch.empty(n_experts, in_dim, out_dim, dtype=dtype,
                        device=device)
        self.weight = nn.Parameter(w.uniform_(-bound, bound,
                                              generator=generator))
        self.bias = nn.Parameter(torch.zeros(n_experts, out_dim,
                                             dtype=dtype, device=device))


class _Axis(NamedTuple):
    """A mesh axis of one island: its group, its size, this rank's
    index (one rank, no group, outside an island)."""
    group: Any = None
    size: int = 1
    rank: int = 0


class _Copy(torch.autograd.Function):
    """Identity forward; the gradient summed over the axis backward (a
    replicated input entering each rank's part of a sum)."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x

    @staticmethod
    def backward(ctx, g):
        return prim.psum(g.contiguous(), ctx.axis.group), None


class _Sum(torch.autograd.Function):
    """The sum over the axis forward (each rank's part); identity
    backward (the sum is read alike on every rank)."""

    @staticmethod
    def forward(ctx, x, axis):
        return prim.psum(x.contiguous(), axis.group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _ScatterSlots(torch.autograd.Function):
    """(E, C, D) blocks summed over the axis, this rank keeping its C/n
    slots; the gradient all-gathered back."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return prim.reduce_scatter(x, 1, group=axis.group)

    @staticmethod
    def backward(ctx, g):
        return prim.all_gather(g.contiguous(), 1, tiled=True,
                               group=ctx.axis.group), None


class _GatherSlots(torch.autograd.Function):
    """Every rank's C/n slots of (E, C, D) blocks, concatenated; the
    gradient summed and scattered back."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return prim.all_gather(x.contiguous(), 1, tiled=True,
                               group=axis.group)

    @staticmethod
    def backward(ctx, g):
        return prim.reduce_scatter(g, 1, group=ctx.axis.group), None


def _top(x, k: int, dim: int = -1):
    """The k largest of ``x`` along ``dim`` and their indices, ties
    ranked lower index first (``jax.lax.top_k``)."""
    vals, idx = torch.sort(x, dim=dim, descending=True, stable=True)
    return vals.narrow(dim, 0, k), idx.narrow(dim, 0, k)


class MoELayer(nn.Module):
    """Token-routed expert FFN bank: x (..., D) -> (y (..., D), aux)."""

    def __init__(self, dim: int, n_experts: int, mlp_ratio: int = 4,
                 capacity_factor: float = 1.25, top_k: int = 1,
                 normalize_gates: bool = True, router: str = "tokens",
                 n_shared_experts: int = 0, *, dtype=torch.float32,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        if not 1 <= top_k <= n_experts:
            raise ValueError(f"top_k={top_k} not in [1, {n_experts}]")
        if router not in ("tokens", "experts"):
            raise ValueError(f"router must be tokens|experts, got {router!r}")
        if n_shared_experts < 0:
            raise ValueError(
                f"n_shared_experts must be >= 0, got {n_shared_experts}")
        self.dim = dim
        self.n_experts = n_experts
        self.hidden = mlp_ratio * dim
        self.capacity_factor = capacity_factor
        self.top_k = top_k
        self.normalize_gates = normalize_gates
        self.router = router
        self.n_shared = n_shared_experts
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.gate = Linear(dim, n_experts, bias=False, **kw)
        self.fc1 = ExpertLinear(n_experts, dim, self.hidden, **kw)
        self.fc2 = ExpertLinear(n_experts, self.hidden, dim, **kw)
        if self.n_shared:
            hs = self.n_shared * self.hidden
            self.shared = nn.Module()
            self.shared.fc1 = Linear(dim, hs, **kw)
            self.shared.fc2 = Linear(hs, dim, **kw)
            with torch.no_grad():     # zero biases, as the JAX init
                self.shared.fc1.bias.zero_()
                self.shared.fc2.bias.zero_()
        else:
            self.shared = None

    # -- the layer on local tensors -------------------------------------

    def _weights(self):
        w = {"gate": self.gate.weight, "fc1_w": self.fc1.weight,
             "fc1_b": self.fc1.bias, "fc2_w": self.fc2.weight,
             "fc2_b": self.fc2.bias}
        if self.shared is not None:
            w.update(s1_w=self.shared.fc1.weight, s1_b=self.shared.fc1.bias,
                     s2_w=self.shared.fc2.weight, s2_b=self.shared.fc2.bias)
        return w

    def _shared_ffn(self, w, xt):
        f32 = torch.float32
        h = gelu(xt.to(f32) @ w["s1_w"].to(f32).t() + w["s1_b"])
        return h @ w["s2_w"].to(f32).t() + w["s2_b"]

    def _expert_ffn(self, w, dispatch, combine, xt, ep: _Axis,
                    tok: _Axis):
        """Dispatch -> each expert's GELU MLP -> combine over this rank's
        experts (all of them at ep 1), summed over ep; over the token
        axis each rank runs the experts on its share of the slots."""
        f32 = torch.float32
        if ep.size > 1:
            xt = _Copy.apply(xt, ep)
        expert_in = torch.einsum("nec,nd->ecd", dispatch, xt.to(f32))
        if tok.size > 1:
            expert_in = _ScatterSlots.apply(expert_in, tok)
        h = gelu(torch.einsum("ecd,edh->ech", expert_in, w["fc1_w"].to(f32))
                 + w["fc1_b"][:, None, :])
        expert_out = (torch.einsum("ech,ehd->ecd", h, w["fc2_w"].to(f32))
                      + w["fc2_b"][:, None, :])
        if tok.size > 1:
            expert_out = _GatherSlots.apply(expert_out, tok)
        y = torch.einsum("nec,ecd->nd", combine, expert_out)
        return _Sum.apply(y, ep) if ep.size > 1 else y

    def _forward_local(self, x, w, ep: _Axis = _Axis(),
                       tok: _Axis = _Axis()):
        """The layer on this rank's tokens ``x``, one of ``tok.size``
        equal shards of the batch; this rank's experts are its ep share
        of the E."""
        orig_shape = x.shape
        n = math.prod(orig_shape[:-1])
        n_all = n * tok.size
        xt = x.reshape(n, self.dim)
        logits = F.linear(xt, w["gate"]).to(torch.float32)       # (N, E)
        probs = torch.softmax(logits, dim=-1)
        # the routed branch reads the probabilities through the ep copy
        # (its gradient is summed over the ranks' experts); the metrics
        # read them whole
        routed = _Copy.apply(probs, ep) if ep.size > 1 else probs
        e_loc = self.n_experts // ep.size
        mine = slice(ep.rank * e_loc, (ep.rank + 1) * e_loc)
        if self.router == "experts":
            dispatch, combine, metrics = self._expert_choice(
                routed, n_all, mine, tok)
        else:
            dispatch, combine, metrics = self._token_choice(
                routed, n_all, mine, tok)
        y = self._expert_ffn(w, dispatch, combine, xt, ep, tok)
        if self.shared is not None:
            y = y + self._shared_ffn(w, xt)
        # the whole batch's sums of lse^2 and of the probabilities
        sums = torch.cat([(torch.logsumexp(logits, dim=-1) ** 2).sum()[None],
                          probs.sum(dim=0)])
        if tok.size > 1:
            sums = _Sum.apply(sums, tok)
        z_loss = sums[0] / n_all
        if self.router == "experts":
            aux = torch.zeros((), dtype=torch.float32, device=x.device)
        else:
            # Switch aux loss over first-choice assignments (eq. 4)
            frac = metrics.pop("first_choice")
            aux = self.n_experts * torch.sum(frac * (sums[1:] / n_all))
        metrics = {"aux_loss": aux, "z_loss": z_loss, **metrics}
        return y.reshape(orig_shape).to(x.dtype), metrics

    def _slots(self, cap: int, tok: _Axis) -> int:
        """The capacity padded to a multiple of the token axis (the
        slots past ``cap`` stay empty)."""
        return -(-cap // tok.size) * tok.size

    def _token_choice(self, probs, n_all: int, mine: slice, tok: _Axis):
        e, k = self.n_experts, self.top_k
        cap = max(int(self.capacity_factor * n_all * k / e), 1)
        top_p, top_i = _top(probs, k)                            # (N, K)
        gates = top_p
        if k > 1 and self.normalize_gates:
            gates = top_p / top_p.sum(dim=-1, keepdim=True)
        onehot = F.one_hot(top_i, e).to(torch.float32)           # (N, K, E)
        # queue positions, first choices ahead of second choices, the
        # whole batch's tokens in order: a cumsum over this rank's
        # tokens of each choice, after every rank's earlier choices and
        # the lower ranks' tokens of this choice
        flat = onehot.transpose(0, 1)                            # (K, N, E)
        counts = flat.sum(dim=1)                                 # (K, E)
        every = prim.all_gather(counts, 0, group=tok.group) \
            if tok.size > 1 else counts[None]                    # (R, K, E)
        total = every.sum(dim=0)
        start = torch.cumsum(total, dim=0) - total               # (K, E)
        offset = start + every[:tok.rank].sum(dim=0)
        pos = ((torch.cumsum(flat, dim=1) + offset[:, None, :]) * flat
               - 1.0).transpose(0, 1)                            # (N, K, E)
        keep = (pos >= 0) & (pos < cap)
        pos, keep = pos[..., mine], keep[..., mine]
        disp_k = F.one_hot(pos.clamp(0, cap - 1).long(),
                           self._slots(cap, tok)) \
            .to(torch.float32) * keep[..., None]                 # (N,K,E,C)
        dispatch = disp_k.sum(dim=1)                             # (N, E, C)
        combine = torch.einsum("nkec,nk->nec", disp_k, gates)
        kept = torch.minimum(total, (cap - start).clamp(min=0))  # (K, E)
        per_expert = kept.sum(dim=0)                             # (E,)
        metrics = {
            "first_choice": total[0] / n_all,
            "drop_rate": 1.0 - kept.sum() / (n_all * k),
            "expert_load": per_expert / torch.clamp(per_expert.sum(),
                                                    min=1.0),
        }
        return dispatch, combine, metrics

    def _expert_choice(self, probs, n_all: int, mine: slice, tok: _Axis):
        e = self.n_experts
        n = probs.shape[0]
        cap = min(max(int(self.capacity_factor * n_all / e), 1), n_all)
        # each expert's top tokens of the whole batch, ranked on every
        # rank alike from the gathered scores
        scores = probs.detach()
        if tok.size > 1:
            scores = prim.all_gather(scores, 0, tiled=True, group=tok.group)
        top_idx = _top(scores.t(), cap)[1]                      # (E, C)
        local = top_idx[mine] - tok.rank * n                    # this rank's
        ours = (local >= 0) & (local < n)
        disp = F.one_hot(local.clamp(0, n - 1), n).to(torch.float32) \
            * ours[..., None]                                   # (E, C, N)
        pad = self._slots(cap, tok) - cap
        dispatch = F.pad(disp.permute(2, 0, 1), (0, pad))       # (N, E, C)
        combine = dispatch * probs[:, mine, None]
        picks = torch.bincount(top_idx.reshape(-1), minlength=n_all)
        metrics = {
            "drop_rate": torch.mean((picks == 0).to(torch.float32)),
            "expert_load": torch.full((e,), 1.0 / e, dtype=torch.float32,
                                      device=probs.device),
        }
        return dispatch, combine, metrics

    # -- entry points -----------------------------------------------------

    def forward_with_metrics(self, x) -> Tuple[Any, Dict[str, Any]]:
        """(y, metrics): y of x's shape and dtype (and layout)."""
        from torch.distributed.tensor import DTensor
        if isinstance(x, DTensor):
            return self._island(x)
        return self._forward_local(x, self._weights())

    def forward(self, x):
        """``(y, aux_loss)``, the JAX package's ``apply``."""
        y, m = self.forward_with_metrics(x)
        return y, m["aux_loss"]

    def _island(self, x):
        """The layer on DTensor x (module docstring): x as shards of its
        first dimension over the token axis, the weights replicated
        except the experts' ep dimension, the local layer, and y put
        back in x's layout (the metrics are replicated DTensors)."""
        from torch.distributed.tensor import (DTensor, Partial, Replicate,
                                              Shard)
        mesh = x.device_mesh
        w = self._weights()
        for t in w.values():
            if not isinstance(t, DTensor) or t.device_mesh != mesh:
                raise ValueError(
                    "an MoE layer on a DTensor input takes its parameters "
                    "as DTensors of the input's mesh (place them with "
                    "tensor.shard_params)")

        def axis(i):
            if i is None:
                return _Axis()
            sub = mesh[mesh.mesh_dim_names[i]] if mesh.ndim > 1 else mesh
            return _Axis(sub.get_group(), mesh.size(i), sub.get_local_rank())
        ep_dim = next((i for i, p in enumerate(self.fc1.weight.placements)
                       if p == Shard(0) and mesh.size(i) > 1), None)
        tok_dim = next((i for i, p in enumerate(x.placements)
                        if p == Shard(0) and i != ep_dim
                        and mesh.size(i) > 1), None)
        ep, tok = axis(ep_dim), axis(tok_dim)
        dims = range(mesh.ndim)
        rep = tuple(Replicate() for _ in dims)
        local = {}
        for name, t in w.items():
            want = tuple(Shard(0) if i == ep_dim and name.startswith("fc")
                         else Replicate() for i in dims)
            if tuple(t.placements) != want:
                t = t.redistribute(mesh, want)
            grad = tuple(Partial() if i == tok_dim else p
                         for i, p in zip(dims, want))
            local[name] = t.to_local(grad_placements=grad)
        xp = tuple(Shard(0) if i == tok_dim else Replicate() for i in dims)
        xl = x if tuple(x.placements) == xp else x.redistribute(mesh, xp)
        if tok.size > 1 and xl.to_local().shape[0] * tok.size != x.shape[0]:
            raise ValueError(f"an MoE island splits the batch's first "
                             f"dimension ({x.shape[0]}) evenly over its "
                             f"{tok.size} token ranks")
        y, metrics = self._forward_local(xl.to_local(), local, ep, tok)
        y = DTensor.from_local(y, mesh, xp, run_check=False, shape=x.shape,
                               stride=x.stride())
        # the metrics as replicated DTensors of the mesh (the loss adds
        # the aux to DTensors)
        metrics = {k: DTensor.from_local(v, mesh, rep, run_check=False)
                   for k, v in metrics.items()}
        if tuple(x.placements) != xp:
            y = y.redistribute(mesh, x.placements)
        return y, metrics


def moe_param_specs(ep_axis: str = "ep", tp_axis: Optional[str] = None,
                    n_shared_experts: int = 0):
    """The spec tree of a :class:`MoELayer`'s params (the JAX tree's
    shape): experts over ``ep`` (their hidden over ``tp``), the gate
    replicated, shared experts replicated over ep with their hidden over
    ``tp``."""
    from .tensor import P
    t = tp_axis
    specs = {
        "gate": {"w": P()},
        "fc1": {"w": P(ep_axis, None, t), "b": P(ep_axis, t)},
        "fc2": {"w": P(ep_axis, t, None), "b": P(ep_axis, None)},
    }
    if n_shared_experts:
        specs["shared"] = {"fc1": {"w": P(None, t), "b": P(t)},
                           "fc2": {"w": P(t, None), "b": P()}}
    return specs


__all__ = ["ExpertLinear", "MoELayer", "moe_param_specs"]
