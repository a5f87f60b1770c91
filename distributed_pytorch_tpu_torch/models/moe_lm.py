"""Mixture-of-experts transformer LM: ``TransformerLM``'s blocks with the
dense MLP swapped for a Switch MoE layer (``parallel/moe.py``), experts
sharded over the ``ep`` mesh axis by :meth:`MoETransformerLM.param_specs`.

Counterpart of ``distributed_pytorch_tpu/models/moe_lm.py``. The model
is built on the card unless ``device`` says otherwise; weights are
drawn from ``generator`` or loaded from a JAX param tree with
``convert.from_jax_params``.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from ..nn.attention import MultiHeadAttention
from ..nn.core import Embedding, LayerNorm, Linear
from ..parallel.moe import MoELayer, moe_param_specs
from ..runtime.device import DeviceLike, resolve_device


class MoEBlock(nn.Module):
    """Pre-norm block with an MoE MLP: x + MHA(LN(x)); x + MoE(LN(x))."""

    def __init__(self, dim: int, n_heads: int, n_experts: int,
                 mlp_ratio: int = 4, *, causal: bool = True,
                 capacity_factor: float = 2.0, top_k: int = 1,
                 router_z_coef: float = 0.1, router: str = "tokens",
                 n_shared_experts: int = 0,
                 n_kv_heads: Optional[int] = None, rope: bool = False,
                 attn_fn: Optional[Callable] = None, dtype=torch.float32,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.ln1 = LayerNorm(dim, **kw)
        self.attn = MultiHeadAttention(dim, n_heads, causal=causal,
                                       n_kv_heads=n_kv_heads, rope=rope,
                                       attn_fn=attn_fn, generator=generator,
                                       **kw)
        self.ln2 = LayerNorm(dim, **kw)
        self.router_z_coef = router_z_coef
        self.moe = MoELayer(dim, n_experts, mlp_ratio,
                            capacity_factor=capacity_factor, top_k=top_k,
                            router=router, n_shared_experts=n_shared_experts,
                            generator=generator, **kw)

    def forward_with_metrics(self, x, positions=None):
        """(y, the router metrics with the combined trainable ``aux`` =
        load-balancing loss + ``router_z_coef`` * z-loss)."""
        x = x + self.attn(self.ln1(x), positions=positions)
        h, m = self.moe.forward_with_metrics(self.ln2(x))
        m = dict(m, aux=m["aux_loss"] + self.router_z_coef * m["z_loss"])
        return x + h, m

    def forward(self, x, positions=None):
        y, m = self.forward_with_metrics(x, positions=positions)
        return y, m["aux"]


class MoETransformerLM(nn.Module):
    """Decoder-only LM with MoE MLPs; ``forward`` returns (logits, aux)."""

    def __init__(self, vocab: int = 256, dim: int = 128, n_layers: int = 2,
                 n_heads: int = 4, n_experts: int = 4, max_seq: int = 512,
                 mlp_ratio: int = 4, capacity_factor: float = 2.0,
                 top_k: int = 1, router_z_coef: float = 0.1,
                 router: str = "tokens", n_shared_experts: int = 0,
                 n_kv_heads: Optional[int] = None, pos: str = "learned",
                 attn_fn: Optional[Callable] = None, dtype=torch.float32,
                 device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if pos not in ("learned", "rope", "none"):
            raise ValueError(f"pos must be learned|rope|none, got {pos!r}")
        device = resolve_device(device)
        self.vocab = vocab
        self.dim = dim
        self.n_layers = n_layers
        self.n_experts = n_experts
        self.n_shared_experts = n_shared_experts
        self.pos_kind = pos
        self.dtype = dtype
        kw = dict(dtype=dtype, device=device)
        self.tok = Embedding(vocab, dim, std=dim ** -0.5, generator=generator,
                             **kw)
        self.pos = Embedding(max_seq, dim, std=dim ** -0.5,
                             generator=generator, **kw) \
            if pos == "learned" else None
        self.blocks = nn.ModuleList([
            MoEBlock(dim, n_heads, n_experts, mlp_ratio,
                     capacity_factor=capacity_factor, top_k=top_k,
                     router_z_coef=router_z_coef, router=router,
                     n_shared_experts=n_shared_experts,
                     n_kv_heads=n_kv_heads, rope=(pos == "rope"),
                     attn_fn=attn_fn, generator=generator, **kw)
            for _ in range(n_layers)])
        self.ln_f = LayerNorm(dim, **kw)
        self.head = Linear(dim, vocab, bias=False, generator=generator, **kw)

    @property
    def device(self) -> torch.device:
        return self.ln_f.scale.device

    def forward_with_metrics(self, tokens, positions=None, pos_offset=0):
        """(logits, aux, metrics): ``metrics`` averages the per-layer
        router metrics (``aux_loss``, ``z_loss``, ``drop_rate``,
        ``expert_load``). ``positions`` overrides the position ids (the
        striped layout of ``parallel.sequence.stripe_tokens``)."""
        tokens = tokens.to(self.device, torch.long)
        if positions is None:
            positions = pos_offset + torch.arange(tokens.shape[1],
                                                  device=self.device)
        x = self.tok(tokens)
        if self.pos is not None:
            x = x + self.pos(positions)
        per_layer = []
        for blk in self.blocks:
            x, m = blk.forward_with_metrics(x, positions=positions)
            per_layer.append(m)
        x = self.ln_f(x)
        metrics = {k: sum(m[k] for m in per_layer) / self.n_layers
                   for k in per_layer[0]}
        return self.head(x), metrics.pop("aux"), metrics

    def forward(self, tokens, positions=None, pos_offset=0):
        logits, aux, _ = self.forward_with_metrics(
            tokens, positions=positions, pos_offset=pos_offset)
        return logits, aux

    def param_specs(self, ep_axis: str = "ep", tp_axis: str = "tp"):
        """The spec tree (the JAX tree's shape): attention tensor-parallel
        over ``tp``, experts over ``ep``."""
        from ..parallel.tensor import P
        t = tp_axis

        def block_specs():
            return {
                "ln1": {"scale": P(), "bias": P()},
                "attn": {"qkv": {"w": P(None, t), "b": P(t)},
                         "out": {"w": P(t, None), "b": P()}},
                "ln2": {"scale": P(), "bias": P()},
                "moe": moe_param_specs(
                    ep_axis=ep_axis, tp_axis=t,
                    n_shared_experts=self.n_shared_experts),
            }

        specs = {
            "tok": {"emb": P()},
            "blocks": [block_specs() for _ in range(self.n_layers)],
            "ln_f": {"scale": P(), "bias": P()},
            "head": {"w": P(None, t)},
        }
        if self.pos is not None:
            specs["pos"] = {"emb": P()}
        return specs


__all__ = ["MoEBlock", "MoETransformerLM"]
