"""GPT-2 weights made on the device from the run's seed.

One ``torch.randn`` over every normally-initialised element, drawn in
the dtype the cell runs in by a ``torch.Generator`` on the card, then
one in-place scale per initialisation group: GPT-2's initialisation
(``initializer_range`` for ``wte`` and every projection, 0.01 for
``wpe``, the two residual projections of a block at
``initializer_range / sqrt(2 n_layer)``, zero biases, unit LayerNorm
scales). The names and layouts are GPT-2's own (``Conv1D`` weights are
``(in, out)``); the reference reads this dict as it is, and
:func:`load_into_port` copies it into the program's modules.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch


def layout(cfg: dict) -> List[Tuple[str, Tuple[int, ...], str]]:
    """``(name, shape, init)`` of every GPT-2 parameter; ``init`` is
    ``std``, ``std_pos``, ``std_resid``, ``ones`` or ``zeros``."""
    d, L = cfg["n_embd"], cfg["n_layer"]
    v, p = cfg["vocab_size"], cfg["n_positions"]
    out = [("wte", (v, d), "std"), ("wpe", (p, d), "std_pos")]
    for i in range(L):
        h = f"h.{i}."
        out += [(h + "ln_1.weight", (d,), "ones"),
                (h + "ln_1.bias", (d,), "zeros"),
                (h + "attn.c_attn.weight", (d, 3 * d), "std"),
                (h + "attn.c_attn.bias", (3 * d,), "zeros"),
                (h + "attn.c_proj.weight", (d, d), "std_resid"),
                (h + "attn.c_proj.bias", (d,), "zeros"),
                (h + "ln_2.weight", (d,), "ones"),
                (h + "ln_2.bias", (d,), "zeros"),
                (h + "mlp.c_fc.weight", (d, 4 * d), "std"),
                (h + "mlp.c_fc.bias", (4 * d,), "zeros"),
                (h + "mlp.c_proj.weight", (4 * d, d), "std_resid"),
                (h + "mlp.c_proj.bias", (d,), "zeros")]
    out += [("ln_f.weight", (d,), "ones"), ("ln_f.bias", (d,), "zeros")]
    return out


def n_params(cfg: dict) -> int:
    return sum(math.prod(shape) for _, shape, _ in layout(cfg))


def make(cfg: dict, seed: int, device, dtype) -> Dict[str, torch.Tensor]:
    """Every GPT-2 parameter of ``cfg`` from ``seed``, on ``device`` in
    ``dtype``: views into one buffer per initialisation kind."""
    stds = {"std": cfg["initializer_range"], "std_pos": 0.01,
            "std_resid": cfg["initializer_range"]
            / math.sqrt(2 * cfg["n_layer"])}
    items = layout(cfg)
    order = ["std", "std_pos", "std_resid"]
    drawn = [it for kind in order for it in items if it[2] == kind]
    sizes = [math.prod(shape) for _, shape, _ in drawn]
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(sum(sizes), generator=gen, device=device, dtype=dtype)
    out, off = {}, 0
    for kind in order:
        n = sum(s for (_, _, k), s in zip(drawn, sizes) if k == kind)
        flat[off:off + n].mul_(stds[kind])
        off += n
    off = 0
    for (name, shape, _), size in zip(drawn, sizes):
        out[name] = flat[off:off + size].view(shape)
        off += size
    for name, shape, kind in items:
        if kind == "ones":
            out[name] = torch.ones(shape, device=device, dtype=dtype)
        elif kind == "zeros":
            out[name] = torch.zeros(shape, device=device, dtype=dtype)
    return {name: out[name] for name, _, _ in items}


def port_name(name: str) -> Tuple[str, bool]:
    """The program's parameter name for a GPT-2 name, and whether the
    tensor is stored transposed there (``nn.Linear`` keeps
    ``(out, in)``, GPT-2's ``Conv1D`` ``(in, out)``)."""
    fixed = {"wte": "tok.weight", "wpe": "pos.weight",
             "ln_f.weight": "ln_f.scale", "ln_f.bias": "ln_f.bias"}
    if name in fixed:
        return fixed[name], False
    _, i, rest = name.split(".", 2)
    sub = {"ln_1.weight": "ln1.scale", "ln_1.bias": "ln1.bias",
           "attn.c_attn.weight": "attn.qkv.weight",
           "attn.c_attn.bias": "attn.qkv.bias",
           "attn.c_proj.weight": "attn.out.weight",
           "attn.c_proj.bias": "attn.out.bias",
           "ln_2.weight": "ln2.scale", "ln_2.bias": "ln2.bias",
           "mlp.c_fc.weight": "fc1.weight", "mlp.c_fc.bias": "fc1.bias",
           "mlp.c_proj.weight": "fc2.weight",
           "mlp.c_proj.bias": "fc2.bias"}[rest]
    return f"blocks.{i}.{sub}", rest.endswith("weight") and "ln_" not in rest


def parts(name: str, t: torch.Tensor, port_layout: bool = False):
    """The leaves the checks compare: every parameter whole, but
    ``c_attn``'s weight and bias split into their q, k and v thirds
    (along the output axis: dim 1 in GPT-2's layout, dim 0 in the
    program's), so that the key bias, whose gradient is nought under
    softmax, is a leaf of its own."""
    if ".c_attn." not in name:
        return [(name, t)]
    dim = 0 if (port_layout or t.dim() == 1) else 1
    return [(f"{name}.{p}", c) for p, c in zip("qkv", t.chunk(3, dim=dim))]


@torch.no_grad()
def load_into_port(model, weights: Dict[str, torch.Tensor]) -> None:
    """Copy the seed-made weights into the program's ``TransformerLM``;
    every one of its parameters must be written exactly once."""
    params = dict(model.named_parameters())
    seen = set()
    for name, w in weights.items():
        target, transposed = port_name(name)
        src = w.t() if transposed else w
        if params[target].shape != src.shape:
            raise ValueError(f"{name} -> {target}: shape {tuple(src.shape)} "
                             f"against {tuple(params[target].shape)}")
        params[target].copy_(src)
        seen.add(target)
    if seen != set(params):
        raise ValueError(f"parameters not written: "
                         f"{sorted(set(params) - seen)}")
