"""Plain GPT-2 in float32: forward, loss, gradients and AdamW.

The benchmark's reference for every GPT-2 cell. It follows the published
model (``modeling_gpt2.py``'s equations): learned positions, pre-LN
blocks with LayerNorm eps from the config, fused ``c_attn`` laid out
``[q | k | v]``, causal softmax attention over heads of
``n_embd / n_head``, GELU (tanh form) in a 4x MLP, a final LayerNorm and
the vocabulary projection tied to ``wte``. Dropout is off, as the cells
run it. It reads the seed-made weight dict of ``portbench.weights`` in
GPT-2's own layout, uses plain torch operations and autograd only, and
imports nothing of the program.

Every matrix product goes through ``mm``. :func:`exact_mm` is float32
with TF32 off (:func:`strict_float32` sets it); :func:`fp8_mm` is the
control: each operand rounded to float8 e4m3 (gradients to e5m2) with a
per-tensor scale, products summed in float32, as fp8 training computes
them.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

Mm = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def strict_float32() -> None:
    """Float32 products stay float32 on the card (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def exact_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(a, b)


_E4M3_MAX, _E5M2_MAX = 448.0, 57344.0


def _round_fp8(x: torch.Tensor, dtype, top: float) -> torch.Tensor:
    amax = x.detach().abs().amax().clamp_min(1e-12)
    scale = top / amax
    return (x * scale).to(dtype).to(x.dtype) / scale


class _Fp8Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        qa = _round_fp8(a, torch.float8_e4m3fn, _E4M3_MAX)
        qb = _round_fp8(b, torch.float8_e4m3fn, _E4M3_MAX)
        ctx.save_for_backward(qa, qb)
        return torch.matmul(qa, qb)

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = _round_fp8(g, torch.float8_e5m2, _E5M2_MAX)
        ga = torch.matmul(qg, qb.transpose(-1, -2))
        if qb.dim() == 2:
            gb = (qa.reshape(-1, qa.shape[-1]).t()
                  @ qg.reshape(-1, qg.shape[-1]))
        else:
            gb = torch.matmul(qa.transpose(-1, -2), qg)
        return ga, gb


def fp8_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _Fp8Matmul.apply(a, b)


def _ln(x, w, b, eps):
    return F.layer_norm(x, (x.shape[-1],), w, b, eps)


def _block(x, p: Dict[str, torch.Tensor], i: int, cfg: dict, mm: Mm):
    h, eps = f"h.{i}.", cfg["layer_norm_epsilon"]
    n_head = cfg["n_head"]
    bsz, s, d = x.shape
    dh = d // n_head
    a = _ln(x, p[h + "ln_1.weight"], p[h + "ln_1.bias"], eps)
    qkv = mm(a, p[h + "attn.c_attn.weight"]) + p[h + "attn.c_attn.bias"]
    q, k, v = (t.reshape(bsz, s, n_head, dh).transpose(1, 2)
               for t in qkv.split(d, dim=-1))
    scores = mm(q, k.transpose(-1, -2)) / math.sqrt(dh)
    mask = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
    probs = torch.softmax(scores.masked_fill(~mask, float("-inf")), dim=-1)
    o = mm(probs, v).transpose(1, 2).reshape(bsz, s, d)
    x = x + mm(o, p[h + "attn.c_proj.weight"]) + p[h + "attn.c_proj.bias"]
    m = _ln(x, p[h + "ln_2.weight"], p[h + "ln_2.bias"], eps)
    m = F.gelu(mm(m, p[h + "mlp.c_fc.weight"]) + p[h + "mlp.c_fc.bias"],
               approximate="tanh")
    return x + mm(m, p[h + "mlp.c_proj.weight"]) + p[h + "mlp.c_proj.bias"]


def hidden(p: Dict[str, torch.Tensor], cfg: dict, tokens: torch.Tensor,
           mm: Mm = exact_mm, layerwise: bool = False) -> torch.Tensor:
    """Final-LayerNorm hidden states (B, S, n_embd) of ``tokens`` (B, S).
    ``layerwise`` keeps only each block's input for the backward and
    recomputes the block there (the same arithmetic, less memory)."""
    pos = torch.arange(tokens.shape[1], device=tokens.device)
    x = p["wte"][tokens] + p["wpe"][pos]
    for i in range(cfg["n_layer"]):
        if layerwise and torch.is_grad_enabled():
            x = checkpoint(_block, x, p, i, cfg, mm, use_reentrant=False)
        else:
            x = _block(x, p, i, cfg, mm)
    return _ln(x, p["ln_f.weight"], p["ln_f.bias"], cfg["layer_norm_epsilon"])


def logits(p, cfg, tokens, mm: Mm = exact_mm) -> torch.Tensor:
    """(B, S, vocab) float32 logits of ``tokens`` (B, S)."""
    return mm(hidden(p, cfg, tokens, mm), p["wte"].t())


def loss(p, cfg, x, y, mm: Mm = exact_mm) -> torch.Tensor:
    """Mean next-token cross-entropy of inputs ``x`` against ``y``."""
    h = hidden(p, cfg, x, mm, layerwise=True)
    lg = mm(h, p["wte"].t())
    return F.cross_entropy(lg.reshape(-1, lg.shape[-1]), y.reshape(-1))


def leaves(name: str, t: torch.Tensor):
    """The leaves a training run is read by: each parameter whole, but
    ``c_attn``'s weight and bias as their q, k and v thirds, so that the
    key bias, whose gradient is nought under softmax, is one of its
    own."""
    if ".c_attn." not in name:
        return [(name, t)]
    return [(f"{name}.{p}", c) for p, c in zip("qkv", t.chunk(3, dim=-1))]


def train(weights: Dict[str, torch.Tensor], cfg: dict,
          steps: Sequence[Sequence[Tuple[torch.Tensor, torch.Tensor]]],
          adamw: dict, mm: Mm = exact_mm) -> dict:
    """AdamW steps from float32 copies of ``weights``. Each step is a
    list of equal-sized parts (one per data-parallel rank); the step's
    gradient is the mean of the parts' gradients. Returns each step's
    loss of each part, every leaf's (:func:`leaves`) gradient norm at
    step 1, and every leaf's change norm after the last step. AdamW as
    torch defines it: decoupled decay ``p * (1 - lr * wd)`` on every
    parameter, then the bias-corrected Adam step."""
    lr, b1, b2 = adamw["lr"], adamw["b1"], adamw["b2"]
    eps, wd = adamw["eps"], adamw["weight_decay"]
    p = {n: w.detach().to(torch.float32).clone().requires_grad_()
         for n, w in weights.items()}
    m = {n: torch.zeros_like(t) for n, t in p.items()}
    v = {n: torch.zeros_like(t) for n, t in p.items()}
    names = list(p)
    losses: List[List[float]] = []
    grad_norms: Dict[str, float] = {}
    for t, parts in enumerate(steps, 1):
        grads, step_losses = None, []
        for x, y in parts:
            lv = loss(p, cfg, x, y, mm)
            g = torch.autograd.grad(lv, [p[n] for n in names])
            step_losses.append(float(lv.detach()))
            grads = list(g) if grads is None else [
                a.add_(b) for a, b in zip(grads, g)]
            del g
        grads = [g.div_(len(parts)) for g in grads]
        losses.append(step_losses)
        with torch.no_grad():
            if t == 1:
                grad_norms = {k: float(part.norm()) for n, g in
                              zip(names, grads) for k, part in leaves(n, g)}
            c1, c2 = 1.0 - b1 ** t, 1.0 - b2 ** t
            for n, g in zip(names, grads):
                m[n].mul_(b1).add_(g, alpha=1.0 - b1)
                v[n].mul_(b2).addcmul_(g, g, value=1.0 - b2)
                p[n].mul_(1.0 - lr * wd)
                p[n].sub_(lr * (m[n] / c1) / ((v[n] / c2).sqrt() + eps))
        del grads
    with torch.no_grad():
        change = {k: float(part.norm()) for n in names for k, part in
                  leaves(n, p[n] - weights[n].to(torch.float32))}
    return {"losses": losses, "grad_norms": grad_norms,
            "change_norms": change}


@torch.no_grad()
def served_gaps(weights, cfg, prompt: torch.Tensor, served: torch.Tensor,
                mm: Mm = exact_mm, pick_mm: Mm = None) -> torch.Tensor:
    """For each served token, how far its float32 logit lies below the
    best logit at its position (0 where it is the argmax). With
    ``pick_mm`` the token judged at each position is instead the one a
    forward through ``pick_mm`` ranks first (the control)."""
    p = {n: w.to(torch.float32) for n, w in weights.items()}
    seq = torch.cat([prompt, served])[None, :-1]
    pos = slice(prompt.numel() - 1, seq.shape[1])
    ref = logits(p, cfg, seq, mm)[0, pos]
    if pick_mm is None:
        chosen = served
    else:
        chosen = logits(p, cfg, seq, pick_mm)[0, pos].argmax(-1)
    return ref.max(-1).values - ref.gather(-1, chosen[:, None])[:, 0]
