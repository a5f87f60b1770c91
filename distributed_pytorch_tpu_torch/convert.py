"""Move ``TransformerLM`` and ``DummyModel`` params between the JAX
param tree and the port's modules: ``from_jax_params`` loads,
``to_jax_params`` reads back.

The JAX package's params are a nested dict/list pytree (what
``TransformerLM.init`` returns); pass it with every leaf as a numpy
array (``jax.tree_util.tree_map(np.asarray, params)``). Layout changes:

- ``Linear`` W is (in, out) in JAX and (out, in) here: transposed;
- the fused qkv projection keeps its ``[q | k | v]`` column order, so it
  transposes like any Linear;
- LayerNorm ``scale``/``bias`` and embedding tables copy as they are;
- with tied embeddings there is no head: the port's vocab projection
  reads the token table, as the JAX package's does.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from .models.mlp import DummyModel


def _copy(dst: torch.nn.Parameter, src, transpose: bool = False) -> None:
    arr = np.asarray(src)
    if transpose:
        arr = arr.T
    if tuple(arr.shape) != tuple(dst.shape):
        raise ValueError(f"param shape {arr.shape} does not match the "
                         f"port's {tuple(dst.shape)}")
    with torch.no_grad():
        dst.copy_(torch.from_numpy(np.array(arr)).to(
            device=dst.device, dtype=dst.dtype))


def _linear(mod, p: Mapping[str, Any]) -> None:
    _copy(mod.weight, p["w"], transpose=True)
    if mod.bias is not None:
        _copy(mod.bias, p["b"])


def _layer_norm(mod, p: Mapping[str, Any]) -> None:
    _copy(mod.scale, p["scale"])
    _copy(mod.bias, p["bias"])


def from_jax_params(params_np: Mapping[str, Any], model):
    """Copy the JAX param tree into ``model`` (a ``TransformerLM`` or a
    ``DummyModel``) in place; returns it."""
    if isinstance(model, DummyModel):
        _linear(model.lin1, params_np["lin1"])
        _linear(model.lin2, params_np["lin2"])
        return model
    if "emb" not in params_np["tok"]:
        raise ValueError("int8-quantized params are not supported yet: "
                         "pass the float param tree")
    _copy(model.tok.weight, params_np["tok"]["emb"])
    if model.pos is not None:
        _copy(model.pos.weight, params_np["pos"]["emb"])
    if len(params_np["blocks"]) != len(model.blocks):
        raise ValueError(f"{len(params_np['blocks'])} JAX blocks for a "
                         f"{len(model.blocks)}-layer model")
    for blk, p in zip(model.blocks, params_np["blocks"]):
        _layer_norm(blk.ln1, p["ln1"])
        _linear(blk.attn.qkv, p["attn"]["qkv"])
        _linear(blk.attn.out, p["attn"]["out"])
        _layer_norm(blk.ln2, p["ln2"])
        _linear(blk.fc1, p["fc1"])
        _linear(blk.fc2, p["fc2"])
    _layer_norm(model.ln_f, params_np["ln_f"])
    if model.head is not None:
        _linear(model.head, params_np["head"])
    return model


def _leaf(param: torch.nn.Parameter, grads: bool, transpose: bool = False):
    t = param.grad if grads else param
    if t is None:
        t = torch.zeros_like(param)
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:       # numpy has no bfloat16
        t = t.to(torch.float32)
    arr = t.numpy()
    return np.ascontiguousarray(arr.T) if transpose else arr


def to_jax_params(model, grads: bool = False):
    """The JAX param tree of ``model`` as numpy arrays: the inverse of
    :func:`from_jax_params` (Linear W transposed back to (in, out)).
    With ``grads=True`` the same tree of the parameters' ``.grad``
    (zeros where a parameter has none); bfloat16 reads as float32."""
    def linear(mod):
        out = {"w": _leaf(mod.weight, grads, transpose=True)}
        if mod.bias is not None:
            out["b"] = _leaf(mod.bias, grads)
        return out

    def layer_norm(mod):
        return {"scale": _leaf(mod.scale, grads),
                "bias": _leaf(mod.bias, grads)}

    if isinstance(model, DummyModel):
        return {"lin1": linear(model.lin1), "lin2": linear(model.lin2)}

    tree = {"tok": {"emb": _leaf(model.tok.weight, grads)},
            "blocks": [{"ln1": layer_norm(blk.ln1),
                        "attn": {"qkv": linear(blk.attn.qkv),
                                 "out": linear(blk.attn.out)},
                        "ln2": layer_norm(blk.ln2),
                        "fc1": linear(blk.fc1), "fc2": linear(blk.fc2)}
                       for blk in model.blocks],
            "ln_f": layer_norm(model.ln_f)}
    if model.pos is not None:
        tree["pos"] = {"emb": _leaf(model.pos.weight, grads)}
    if model.head is not None:
        tree["head"] = linear(model.head)
    return tree
