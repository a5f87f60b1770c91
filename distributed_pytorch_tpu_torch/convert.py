"""Load a JAX ``TransformerLM`` param tree into the port's modules.

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

from .models.transformer import TransformerLM


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


def from_jax_params(params_np: Mapping[str, Any],
                    model: TransformerLM) -> TransformerLM:
    """Copy the JAX param tree into ``model`` in place; returns it."""
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
