"""Move ``TransformerLM``, ``DummyModel`` and ``ResNet18`` params between
the JAX param tree and the port's modules: ``from_jax_params`` loads,
``to_jax_params`` reads back; ``from_jax_state`` / ``to_jax_state`` do
the same for ``ResNet18``'s BatchNorm running stats.

The JAX package's params are a nested dict/list pytree (what
``TransformerLM.init`` returns); pass it with every leaf as a numpy
array (``jax.tree_util.tree_map(np.asarray, params)``). Layout changes:

- ``Linear`` W is (in, out) in JAX and (out, in) here: transposed;
- the fused qkv projection keeps its ``[q | k | v]`` column order, so it
  transposes like any Linear;
- LayerNorm and BatchNorm ``scale``/``bias`` and embedding tables copy
  as they are;
- conv kernels are HWIO in JAX and OIHW here: permuted (3, 2, 0, 1);
- with tied embeddings there is no head: the port's vocab projection
  reads the token table, as the JAX package's does.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from .models.mlp import DummyModel
from .models.resnet import ResNet18
from .nn.conv import BatchNorm2d, Conv2d

# HWIO -> OIHW (and its inverse, OIHW -> HWIO)
_TO_OIHW, _TO_HWIO = (3, 2, 0, 1), (2, 3, 1, 0)


def _copy(dst: torch.Tensor, src, transpose: bool = False,
          perm=None) -> None:
    arr = np.asarray(src)
    if transpose:
        arr = arr.T
    if perm is not None:
        arr = arr.transpose(perm)
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


def _norm(mod, p: Mapping[str, Any]) -> None:
    _copy(mod.scale, p["scale"])
    _copy(mod.bias, p["bias"])


def _conv(mod, p: Mapping[str, Any]) -> None:
    _copy(mod.weight, p["w"], perm=_TO_OIHW)
    if mod.bias is not None:
        _copy(mod.bias, p["b"])


def _resnet_modules(model: ResNet18):
    """(JAX path, module) of every conv, BatchNorm and the fc."""
    yield ("stem",), model.stem
    yield ("bn_stem",), model.bn_stem
    for name in model.block_names:
        blk = getattr(model, name)
        for sub in ("conv1", "bn1", "conv2", "bn2", "ds_conv", "ds_bn"):
            if getattr(blk, sub) is not None:
                yield (name, sub), getattr(blk, sub)
    yield ("fc",), model.fc


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _put(tree, path, value):
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def from_jax_params(params_np: Mapping[str, Any], model):
    """Copy the JAX param tree into ``model`` (a ``TransformerLM``, a
    ``DummyModel`` or a ``ResNet18``) in place; returns it."""
    if isinstance(model, ResNet18):
        for path, mod in _resnet_modules(model):
            p = _get(params_np, path)
            if isinstance(mod, Conv2d):
                _conv(mod, p)
            elif isinstance(mod, BatchNorm2d):
                _norm(mod, p)
            else:
                _linear(mod, p)
        return model
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
        _norm(blk.ln1, p["ln1"])
        _linear(blk.attn.qkv, p["attn"]["qkv"])
        _linear(blk.attn.out, p["attn"]["out"])
        _norm(blk.ln2, p["ln2"])
        _linear(blk.fc1, p["fc1"])
        _linear(blk.fc2, p["fc2"])
    _norm(model.ln_f, params_np["ln_f"])
    if model.head is not None:
        _linear(model.head, params_np["head"])
    return model


def _leaf(param: torch.Tensor, grads: bool, transpose: bool = False,
          perm=None):
    t = param.grad if grads else param
    if t is None:
        t = torch.zeros_like(param)
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:       # numpy has no bfloat16
        t = t.to(torch.float32)
    arr = t.numpy()
    if transpose:
        arr = arr.T
    if perm is not None:
        arr = arr.transpose(perm)
    return np.ascontiguousarray(arr)


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

    def norm(mod):
        return {"scale": _leaf(mod.scale, grads),
                "bias": _leaf(mod.bias, grads)}

    if isinstance(model, DummyModel):
        return {"lin1": linear(model.lin1), "lin2": linear(model.lin2)}
    if isinstance(model, ResNet18):
        tree = {}
        for path, mod in _resnet_modules(model):
            if isinstance(mod, Conv2d):
                leaf = {"w": _leaf(mod.weight, grads, perm=_TO_HWIO)}
                if mod.bias is not None:
                    leaf["b"] = _leaf(mod.bias, grads)
            elif isinstance(mod, BatchNorm2d):
                leaf = norm(mod)
            else:
                leaf = linear(mod)
            _put(tree, path, leaf)
        return tree

    tree = {"tok": {"emb": _leaf(model.tok.weight, grads)},
            "blocks": [{"ln1": norm(blk.ln1),
                        "attn": {"qkv": linear(blk.attn.qkv),
                                 "out": linear(blk.attn.out)},
                        "ln2": norm(blk.ln2),
                        "fc1": linear(blk.fc1), "fc2": linear(blk.fc2)}
                       for blk in model.blocks],
            "ln_f": norm(model.ln_f)}
    if model.pos is not None:
        tree["pos"] = {"emb": _leaf(model.pos.weight, grads)}
    if model.head is not None:
        tree["head"] = linear(model.head)
    return tree


_STATS = ("mean", "var", "count")


def from_jax_state(state_np: Mapping[str, Any], model: ResNet18):
    """Copy the JAX model state (BatchNorm ``mean``, ``var``, ``count``
    per norm, as ``ResNet18.init`` returns it) into ``model``'s buffers
    in place; returns it."""
    for path, mod in _resnet_modules(model):
        if isinstance(mod, BatchNorm2d):
            st = _get(state_np, path)
            for k in _STATS:
                _copy(getattr(mod, k), st[k])
    return model


def to_jax_state(model: ResNet18):
    """The JAX model state of ``model`` as numpy arrays: the inverse of
    :func:`from_jax_state`."""
    tree = {}
    for path, mod in _resnet_modules(model):
        if isinstance(mod, BatchNorm2d):
            _put(tree, path, {k: getattr(mod, k).detach().cpu().numpy()
                              .copy() for k in _STATS})
    return tree
