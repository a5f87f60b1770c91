"""Move ``TransformerLM``, ``MoETransformerLM``, ``DummyModel`` and
``ResNet18`` params, and stacked blocks (``parallel.pipeline
.stack_layer_params``), between the JAX param tree and the port's
modules: ``from_jax_params`` loads, ``to_jax_params`` reads back;
``from_jax_state`` / ``to_jax_state`` do the same for ``ResNet18``'s
BatchNorm running stats.

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
  reads the token table, as the JAX package's does;
- an MoE layer's expert banks (``fc1`` / ``fc2``: W (E, D, H) / (E, H,
  D), b (E, H) / (E, D)) keep the JAX layout and copy as they are; its
  gate and shared experts are Linears (the gate has no bias);
- a stack of blocks (a block module whose parameters carry a leading
  layer axis, ``n_stacked`` set) maps onto the JAX package's
  ``stack_layer_params`` tree of the same blocks: every leaf keeps the
  leading axis, and a Linear W swaps its last two axes;
- an int8 tree (``ops.quant.quantize_tree`` of the JAX package:
  ``{"w_q", "w_scale"}``, ``{"emb_q", "emb_scale"}``) loads into int8
  buffers (the port's ``quantize_tree`` form) and reads back the same
  way: ``w_q`` transposes like any Linear W, its scales copy as they
  are.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Optional

import numpy as np
import torch

from .models.mlp import DummyModel
from .models.resnet import ResNet18
from .nn.conv import BatchNorm2d, Conv2d
from .ops.quant import is_quantized, set_quantized

# HWIO -> OIHW (and its inverse, OIHW -> HWIO)
_TO_OIHW, _TO_HWIO = (3, 2, 0, 1), (2, 3, 1, 0)


def _copy(dst: torch.Tensor, src, transpose: bool = False,
          perm=None) -> None:
    arr = np.asarray(src)
    if transpose and arr.ndim >= 2:
        arr = arr.swapaxes(-1, -2)
    if perm is not None:
        arr = arr.transpose(perm)
    if tuple(arr.shape) != tuple(dst.shape):
        raise ValueError(f"param shape {arr.shape} does not match the "
                         f"port's {tuple(dst.shape)}")
    with torch.no_grad():
        dst.copy_(torch.from_numpy(np.array(arr)).to(
            device=dst.device, dtype=dst.dtype))


def _quantized(mod, p: Mapping[str, Any], key: str,
               transpose: bool) -> None:
    """Load the int8 pair ``{key}_q`` / ``{key}_scale`` into ``mod``'s
    int8 buffers, in the dtype its float weight has (or had)."""
    q = np.asarray(p[f"{key}_q"])
    q = q.T if transpose else q
    ref = mod.weight if mod.weight is not None else mod.weight_q
    if tuple(q.shape) != tuple(ref.shape):
        raise ValueError(f"param shape {q.shape} does not match the "
                         f"port's {tuple(ref.shape)}")
    dtype = mod.weight.dtype if mod.weight is not None else mod.weight_dtype
    set_quantized(mod, torch.from_numpy(np.array(q, np.int8)),
                  torch.from_numpy(np.array(p[f"{key}_scale"], np.float32)),
                  dtype, -1 if transpose else -2)


def _weight(mod, p: Mapping[str, Any], key: str, transpose: bool) -> None:
    if f"{key}_q" in p:
        _quantized(mod, p, key, transpose)
    else:
        _copy(mod.weight, p[key], transpose=transpose)


def _linear(mod, p: Mapping[str, Any]) -> None:
    _weight(mod, p, "w", transpose=True)
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
    """Copy the JAX param tree into ``model`` (a ``TransformerLM``, an
    ``MoETransformerLM``, an ``MoELayer``, a ``DummyModel``, a
    ``ResNet18`` or a stack of blocks) in place; returns it."""
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
    if getattr(model, "n_stacked", None) is not None:
        _block(model, params_np)
        return model
    from .parallel.moe import MoELayer
    if isinstance(model, MoELayer):
        _moe(model, params_np)
        return model
    _weight(model.tok, params_np["tok"], "emb", transpose=False)
    if model.pos is not None:
        _weight(model.pos, params_np["pos"], "emb", transpose=False)
    if len(params_np["blocks"]) != len(model.blocks):
        raise ValueError(f"{len(params_np['blocks'])} JAX blocks for a "
                         f"{len(model.blocks)}-layer model")
    for blk, p in zip(model.blocks, params_np["blocks"]):
        _block(blk, p)
    _norm(model.ln_f, params_np["ln_f"])
    if model.head is not None:
        _linear(model.head, params_np["head"])
    return model


def _moe(moe, q: Mapping[str, Any]) -> None:
    _linear(moe.gate, q["gate"])
    for name in ("fc1", "fc2"):
        _copy(getattr(moe, name).weight, q[name]["w"])
        _copy(getattr(moe, name).bias, q[name]["b"])
    if moe.shared is not None:
        _linear(moe.shared.fc1, q["shared"]["fc1"])
        _linear(moe.shared.fc2, q["shared"]["fc2"])


def _block(blk, p: Mapping[str, Any]) -> None:
    """One transformer or MoE block (or a stack of them) from its JAX
    tree."""
    _norm(blk.ln1, p["ln1"])
    _linear(blk.attn.qkv, p["attn"]["qkv"])
    _linear(blk.attn.out, p["attn"]["out"])
    _norm(blk.ln2, p["ln2"])
    if hasattr(blk, "moe"):
        _moe(blk.moe, p["moe"])
    else:
        _linear(blk.fc1, p["fc1"])
        _linear(blk.fc2, p["fc2"])


def _leaf(param: torch.Tensor, grads: bool, transpose: bool = False,
          perm=None):
    t = param.grad if grads else param
    if t is None:
        t = torch.zeros_like(param)
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:       # numpy has no bfloat16
        t = t.to(torch.float32)
    arr = t.numpy()
    if transpose and arr.ndim >= 2:
        arr = arr.swapaxes(-1, -2)
    if perm is not None:
        arr = arr.transpose(perm)
    return np.ascontiguousarray(arr)


def _jax_tree(model, leaf):
    """The JAX param tree of ``model`` with ``leaf(param, transpose,
    perm)`` at every leaf: how each parameter turns into its JAX leaf
    (Linear W transposed back to (in, out), conv kernels permuted back
    to HWIO)."""
    def weight(mod, key, transpose):
        if is_quantized(mod):
            return {f"{key}_q": leaf(mod.weight_q, transpose, None),
                    f"{key}_scale": leaf(mod.weight_scale, False, None)}
        return {key: leaf(mod.weight, transpose, None)}

    def linear(mod):
        out = weight(mod, "w", True)
        if mod.bias is not None:
            out["b"] = leaf(mod.bias, False, None)
        return out

    def norm(mod):
        return {"scale": leaf(mod.scale, False, None),
                "bias": leaf(mod.bias, False, None)}

    if isinstance(model, DummyModel):
        return {"lin1": linear(model.lin1), "lin2": linear(model.lin2)}
    if isinstance(model, ResNet18):
        tree = {}
        for path, mod in _resnet_modules(model):
            if isinstance(mod, Conv2d):
                node = {"w": leaf(mod.weight, False, _TO_HWIO)}
                if mod.bias is not None:
                    node["b"] = leaf(mod.bias, False, None)
            elif isinstance(mod, BatchNorm2d):
                node = norm(mod)
            else:
                node = linear(mod)
            _put(tree, path, node)
        return tree

    def moe_tree(moe):
        node = {"gate": linear(moe.gate)}
        for name in ("fc1", "fc2"):
            bank = getattr(moe, name)
            node[name] = {"w": leaf(bank.weight, False, None),
                          "b": leaf(bank.bias, False, None)}
        if moe.shared is not None:
            node["shared"] = {"fc1": linear(moe.shared.fc1),
                              "fc2": linear(moe.shared.fc2)}
        return node

    def block(blk):
        node = {"ln1": norm(blk.ln1),
                "attn": {"qkv": linear(blk.attn.qkv),
                         "out": linear(blk.attn.out)},
                "ln2": norm(blk.ln2)}
        if hasattr(blk, "moe"):
            node["moe"] = moe_tree(blk.moe)
        else:
            node.update(fc1=linear(blk.fc1), fc2=linear(blk.fc2))
        return node

    if getattr(model, "n_stacked", None) is not None:
        return block(model)
    from .parallel.moe import MoELayer
    if isinstance(model, MoELayer):
        return moe_tree(model)
    tree = {"tok": weight(model.tok, "emb", False),
            "blocks": [block(blk) for blk in model.blocks],
            "ln_f": norm(model.ln_f)}
    if model.pos is not None:
        tree["pos"] = weight(model.pos, "emb", False)
    if model.head is not None:
        tree["head"] = linear(model.head)
    return tree


def to_jax_params(model, grads: bool = False):
    """The JAX param tree of ``model`` as numpy arrays: the inverse of
    :func:`from_jax_params` (Linear W transposed back to (in, out)).
    With ``grads=True`` the same tree of the parameters' ``.grad``
    (zeros where a parameter has none); bfloat16 reads as float32."""
    return _jax_tree(model, lambda p, transpose, perm: _leaf(
        p, grads, transpose=transpose, perm=perm))


@dataclasses.dataclass(frozen=True)
class ParamSlot:
    """Where one of ``model.parameters()`` sits in the JAX param tree."""

    index: int                  # its position in ``model.parameters()``
    transpose: bool             # a Linear W: (out, in) here, (in, out) there
    perm: Optional[tuple]       # a conv kernel: OIHW here -> HWIO there
    lead: int = 0               # leading stack axes (a stack of blocks)

    def to_jax(self, t: torch.Tensor) -> torch.Tensor:
        """A tensor laid out like the parameter, in the JAX layout (a
        vector, such as a factored statistic, as it is)."""
        if self.transpose and t.dim() >= 2:
            return t.transpose(-1, -2)
        return t.permute(self.perm) if self.perm is not None else t

    def from_jax(self, t: torch.Tensor) -> torch.Tensor:
        """The inverse of :meth:`to_jax`."""
        if self.transpose and t.dim() >= 2:
            return t.transpose(-1, -2)
        if self.perm is not None:
            return t.permute(_TO_OIHW)
        return t

    def port_dim(self, jax_dim: int) -> int:
        """The parameter's dimension that is dimension ``jax_dim`` of its
        JAX leaf."""
        if self.transpose and jax_dim >= self.lead:
            return 2 * self.lead + 1 - jax_dim
        return self.perm[jax_dim] if self.perm is not None else jax_dim


def jax_param_slots(model):
    """The JAX param tree of ``model`` with a :class:`ParamSlot` at each
    leaf: the map between the port's parameter list (the order of
    optimizer states) and the JAX package's param paths."""
    index = {id(p): i for i, p in enumerate(model.parameters())}
    lead = 1 if getattr(model, "n_stacked", None) is not None else 0
    return _jax_tree(model, lambda p, transpose, perm: ParamSlot(
        index[id(p)], transpose, perm, lead))


def spec_placements(spec, slot: ParamSlot, mesh_axes) -> tuple:
    """The DTensor placements of the parameter at ``slot`` over a mesh
    whose dimensions are named ``mesh_axes``, from the JAX
    ``PartitionSpec`` ``spec`` of its JAX leaf: a mesh axis that the
    spec names on JAX dimension j shards the parameter's dimension
    ``slot.port_dim(j)`` (a Linear W's dimensions swap: JAX ``qkv.w``
    ``P(None, "tp")`` on (D, 3D) is ``Shard(0)`` of the (3D, D)
    ``weight``); every other mesh axis replicates. The one map from the
    JAX package's layouts onto the port's parameters: the tensor and
    FSDP layouts place parameters and optimizer states by it. A spec
    axis the mesh lacks raises ``ValueError``."""
    from torch.distributed.tensor import Replicate, Shard
    placements = [Replicate() for _ in mesh_axes]
    for jax_dim, axis in enumerate(tuple(spec)):
        if axis is None:
            continue
        for name in (axis if isinstance(axis, tuple) else (axis,)):
            if name not in mesh_axes:
                raise ValueError(f"spec {tuple(spec)} names axis {name!r}, "
                                 f"not one of the mesh's {tuple(mesh_axes)}")
            placements[mesh_axes.index(name)] = Shard(slot.port_dim(jax_dim))
    return tuple(placements)


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
