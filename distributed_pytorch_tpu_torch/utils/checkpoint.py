"""Checkpoint / resume: the single-file path (format 1).

Counterpart of ``distributed_pytorch_tpu/utils/checkpoint.py`` on the
same on-disk format, so each package restores what the other wrote:

* A checkpoint is a directory ``step_<N>/`` holding one ``.npz`` of
  leaves per saved tree (``params``, ``opt_state``) plus
  ``manifest.json``. No pickle anywhere.
* The trees are written in the JAX layout. The params go under the JAX
  parameter paths (``blocks/0/attn/qkv/w``, Linear W as (in, out):
  ``convert.jax_param_slots``); the optimizer state goes as the JAX
  optimizer's state pytree (``AdamWState`` with its int32 step count and
  per-parameter moments under the same paths, the wrappers' states
  around it). bfloat16 leaves are stored as raw uint8 bytes with the
  dtype name and shape in the manifest, as the JAX package does.
* Writes are atomic: into ``step_<N>.tmp.<pid>``, then ``os.replace``;
  a re-save of a live step renames the old copy aside first, so a crash
  between the two renames still leaves one complete copy.
* Primary-only write, every-rank read; a barrier brackets save and
  restore.

``save_checkpoint(dir, step, model, opt_state)`` takes the model (an
``nn.Module`` the port's ``convert`` knows) and the state its
optimizer's ``init(model.parameters())`` returned; ``restore_checkpoint
(dir, like_params=model, like_opt_state=state)`` loads the params into
the model in place and returns a new state of the template's structure.
Without templates the trees come back as nested dicts and lists of CPU
tensors. ``restore_checkpoint`` dispatches on the manifest's format: a
sharded (format 2) checkpoint of ``ckpt/`` restores through the
resharding reader (``ckpt/reader.py``).
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ckpt.errors import CkptError, CkptIncomplete, CkptShapeMismatch
from ..optim import AdafactorState, Q8LogMoment, Q8Moment, q8_base
from ..optim.sharded.optimizer import ShardedOptState
from ..runtime import context
from .logging import append_event, is_primary

_STEP_DIR_RE = re.compile(r"^step_(\d+)$")
_OLD_DIR_RE = re.compile(r"^step_(\d+)\.old\.\d+$")
_TMP_DIR_RE = re.compile(r"^step_(\d+)\.tmp\.\d+$")
_MANIFEST = "manifest.json"


# ---------------------------------------------------------------------------
# Trees <-> flat leaves, in jax.tree_util's order
# ---------------------------------------------------------------------------

def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def _children(node):
    """``(key, is_sequence_index, child)`` of an internal node in the
    order ``jax.tree_util`` flattens it (dict keys sorted, NamedTuple
    fields by name, lists and tuples by index), or None for a leaf.
    ``None`` is an empty node, as in JAX."""
    if isinstance(node, dict):
        return [(str(k), False, node[k]) for k in sorted(node)]
    if _is_namedtuple(node):
        return [(f, False, getattr(node, f)) for f in node._fields]
    if isinstance(node, (list, tuple)):
        return [(str(i), True, v) for i, v in enumerate(node)]
    if node is None:
        return []
    return None


def _escape(part: str) -> str:
    return part.replace("\\", "\\\\").replace("/", "\\/")


def _split_escaped(key: str) -> List[str]:
    """Split on unescaped '/' only, keeping components escaped."""
    parts, cur, i = [], [], 0
    while i < len(key):
        c = key[i]
        if c == "\\" and i + 1 < len(key):
            cur.append(c)
            cur.append(key[i + 1])
            i += 2
        elif c == "/":
            parts.append("".join(cur))
            cur = []
            i += 1
        else:
            cur.append(c)
            i += 1
    parts.append("".join(cur))
    return parts


def _unescape(part: str) -> str:
    out, i = [], 0
    while i < len(part):
        if part[i] == "\\" and i + 1 < len(part):
            out.append(part[i + 1])
            i += 2
        else:
            out.append(part[i])
            i += 1
    return "".join(out)


def _flatten(tree) -> Tuple[List[str], List[Any], List[str]]:
    """Leaf key paths ('/'-joined, components escaped), the leaves, and
    the sorted internal-node paths that are sequences (so a
    template-free restore can tell a list from a digit-keyed dict)."""
    keys, leaves, seq = [], [], set()

    def walk(node, esc: List[str]):
        kids = _children(node)
        if kids is None:
            keys.append("/".join(esc))
            leaves.append(node)
            return
        for key, is_seq, child in kids:
            if is_seq:
                seq.add("/".join(esc))
            walk(child, esc + [_escape(key)])

    walk(tree, [])
    return keys, leaves, sorted(seq)


def _map_with_keys(tree, fn, esc: Tuple[str, ...] = (), is_leaf=None):
    """``tree`` with every leaf (and every subtree ``is_leaf`` accepts)
    replaced by ``fn(key, leaf)``."""
    kids = None if is_leaf is not None and is_leaf(tree) else \
        _children(tree)
    if kids is None:
        return fn("/".join(esc), tree)
    if tree is None:
        return None
    out = [_map_with_keys(child, fn, esc + (_escape(k),), is_leaf)
           for k, _, child in kids]
    if isinstance(tree, dict):
        return {k: v for (k, _, _), v in zip(kids, out)}
    if _is_namedtuple(tree):
        return type(tree)(*out)
    return type(tree)(out)


def _to_numpy(leaf) -> Tuple[np.ndarray, Optional[str], Optional[list]]:
    """A leaf as the array ``np.savez`` stores, with the dtype name and
    shape when it goes as raw bytes (bfloat16: numpy has no such dtype;
    the JAX package stores its ml_dtypes leaves the same way)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            raw = t.reshape(-1).view(torch.uint8).numpy()
            return raw, "bfloat16", list(t.shape)
        return t.numpy(), None, None
    return np.asarray(leaf), None, None


def _save_tree(path: str, tree) -> Dict[str, Any]:
    """Save one tree's leaves to ``path`` (.npz); returns the leaf
    metadata of the manifest."""
    keys, leaves, seq_prefixes = _flatten(tree)
    out, dtypes, shapes = {}, [], []
    for i, leaf in enumerate(leaves):
        arr, dtype, shape = _to_numpy(leaf)
        out[f"leaf_{i}"] = arr
        dtypes.append(dtype)
        shapes.append(shape)
    np.savez(path, **out)
    return {"keys": keys, "count": len(leaves), "raw_dtypes": dtypes,
            "raw_shapes": shapes, "seq_prefixes": seq_prefixes}


def _raw_dtype(name: str, step: int) -> torch.dtype:
    dtype = getattr(torch, name, None)
    if not isinstance(dtype, torch.dtype):
        raise CkptError(f"step {step}: raw leaf dtype {name!r} has no "
                        "torch counterpart", step=step)
    return dtype


def _load_leaves(path: str, meta: Dict[str, Any],
                 step: int = -1) -> List[torch.Tensor]:
    """The leaves of one tree file as CPU tensors (raw-byte leaves
    rebuilt through ``torch.frombuffer(...).view(dtype)``)."""
    n = meta["count"]
    dtypes = meta.get("raw_dtypes") or [None] * n
    shapes = meta.get("raw_shapes") or [None] * n
    if not os.path.exists(path):
        raise CkptIncomplete(f"step {step}: tree file {path!r} is missing",
                             step=step, shard=os.path.basename(path))
    leaves = []
    with np.load(path) as z:
        for i in range(n):
            member = f"leaf_{i}"
            if member not in z.files:
                raise CkptIncomplete(
                    f"step {step}: {path!r} has no member {member}",
                    step=step, shard=f"{os.path.basename(path)}:{member}")
            a = z[member]
            if dtypes[i] is not None:
                t = torch.frombuffer(bytearray(a.tobytes()),
                                     dtype=torch.uint8)
                leaves.append(t.view(_raw_dtype(dtypes[i], step))
                              .reshape(shapes[i]))
            else:
                leaves.append(torch.from_numpy(np.array(a)))
    return leaves


def _nest(keys: Sequence[str], leaves: Sequence[Any],
          seq_prefixes: Sequence[str]):
    """Rebuild nested dicts and lists from key paths (template-free
    restore); a single unnamed leaf restores as the bare leaf."""
    if len(keys) == 1 and keys[0] == "":
        return leaves[0]
    seq = set(seq_prefixes)
    root: Dict[str, Any] = {}
    for key, leaf in zip(keys, leaves):
        node = root
        parts = _split_escaped(key)
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = leaf
    return _listify(root, "", seq)


def _listify(node, prefix: str, seq: set):
    """Turn the dict nodes recorded in ``seq`` into lists (escaped-prefix
    addressing), unescaping dict keys."""
    if not isinstance(node, dict):
        return node
    if prefix in seq:
        idxs = sorted(int(k) for k in node)
        return [_listify(node[str(i)],
                         f"{prefix}/{i}" if prefix else str(i), seq)
                for i in idxs]
    return {_unescape(k): _listify(v, f"{prefix}/{k}" if prefix else k, seq)
            for k, v in node.items()}


# ---------------------------------------------------------------------------
# The port's model and optimizer state <-> the JAX layout
# ---------------------------------------------------------------------------

def _host_copy(t: torch.Tensor) -> torch.Tensor:
    """A fresh contiguous CPU copy (never a view of ``t``: the port
    updates parameters in place, so a snapshot must not alias them)."""
    out = torch.empty(t.shape, dtype=t.dtype)
    out.copy_(t.detach())
    return out


def _slots(model) -> Tuple[Any, List[Tuple[str, Any]]]:
    from ..convert import jax_param_slots
    tree = jax_param_slots(model)
    keys, slots, _ = _flatten(tree)
    return tree, list(zip(keys, slots))


def _meta(t: torch.Tensor) -> torch.Tensor:
    """A storage-less stand-in of ``t`` (a restore's template needs only
    the keys, shapes and dtypes)."""
    return torch.empty(t.shape, dtype=t.dtype, device="meta")


def jax_params(model, leaf=_host_copy) -> Any:
    """``model``'s parameters as the JAX param tree of fresh CPU tensors
    in their own dtype (bfloat16 stays bfloat16); ``leaf`` makes each
    tensor from its JAX-layout view."""
    params = list(model.parameters())
    tree, _ = _slots(model)
    return _map_with_keys(tree, lambda _, s: leaf(s.to_jax(params[s.index])))


def _per_param(xs, n: int) -> bool:
    return (isinstance(xs, list) and len(xs) == n and n > 0
            and all(isinstance(x, torch.Tensor) for x in xs))


def _per_param_q8(xs, n: int) -> bool:
    """A per-parameter list of ``adamw_8bit``'s int8 moments."""
    return (isinstance(xs, list) and len(xs) == n and n > 0
            and all(isinstance(x, (Q8Moment, Q8LogMoment)) for x in xs))


def _q8_check_order(node, slot, key: str) -> None:
    """Refuse an ``adamw_8bit`` node whose blocks do not run over the
    JAX layout of its parameter: its codes and scales would be read with
    another block's scale by the other side."""
    nd = node.q.dim()
    if slot.transpose and nd >= 2:
        want = tuple(range(nd - 2)) + (nd - 1, nd - 2)
    else:
        want = slot.perm
    if node.perm != want:
        raise CkptError(
            f"adamw_8bit moment {key!r} is blocked over the order "
            f"{node.perm}, not its JAX layout's {want}: its parameter "
            "lost its layout mark (optim.jax_perm) before optimizer.init",
            rank=context.get_rank(), shard=f"opt_state.npz:{key}")


def jax_opt_state(state, model, leaf=_host_copy) -> Any:
    """The port optimizer ``state`` of ``model`` (what
    ``optimizer.init(model.parameters())`` returned) as the JAX
    optimizer's state pytree of fresh CPU tensors: int step counts as
    int32 scalars, every per-parameter list as a JAX param tree.
    Adafactor's moments are lists in the JAX param tree's leaf order, as
    the JAX adafactor keeps them, and the factored moments of a Linear W
    swap (its rows are the JAX kernel's columns). ``adamw_8bit``'s
    per-parameter int8 moments become the JAX package's ``Q8Moment`` /
    ``Q8LogMoment`` trees keyed like the parameters: each node's codes in
    the JAX layout, its block scales (and the log moment's midpoints)
    as they are. The port blocks each moment over its parameter's JAX
    layout (``optim.jax_perm``), so codes and scales mean there what
    they mean here; a node blocked in another order raises
    ``CkptError``. ``leaf`` makes each tensor from its JAX-layout
    view."""
    tree, slot_list = _slots(model)
    n = len(list(model.parameters()))

    def per_param(xs):
        return _map_with_keys(tree, lambda _, s: leaf(s.to_jax(xs[s.index])))

    def q8_node(key, x, s):
        _q8_check_order(x, s, key)
        return q8_base(x)(leaf(s.to_jax(x.q)), *[leaf(v) for v in x[1:]])

    def leaf_list(xs, swapped):
        return [leaf(s.to_jax((swapped if s.transpose else xs)[s.index]))
                for _, s in slot_list]

    def flat(node):
        """The sharded update's state over its flat slice: the wrapped
        optimizer's one-tensor lists are the JAX state's bare leaves."""
        if isinstance(node, list) and len(node) == 1 and isinstance(
                node[0], torch.Tensor):
            return leaf(node[0])
        if _is_namedtuple(node):
            return type(node)(*[flat(v) for v in node])
        return conv(node)

    def conv(node):
        if isinstance(node, ShardedOptState):
            if context.get_world_size() > 1:
                raise CkptError(
                    "the sharded update's state is this rank's slice of "
                    "the flat bucket, not laid out on the mesh; "
                    "checkpoint it at world 1", rank=context.get_rank())
            return ShardedOptState(inner=flat(node.inner),
                                   master=leaf(node.master))
        if isinstance(node, AdafactorState):
            return AdafactorState(step=conv(node.step),
                                  vr=leaf_list(node.vr, node.vc),
                                  vc=leaf_list(node.vc, node.vr),
                                  v=leaf_list(node.v, node.v))
        if isinstance(node, torch.Tensor):
            return leaf(node)
        if isinstance(node, (int, np.integer)) and not isinstance(node,
                                                                  bool):
            return np.asarray(node, np.int32)
        if node is None:
            return None
        if _per_param(node, n):
            return per_param(node)
        if _per_param_q8(node, n):
            return _map_with_keys(tree, lambda k, s: q8_node(k, node[s.index],
                                                             s))
        if _is_namedtuple(node):
            return type(node)(*[conv(v) for v in node])
        if isinstance(node, (list, tuple)):
            return type(node)(conv(v) for v in node)
        raise CkptError(f"optimizer state leaf {type(node).__name__} has "
                        "no JAX layout", rank=context.get_rank())

    return conv(state)


def _port_opt_state(jtree, like, model):
    """The inverse of :func:`jax_opt_state`: ``jtree`` (the JAX-layout
    tree, leaves CPU tensors) as a port state of ``like``'s structure,
    every tensor on its template's device and dtype."""
    params = list(model.parameters())
    n = len(params)
    _, slot_list = _slots(model)

    def get(tree, key):
        for part in _split_escaped(key):
            tree = tree[_unescape(part)] if isinstance(tree, dict) \
                else tree[int(part)] if isinstance(tree, list) \
                else getattr(tree, _unescape(part))
        return tree

    def place(t, ref, key):
        if tuple(t.shape) != tuple(ref.shape):
            raise CkptShapeMismatch(
                f"optimizer state leaf {key!r} is {tuple(t.shape)}, "
                f"the template's {tuple(ref.shape)}",
                rank=context.get_rank(), shard=f"opt_state.npz:{key}")
        return t.to(device=ref.device, dtype=ref.dtype,
                    copy=True).contiguous()

    def per_param(jt, like_xs):
        out = [None] * n
        for key, s in slot_list:
            out[s.index] = place(s.from_jax(get(jt, key)),
                                 like_xs[s.index], key)
        return out

    def leaf_list(jl, swapped, like_xs):
        out = [None] * n
        for i, (key, s) in enumerate(slot_list):
            src = swapped if s.transpose else jl
            out[s.index] = place(s.from_jax(src[i]), like_xs[s.index], key)
        return out

    def per_param_q8(jt, like_xs):
        out = [None] * n
        for key, s in slot_list:
            node, ref = get(jt, key), like_xs[s.index]
            _q8_check_order(ref, s, key)
            out[s.index] = type(ref)(
                place(s.from_jax(node.q), ref.q, f"{key}/q"),
                *[place(getattr(node, f), getattr(ref, f), f"{key}/{f}")
                  for f in ref._fields[1:]])
        return out

    def conv(jt, lk):
        if isinstance(lk, AdafactorState):
            return AdafactorState(step=conv(jt.step, lk.step),
                                  vr=leaf_list(jt.vr, jt.vc, lk.vr),
                                  vc=leaf_list(jt.vc, jt.vr, lk.vc),
                                  v=leaf_list(jt.v, jt.v, lk.v))
        if isinstance(lk, int) and not isinstance(lk, bool):
            return int(jt)
        if isinstance(lk, torch.Tensor):
            return jt.to(device=lk.device, dtype=lk.dtype, copy=True)
        if _per_param(lk, n):
            return per_param(jt, lk)
        if _per_param_q8(lk, n):
            return per_param_q8(jt, lk)
        if _is_namedtuple(lk):
            return type(lk)(*[conv(getattr(jt, f), getattr(lk, f))
                              for f in lk._fields])
        return type(lk)(conv(j, x) for j, x in zip(jt, lk))

    return conv(jtree, like)


def _with_restored_scalars(like, jtree):
    """``like`` (a port optimizer state whose tensors were restored in
    place) with each non-tensor leaf (a step count) taken from
    ``jtree``, its JAX-layout tree."""
    def conv(jt, lk):
        if isinstance(lk, int) and not isinstance(lk, bool):
            return int(np.asarray(jt))
        if isinstance(lk, (torch.Tensor, list)) or lk is None:
            return lk
        if isinstance(lk, AdafactorState):
            return lk._replace(step=conv(jt.step, lk.step))
        if _is_namedtuple(lk):
            return type(lk)(*[conv(getattr(jt, f), getattr(lk, f))
                              for f in lk._fields])
        if isinstance(lk, tuple):
            return type(lk)(conv(j, x) for j, x in zip(jt, lk))
        return lk

    return conv(jtree, like)


def _as_tree(params, opt_state):
    """(params tree, opt_state tree) in the JAX layout: a model goes
    through :func:`jax_params` and its optimizer state through
    :func:`jax_opt_state`; plain trees pass as they are."""
    if isinstance(params, torch.nn.Module):
        opt = (jax_opt_state(opt_state, params)
               if opt_state is not None else None)
        return jax_params(params), opt
    return params, opt_state


# ---------------------------------------------------------------------------
# Directory layout / discovery
# ---------------------------------------------------------------------------

def _step_dir(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"step_{step}")


def _is_complete(ckpt_dir: str, name: str) -> bool:
    return os.path.exists(os.path.join(ckpt_dir, name, _MANIFEST))


def _resolve_step_dir(ckpt_dir: str, step: int) -> Optional[str]:
    """Directory holding a complete checkpoint for ``step``, or None:
    ``step_<N>``, else the newest complete ``step_<N>.old.<pid>`` (left
    by a re-save that crashed between its two renames)."""
    if _is_complete(ckpt_dir, f"step_{step}"):
        return _step_dir(ckpt_dir, step)
    if not os.path.isdir(ckpt_dir):
        return None
    candidates = []
    for name in os.listdir(ckpt_dir):
        m = _OLD_DIR_RE.match(name)
        if m and int(m.group(1)) == step and _is_complete(ckpt_dir, name):
            candidates.append(name)
    if not candidates:
        return None
    best = max(candidates, key=lambda n: os.path.getmtime(
        os.path.join(ckpt_dir, n, _MANIFEST)))
    return os.path.join(ckpt_dir, best)


def available_steps(ckpt_dir: str) -> List[int]:
    """Steps with a complete (manifest-bearing) checkpoint, ascending,
    including steps whose only complete copy is a crash-window ``.old``
    directory."""
    if not os.path.isdir(ckpt_dir):
        return []
    steps = set()
    for name in os.listdir(ckpt_dir):
        m = _STEP_DIR_RE.match(name) or _OLD_DIR_RE.match(name)
        if m and _is_complete(ckpt_dir, name):
            steps.add(int(m.group(1)))
    return sorted(steps)


def _sweep_stale(ckpt_dir: str, keep_old_for: Optional[int] = None) -> None:
    """Remove leftover ``.tmp``/``.old`` dirs of crashed saves. An
    ``.old`` dir stays when it is the only complete copy of its step or
    belongs to ``keep_old_for`` (the step being re-saved); ``.tmp`` dirs
    are never trusted."""
    if not os.path.isdir(ckpt_dir):
        return
    for name in os.listdir(ckpt_dir):
        p = os.path.join(ckpt_dir, name)
        if _TMP_DIR_RE.match(name):
            shutil.rmtree(p, ignore_errors=True)
            continue
        m = _OLD_DIR_RE.match(name)
        if m:
            s = int(m.group(1))
            if s != keep_old_for and _is_complete(ckpt_dir, f"step_{s}"):
                shutil.rmtree(p, ignore_errors=True)


def latest_step(ckpt_dir: str) -> Optional[int]:
    """Most recent checkpointed step, or None."""
    steps = available_steps(ckpt_dir)
    return steps[-1] if steps else None


def _remove_step(ckpt_dir: str, step: int) -> None:
    """Remove every on-disk form of ``step`` (live, .old, .tmp)."""
    shutil.rmtree(_step_dir(ckpt_dir, step), ignore_errors=True)
    for name in os.listdir(ckpt_dir):
        m = _OLD_DIR_RE.match(name) or _TMP_DIR_RE.match(name)
        if m and int(m.group(1)) == step:
            shutil.rmtree(os.path.join(ckpt_dir, name), ignore_errors=True)


def _supersede_old_forms(ckpt_dir: str, step: int) -> None:
    """After a commit of ``step_<step>``, drop every stale ``.old`` or
    ``.tmp`` form of the same step (a later crash window would otherwise
    leave two ``.old`` candidates to choose between)."""
    if not _is_complete(ckpt_dir, f"step_{step}"):
        return
    for name in os.listdir(ckpt_dir):
        m = _OLD_DIR_RE.match(name) or _TMP_DIR_RE.match(name)
        if m and int(m.group(1)) == step:
            shutil.rmtree(os.path.join(ckpt_dir, name), ignore_errors=True)


def _apply_retention(ckpt_dir: str, step: int, keep: int) -> None:
    """Evict all but the newest ``keep`` steps, never any form of
    ``step`` (the copy just committed, which a forced off-interval save
    may sort below the newest ``keep``)."""
    for old in available_steps(ckpt_dir)[:-keep]:
        if old != step:
            _remove_step(ckpt_dir, old)


# ---------------------------------------------------------------------------
# Save / restore
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Checkpoint:
    step: int
    params: Any
    opt_state: Any = None
    extra: Optional[Dict[str, Any]] = None


def _write_full(tmp: str, step: int, params, opt_state,
                extra: Optional[Dict[str, Any]]) -> int:
    """Write the format-1 payload and manifest of JAX-layout trees into
    ``tmp`` (file IO only: safe on a background thread). Returns the
    bytes written."""
    manifest: Dict[str, Any] = {"step": step, "format": 1,
                                "extra": extra or {}, "trees": {}}
    manifest["trees"]["params"] = _save_tree(
        os.path.join(tmp, "params.npz"), params)
    if opt_state is not None:
        manifest["trees"]["opt_state"] = _save_tree(
            os.path.join(tmp, "opt_state.npz"), opt_state)
    with open(os.path.join(tmp, _MANIFEST), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    return sum(os.path.getsize(os.path.join(tmp, n))
               for n in os.listdir(tmp))


def _commit_full(ckpt_dir: str, step: int, tmp: str,
                 keep: Optional[int] = None, rank: int = 0) -> str:
    """Atomically promote a fully written ``tmp`` dir to ``step_<step>``:
    a live copy is renamed aside first, so a crash between the two
    renames leaves it discoverable as ``.old``. Fires the ``DPX_FAULT``
    ops ``ckpt_commit`` at entry and ``ckpt_commit_window`` just before
    the rename that lands ``tmp`` (``runtime/faults.py``)."""
    from ..runtime import faults

    faults.on_comm_op("ckpt_commit", rank=rank)
    final = _step_dir(ckpt_dir, step)
    if os.path.exists(final):
        aside = final + f".old.{os.getpid()}"
        if os.path.exists(aside):
            shutil.rmtree(aside)
        os.replace(final, aside)
        # the crash window: only the .old copy is complete here
        faults.on_comm_op("ckpt_commit_window", rank=rank)
        os.replace(tmp, final)
        shutil.rmtree(aside, ignore_errors=True)
    else:
        faults.on_comm_op("ckpt_commit_window", rank=rank)
        os.replace(tmp, final)
    _supersede_old_forms(ckpt_dir, step)
    if keep is not None:
        _apply_retention(ckpt_dir, step, keep)
    return final


def save_checkpoint(ckpt_dir: str, step: int, params,
                    opt_state=None, extra: Optional[Dict[str, Any]] = None,
                    keep: Optional[int] = None) -> str:
    """Atomically write ``step_<step>/`` under ``ckpt_dir``.

    ``params``: the model (its optimizer ``opt_state`` mapped to the JAX
    layout through it) or a JAX-layout tree. Primary-only under a
    process group (other ranks no-op); a barrier on both sides makes the
    checkpoint visible to every rank before anyone proceeds. ``extra``
    must be JSON-serializable; ``keep`` retains the newest ``keep``
    checkpoints after the save."""
    from ..comm.collectives import barrier
    from ..runtime import faults

    if keep is not None and keep < 1:
        raise ValueError(f"keep must be >= 1, got {keep}")
    final = _step_dir(ckpt_dir, step)
    try:
        if is_primary():
            faults.on_comm_op("ckpt", rank=context.get_rank())
            json.dumps(extra or {})     # reject before touching a file
            t0 = time.perf_counter()
            p_tree, o_tree = _as_tree(params, opt_state)
            os.makedirs(ckpt_dir, exist_ok=True)
            _sweep_stale(ckpt_dir, keep_old_for=step)
            tmp = final + f".tmp.{os.getpid()}"
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
            nbytes = _write_full(tmp, step, p_tree, o_tree, extra)
            _commit_full(ckpt_dir, step, tmp, keep=keep,
                         rank=context.get_rank())
            append_event("ckpt_save", step=step, rank=context.get_rank(),
                         world=context.get_world_size(), sharded=False,
                         async_save=False, bytes=nbytes, shards=1,
                         io_s=round(time.perf_counter() - t0, 6))
    finally:
        # the other ranks must not hang when the primary's write raises
        barrier()
    return final


def _load_manifest(step_dir: str, step: int) -> Dict[str, Any]:
    """Read and check a manifest: absent or unparseable is
    :class:`CkptIncomplete`, an unknown format :class:`CkptError`."""
    rank = context.get_rank()
    path = os.path.join(step_dir, _MANIFEST)
    if not os.path.exists(path):
        raise CkptIncomplete(
            f"no manifest under {step_dir!r} (incomplete checkpoint)",
            step=step, rank=rank)
    try:
        with open(path) as f:
            manifest = json.load(f)
    except (json.JSONDecodeError, UnicodeDecodeError) as e:
        raise CkptIncomplete(
            f"step {step}: manifest at {path!r} is truncated/unparseable "
            f"({e})", step=step, rank=rank) from e
    fmt = manifest.get("format")
    if fmt not in (1, 2):
        raise CkptError(f"step {step}: unknown manifest format {fmt!r}",
                        step=step, rank=rank)
    return manifest


def _restore_tree(d: str, manifest, name: str, like, step: int):
    """One stored tree: in the template's structure when ``like`` is a
    JAX-layout tree (its keys must be the stored keys), else rebuilt
    from the stored key paths."""
    meta = manifest["trees"].get(name)
    if meta is None:
        return None
    leaves = _load_leaves(os.path.join(d, f"{name}.npz"), meta, step)
    if like is None:
        return _nest(meta["keys"], leaves, meta.get("seq_prefixes") or [])
    keys, like_leaves, _ = _flatten(like)
    if len(keys) != len(leaves):
        raise CkptShapeMismatch(
            f"checkpoint tree {name!r} has {len(leaves)} leaves but "
            f"template has {len(keys)}", step=step,
            rank=context.get_rank())
    stored = dict(zip(meta["keys"], leaves))
    missing = sorted(set(keys) - set(stored))
    if missing:
        raise CkptShapeMismatch(
            f"checkpoint tree {name!r} lacks the template's leaves "
            f"{missing[:5]}", step=step, rank=context.get_rank())
    for key, ref in zip(keys, like_leaves):
        got, want = tuple(stored[key].shape), tuple(np.shape(ref)) \
            if not isinstance(ref, torch.Tensor) else tuple(ref.shape)
        if got != want:
            raise CkptShapeMismatch(
                f"checkpoint leaf {name}/{key} is {got}, the template's "
                f"{want}", step=step,
                rank=context.get_rank(), shard=f"{name}.npz:{key}")
    return _map_with_keys(like, lambda key, _: stored[key])


def restore_checkpoint(ckpt_dir: str, step: Optional[int] = None,
                       like_params=None, like_opt_state=None,
                       target=None) -> Checkpoint:
    """Read ``step_<step>/`` (default: the latest).

    ``like_params``: the model, whose parameters are loaded in place
    (each cast to its own dtype and device; ``Checkpoint.params`` is the
    model), or a JAX-layout tree. ``like_opt_state``: with a model, the
    port state its optimizer made, returned restored as a new state of
    the same structure; else a tree of the stored layout. Without
    templates the trees come back as nested dicts and lists of CPU
    tensors. A sharded (format 2) checkpoint restores through
    ``ckpt.reader.restore_dir``: into a module, each parameter and state
    tensor receives the region it holds (a ZeRO-3 shard, or the whole
    leaf); ``target`` (a ``ckpt.reader.Target``) opts a template-free
    restore into this rank's slices. Raises ``FileNotFoundError`` when
    nothing is checkpointed and the typed :mod:`..ckpt.errors` when what
    is there cannot be trusted.
    A closing barrier keeps a fast rank from deleting, by a later
    save's retention, a step a slower rank still reads."""
    from ..comm.collectives import barrier

    try:
        if step is None:
            step = latest_step(ckpt_dir)
            if step is None:
                raise FileNotFoundError(f"no checkpoints under {ckpt_dir!r}")
        d = _resolve_step_dir(ckpt_dir, step)
        if d is None:
            raise FileNotFoundError(
                f"no complete checkpoint for step {step} under {ckpt_dir!r}")
        manifest = _load_manifest(d, step)
        if manifest.get("format") == 2:
            from ..ckpt import reader as _reader
            return _reader.restore_dir(
                d, manifest, like_params=like_params,
                like_opt_state=like_opt_state, target=target,
                rank=context.get_rank())
        if target is not None:
            raise ValueError(
                "target= (slice restore) needs a sharded (format 2) "
                f"checkpoint; step {step} is format 1")
        model = like_params if isinstance(like_params,
                                          torch.nn.Module) else None
        p_like = (jax_params(model, _meta) if model is not None
                  else like_params)
        o_like = like_opt_state
        if like_opt_state is not None and model is not None:
            o_like = jax_opt_state(like_opt_state, model, _meta)
        params = _restore_tree(d, manifest, "params", p_like, step)
        opt = _restore_tree(d, manifest, "opt_state", o_like, step)
        if model is not None:
            _load_into(model, params)
            params = model
            if opt is not None and like_opt_state is not None:
                opt = _port_opt_state(opt, like_opt_state, model)
        ck = Checkpoint(step=manifest["step"], params=params, opt_state=opt,
                        extra=manifest.get("extra") or {})
        append_event("ckpt_restore", step=ck.step, rank=context.get_rank(),
                     sharded=False)
        return ck
    finally:
        barrier()


@torch.no_grad()
def _load_into(model, tree) -> None:
    """Copy a JAX-layout param tree of tensors into ``model`` in place."""
    params = list(model.parameters())
    _, slot_list = _slots(model)
    keys, leaves, _ = _flatten(tree)
    by_key = dict(zip(keys, leaves))
    for key, s in slot_list:
        p = params[s.index]
        p.copy_(s.from_jax(by_key[key]).to(device=p.device, dtype=p.dtype))


# the manager lives in ckpt/manager.py; re-exported so that this module
# is the one checkpoint door an application needs, as in the JAX package
from ..ckpt.errors import (CkptCorrupt, CkptError,  # noqa: E402,F401
                           CkptIncomplete, CkptShapeMismatch)
from ..ckpt.manager import CheckpointManager  # noqa: E402,F401
