"""One front door for every train step: ``make_step``.

Counterpart of ``distributed_pytorch_tpu/parallel/front_door.py``. Every
data-parallel train step of the port is built here, and the historical
builders (``data_parallel.make_train_step``,
``fsdp.make_fsdp_train_step`` / ``make_zero1_train_step`` /
``make_zero2_train_step``, ``spmd.make_spmd_train_step``,
``optim.sharded.spmd.make_spmd_sharded_train_step``) are shims over it.
Parallelism is a spec choice, resolved to the engine that runs it::

    specs=None          pure DP: replicated parameters, the batch split
                        over "dp", per-rank (1,) losses (the DDP step of
                        data_parallel.py, every wire mode)
    specs=FROM_INPUTS   the layout carried by the inputs: parameters the
                        caller placed as DTensors, the batch a DTensor
                        sharded over "dp" (and over "sp" along the
                        sequence); one global scalar loss
    specs=StepSpecs(..) the constraint ladder: ZeRO-3/2/1 (and tp under
                        ZeRO-3) from the spec trees (fsdp.py's engines)
    weight_update=      ZeRO-1 on the flat bucket (optim/sharded/)
      "sharded"

The host door (a native host group is live) dispatches to its engines
unchanged (``data_parallel._make_host_train_step``,
``optim/sharded/host.py``), uncached, with no sharding contract.

There is no compiled program: a "program" here is an engine the builder
made. What the JAX package's contracts pin becomes:

* **the builder cache**: a bounded LRU (:data:`_CACHE_MAX`) keyed on
  the JAX package's tuple (the loss, the optimizer, the mesh's dimension
  names, shape and ranks, the world, the spec trees, the wire, the
  weight update, the bf16 policy, the remat policy, ``donate``,
  ``pad_multiple``): an identical request returns the same
  :class:`FrontDoorStep`, its counts unchanged;
* **trace counts**: ``step.trace_counts`` counts, per program key (the
  wire width under ``adaptive``; one key otherwise), the first call that
  ran it; ``step.compiles`` is their sum;
* **donation**: ``donate`` (``None`` reads ``DPX_DONATE``) is part of
  the key and recorded on ``step.donated``. Every engine updates the
  parameters and the optimizer state in place, which is what donation
  buys XLA; ``donate=False`` builds the same in-place step;
* **the reshard-free handoff**: a *sharding* is a :class:`Sharding`,
  a ``(DeviceMesh, placements)`` pair; a tree of them is a dict keyed by
  parameter name. ``step.out_shardings["params"]`` is what the step's
  parameters carry after it, equal to ``in_shardings["params"]`` (the
  update is in place). :func:`verify_handoff` asserts that a module (or
  a dict of tensors) already carries them, never moving a byte (no
  ``redistribute``, no ``full_tensor``); :func:`make_eval_step` and the
  serving engine's ``EngineConfig(param_shardings=)`` run that check.
  Without a torch.distributed group (world 1) and on the host door there
  is no sharding contract: the shardings are ``None`` and every check
  passes.
"""

from __future__ import annotations

import collections
import contextlib
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch
from torch import nn

from ..obs import metrics as _dpxmon
from ..optim import Optimizer
from ..runtime import context
from ..runtime import env as _env
from ..runtime.context import DATA_AXIS
from .data_parallel import (GRAD_REDUCE_MODES, MP_POLICIES,
                            forward_backward)

#: weight_update spellings accepted by :func:`make_step`.
WEIGHT_UPDATES = ("replicated", "sharded")


class _FromInputs:
    """Sentinel: the layout is carried by the inputs."""

    def __repr__(self):  # stable cache-key repr
        return "FROM_INPUTS"


FROM_INPUTS = _FromInputs()


class StepSpecs(NamedTuple):
    """The constraint-ladder spec trees (``None`` defaults follow the
    fsdp ladder: ``opt`` <- ``params``, ``grads`` <- ``opt``)."""

    params: Any
    opt: Any = None
    grads: Any = None


class Sharding(NamedTuple):
    """Where a tensor lives: a DTensor's mesh and placements; a plain
    tensor carries ``Replicate`` on every dimension of the mesh of its
    device type."""

    mesh: Any
    placements: Tuple[Any, ...]


class HandoffMismatch(ValueError):
    """A handoff would have resharded: the tree does not already carry
    the expected shardings. Raised instead of copying — train -> eval ->
    serve-admit moves no bytes."""

    def __init__(self, what: str, path: str, got, want):
        self.what, self.path, self.got, self.want = what, path, got, want
        super().__init__(
            f"reshard-free handoff violated for {what}: leaf {path!r} "
            f"carries sharding {got} but the consumer pins {want} — "
            f"place the producer's out_shardings on it (or fix the "
            f"producer) instead of letting it be silently copied")


class MemoryAnalysisUnavailable(KeyError):
    """A key of ``FrontDoorStep.memory_analysis`` the port cannot
    measure without running the step."""


# ---------------------------------------------------------------------------
# config + cache
# ---------------------------------------------------------------------------


def _mesh_key(mesh) -> Tuple:
    return (mesh.device_type, tuple(mesh.mesh_dim_names or ()),
            tuple(mesh.mesh.shape), tuple(mesh.mesh.flatten().tolist()))


def _spec_key(specs) -> str:
    # spec trees repr deterministically; a string key survives the
    # unhashable dicts and lists inside them
    return repr(specs)


#: Bounded LRU of built steps. An evicted step keeps working (its
#: callers own it); only a later identical request would rebuild.
_CACHE_MAX = 64
_CACHE: "collections.OrderedDict[Tuple, FrontDoorStep]" = \
    collections.OrderedDict()


def cache_clear() -> None:
    """Drop every cached step."""
    _CACHE.clear()


def cache_info() -> Dict[Tuple, "FrontDoorStep"]:
    return dict(_CACHE)


# ---------------------------------------------------------------------------
# the step object
# ---------------------------------------------------------------------------


class _MemoryAnalysis(dict):
    def __missing__(self, key):
        if key in ("temp", "peak_bytes"):
            raise MemoryAnalysisUnavailable(
                f"memory_analysis[{key!r}]: XLA reads it off the compiled "
                "program; the port has no compiled program, and a step's "
                "transient memory shows only by running it "
                "(torch.cuda.max_memory_allocated around a step)")
        raise KeyError(key)


def _tensor_bytes(tree) -> int:
    """Bytes of the (local) tensors of a module, a state or a batch."""
    from torch.distributed.tensor import DTensor
    total = 0

    def walk(node):
        nonlocal total
        if isinstance(node, DTensor):
            node = node.to_local()
        if isinstance(node, torch.Tensor):
            total += node.numel() * node.element_size()
        elif isinstance(node, nn.Module):
            for t in list(node.parameters()) + list(node.buffers()):
                walk(t)
        elif isinstance(node, dict):
            for v in node.values():
                walk(v)
        elif isinstance(node, (list, tuple)):
            for v in node:
                walk(v)

    walk(tree)
    return total


class FrontDoorStep:
    """A built train step: ``step(model, opt_state, batch)``.

    * ``trace_counts`` — program key -> engine builds (first calls);
      ``compiles`` is their sum.
    * ``in_shardings`` / ``out_shardings`` — dicts with ``params`` /
      ``opt`` / ``batch`` entries (``None`` with no sharding contract);
      params and opt equal in and out.
    * ``memory_analysis(model, opt_state, batch)`` — the JAX keys, each
      by its stated method.
    * ``donated``, ``config`` — what was built.
    * ``width_chooser`` — the adaptive wire's state machine (None
      otherwise); ``init_opt_state`` / ``state_specs`` on the sharded
      engine.
    """

    def __init__(self, config: Tuple, donated: bool):
        self.config = config
        self.donated = donated
        self.trace_counts: Dict[Any, int] = {}
        self.in_shardings: Optional[Dict[str, Any]] = None
        self.out_shardings: Optional[Dict[str, Any]] = None
        self.width_chooser = None
        self._call = None                      # bound by the builder

    @property
    def compiles(self) -> int:
        return sum(self.trace_counts.values())

    def _run(self, key, engine, *args):
        """Run ``engine`` as the program ``key``, counting its first
        call."""
        if key not in self.trace_counts:
            self.trace_counts[key] = 1
        return engine(*args)

    def memory_analysis(self, params, opt_state, batch) -> dict:
        """The JAX package's keys, by these methods: ``argument``, the
        bytes of every (local) tensor the step reads (the module's
        parameters and buffers, ``opt_state``, ``batch``), counted;
        ``output``, the bytes of what it returns (the same parameter and
        state tensors, plus the ``(1,)`` or scalar float32 loss);
        ``alias``, the bytes of outputs that are input tensors updated in
        place (every parameter and state byte: the update is in place,
        ``donate`` or not). ``temp`` and ``peak_bytes`` raise
        :class:`MemoryAnalysisUnavailable`: they need a compiled
        program."""
        state = _tensor_bytes(params) + _tensor_bytes(opt_state)
        out = _MemoryAnalysis()
        out["argument"] = state + _tensor_bytes(batch)
        out["output"] = state + 4
        out["alias"] = state
        return out

    def __call__(self, params, opt_state, batch):
        out = self._call(params, opt_state, batch)
        # dpxmon step hook (obs/metrics.py; one global read when off):
        # the mesh engines' per-call seam. The host door's builders
        # return their own step functions and hook themselves, so no
        # call is counted twice
        _dpxmon.on_train_step("front_door")
        return out


# ---------------------------------------------------------------------------
# handoff
# ---------------------------------------------------------------------------


def _replicated(mesh) -> Sharding:
    from torch.distributed.tensor import Replicate
    return Sharding(mesh, tuple(Replicate() for _ in range(mesh.ndim)))


def sharding_of(t: torch.Tensor, mesh=None) -> Optional[Sharding]:
    """What ``t`` carries: a DTensor's mesh and placements; for a plain
    tensor, ``Replicate`` on every dimension of ``mesh`` (None without
    one)."""
    from torch.distributed.tensor import DTensor
    if isinstance(t, DTensor):
        return Sharding(t.device_mesh, tuple(t.placements))
    return None if mesh is None else _replicated(mesh)


def _carries(t: torch.Tensor, want: Sharding) -> bool:
    from torch.distributed.tensor import DTensor
    if isinstance(t, DTensor):
        return (t.device_mesh == want.mesh
                and tuple(t.placements) == tuple(want.placements))
    return (all(p.is_replicate() for p in want.placements)
            and t.device.type == want.mesh.device_type)


def _describe(t: torch.Tensor) -> str:
    from torch.distributed.tensor import DTensor
    if isinstance(t, DTensor):
        return f"{tuple(t.placements)} on {t.device_mesh}"
    return f"a plain tensor on {t.device}"


def _named(tree) -> Dict[str, torch.Tensor]:
    if isinstance(tree, nn.Module):
        return dict(tree.named_parameters())
    if isinstance(tree, dict):
        return dict(tree)
    raise TypeError(f"verify_handoff takes a module or a dict of tensors, "
                    f"not {type(tree).__name__}")


def verify_handoff(tree, shardings, *, what: str = "params"):
    """Assert ``tree`` (a module's parameters, or a dict of tensors by
    name) already carries ``shardings``: one :class:`Sharding` for every
    leaf, or a dict of them by name. Returns ``tree`` unchanged; raises
    :class:`HandoffMismatch` naming the first leaf that differs. Nothing
    is moved or gathered. ``None`` skips the check (no sharding
    contract: world 1, the host door)."""
    if shardings is None:
        return tree
    named = _named(tree)
    if isinstance(shardings, Sharding):
        want = {name: shardings for name in named}
    else:
        want = dict(shardings)
        if list(want) != list(named):
            raise HandoffMismatch(what, "<structure>",
                                  f"{len(named)} leaves",
                                  f"{len(want)} shardings")
    for name, t in named.items():
        w = want[name]
        if not _carries(t, w):
            raise HandoffMismatch(what, name, _describe(t),
                                  f"{tuple(w.placements)} on {w.mesh}")
    return tree


def handoff_shardings(step) -> Optional[Any]:
    """The params out-shardings a downstream consumer (eval, serve
    admit) should pin. None when the step has no sharding contract."""
    out = getattr(step, "out_shardings", None)
    return out.get("params") if isinstance(out, dict) else None


def _group_mesh():
    """The mesh of the live torch.distributed group, or None (no group,
    or the host group: no sharding contract)."""
    if not context.is_initialized() or context.get_host_comm() is not None:
        return None
    return context.get_mesh()


def _dp_placements(mesh) -> Tuple:
    """``Shard(0)`` on the mesh's ``dp`` dimension, ``Replicate``
    elsewhere: a batch split over dp."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(mesh.mesh_dim_names or (DATA_AXIS,))
    return tuple(Shard(0) if n == DATA_AXIS else Replicate() for n in names)


def _param_shardings(model, mesh) -> Dict[str, Sharding]:
    return {name: sharding_of(p, mesh)
            for name, p in model.named_parameters()}


def _state_shardings(state, mesh) -> Tuple:
    """The shardings of an optimizer state's tensors, in order."""
    out = []

    def walk(node):
        if isinstance(node, torch.Tensor):
            out.append(sharding_of(node, mesh))
        elif isinstance(node, (list, tuple)):
            for v in node:
                walk(v)

    walk(state)
    return tuple(out)


# ---------------------------------------------------------------------------
# builder
# ---------------------------------------------------------------------------


def make_step(loss_fn: Callable, optimizer: Optimizer, *,
              mesh=None,
              specs: Any = None,
              wire: str = "mean",
              weight_update: Optional[str] = None,
              mixed_precision: Optional[str] = None,
              remat: Any = None,
              overlap: Optional[bool] = None,
              comm_buckets: Optional[int] = None,
              on_bucket_ready: Optional[Callable] = None,
              donate: Optional[bool] = None,
              pad_multiple: Optional[int] = None) -> Callable:
    """Build THE train step: ``step(model, opt_state, batch)``.

    ``loss_fn(model, batch) -> (loss, metrics)``. Parallelism is a spec
    choice (module docstring): ``specs=None`` (every ``wire`` mode:
    mean | quant/int8 | q4 | adaptive; :class:`..data_parallel
    .StepOutput`), ``specs=FROM_INPUTS`` (:class:`.spmd.SpmdStepOutput`),
    ``specs=StepSpecs(params, opt, grads)`` (spec trees from
    ``fsdp_param_specs`` / ``shard_layouts`` /
    ``transformer_lm_param_specs``; :class:`..data_parallel
    .StepOutput`), ``weight_update="sharded"`` (state from
    ``step.init_opt_state(params)``, its spec tree from
    ``step.state_specs(opt_state)`` for the sharded checkpoint).

    ``mixed_precision`` (``None`` reads ``DPX_MP_POLICY``) and ``remat``
    (``None`` reads ``DPX_REMAT``; the loss recomputed in backward under
    the named policy) apply to every engine, the host door's included.
    ``overlap`` / ``comm_buckets`` / ``on_bucket_ready`` are host-door
    knobs. ``donate`` (``None`` reads ``DPX_DONATE``) is keyed and
    recorded; every engine updates in place.
    """
    if wire not in GRAD_REDUCE_MODES:
        raise ValueError(f"wire (grad_reduce) must be one of "
                         f"{'|'.join(GRAD_REDUCE_MODES)}, got {wire!r}")
    if mixed_precision is None:
        mixed_precision = _env.get("DPX_MP_POLICY")
    if mixed_precision not in MP_POLICIES:
        raise ValueError(f"mixed_precision must be one of "
                         f"{'|'.join(MP_POLICIES)}, got "
                         f"{mixed_precision!r}")
    if weight_update is None:
        weight_update = _env.get("DPX_WEIGHT_UPDATE")
    if weight_update not in WEIGHT_UPDATES:
        raise ValueError(f"weight_update must be "
                         f"{'|'.join(WEIGHT_UPDATES)}, got "
                         f"{weight_update!r}")
    if donate is None:
        donate = bool(_env.get("DPX_DONATE"))
    if weight_update == "sharded" and wire in ("q4", "adaptive"):
        raise ValueError(
            "weight_update='sharded' supports wire mean|quant|int8 only "
            "(the sharded gather leg pins the q8 grid its exact-master "
            "error feedback assumes); use weight_update='replicated' "
            "with q4/adaptive")

    from ..models.transformer import apply_remat_policy, resolve_remat
    remat_policy = resolve_remat(remat)

    base_loss = loss_fn
    if remat_policy != "none":
        loss_fn = apply_remat_policy(loss_fn, remat_policy)

    # -- host (per-rank-process) door: dispatched to, unchanged
    if context.get_host_comm() is not None:
        if weight_update == "sharded":
            from ..optim.sharded import make_sharded_train_step
            if pad_multiple is not None:
                raise ValueError(
                    "pad_multiple applies to the SPMD/global-state "
                    "engine; the host engine derives its layout from "
                    "the live world")
            return make_sharded_train_step(loss_fn, optimizer,
                                           grad_reduce=wire,
                                           mixed_precision=mixed_precision)
        from .data_parallel import _make_host_train_step
        return _make_host_train_step(
            forward_backward(loss_fn, mixed_precision), optimizer, wire,
            overlap, comm_buckets, on_bucket_ready)

    if mesh is None:
        mesh = context.get_mesh()
    world = context.get_world_size()

    key = ("front_door", base_loss, optimizer, _mesh_key(mesh), world,
           _spec_key(specs), wire, weight_update, mixed_precision,
           remat_policy, bool(donate), pad_multiple)
    try:
        cached = _CACHE.get(key)
    except TypeError:                    # unhashable loss/optimizer
        cached, key = None, None
    if cached is not None:
        _CACHE.move_to_end(key)          # LRU touch
        return cached

    step = FrontDoorStep(config=key or ("front_door", "<unhashable>"),
                         donated=bool(donate))
    if weight_update == "sharded":
        _build_sharded(step, loss_fn, optimizer, world, wire=wire,
                       mp=mixed_precision, pad_multiple=pad_multiple)
    elif isinstance(specs, _FromInputs):
        _build_propagate(step, loss_fn, optimizer, mp=mixed_precision)
    elif specs is None:
        _build_stacked_dp(step, loss_fn, optimizer, wire=wire,
                          mp=mixed_precision)
    else:
        if not isinstance(specs, StepSpecs):
            specs = StepSpecs(params=specs)
        _build_constrained(step, loss_fn, optimizer, mesh, specs,
                           mp=mixed_precision)
    if key is not None:
        _CACHE[key] = step
        while len(_CACHE) > _CACHE_MAX:
            _CACHE.popitem(last=False)   # evict least-recently-used
    return step


# ---------------------------------------------------------------------------
# engine: pure DP over the dp axis (per-rank losses)
# ---------------------------------------------------------------------------


def _build_stacked_dp(step, loss_fn, optimizer, *, wire, mp):
    """The DDP engine of ``data_parallel``: forward, backward, the
    gradient mean over the ranks (one flat bucket; the quantized wires
    through ``comm.primitives``), the replicated update. Under
    ``adaptive`` the program key is the width the chooser picked."""
    from .data_parallel import _make_dist_train_step

    engine = _make_dist_train_step(loss_fn, mp, optimizer, wire)
    step.width_chooser = chooser = engine.width_chooser
    mesh = _group_mesh()
    if mesh is not None:
        rep, dp = _replicated(mesh), Sharding(mesh, _dp_placements(mesh))
        step.in_shardings = {"params": rep, "opt": rep, "batch": dp}
        step.out_shardings = {"params": rep, "opt": rep, "loss": dp,
                              "metrics": dp}
    def call(model, opt_state, batch):
        key = chooser.width if chooser is not None else engine.wire_bits
        return step._run(key, engine, model, opt_state, batch)

    step._call = call


# ---------------------------------------------------------------------------
# engine: the layout carried by the inputs
# ---------------------------------------------------------------------------


def _batch_mesh(batch):
    """The mesh of the batch's DTensors (None for a plain batch). Any
    layout is taken: a batch sharded along the sequence (``P("dp",
    "sp")``) runs token-wise layers on its local shards and attention
    through the model's ``attn_fn`` (the sp island of
    ``spmd.make_gspmd_ring_attn_fn``, or the flash kernel on the
    gathered sequence)."""
    from torch.distributed.tensor import DTensor
    found = []

    def walk(node):
        if isinstance(node, DTensor):
            found.append(node.device_mesh)
        elif isinstance(node, (list, tuple)):
            for v in node:
                walk(v)
        elif isinstance(node, dict):
            for v in node.values():
                walk(v)

    walk(batch)
    return found[0] if found else None


def _build_propagate(step, loss_fn, optimizer, *, mp):
    """The step of a module whose parameters the caller laid out as
    DTensors (``tensor.shard_params``), on a batch placed with
    :func:`.spmd.shard_batch_spec`: ``loss_fn`` sees global shapes and
    computes the global mean loss, DTensor propagation derives the
    collectives (plain tensors read as replicated), each gradient is
    placed as its parameter before the update (the gradient mean over
    ``dp``). The flash kernel runs on the local shards (``ops
    .flash_attention``). Returns one global scalar loss."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication
    from .data_parallel import mp_cast_params
    from .spmd import SpmdStepOutput

    cast = mp_cast_params if mp == "bf16" else contextlib.nullcontext

    def engine(model, opt_state, batch):
        mesh = _batch_mesh(batch)
        params = list(model.parameters())
        if mesh is not None:
            plain = [n for n, p in model.named_parameters()
                     if p.requires_grad and not isinstance(p, DTensor)]
            if plain:
                raise ValueError(
                    f"FROM_INPUTS with a DTensor batch takes parameters "
                    f"laid out on its mesh; {plain[:3]} are plain tensors "
                    "(place them with parallel.tensor.shard_params)")
        for p in params:
            p.grad = None
        with (implicit_replication() if mesh is not None
              else contextlib.nullcontext()), cast(model):
            loss, metrics = loss_fn(model, batch)
            loss.backward()
        grads = []
        for p in params:
            g = p.grad
            if g is None and p.requires_grad:
                g = torch.zeros_like(p)
            if isinstance(g, DTensor) and (
                    tuple(g.placements) != tuple(p.placements)):
                g = g.redistribute(p.device_mesh, p.placements)
            grads.append(g if p.requires_grad else None)
        opt_state = optimizer.update(grads, opt_state, params)
        loss = loss.detach()
        if isinstance(loss, DTensor):
            loss = loss.full_tensor()
        metrics = context.map_tensors(
            lambda t: t.full_tensor() if isinstance(t, DTensor)
            else t.detach(), metrics)
        return SpmdStepOutput(model, opt_state, loss.reshape(()), metrics)

    mesh = _group_mesh()

    def call(model, opt_state, batch):
        out = step._run("propagate", engine, model, opt_state, batch)
        if step.out_shardings is None and mesh is not None:
            p_sh = _param_shardings(model, mesh)
            o_sh = _state_shardings(out.opt_state, mesh)
            step.in_shardings = {"params": p_sh, "opt": o_sh,
                                 "batch": None}
            step.out_shardings = {"params": p_sh, "opt": o_sh}
        return out

    step._call = call


# ---------------------------------------------------------------------------
# engine: the constraint ladder (ZeRO-3/2/1, tp)
# ---------------------------------------------------------------------------


def _build_constrained(step, loss_fn, optimizer, mesh, specs: StepSpecs,
                       *, mp):
    """The fsdp ladder from the spec trees (``fsdp._ladder_step``: FSDP2
    under ZeRO-3, the sharded optimizer state and flat collectives under
    ZeRO-1/2). The shardings are what the laid-out parameters and state
    carry after the first call (in == out: the update is in place)."""
    from . import fsdp

    engine = fsdp._ladder_step(loss_fn, optimizer, mesh, specs.params,
                               specs.opt, specs.grads, mp)
    g_mesh = _group_mesh()

    def call(model, opt_state, batch):
        out = step._run("constrained", engine, model, opt_state, batch)
        if step.out_shardings is None:
            p_sh = _param_shardings(model, g_mesh or mesh)
            o_sh = _state_shardings(out.opt_state, g_mesh or mesh)
            step.in_shardings = {"params": p_sh, "opt": o_sh,
                                 "batch": None}
            step.out_shardings = {"params": p_sh, "opt": o_sh}
        return out

    step._call = call


# ---------------------------------------------------------------------------
# engine: ZeRO-1 on the flat bucket (optim/sharded)
# ---------------------------------------------------------------------------


def _build_sharded(step, loss_fn, optimizer, world, *, wire, mp,
                   pad_multiple):
    """The ``reduce-scatter -> owned-slice step -> all-gather`` engine
    (``optim/sharded/spmd.py``): rank r owns segment r of the flat
    bucket. ``step.state_specs(opt_state)`` is the JAX package's spec
    tree of the state (1-D flat vectors ``P("dp")``, step counts
    ``P()``): what the sharded checkpoint takes as ``opt_specs``."""
    from ..optim.sharded import make_sharded_train_step
    from .tensor import P

    engine = make_sharded_train_step(loss_fn, optimizer, grad_reduce=wire,
                                     mixed_precision=mp,
                                     pad_multiple=pad_multiple)
    mesh = _group_mesh()
    if mesh is not None:
        rep, dp = _replicated(mesh), Sharding(mesh, _dp_placements(mesh))
        step.in_shardings = {"params": rep, "opt": dp, "batch": dp}
        step.out_shardings = {"params": rep, "opt": dp, "loss": dp,
                              "metrics": dp}

    def state_specs(opt_state, axis: str = DATA_AXIS):
        """The spec tree of the sharded state, in the JAX package's
        structure: the wrapped optimizer's one-tensor lists read as
        their tensor."""
        def pick(node):
            if isinstance(node, list) and len(node) == 1 and isinstance(
                    node[0], torch.Tensor):
                node = node[0]
            if isinstance(node, torch.Tensor):
                return P(axis) if node.dim() == 1 and node.numel() else P()
            if isinstance(node, tuple) and hasattr(node, "_fields"):
                return type(node)(*(pick(v) for v in node))
            if isinstance(node, (list, tuple)):
                return type(node)(pick(v) for v in node)
            return P()
        return pick(opt_state)

    def call(model, opt_state, batch):
        return step._run("sharded", engine, model, opt_state, batch)

    step._call = call
    step.init_opt_state = engine.init_opt_state
    step.state_specs = state_specs


# ---------------------------------------------------------------------------
# eval: the consumer side of the handoff
# ---------------------------------------------------------------------------


def _dp_slot(mesh) -> Tuple[int, int, Any]:
    """(dp size, this rank's dp index, the dp group) of ``mesh``."""
    if mesh is None:
        return 1, 0, None
    names = tuple(mesh.mesh_dim_names or ())
    dp = mesh[DATA_AXIS] if mesh.ndim > 1 and DATA_AXIS in names else mesh
    n = dp.size()
    if n == 1:
        return 1, 0, None
    return n, dp.get_local_rank(), dp.get_group()


def make_eval_step(eval_fn: Callable, *, like=None, mesh=None) -> Callable:
    """A data-parallel eval step ``step(model, batch) -> metrics`` whose
    params are pinned to ``like``'s (a train :class:`FrontDoorStep`)
    out-shardings: each call asserts the model already carries them
    (:func:`verify_handoff`: nothing moved), so feeding it the train
    step's model moves zero bytes.

    ``eval_fn(model, batch) -> metrics`` (per-example leading axis). The
    step takes the global batch, runs ``eval_fn`` on this rank's rows of
    it (split over ``dp``) under ``torch.no_grad()`` with the model in
    eval mode — for a ZeRO-3 model its FSDP2 forward, whose per-unit
    all-gather is the counterpart of the gathers GSPMD derives around
    sharded weights, each unit resharded after — and returns every
    rank's rows in rank order.
    ``step.trace_counts["n"]`` counts its first call;
    ``step.in_shardings`` holds the pinned params (the very object
    ``like`` exposes) and the batch's."""
    from .data_parallel import _mode
    from ..comm import primitives as prim

    if mesh is None:
        mesh = _group_mesh()
    pinned = handoff_shardings(like) if like is not None else None
    n, index, group = _dp_slot(mesh)
    counters = {"n": 0}

    def run(model, batch):
        if not counters["n"]:
            counters["n"] = 1
        verify_handoff(model, pinned, what="eval params")
        local = context.map_tensors(
            lambda b: b[index * (b.shape[0] // n):
                        (index + 1) * (b.shape[0] // n)], batch)
        with torch.no_grad(), _mode(model, False):
            metrics = eval_fn(model, local)
        if getattr(model, "_dpx_fsdp", None) is not None:
            # FSDP2 keeps the root unit gathered after a forward with no
            # backward: put the step's layout back (frees, moves nothing)
            from torch.distributed.fsdp import FSDPModule
            for m in model.modules():
                if isinstance(m, FSDPModule):
                    m.reshard()
        if n > 1:
            metrics = context.map_tensors(
                lambda t: prim.all_gather(t.contiguous(), axis=0,
                                          tiled=True, group=group), metrics)
        return metrics

    run.trace_counts = counters
    run.in_shardings = (None if mesh is None else
                        {"params": pinned if pinned is not None
                         else _replicated(mesh),
                         "batch": Sharding(mesh, _dp_placements(mesh))})
    return run


__all__ = ["FROM_INPUTS", "FrontDoorStep", "HandoffMismatch",
           "MemoryAnalysisUnavailable", "Sharding",
           "StepSpecs", "WEIGHT_UPDATES", "cache_clear", "cache_info",
           "handoff_shardings", "make_eval_step", "make_step",
           "sharding_of", "verify_handoff"]
