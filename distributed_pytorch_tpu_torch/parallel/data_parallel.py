"""Data parallelism: the train steps, the eval steps, the bf16 policy and
the DDP wrapper.

Counterpart of ``distributed_pytorch_tpu/parallel/data_parallel.py``
(``StepOutput``, ``make_train_step``, ``StatefulStepOutput``,
``make_stateful_train_step``, ``make_eval_step``,
``make_stateful_eval_step``, ``stack_state``, ``make_scan_train_steps``,
``mp_cast_params``, ``DataParallel``, ``prepare_ddp_model``), in the
per-rank form of its host front door (``_make_host_train_step``): every
rank process runs ``step(model, opt_state, batch) -> StepOutput`` on its
own local batch, through one of the JAX package's two doors: the host
door over the native group (``_make_host_train_step``) or, in place of
its compiled single-controller door, torch.distributed.
The params are the ``nn.Module`` (updated in place), ``opt_state`` is
what ``optimizer.init(model.parameters())`` returned, and the loss comes
back as this rank's ``(1,)`` mean. At world > 1 the gradients are
averaged over the ranks once per step, between backward and the
optimizer update, so every rank applies the same update.

Every ``grad_reduce`` mode (the exact mean and the quantized wires),
the overlapped buckets of the host door and ``weight_update="sharded"``
(ZeRO-1, ``optim/sharded/``) are ported.
"""

from __future__ import annotations

import contextlib
import time
from typing import Any, Callable, Iterator, NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from ..comm.collectives import all_gather, sync_params
from ..optim import Optimizer
from ..runtime import context
from ..runtime import env as _env

#: grad_reduce spellings accepted by :func:`make_train_step`.
GRAD_REDUCE_MODES = ("mean", "int8", "quant", "q4", "adaptive")

#: mixed_precision policies accepted by :func:`make_train_step`.
MP_POLICIES = ("off", "bf16")


class StepOutput(NamedTuple):
    params: Any              # the model, its parameters updated in place
    opt_state: Any
    loss: torch.Tensor       # (1,) this rank's mean loss
    metrics: Any             # loss_fn's metrics, detached


class StatefulStepOutput(NamedTuple):
    params: Any              # the model, its parameters updated in place
    state: Any               # the model's buffers (BatchNorm running stats)
    opt_state: Any
    loss: torch.Tensor       # (1,) this rank's mean loss
    metrics: Any


@contextlib.contextmanager
def mp_cast_params(model: nn.Module, only=None) -> Iterator[nn.Module]:
    """Inside the block, every float32 parameter of ``model`` (or of
    those in ``only``, when given) reads as its bfloat16 cast; other
    parameters and all buffers are untouched.

    The cast is a differentiable op of the float32 master parameter, so
    a backward run inside the block (where a remat policy recomputes
    the forward from the same casts) leaves float32 gradients on the
    masters, which stay what the optimizer updates. A parameter shared
    by several modules is cast once."""
    keep = None if only is None else {id(p) for p in only}
    casts, swapped = {}, []
    for mod in model.modules():
        for name, p in mod._parameters.items():
            if p is not None and p.dtype == torch.float32 and (
                    keep is None or id(p) in keep):
                if id(p) not in casts:
                    casts[id(p)] = p.to(torch.bfloat16)
                swapped.append((mod, name, p))
    try:
        for mod, name, p in swapped:
            mod._parameters[name] = casts[id(p)]
        yield model
    finally:
        for mod, name, p in swapped:
            mod._parameters[name] = p


def _average_grads(grads, world: int, group=None) -> None:
    """Average ``grads`` over the ranks (of ``group``, default all) in
    place: one float32 flat bucket, one ``all_reduce`` (sum), divided by
    ``world``."""
    flat = torch.cat([g.reshape(-1).to(torch.float32) for g in grads])
    torch.distributed.all_reduce(flat, group=group)
    flat /= world
    _scatter_flat(flat, grads)


def _scatter_flat(flat: torch.Tensor, tensors) -> None:
    """Copy consecutive pieces of ``flat`` into ``tensors`` in place,
    each cast to its dtype."""
    off = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[off:off + n].view_as(t))
        off += n


def _wire_format(grad_reduce: str) -> str:
    """A grad_reduce spelling as a wire format of
    ``comm/host_backend.py`` (``"int8"`` is ``"quant"``)."""
    return "quant" if grad_reduce in ("quant", "int8") else grad_reduce


def forward_backward(loss_fn: Callable, mixed_precision: str,
                     cast: Optional[Callable] = None) -> Callable:
    """``run(model, batch) -> (params, grads, loss, metrics)``: clears
    the gradients, runs the forward (on the bf16 casts under
    ``mixed_precision="bf16"``; ``cast(model)``, a context manager, in
    place of :func:`mp_cast_params` where given) and the backward.
    ``grads`` lines up with ``params`` (``model.parameters()``): a zero
    tensor for a trainable parameter the loss does not reach, ``None``
    for a frozen one."""
    if cast is None or mixed_precision != "bf16":
        cast = mp_cast_params if mixed_precision == "bf16" \
            else contextlib.nullcontext

    def run(model, batch):
        params = list(model.parameters())
        for p in params:
            p.grad = None
        with cast(model):
            loss, metrics = loss_fn(model, batch)
            loss.backward()
        grads = [(p.grad if p.grad is not None else torch.zeros_like(p))
                 if p.requires_grad else None for p in params]
        return params, grads, loss, metrics

    return run


def step_output(model, opt_state, loss, metrics) -> StepOutput:
    return StepOutput(model, opt_state, loss.detach().reshape(1),
                      context.map_tensors(torch.Tensor.detach, metrics))


def make_train_step(loss_fn: Callable, optimizer: Optimizer,
                    donate: Optional[bool] = None,
                    grad_reduce: str = "mean",
                    weight_update: Optional[str] = None,
                    overlap: Optional[bool] = None,
                    comm_buckets: Optional[int] = None,
                    on_bucket_ready: Optional[Callable] = None,
                    mixed_precision: Optional[str] = None) -> Callable:
    """A training step ``step(model, opt_state, batch) -> StepOutput``.

    ``loss_fn(model, batch) -> (loss, metrics)`` with ``loss`` the
    local batch mean. Each call clears the gradients, runs the forward
    and backward, averages the gradients of the parameters that require
    them over the ranks (world > 1), applies ``optimizer.update`` in
    place and returns the loss as a ``(1,)`` tensor. A trainable
    parameter that the loss does not reach gets a zero gradient, as in
    the JAX package; a frozen one (``requires_grad=False``) gets
    ``None``, which the optimizer skips, so neither weight decay nor the
    all-reduce touches it. Buffers are left alone.

    ``grad_reduce``: ``"mean"`` (exact), ``"quant"`` (alias ``"int8"``;
    width from ``DPX_WIRE_WIDTH``, default 8 bits), ``"q4"`` or
    ``"adaptive"`` (width per bucket from the reduced bucket's dynamic
    range, with hysteresis; the chooser is ``step.width_chooser``). Two
    doors, as in the JAX package:

    * the **host door**, while a native host group is live
      (``DPX_BACKEND=host``): the gradients go to the host as one flat
      float32 bucket in parameter order; under a quantized mode an
      :class:`~..ops.quant.ErrorFeedback` residual rounds it onto the
      wire grid (carrying each step's rounding into the next), the
      native quantized ring reduces it (two-level under
      ``DPX_HIER_RING``), and the mean comes back to each gradient's
      device and dtype. ``overlap`` (default ``DPX_COMM_OVERLAP``) cuts
      the bucket into ``comm_buckets`` (default ``DPX_COMM_BUCKETS``)
      contiguous buckets and dispatches each bucket's update before the
      next bucket's ring runs; a bucket's ring time counts as
      ``overlapped_s`` in the comm's ``CommStats`` only while an update
      issued before it is still running on the card (a CUDA event not
      yet reached), else ``exposed_s``. The overlapped step keeps one
      optimizer state per bucket: build it with
      ``step.init_opt_state(params)``; an optimizer that reads all the
      gradients together (global-norm clipping) is refused.
      ``on_bucket_ready(b, n_buckets, nbytes)`` is called as each bucket
      reaches the host. ``step.host_times`` sums the host seconds of the
      device-to-host copy (``d2h_s``), the codec (``codec_s``), the ring
      (``ring_s``) and the copy back (``h2d_s``);
    * the **torch.distributed door** (NCCL / gloo): each gradient is
      zero-padded to a ``QUANT_BLOCK`` multiple and the concatenation
      takes one ``comm.primitives.quantized_pmean``; the adaptive
      chooser reads the outlier statistic of the unpadded reduced
      gradients. At world 1 every mode is the exact mean. ``overlap``,
      ``comm_buckets`` and ``on_bucket_ready`` change nothing here.

    ``weight_update``: ``"replicated"`` (every rank runs the whole
    update) or ``"sharded"`` (ZeRO-1, ``optim/sharded/``: reduce-scatter,
    the update of the owned 1/world flat slice, all-gather; state from
    ``step.init_opt_state(params)``); ``None`` reads
    ``DPX_WEIGHT_UPDATE``. The sharded update speaks ``mean`` and the
    8-bit ``quant`` only.

    ``mixed_precision``: ``"off"`` or ``"bf16"`` (``None`` reads
    ``DPX_MP_POLICY``). Under ``bf16`` the forward and backward run on
    the bf16 cast of the float32 parameters (:func:`mp_cast_params`)
    and the float32 gradients update the float32 masters.

    A shim over the front door (``front_door.make_step`` with
    ``specs=None``, as in the JAX package): the builder cache, the build
    counts and the handoff shardings come from there. ``donate`` is
    keyed there and changes nothing: the update already writes the
    parameters and the optimizer state in place, which is what donation
    buys XLA."""
    from .front_door import make_step
    return make_step(loss_fn, optimizer, wire=grad_reduce,
                     weight_update=weight_update,
                     mixed_precision=mixed_precision,
                     overlap=overlap, comm_buckets=comm_buckets,
                     on_bucket_ready=on_bucket_ready, donate=donate)


def _make_dist_train_step(fb: Callable, optimizer: Optimizer,
                          grad_reduce: str) -> Callable:
    """The torch.distributed door of :func:`make_train_step`: the
    front door's DDP engine (``specs=None``)."""
    from ..comm import host_backend as _hb
    from ..comm import primitives as prim
    from ..comm.wire import WidthChooser
    from ..ops.quant import block_outlier_frac

    adaptive, bits = False, 8
    if grad_reduce != "mean":
        width = _hb.resolve_wire_width(_wire_format(grad_reduce))
        adaptive = width == "adaptive"
        bits = 8 if adaptive else width
    chooser = WidthChooser() if adaptive else None
    block = prim.QUANT_BLOCK

    def reduce_quantized(grads, width):
        pieces = []
        for g in grads:
            f = g.reshape(-1).to(torch.float32)
            pad = (-f.numel()) % block
            pieces.append(torch.nn.functional.pad(f, (0, pad)) if pad
                          else f)
        red = prim.quantized_pmean(torch.cat(pieces), bits=width)
        out, off = [], 0
        for g in grads:
            n = g.numel()
            out.append(red[off:off + n])
            off += n + ((-n) % block)
        for g, r in zip(grads, out):
            g.copy_(r.view_as(g))
        return out

    def step(model, opt_state, batch) -> StepOutput:
        params, grads, loss, metrics = fb(model, batch)
        world = context.get_world_size()
        live = [g for g in grads if g is not None]
        if world > 1 and live:
            if grad_reduce == "mean":
                _average_grads(live, world)
            else:
                width = chooser.width if chooser is not None else bits
                reduced = reduce_quantized(live, width)
                if chooser is not None:
                    # the statistic of the unpadded reduced gradients,
                    # the same input the host door's chooser reads
                    chooser.observe_frac(float(block_outlier_frac(
                        torch.cat(reduced), block)))
        opt_state = optimizer.update(grads, opt_state, params)
        return step_output(model, opt_state, loss, metrics)

    step.width_chooser = chooser
    step.wire_bits = bits
    return step


def trainable(params) -> list:
    """The parameters that require gradients, of a module or an
    iterable: the tensors a per-bucket or sharded optimizer state
    covers."""
    if isinstance(params, nn.Module):
        params = params.parameters()
    return [p for p in params if p.requires_grad]


def _partition_contiguous(sizes, k: int):
    """Indices split into <= k contiguous groups balanced by element
    count (greedy on the running total; the JAX package's). Depends on
    the sizes alone, so every rank partitions alike."""
    k = max(1, min(int(k), len(sizes)))
    if k == 1:
        return [list(range(len(sizes)))]
    total = sum(sizes)
    groups, cur, acc = [], [], 0
    for i, s in enumerate(sizes):
        cur.append(i)
        acc += s
        # close the group once the running count crosses the next
        # k-quantile of the total (k is a cap: tiny lists give fewer)
        if acc * k >= total * (len(groups) + 1) \
                and len(groups) < k - 1:
            groups.append(cur)
            cur = []
    if cur:
        groups.append(cur)
    return groups


def _outstanding(pending) -> bool:
    """Whether an update issued before is still running on the card: a
    CUDA event recorded after it not yet reached. CPU work is done when
    its call returns."""
    return any(ev is not None and not ev.query() for ev in pending)


def _make_host_train_step(fb: Callable, optimizer: Optimizer,
                          grad_reduce: str, overlap: Optional[bool],
                          comm_buckets: Optional[int],
                          on_bucket_ready: Optional[Callable]) -> Callable:
    """The host door of :func:`make_train_step` (JAX
    ``parallel/data_parallel.py:219-465`` ``_make_host_train_step``)."""
    from ..comm import host_backend as _hb
    from ..comm.wire import WidthChooser
    from ..obs import metrics as _dpxmon
    from ..obs import trace as _dpxtrace
    from ..ops.quant import ErrorFeedback
    from ..optim.schedules import reduces_across_leaves

    comm = context.get_host_comm()
    world = comm.world
    quant = grad_reduce != "mean"
    width = _hb.resolve_wire_width(_wire_format(grad_reduce)) \
        if quant else None
    chooser = WidthChooser() if width == "adaptive" else None
    if overlap is None:
        overlap = bool(_env.get("DPX_COMM_OVERLAP"))
    n_buckets = comm_buckets if comm_buckets is not None \
        else int(_env.get("DPX_COMM_BUCKETS"))
    if not overlap:
        n_buckets = 1
    if overlap and reduces_across_leaves(optimizer):
        raise ValueError(
            "overlap=True updates one bucket of gradients at a time: an "
            "optimizer that reads all of them together (global-norm "
            "clipping) cannot run that way; use overlap=False")
    efs = {}            # bucket -> ErrorFeedback (sizes differ per bucket)
    times = {"d2h_s": 0.0, "codec_s": 0.0, "ring_s": 0.0, "h2d_s": 0.0}

    def reduce_bucket(b, flat, bits, hidden):
        if quant:
            t0 = time.perf_counter()
            flat = efs.setdefault(b, ErrorFeedback()).compensate(
                flat, bits=bits)
            t1 = time.perf_counter()
            _hb.quant_ring(comm, flat, bits, hidden)
        else:
            t1 = time.perf_counter()
            comm.allreduce(flat, hidden=hidden)
        flat /= world                       # DDP averages gradients
        times["ring_s"] += time.perf_counter() - t1
        if quant:
            times["codec_s"] += t1 - t0
        return flat

    def to_host(live):
        """The gradients as one float32 host bucket (one copy)."""
        dev = torch.cat([g.reshape(-1).to(torch.float32) for g in live])
        if dev.is_cuda:             # the copy alone, not the backward
            torch.cuda.synchronize(dev.device)
        t0 = time.perf_counter()
        flat = dev.cpu().numpy()
        times["d2h_s"] += time.perf_counter() - t0
        return flat

    def to_device(flat, tensors):
        t0 = time.perf_counter()
        dev = torch.from_numpy(flat).to(tensors[0].device)
        _scatter_flat(dev, tensors)
        times["h2d_s"] += time.perf_counter() - t0

    def observe(reduced):
        # the reduced mean bucket is bit-identical on every rank, so the
        # width state machines agree world-wide
        if chooser is not None:
            chooser.observe(np.concatenate(reduced) if len(reduced) > 1
                            else reduced[0])

    def bits_now():
        return chooser.width if chooser is not None else (width or 8)

    if not overlap:
        def step(model, opt_state, batch) -> StepOutput:
            # dpxtrace spans (obs/trace.py; no-ops unless DPX_TRACE):
            # host_step > backward / bucket (the comm span nests inside)
            # / update, on the host's clock: on the card `backward` ends
            # at the device-to-host copy of the gradients, which waits
            # for them, and `update` times the launches
            with _dpxtrace.span("host_step", wire=grad_reduce, buckets=1):
                with _dpxtrace.span("backward"):
                    params, grads, loss, metrics = fb(model, batch)
                    live = [g for g in grads if g is not None]
                    flat = to_host(live) if live else None
                if live:
                    bits = bits_now()
                    if on_bucket_ready is not None:
                        on_bucket_ready(0, 1, flat.nbytes)
                    with _dpxtrace.span("bucket", b=0, nbytes=flat.nbytes,
                                        bits=bits):
                        flat = reduce_bucket(0, flat, bits, False)
                    observe([flat])
                    to_device(flat, live)
                with _dpxtrace.span("update"):
                    opt_state = optimizer.update(grads, opt_state, params)
            # dpxmon step hook (obs/metrics.py; one global read when off)
            _dpxmon.on_train_step("host_step")
            return step_output(model, opt_state, loss, metrics)

        step.width_chooser = chooser
        step.host_times = times
        return step

    def groups_for(tensors):
        return _partition_contiguous([t.numel() for t in tensors],
                                     n_buckets)

    def init_opt_state(params):
        """One optimizer state per bucket of the trainable
        parameters."""
        ps = trainable(params)
        return [optimizer.init([ps[i] for i in idx])
                for idx in groups_for(ps)]

    def step(model, opt_state, batch) -> StepOutput:
        with _dpxtrace.span("host_step", wire=grad_reduce,
                            buckets=n_buckets, overlap=True):
            with _dpxtrace.span("backward"):
                params, grads, loss, metrics = fb(model, batch)
                ps = [p for p, g in zip(params, grads) if g is not None]
                gs = [g for g in grads if g is not None]
                groups = groups_for(gs)
                # a list, as init_opt_state builds it: an optimizer state
                # is itself a tuple, which a length check alone could take
                # for one
                if not isinstance(opt_state, list) \
                        or len(opt_state) != len(groups):
                    raise TypeError(
                        "the overlapped host step keeps one optimizer "
                        "state per bucket: build opt_state with "
                        "step.init_opt_state(params), not optimizer.init")
                # every bucket reaches the host in one copy before any
                # update is issued: a later copy would wait for the
                # updates queued before it
                flat = to_host(gs)
            bits = bits_now()
            new_states, pending, reduced, off = [], [], [], 0
            for b, idx in enumerate(groups):
                n = sum(gs[i].numel() for i in idx)
                piece = flat[off:off + n]
                off += n
                if on_bucket_ready is not None:
                    on_bucket_ready(b, len(groups), piece.nbytes)
                hidden = _outstanding(pending)
                # the bucket span carries the measured overlap verdict;
                # the comm span nests inside via CommStats.timed
                with _dpxtrace.span("bucket", b=b, nbytes=piece.nbytes,
                                    bits=bits, hidden=hidden):
                    piece = reduce_bucket(b, piece, bits, hidden)
                reduced.append(piece)
                g_sub = [gs[i] for i in idx]
                to_device(piece, g_sub)
                # issued and not waited for: the card runs it while the
                # next bucket's ring runs on the host
                with _dpxtrace.span("update", b=b):
                    new_states.append(optimizer.update(
                        g_sub, opt_state[b], [ps[i] for i in idx]))
                if g_sub[0].is_cuda:
                    ev = torch.cuda.Event()
                    ev.record()
                    pending.append(ev)
            observe(reduced)
        _dpxmon.on_train_step("host_step")
        return step_output(model, new_states, loss, metrics)

    step.width_chooser = chooser
    step.init_opt_state = init_opt_state
    step.host_times = times
    return step


@contextlib.contextmanager
def _mode(model: nn.Module, train: bool) -> Iterator[None]:
    """``model`` in training (``train``) or eval mode inside the block,
    its previous mode restored after."""
    was = model.training
    model.train(train)
    try:
        yield
    finally:
        model.train(was)


def make_stateful_train_step(loss_fn: Callable, optimizer: Optimizer,
                             donate: Optional[bool] = None,
                             **kw) -> Callable:
    """:func:`make_train_step` for a model with state that is not trained
    (BatchNorm running stats): ``step(model, opt_state, batch) ->
    StatefulStepOutput``, the model in training mode for the step (its
    previous mode restored after), ``state`` its buffers by name after
    the step (BatchNorm ``mean``, ``var`` and ``count``: the tensors
    themselves).

    ``loss_fn(model, batch) -> (loss, metrics)``: the forward updates the
    running stats in place from this rank's local batch. Nothing syncs
    them across the ranks, as in torch DDP and the JAX package's
    per-device state; the gradients are averaged once per step, as in
    :func:`make_train_step`, whose step this one runs."""
    inner = make_train_step(loss_fn, optimizer, donate=donate, **kw)

    def step(model, opt_state, batch) -> StatefulStepOutput:
        with _mode(model, True):
            out = inner(model, opt_state, batch)
        return StatefulStepOutput(out.params, dict(model.named_buffers()),
                                  out.opt_state, out.loss, out.metrics)

    return step


def _gather_ranks(metrics):
    """Every rank's ``metrics`` concatenated along axis 0 in rank order,
    on every rank: one ``all_gather`` of all the leaves packed into one
    float64 buffer (exact for the bool, int32 and float32 leaves an eval
    step returns), cast back to each leaf's dtype."""
    leaves = []
    context.map_tensors(leaves.append, metrics)
    flat = torch.cat([t.reshape(-1).to(torch.float64) for t in leaves])
    rows = all_gather(flat)                      # (world, n)
    out, off = [], 0
    for t in leaves:
        n = t.numel()
        out.append(rows[:, off:off + n].reshape((-1,) + tuple(t.shape[1:]))
                   .to(t.dtype))
        off += n
    it = iter(out)
    return context.map_tensors(lambda _: next(it), metrics)


def make_eval_step(eval_fn: Callable) -> Callable:
    """An evaluation step ``step(model, batch) -> metrics``: no
    gradients, no update, the model in eval mode (its previous mode
    restored after). ``eval_fn(model, batch)`` returns per-example
    tensors (leading axis the local batch); at world > 1 the step returns
    every rank's in rank order, concatenated along axis 0, on every rank
    (the JAX step's global layout)."""

    def step(model, batch):
        with torch.no_grad(), _mode(model, False):
            metrics = eval_fn(model, batch)
        if context.get_world_size() > 1:
            metrics = _gather_ranks(metrics)
        return metrics

    return step


def make_stateful_eval_step(eval_fn: Callable) -> Callable:
    """:func:`make_eval_step` for a model with state: in eval mode the
    BatchNorm layers normalize with this rank's running stats (the
    model's buffers) and leave them unchanged."""
    return make_eval_step(eval_fn)


def stack_state(state, world: Optional[int] = None):
    """Each tensor of ``state`` repeated along a new leading axis of
    size ``world`` (default: the group's): every rank's state in one
    place, each starting from the same values."""
    w = world or context.get_world_size()
    return context.map_tensors(
        lambda t: t.unsqueeze(0).expand((w,) + tuple(t.shape)).clone(),
        state)


def make_scan_train_steps(loss_fn: Callable, optimizer: Optimizer,
                          n_steps: int, donate: Optional[bool] = None,
                          **kw) -> Callable:
    """``n_steps`` training steps in one call: ``run(model, opt_state,
    batches) -> (model, opt_state, losses)``, where every tensor of
    ``batches`` holds the steps' local batches stacked on a leading
    ``n_steps`` axis and ``losses`` is ``(n_steps, 1)``, this rank's
    loss per step. Each step is :func:`make_train_step`'s."""
    step = make_train_step(loss_fn, optimizer, donate=donate, **kw)

    def run(model, opt_state, batches):
        losses = []
        for t in range(n_steps):
            out = step(model, opt_state,
                       context.map_tensors(lambda b: b[t], batches))
            opt_state = out.opt_state
            losses.append(out.loss)
        return model, opt_state, torch.stack(losses)

    return run


class DataParallel(nn.Module):
    """``module`` prepared for data-parallel training: the result of
    :func:`prepare_ddp_model` at world > 1.

    Construction broadcasts rank 0's parameters and buffers to every
    rank (DDP's constructor contract); ``forward`` is the module's.
    Gradients are averaged by :func:`make_train_step`, once per step,
    so no autograd hook is installed (wrapping in torch's
    ``DistributedDataParallel`` as well would average them twice)."""

    def __init__(self, module: nn.Module):
        super().__init__()
        self.module = module
        sync_params(list(module.parameters()) + list(module.buffers()))

    def forward(self, *args, **kwargs):
        return self.module(*args, **kwargs)

    def make_train_step(self, loss_fn: Callable, optimizer: Optimizer,
                        **kw) -> Callable:
        return make_train_step(loss_fn, optimizer, **kw)


def prepare_ddp_model(model: nn.Module, device_ids=None, *args, **kwargs):
    """``DataParallel(model)`` iff the world is larger than 1, else
    ``model`` itself (reference ``distributed.py:112-115``).
    ``device_ids`` and the rest are accepted for the reference's
    signature: rank r's model already lives on ``cuda:r``."""
    del device_ids, args, kwargs
    if context.get_world_size() > 1:
        return DataParallel(model)
    return model
