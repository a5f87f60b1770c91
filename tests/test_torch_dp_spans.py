"""The DDP engine's phase spans (``parallel/data_parallel.py``
``_make_dist_train_step``, the front door's ``specs=None`` engine) and
the profiler bridge of ``obs/trace.py``.

- Under a CPU ``torch.profiler``, with ``DPX_TRACE`` off or on, a
  world-1 step of a small LM opens the ranges ``dpx.dp_step`` >
  ``dpx.forward``, ``dpx.backward``, ``dpx.update``, in that order.
- With ``DPX_TRACE`` on, the records form the same tree, ``dp_step``
  carrying ``wire`` and ``world``.
- At world 2 over gloo (one launch of two CPU ranks) ``grad_reduce``
  sits between ``backward`` and ``update``, its ``bytes`` the flat
  float32 bucket's, with ``comm:allreduce`` of the same bytes inside;
  the profiler's ranges nest alike.
- With neither on, :func:`span` returns the shared null object; a comm
  op's profiler range is ``dpx.comm:<op>`` alone.
- Spans and ranges change no bit: losses and parameters after three
  steps equal an untraced run's.

Serial run time ~10 s.
"""

import json

import pytest
import torch

import _torch_obs_workers as ow
from _torch_port import launch_cpu_ranks
from distributed_pytorch_tpu_torch import optim
from distributed_pytorch_tpu_torch.obs import export as pexport
from distributed_pytorch_tpu_torch.obs import trace as ptrace
from distributed_pytorch_tpu_torch.parallel.front_door import make_step
from distributed_pytorch_tpu_torch.utils.profiler import CommStats

CPU = [torch.profiler.ProfilerActivity.CPU]


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.delenv("DPX_TRACE", raising=False)
    ptrace.reset()
    yield
    ptrace.reset()


def _steps(n, profile_last=False):
    """``n`` steps of the small LM through the front door at world 1:
    the losses, the parameters, and the profiler's ``dpx.`` ranges of
    the last step when asked."""
    model, loss_fn = ow.dp_lm()
    opt = optim.adamw(1e-3)
    step = make_step(loss_fn, opt)
    state = opt.init(model.parameters())
    losses, ranges = [], []
    for t in range(n):
        if profile_last and t == n - 1:
            with torch.profiler.profile(activities=CPU) as prof:
                out = step(model, state, ow.lm_batch(0, t))
            ranges = [[e.name, e.time_range.start, e.time_range.end]
                      for e in prof.events() if e.name.startswith("dpx.")]
        else:
            out = step(model, state, ow.lm_batch(0, t))
        state = out.opt_state
        losses.append(out.loss.detach().clone())
    params = torch.cat([p.detach().reshape(-1) for p in model.parameters()])
    return torch.cat(losses), params, ranges


def _range_tree(ranges):
    """Nested ``(name, children)`` of profiler ranges by containment,
    children in start order."""
    ranges = sorted(ranges, key=lambda r: (r[1], -r[2]))
    root, stack = [], []
    for name, s, e in ranges:
        while stack and stack[-1][1] < e:
            stack.pop()
        node = (name, [])
        (stack[-1][2] if stack else root).append(node)
        stack.append((name, e, node[1]))
    return root


def _span_tree(recs):
    """Per root span, nested ``(name, attrs, children)`` in start order."""
    spans = [r for r in recs if r.get("event") == "trace_span"]
    kids = {}
    for s in spans:
        kids.setdefault(s["parent_id"], []).append(s)

    def node(s):
        return (s["name"], s.get("attrs", {}),
                [node(c) for c in sorted(kids.get(s["span_id"], []),
                                         key=lambda c: c["t0_wall"])])
    return [node(s) for s in sorted(kids.get(None, []),
                                    key=lambda s: s["t0_wall"])]


PHASES_WORLD1 = [("dpx.dp_step", [("dpx.forward", []),
                                  ("dpx.backward", []),
                                  ("dpx.update", [])])]


@pytest.mark.parametrize("dpx_trace", [False, True])
def test_world1_step_ranges_on_the_profiler(tmp_path, dpx_trace):
    if dpx_trace:
        ptrace.configure(enabled=True, log_path=str(tmp_path / "t.jsonl"))
    _, _, ranges = _steps(1, profile_last=True)
    assert _range_tree(ranges) == PHASES_WORLD1


def test_world1_step_records_form_the_same_tree(tmp_path):
    log = tmp_path / "t.jsonl"
    ptrace.configure(enabled=True, log_path=str(log))
    _steps(2)
    recs, bad = pexport.read_log(str(log))
    assert bad == [] and pexport.check_log(recs, bad) == []
    step = ("dp_step", {"wire": "mean", "world": 1},
            [("forward", {}, []), ("backward", {}, []), ("update", {}, [])])
    assert _span_tree(recs) == [step, step]


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    out = tmp_path_factory.mktemp("dp_spans")
    log = out / "metrics.jsonl"
    with pytest.MonkeyPatch.context() as mp:
        for k, v in {"DPX_TRACE": "1", "DPX_METRICS_LOG": str(log)}.items():
            mp.setenv(k, v)
        launch_cpu_ranks(ow.traced_ddp_worker, 2, str(out))
    recs, _ = pexport.read_log(str(log))
    return recs, [json.loads((out / f"ddp{r}.json").read_text())
                  for r in (0, 1)]


def test_world2_grad_reduce_holds_the_allreduce(world2):
    recs, ranks = world2
    for got in ranks:
        nbytes = got["bytes"]
        mine = [r for r in recs if r.get("pid") == got["pid"]]
        step = ("dp_step", {"wire": "mean", "world": 2},
                [("forward", {}, []), ("backward", {}, []),
                 ("grad_reduce", {"bytes": nbytes},
                  [("comm:allreduce", {"bytes": nbytes}, [])]),
                 ("update", {}, [])])
        assert _span_tree(mine) == [step] * ow.STEPS
        assert _range_tree(got["ranges"]) == [
            ("dpx.dp_step", [("dpx.forward", []), ("dpx.backward", []),
                             ("dpx.grad_reduce",
                              [("dpx.comm:allreduce", [])]),
                             ("dpx.update", [])])]


def test_span_is_the_null_object_with_neither_on():
    assert not ptrace.enabled()
    assert ptrace.span("dp_step", wire="mean") is ptrace._NULL
    with torch.profiler.profile(activities=CPU) as prof:
        sp = ptrace.span("forward")
        assert sp is not ptrace._NULL
        with sp as inner:
            assert inner.span_id is None
        # recorded after the fact: no range
        ptrace.emit_span("late", 0.0, 1.0)
    assert ptrace.span("forward") is ptrace._NULL
    assert [e.name for e in prof.events()
            if e.name.startswith("dpx.")] == ["dpx.forward"]
    assert ptrace.flight_snapshot() == ([], 0)


def test_a_comm_op_has_one_profiler_range():
    stats = CommStats()
    with torch.profiler.profile(activities=CPU) as prof:
        with stats.timed("allreduce_sum", 64):
            torch.ones(4).sum()
    names = [e.name for e in prof.events()]
    assert "dpx.comm:allreduce_sum" in names
    assert "comm:allreduce_sum" not in names
    assert stats.per_op["allreduce_sum"]["calls"] == 1


def test_spans_change_no_bit(tmp_path):
    loss0, params0, _ = _steps(3)
    ptrace.configure(enabled=True, log_path=str(tmp_path / "t.jsonl"))
    with torch.profiler.profile(activities=CPU):
        loss1, params1, _ = _steps(3)
    assert torch.equal(loss0, loss1) and torch.equal(params0, params1)
