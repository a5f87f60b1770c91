"""The port's instrumented seams (the host train step and its comm ops,
the checkpoint manager, the serve engines) against the JAX package's,
with ``DPX_TRACE`` on.

- The host door at world 1 (each package's native host group, in this
  process): the same MLP, weights and batches, 2 steps traced, plain and
  overlapped (2 buckets). The span names and their nesting (``host_step``
  > ``backward`` / ``bucket`` > ``comm:<op>`` / ``update``, each span's
  attrs) equal the JAX package's step for step, and each step counts
  once in ``train.steps``. Tracing changes no loss and no parameter:
  a traced run equals an untraced one bit for bit.
- The monolithic engine and the disaggregated split: every request has
  one ``serve.request`` root under one ``trace_id`` (the one its
  ``serve_request`` record carries) and children that telescope to its
  TTFT (0.02 ms: four wall stamps' float ulp), as the JAX package's
  ``tests/test_obs.py`` holds them; traced and untraced streams are the
  same tokens; the ``serve.ttft_ms`` histogram counts the requests.
- A checkpoint save (sync and async): ``ckpt.save`` / ``ckpt.io`` /
  ``ckpt.commit`` spans with the JAX package's names, attrs and
  ``ckpt.<phase>`` events, ``ckpt.saves`` counts the saves, and the
  async IO span runs on the ``ckpt-io`` thread.

Serial run time ~13 s.
"""

import numpy as np
import pytest
import torch

import _torch_host_workers as hw
from distributed_pytorch_tpu.obs import metrics as jmetrics
from distributed_pytorch_tpu.obs import trace as jtrace
from distributed_pytorch_tpu_torch.obs import export as pexport
from distributed_pytorch_tpu_torch.obs import metrics as pmetrics
from distributed_pytorch_tpu_torch.obs import trace as ptrace

STEPS = 2


@pytest.fixture(autouse=True)
def _clean():
    for m in (jmetrics, jtrace, pmetrics, ptrace):
        m.reset()
    yield
    for m in (jmetrics, jtrace, pmetrics, ptrace):
        m.reset()


def _tree(recs):
    """Per root span, its subtree as nested (name, attrs, children)."""
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


# -- the host door ------------------------------------------------------------

def _jax_host_steps(overlap):
    import jax
    import jax.numpy as jnp

    from distributed_pytorch_tpu import optim as joptim
    from distributed_pytorch_tpu.parallel import make_train_step

    def loss_fn(params, batch):
        x, y = batch
        h = jax.nn.relu(x @ params["w1"] + params["b1"])
        return jnp.mean((h @ params["w2"] + params["b2"] - y) ** 2), {}

    params = {k: jnp.asarray(v) for k, v in hw.mlp_init().items()}
    opt = joptim.adamw(hw.TRAIN_LR)
    step = make_train_step(loss_fn, opt, overlap=overlap, comm_buckets=2)
    state = (step.init_opt_state(params) if overlap else opt.init(params))
    for t in range(STEPS):
        params, state, _, _ = step(params, state, hw.mlp_batch(0, t))


def _port_host_steps(overlap):
    from distributed_pytorch_tpu_torch import optim
    from distributed_pytorch_tpu_torch.parallel import make_train_step
    model = hw.port_mlp()
    opt = optim.adamw(hw.TRAIN_LR)
    step = make_train_step(hw.port_mlp_loss, opt, overlap=overlap,
                           comm_buckets=2)
    state = (step.init_opt_state(model.parameters()) if overlap
             else opt.init(model.parameters()))
    losses = []
    for t in range(STEPS):
        x, y = hw.mlp_batch(0, t)
        out = step(model, state, (torch.from_numpy(x), torch.from_numpy(y)))
        state = out.opt_state
        losses.append(out.loss.detach().clone())
    return torch.stack(losses), torch.cat(
        [p.detach().reshape(-1) for p in model.parameters()])


@pytest.fixture
def host_groups(monkeypatch):
    """A world-1 host group of each package in turn: yields a function
    that runs ``fn`` inside the named package's group."""
    from distributed_pytorch_tpu.runtime import context as jcontext
    from distributed_pytorch_tpu_torch.runtime import context as pcontext
    from distributed_pytorch_tpu_torch.runtime.launcher import \
        find_free_port
    monkeypatch.setenv("DPX_MULTIPROC_ACCEL", "cpu")

    def run(pkg, fn):
        monkeypatch.setenv("DPX_MASTER_PORT", str(find_free_port()))
        ctx = jcontext if pkg == "jax" else pcontext
        ctx.init_process_group(0, 1, backend="host")
        try:
            return fn()
        finally:
            ctx.destroy_process_group()
    return run


@pytest.mark.parametrize("overlap", [False, True], ids=["plain", "overlap"])
def test_host_step_spans_equal_jax(host_groups, tmp_path, overlap):
    trees = {}
    for pkg, tr, mon, fn in (("jax", jtrace, jmetrics, _jax_host_steps),
                             ("port", ptrace, pmetrics, _port_host_steps)):
        log = tmp_path / f"{pkg}.jsonl"
        tr.configure(enabled=True, log_path=str(log))
        mon.configure(enabled=True)
        host_groups(pkg, lambda: fn(overlap))
        recs, bad = pexport.read_log(str(log))
        assert bad == []
        trees[pkg] = _tree(recs)
        assert mon.snapshot()["train.steps"] == STEPS
    assert trees["port"] == trees["jax"]
    assert [n for n, _, _ in trees["port"]] == ["host_step"] * STEPS
    kids = [n for n, _, _ in trees["port"][0][2]]
    assert kids == (["backward", "bucket", "update"] if not overlap
                    else ["backward"] + ["bucket", "update"] * 2)
    bucket = trees["port"][0][2][1]
    assert [n for n, _, _ in bucket[2]] == ["comm:allreduce_sum"]


def test_tracing_changes_no_loss_or_parameter(host_groups, tmp_path):
    runs = []
    for enabled in (False, True, False):
        ptrace.configure(enabled=enabled, log_path=str(tmp_path / "t.jsonl"))
        pmetrics.configure(enabled=enabled, every=1 if enabled else 0)
        runs.append(host_groups("port", lambda: _port_host_steps(False)))
    for losses, params in runs[1:]:
        assert torch.equal(losses, runs[0][0])
        assert torch.equal(params, runs[0][1])
    assert (tmp_path / "t.jsonl").exists()


# -- serving ------------------------------------------------------------------

def _lm():
    from distributed_pytorch_tpu_torch import TransformerLM
    torch.manual_seed(0)
    return TransformerLM(vocab=61, dim=32, n_layers=1, n_heads=4,
                         n_kv_heads=2, pos="rope", max_seq=64, device="cpu")


PROMPTS = [(np.arange(5 + i, dtype=np.int32) * (2 + i)) % 61
           for i in range(3)]


def _serve(kind, model):
    from distributed_pytorch_tpu_torch.serve import (DisaggConfig,
                                                     DisaggEngine,
                                                     EngineConfig,
                                                     InferenceEngine,
                                                     SamplingParams)
    eng = (InferenceEngine(model, EngineConfig(n_slots=2, max_len=64))
           if kind == "monolithic" else
           DisaggEngine(model, DisaggConfig(n_slots=2, max_len=64,
                                            page_len=8)))
    with eng:
        hs = [eng.submit(p, SamplingParams(max_new_tokens=4))
              for p in PROMPTS]
        outs = [h.result(timeout=120) for h in hs]
    return hs, outs


@pytest.mark.parametrize("kind", ["monolithic", "disagg"])
def test_request_traces_telescope_to_ttft(tmp_path, kind):
    model = _lm()
    ptrace.configure(enabled=False)
    _, plain = _serve(kind, model)
    log = tmp_path / "serve.jsonl"
    ptrace.configure(enabled=True, log_path=str(log))
    pmetrics.reset()
    pmetrics.configure(enabled=True)
    hs, outs = _serve(kind, model)
    for a, b in zip(outs, plain):
        np.testing.assert_array_equal(a, b)
    recs, bad = pexport.read_log(str(log))
    assert bad == [] and pexport.check_log(recs, bad) == []
    legs = (("serve.queue", "serve.prefill") if kind == "monolithic" else
            ("serve.queue", "serve.prefill", "serve.handoff",
             "serve.decode"))
    for h in hs:
        rec = h.metrics
        spans = [r for r in recs if r.get("trace_id") == rec["trace_id"]]
        by_name = {s["name"]: s for s in spans}
        assert set(by_name) == {"serve.request", "serve.stream", *legs}
        root = by_name["serve.request"]
        assert root["attrs"]["request_id"] == rec["request_id"]
        assert all(s["parent_id"] == root["span_id"]
                   for s in spans if s is not root)
        total_ms = sum(by_name[n]["dur_ns"] for n in legs) / 1e6
        assert total_ms == pytest.approx(rec["ttft_ms"], abs=0.02)
    snap = pmetrics.snapshot()
    assert snap["serve.completed"] == len(PROMPTS)
    assert snap["serve.ttft_ms"]["count"] == len(PROMPTS)
    assert len({h.metrics["trace_id"] for h in hs}) == len(PROMPTS)


# -- checkpoints --------------------------------------------------------------

def _save(pkg, ckpt_dir, async_save):
    if pkg == "jax":
        import jax.numpy as jnp

        from distributed_pytorch_tpu.ckpt.manager import CheckpointManager
        params = {k: jnp.asarray(v) for k, v in hw.mlp_init().items()}
    else:
        from distributed_pytorch_tpu_torch.ckpt.manager import \
            CheckpointManager
        params = {k: torch.from_numpy(v) for k, v in hw.mlp_init().items()}
    mgr = CheckpointManager(str(ckpt_dir), async_save=async_save)
    assert mgr.save(3, params, force=True)
    mgr.wait()


@pytest.mark.parametrize("async_save", [False, True], ids=["sync", "async"])
def test_checkpoint_spans_and_counters_equal_jax(tmp_path, async_save):
    out = {}
    for pkg, tr, mon in (("jax", jtrace, jmetrics),
                         ("port", ptrace, pmetrics)):
        log = tmp_path / f"{pkg}.jsonl"
        tr.configure(enabled=True, log_path=str(log))
        tr.set_rank(0)
        mon.configure(enabled=True)
        _save(pkg, tmp_path / f"ck_{pkg}", async_save)
        recs, bad = pexport.read_log(str(log))
        assert bad == []
        spans = [r for r in recs if r.get("event") == "trace_span"]
        out[pkg] = sorted(
            (s["name"], s.get("attrs", {}),
             sorted(e["name"] for e in s.get("events", [])),
             s["tid"] == "ckpt-io") for s in spans)
        snap = mon.snapshot()
        assert snap["ckpt.saves"] == 1
        assert snap["ckpt.snapshot_ms"]["count"] == 1
        assert snap["ckpt.io_ms"]["count"] == 1
    assert out["port"] == out["jax"]
    names = [n for n, *_ in out["port"]]
    assert sorted(set(names)) == ["ckpt.commit", "ckpt.io", "ckpt.save"]
    assert any(io for n, _, _, io in out["port"] if n == "ckpt.io") \
        == async_save
