"""The port's sharded checkpoint (format 2: ``ckpt/layout.py``,
``manifest.py``, ``writer.py``, ``reader.py``, ``manager.py``) against
the JAX package's, and the LM trainer's ``--sharded-ckpt``.

- Layout and CRC: ``dim_partitions``, ``leaf_layout`` (grid, offsets,
  round-robin writers, spec), ``local_slices`` and ``intersect`` equal
  JAX's on seeded shapes and specs, a dimension that does not divide
  raising ``CkptShapeMismatch`` in both; ``array_crc32c`` equals JAX's
  on f32, bf16, int8 and 0-d arrays.
- One writer, ``dp 4`` (the single-controller layout): the port's
  manifest of an LM's params and adamw state equals JAX's for the same
  values and specs, field for field and CRC for CRC.
- JAX -> port: a checkpoint JAX's ``CheckpointManager(sharded=True,
  axis_sizes={"dp": 4})`` wrote (after one JAX adamw step) restores in
  the port bit for bit at world 1, and over two gloo ranks under ZeRO-3
  into each rank's local shards, each rank reading half the sharded
  bytes (``ReadStats``).
- Port -> JAX: what the port writes over two gloo ranks (ZeRO-3) and
  over four at ``dp 2 x tp 2`` (ZeRO-3 + tensor parallelism: owners that
  do not hold their pieces get them in one collective) restores in JAX's
  ``restore_checkpoint`` at world 1 equal to the port's gathered state,
  and its manifest equals JAX's plan of the same state and specs: keys,
  shapes, dtypes, spec, grid, offsets, writer and CRC.
- Typed failures as ``tests/test_ckpt_sharded.py`` covers them: a
  corrupt shard, a truncated manifest, a missing shard file, a template
  mismatch, a format-1 directory at ``restore_sharded``, an IO error
  that never commits, a barrier off the control thread; the async save's
  phases on their threads and the ``ckpt_save`` / ``ckpt_restore``
  events.
- The trainer: ``--sharded-ckpt`` resumes bit for bit at world 1 and
  over two gloo ranks with ``--fsdp``; a world-2 checkpoint resumes at
  world 1 exactly as the same state does from a format-1 copy that JAX
  wrote of it.

Serial run time ~75 s (four launches of two ranks, one of four).
"""

import json
import os
import shutil
import threading
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

import _torch_ckpt_workers as cw
import _torch_fsdp_workers as fw
from _torch_port import launch_cpu_ranks
from distributed_pytorch_tpu import models as jmodels
from distributed_pytorch_tpu import optim as joptim
from distributed_pytorch_tpu.ckpt import CheckpointManager as JManager
from distributed_pytorch_tpu.ckpt import integrity as jintegrity
from distributed_pytorch_tpu.ckpt import layout as jlayout
from distributed_pytorch_tpu.ckpt import writer as jwriter
from distributed_pytorch_tpu.ops.losses import cross_entropy as jax_ce
from distributed_pytorch_tpu.parallel import fsdp as jfsdp
from distributed_pytorch_tpu.parallel import tensor as jtensor
from distributed_pytorch_tpu.utils import checkpoint as jck
from distributed_pytorch_tpu_torch import to_jax_params
from distributed_pytorch_tpu_torch.ckpt import (CheckpointManager,
                                                CkptCorrupt, CkptError,
                                                CkptIncomplete,
                                                CkptShapeMismatch,
                                                ReadStats, Target,
                                                clear_trace, integrity,
                                                layout, restore_sharded,
                                                trace_log)
from distributed_pytorch_tpu_torch.examples import train_transformer_lm
from distributed_pytorch_tpu_torch.parallel import fsdp
from distributed_pytorch_tpu_torch.parallel.tensor import P
from distributed_pytorch_tpu_torch.utils import checkpoint as tck


def _jp(spec):
    return None if spec is None else JP(*spec)


def _leaves_np(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


@pytest.fixture(autouse=True)
def _clean_trace():
    clear_trace()
    yield
    clear_trace()


# -- layout and CRC ---------------------------------------------------------

def _layout_cases():
    rng = np.random.default_rng(7)
    cases = [((8, 4), ("dp", None), {"dp": 4}, 4),
             ((2, 8), (None, ("dp", "tp")), {"dp": 2, "tp": 2}, 4),
             ((6,), ("tp",), {"dp": 2}, 2),
             ((3, 3), None, {"dp": 4}, 1),
             ((16, 12), ("dp", "tp"), {"dp": 2, "tp": 3}, 6),
             ((), (), {"dp": 4}, 4)]
    for _ in range(10):
        nd = int(rng.integers(1, 4))
        sizes = {"dp": int(rng.choice([1, 2, 4])),
                 "tp": int(rng.choice([1, 2]))}
        shape, spec = [], []
        for d in range(nd):
            ax = rng.choice(["dp", "tp", None, None])
            k = sizes[ax] if ax else 1
            shape.append(int(k * rng.integers(1, 5)))
            spec.append(None if ax is None or ax in spec else str(ax))
        cases.append((tuple(shape), tuple(spec), sizes,
                      int(rng.integers(1, 5))))
    return cases


@pytest.mark.parametrize("shape,spec,axes,writers", _layout_cases())
def test_layout_equals_jax(shape, spec, axes, writers):
    ps = None if spec is None else P(*spec)
    got = layout.leaf_layout("k", shape, "float32", ps, axes, writers)
    want = jlayout.leaf_layout("k", shape, "float32", _jp(spec), axes,
                               writers)
    assert got.grid == want.grid and got.spec == want.spec
    assert [(s.index, s.offsets, s.writer) for s in got.shards] == \
        [(s.index, s.offsets, s.writer) for s in want.shards]
    for coords in ({"dp": c, "tp": t} for c in range(axes["dp"])
                   for t in range(axes.get("tp", 1))):
        req = layout.local_slices(shape, ps, axes, coords)
        assert req == jlayout.local_slices(shape, _jp(spec), axes, coords)
        assert [layout.intersect(s, req) for s in got.shards] == \
            [jlayout.intersect(s, req) for s in want.shards]


@pytest.mark.parametrize("shape,spec,axes", [
    ((6,), ("dp",), {"dp": 4}), ((4, 10), (None, ("dp", "tp")),
                                 {"dp": 2, "tp": 3})])
def test_non_dividing_dim_is_typed_in_both(shape, spec, axes):
    from distributed_pytorch_tpu.ckpt.errors import \
        CkptShapeMismatch as JMismatch
    with pytest.raises(JMismatch):
        jlayout.dim_partitions(_jp(spec), shape, axes)
    with pytest.raises(CkptShapeMismatch):
        layout.dim_partitions(P(*spec), shape, axes)
    with pytest.raises(CkptShapeMismatch, match="out of range"):
        layout.local_slices((8,), P("dp"), {"dp": 4}, {"dp": 5})


@pytest.mark.parametrize("kind", ["f32", "bf16", "int8", "0d"])
def test_array_crc32c_equals_jax(kind):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((37, 5)).astype(np.float32)
    if kind == "f32":
        port, ref = torch.from_numpy(x), x
    elif kind == "bf16":
        port = torch.from_numpy(x).to(torch.bfloat16)
        ref = np.asarray(jnp.asarray(x, jnp.bfloat16))
        assert integrity.array_crc32c(port) == integrity.array_crc32c(
            port.view(torch.int16).numpy())
    elif kind == "int8":
        q = rng.integers(-128, 128, (64,)).astype(np.int8)
        port, ref = torch.from_numpy(q), q
    else:
        port, ref = torch.tensor(3.25), np.float32(3.25)
    assert integrity.array_crc32c(port) == jintegrity.array_crc32c(ref)
    assert integrity.array_crc32c(np.asarray(ref)) == \
        jintegrity.array_crc32c(ref)


# -- one writer, the JAX manifest --------------------------------------------

def _jax_lm_state(seed=0, steps=1):
    """JAX LM params and adamw state after ``steps`` steps (so the
    moments are not zero), as numpy trees."""
    jm = jmodels.TransformerLM(**fw.LM)
    params = jm.init(jax.random.PRNGKey(seed))
    opt = joptim.adamw(fw.LR, eps=fw.EPS)
    state = opt.init(params)
    rng = np.random.default_rng(seed + 5)
    x = rng.integers(0, fw.LM["vocab"], (2, fw.LM["max_seq"]))
    y = rng.integers(0, fw.LM["vocab"], (2, fw.LM["max_seq"]))
    for _ in range(steps):
        grads = jax.grad(lambda p: jax_ce(jm.apply(p, x), y))(params)
        params, state = opt.update(grads, state, params)
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return jm, np_tree(params), state._replace(
        mu=np_tree(state.mu), nu=np_tree(state.nu),
        step=np.asarray(state.step))


def _port_model_state(params_np, state):
    """The port LM and adamw state holding the JAX values."""
    model = fw.build(params_np)
    port = fw.optimizer("adamw").init(model.parameters())
    for key, s in tck._slots(model)[1]:
        for dst, src in ((port.mu, state.mu), (port.nu, state.nu)):
            dst[s.index].copy_(s.from_jax(torch.from_numpy(
                np.array(_get(src, key)))))
    return model, port._replace(step=int(state.step))


def _get(tree, key):
    for part in tck._split_escaped(key):
        tree = tree[tck._unescape(part)] if isinstance(tree, dict) \
            else tree[int(part)]
    return tree


def test_world1_manifest_equals_jax(tmp_path):
    jm, params, state = _jax_lm_state()
    p_specs = jfsdp.fsdp_param_specs(params, 4)
    with JManager(str(tmp_path / "j"), sharded=True, param_specs=p_specs,
                  axis_sizes={"dp": 4}) as mgr:
        mgr.save(3, params, state, extra={"epoch": 1})
    model, pstate = _port_model_state(params, state)
    with CheckpointManager(str(tmp_path / "t"), sharded=True,
                           param_specs=fsdp.fsdp_param_specs(model, 4),
                           axis_sizes={"dp": 4}, async_save=True) as mgr:
        mgr.save(3, model, pstate, extra={"epoch": 1})
    want = json.load(open(tmp_path / "j" / "step_3" / "manifest.json"))
    got = json.load(open(tmp_path / "t" / "step_3" / "manifest.json"))
    assert got == want
    assert mgr.saves[-1]["moved_bytes"] == 0
    # the optimizer specs of shard_layouts (the port's per-parameter
    # lists) write the same manifest as the ones the manager derives
    p_specs, o_specs, axes = fsdp.shard_layouts(model, pstate, n_shards=4)
    with CheckpointManager(str(tmp_path / "o"), sharded=True,
                           param_specs=p_specs, opt_specs=o_specs,
                           axis_sizes=axes) as mgr:
        mgr.save(3, model, pstate, extra={"epoch": 1})
    assert json.load(open(tmp_path / "o" / "step_3" / "manifest.json")) \
        == want


# -- JAX -> port ---------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_ckpt(tmp_path_factory):
    d = tmp_path_factory.mktemp("jax_dp4")
    jm, params, state = _jax_lm_state()
    with JManager(str(d), sharded=True,
                  param_specs=jfsdp.fsdp_param_specs(params, 4),
                  axis_sizes={"dp": 4}) as mgr:
        mgr.save(1, params, state)
    return str(d), params, state


def _assert_state_equal(p_tree, o_tree, params, state):
    for a, b in zip(_leaves_np(p_tree), _leaves_np(params)):
        np.testing.assert_array_equal(a, b)
    assert int(np.asarray(o_tree["step"])) == int(state.step)
    for field in ("mu", "nu"):
        for a, b in zip(_leaves_np(o_tree[field]),
                        _leaves_np(getattr(state, field))):
            np.testing.assert_array_equal(a, b)


def test_jax_written_restores_in_the_port_world1(jax_ckpt):
    d, params, state = jax_ckpt
    _, other, _ = _jax_lm_state(seed=3, steps=0)
    model = fw.build(other)
    opt = fw.optimizer("adamw")
    st = ReadStats()
    ck = restore_sharded(d, like_params=model,
                         like_opt_state=opt.init(model.parameters()),
                         stats=st)
    assert ck.params is model and ck.step == 1
    for a, b in zip(_leaves_np(to_jax_params(model)), _leaves_np(params)):
        np.testing.assert_array_equal(a, b)
    o = tck.jax_opt_state(ck.opt_state, model)
    _assert_state_equal(params, {"step": o.step, "mu": o.mu, "nu": o.nu},
                        params, state)
    man = json.load(open(os.path.join(d, "step_1", "manifest.json")))
    total = sum(s["nbytes"] for t in man["trees"].values()
                for lf in t["leaves"] for s in lf["shards"])
    assert st.bytes == total
    # through the format dispatch, and a slice at dp 2
    half = ReadStats()
    t = restore_sharded(d, stats=half, target=Target(
        specs={"params": fsdp.fsdp_param_specs(params, 2)},
        axis_sizes={"dp": 2}, coords={"dp": 1}))
    sharded = [lf for lf in man["trees"]["params"]["leaves"]
               if max(lf["grid"]) > 1]
    assert half.bytes < total
    leaf = sharded[0]
    d0 = leaf["grid"].index(4)
    got = _get(t.params, leaf["key"]).numpy()
    full = _get(params, leaf["key"])
    n = full.shape[d0] // 2
    np.testing.assert_array_equal(got, np.take(full, range(n, 2 * n), d0))


def test_jax_written_restores_under_zero3_world2(jax_ckpt, tmp_path):
    d, params, state = jax_ckpt
    _, other, _ = _jax_lm_state(seed=3, steps=0)
    launch_cpu_ranks(cw.zero3_restore_worker, 2, str(tmp_path), d, other)
    rec = torch.load(tmp_path / "restored.pt", weights_only=False)
    assert rec["step"] == 1 and any("Shard" in p for p in rec["placements"])
    _assert_state_equal(rec["params"], rec["opt_state"], params, state)
    man = json.load(open(os.path.join(d, "step_1", "manifest.json")))
    want_bytes, want_members = 0, 0
    for tree in man["trees"].values():
        for lf in tree["leaves"]:
            nb = sum(s["nbytes"] for s in lf["shards"])
            k = len(lf["shards"])
            want_bytes += nb // 2 if k == 4 else nb
            want_members += 2 if k == 4 else k
    # each rank reads the two saved quarters that make its half
    assert rec["reads"] == [[want_bytes, want_members]] * 2


# -- port -> JAX ---------------------------------------------------------------

def _jax_plan(saved, jspecs, world):
    """JAX's plan of the port's gathered state: its layouts and the CRC
    of each shard of the same values."""
    st = saved["opt_state"]
    jstate = joptim.AdamWState(step=np.asarray(st["step"], np.int32),
                               mu=st["mu"], nu=st["nu"])
    o_specs = jfsdp.opt_state_specs(jstate, jspecs, params=saved["params"])
    plan = jwriter.plan_trees({"params": saved["params"],
                               "opt_state": jstate},
                              {"params": jspecs, "opt_state": o_specs},
                              saved["axes"], world)
    out = {}
    for name, meta in plan.items():
        rows = []
        for lay, arr in zip(meta["layouts"], meta["arrays"]):
            rows.append({"key": lay.key, "shape": list(lay.shape),
                         "dtype": lay.dtype,
                         "spec": [list(s) if isinstance(s, tuple) else s
                                  for s in lay.spec],
                         "grid": list(lay.grid),
                         "shards": [(list(sh.index),
                                     [list(o) for o in sh.offsets],
                                     sh.writer,
                                     jintegrity.array_crc32c(
                                         np.ascontiguousarray(
                                             arr[sh.slices()])))
                                    for sh in lay.shards]})
        out[name] = rows
    return out


@pytest.mark.parametrize("world,tp", [(2, False), (4, True)],
                         ids=["dp2", "dp2xtp2"])
def test_port_written_restores_in_jax(tmp_path, world, tp):
    jm, params, _ = _jax_lm_state(steps=0)
    rng = np.random.default_rng(11)
    batches = [tuple(rng.integers(0, fw.LM["vocab"],
                                  (4, fw.LM["max_seq"])) for _ in range(2))
               for _ in range(2)]
    ck = str(tmp_path / "ck")
    launch_cpu_ranks(cw.save_worker, world, str(tmp_path), ck, params,
                     batches, tp)
    saved = torch.load(tmp_path / "saved.pt", weights_only=False)
    got = jck.restore_checkpoint(ck)
    assert got.step == 2 and got.extra == {"epoch": 0}
    _assert_state_equal(got.params, got.opt_state, saved["params"],
                        joptim.AdamWState(**saved["opt_state"]))
    base = jtensor.transformer_lm_param_specs(jm) if tp else None
    jspecs = jfsdp.fsdp_param_specs(params, 2, base_specs=base)
    plan = _jax_plan(saved, jspecs, world)
    man = json.load(open(os.path.join(ck, "step_2", "manifest.json")))
    assert man["format"] == 2 and man["mesh"] == {
        "axes": saved["axes"], "writer_world": world}
    for name, rows in plan.items():
        leaves = man["trees"][name]["leaves"]
        assert [lf["key"] for lf in leaves] == [r["key"] for r in rows]
        for lf, r in zip(leaves, rows):
            for k in ("shape", "dtype", "spec", "grid"):
                assert lf[k] == r[k], (lf["key"], k)
            assert [(s["index"], s["offsets"], s["writer"], s["crc32c"])
                    for s in lf["shards"]] == r["shards"], lf["key"]
    written = saved["written"]
    assert sum(w[0] for w in written) == sum(
        s["nbytes"] for t in man["trees"].values() for lf in t["leaves"]
        for s in lf["shards"])
    moved = [w[2] for w in written]
    # at dp 2 every owner holds its piece; at dp 2 x tp 2 the shards dealt
    # to a rank of the other dp row move in the one exchange
    assert (sum(moved) > 0) == tp


# -- typed failures, threads, events -----------------------------------------

def _state():
    params = {"w": np.arange(64, dtype=np.float32).reshape(16, 4),
              "b": np.ones(16, np.float32), "scale": np.float32(0.5)}
    specs = {"w": P("dp", None), "b": P("dp"), "scale": P()}
    return params, specs


def _saved(tmp_path, step=3):
    params, specs = _state()
    with CheckpointManager(str(tmp_path), sharded=True, param_specs=specs,
                           axis_sizes={"dp": 4}) as mgr:
        mgr.save(step, params)
    return params, specs


def test_roundtrip_reshards_and_one_file_for_one_writer(tmp_path):
    params, specs = _saved(tmp_path, step=1)
    assert set(os.listdir(tmp_path / "step_1")) == {
        "manifest.json", "manifest_r0.json", "shard_r0.npz"}
    with zipfile.ZipFile(tmp_path / "step_1" / "shard_r0.npz") as z:
        assert len(z.namelist()) == 9
    for m in (1, 2, 8):
        t = Target(specs={"params": specs}, axis_sizes={"dp": m},
                   coords={"dp": m - 1})
        st = ReadStats()
        ck = restore_sharded(str(tmp_path), target=t, stats=st)
        lo, hi = 16 // m * (m - 1), 16 // m * m
        np.testing.assert_array_equal(ck.params["w"].numpy(),
                                      params["w"][lo:hi])
        np.testing.assert_array_equal(ck.params["b"].numpy(),
                                      params["b"][lo:hi])
        sharded = params["w"].nbytes + params["b"].nbytes
        assert st.bytes == sharded // min(m, 4) + 4


def test_corrupt_shard_is_typed_with_attribution(tmp_path):
    _saved(tmp_path)
    npz = tmp_path / "step_3" / "shard_r0.npz"
    info = zipfile.ZipFile(npz).infolist()[0]
    raw = bytearray(npz.read_bytes())
    raw[info.header_offset + 30 + len(info.filename) + 80] ^= 0x01
    npz.write_bytes(bytes(raw))
    with pytest.raises(CkptCorrupt) as ei:
        restore_sharded(str(tmp_path))
    assert ei.value.step == 3 and "shard_r0.npz" in ei.value.shard


def test_truncated_manifest_is_incomplete(tmp_path):
    _saved(tmp_path)
    mpath = tmp_path / "step_3" / "manifest.json"
    mpath.write_text(mpath.read_text()[:100])
    with pytest.raises(CkptIncomplete) as ei:
        tck.restore_checkpoint(str(tmp_path))
    assert ei.value.step == 3


def test_missing_shard_file_is_incomplete(tmp_path):
    _saved(tmp_path)
    os.remove(tmp_path / "step_3" / "shard_r0.npz")
    with pytest.raises(CkptIncomplete, match="shard_r0.npz"):
        restore_sharded(str(tmp_path))


def test_template_mismatch_is_shape_mismatch(tmp_path):
    _saved(tmp_path)
    with pytest.raises(CkptShapeMismatch):
        restore_sharded(str(tmp_path), like_params={"only": np.zeros(1)})


def test_format1_dir_rejected_by_the_sharded_door(tmp_path):
    tck.save_checkpoint(str(tmp_path), 1, {"w": np.ones(2, np.float32)})
    with pytest.raises(CkptError, match="format-1"):
        restore_sharded(str(tmp_path))


def test_async_io_error_surfaces_and_never_commits(tmp_path, monkeypatch):
    from distributed_pytorch_tpu_torch.ckpt import writer

    def boom(*a, **k):
        raise OSError("disk full")
    monkeypatch.setattr(writer, "write_shards", boom)
    params, specs = _state()
    mgr = CheckpointManager(str(tmp_path), sharded=True, async_save=True,
                            param_specs=specs, axis_sizes={"dp": 4})
    mgr.save(1, params)
    with pytest.raises(OSError, match="disk full"):
        mgr.wait()
    assert tck.available_steps(str(tmp_path)) == []


def test_barrier_off_the_control_thread_is_typed(tmp_path):
    _, specs = _state()
    mgr = CheckpointManager(str(tmp_path), sharded=True, param_specs=specs,
                            axis_sizes={"dp": 4})
    caught = []

    def off_thread():
        try:
            # dpxlint: disable=DPX001 deliberate violation: this test asserts the runtime guard raises
            mgr._barrier()
        except BaseException as e:  # noqa: BLE001 — the test inspects it
            caught.append(e)
    t = threading.Thread(target=off_thread, name="test-off-thread")
    t.start()
    t.join()
    assert len(caught) == 1 and isinstance(caught[0], CkptError)
    assert "control thread" in str(caught[0])


def test_async_phases_threads_and_events(tmp_path, monkeypatch):
    log = tmp_path / "metrics.jsonl"
    monkeypatch.setenv("DPX_METRICS_LOG", str(log))
    params, specs = _state()
    with CheckpointManager(str(tmp_path / "ck"), sharded=True,
                           async_save=True, param_specs=specs,
                           axis_sizes={"dp": 4}) as mgr:
        mgr.save(1, params)
        assert mgr._pending is not None          # commit deferred
        mgr.save(2, params)
    phases = trace_log()
    assert {th for ph, th in phases if ph == "io"} == {"ckpt-io"}
    assert all(th == "MainThread" for ph, th in phases
               if ph in ("barrier", "commit", "d2h"))
    tck.restore_checkpoint(str(tmp_path / "ck"))
    events = [json.loads(x) for x in open(log)]
    saves = [e for e in events if e["event"] == "ckpt_save"]
    restores = [e for e in events if e["event"] == "ckpt_restore"]
    assert saves[0]["step"] == 1 and saves[0]["sharded"] is True
    assert saves[0]["async_save"] is True and saves[0]["shards"] == 9
    assert restores[0]["saved_axes"] == {"dp": 4}


# -- the trainer ---------------------------------------------------------------

LM_ARGS = ["--device", "cpu", "--batch-size", "2", "--seq-len", "16",
           "--dim", "32", "--n-layers", "2", "--n-heads", "4",
           "--data-size", "64", "--log-every", "1"]


def _losses(rec_dir, rank=0):
    return torch.load(os.path.join(rec_dir, f"rank{rank}.pt"),
                      weights_only=False)


def test_trainer_sharded_resume_world1_exact(tmp_path):
    ck = str(tmp_path / "ck")
    full = train_transformer_lm.main_worker(
        0, 0, LM_ARGS + ["--steps", "10"], quiet=True)
    train_transformer_lm.main_worker(
        0, 0, LM_ARGS + ["--steps", "6", "--save", ck, "--save-every", "3",
                         "--sharded-ckpt"], quiet=True)
    assert os.path.exists(os.path.join(ck, "step_5", "shard_r0.npz"))
    rec = train_transformer_lm.main_worker(
        0, 0, LM_ARGS + ["--steps", "10", "--save", ck, "--sharded-ckpt",
                         "--resume"], quiet=True)
    assert rec["start_step"] == 6
    assert rec["losses"] == full["losses"][6:]


def test_trainer_sharded_resume_world2_fsdp_and_at_world1(tmp_path):
    ck = str(tmp_path / "ck")
    a, b, c = (tmp_path / n for n in ("a", "b", "c"))
    for p in (a, b, c):
        p.mkdir()
    w2 = LM_ARGS + ["--fsdp"]
    launch_cpu_ranks(train_transformer_lm.main_worker, 2,
                     w2 + ["--steps", "6", "--save", ck, "--save-every",
                           "3", "--sharded-ckpt"], True, None, str(a))
    man = json.load(open(os.path.join(ck, "step_5", "manifest.json")))
    assert man["mesh"] == {"axes": {"dp": 2}, "writer_world": 2}
    assert {"shard_r0.npz", "shard_r1.npz"} <= set(
        os.listdir(os.path.join(ck, "step_5")))
    ck5 = str(tmp_path / "ck5")
    shutil.copytree(ck, ck5)          # step 5 stays the latest there
    launch_cpu_ranks(train_transformer_lm.main_worker, 2,
                     w2 + ["--steps", "8", "--save", ck, "--sharded-ckpt",
                           "--resume"], True, None, str(b))
    launch_cpu_ranks(train_transformer_lm.main_worker, 2,
                     w2 + ["--steps", "8"], True, None, str(c))
    resumed, full = _losses(b), _losses(c)
    assert resumed["start_step"] == 6
    assert resumed["losses"] == full["losses"][6:]
    # the world-2 checkpoint at world 1: exactly what the same state
    # continues to from a format-1 copy that JAX wrote of it
    f1 = str(tmp_path / "f1")
    j = jck.restore_checkpoint(ck5, step=5)
    jck.save_checkpoint(f1, 5, j.params, joptim.AdamWState(
        step=np.asarray(j.opt_state["step"], np.int32),
        mu=j.opt_state["mu"], nu=j.opt_state["nu"]), extra=j.extra)
    w1 = LM_ARGS + ["--batch-size", "4", "--steps", "8", "--resume"]
    from_sharded = train_transformer_lm.main_worker(
        0, 0, w1 + ["--save", ck5, "--sharded-ckpt"], quiet=True)
    from_f1 = train_transformer_lm.main_worker(
        0, 0, w1 + ["--save", f1], quiet=True)
    assert from_sharded["start_step"] == from_f1["start_step"] == 6
    assert from_sharded["losses"] == from_f1["losses"]
