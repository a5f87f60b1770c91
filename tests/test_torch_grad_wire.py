"""``make_train_step``'s gradient wire on both doors of the port, on CPU
ranks.

A 2-layer MLP (weights and batches from seeds, its parameters in the JAX
package's tree order) trains 4 steps at world 2 in every arm of
``_torch_host_workers.TRAIN_ARMS`` (``grad_reduce`` mean / quant / int8 /
q4 / adaptive, the overlapped buckets at mean and quant, ZeRO-1 at mean
and quant, all under adamw; quant under sgd), once over the native host
group and once over gloo:

* ``mean`` equals world 1 on the concatenated batch and the JAX
  package's host door on the same weights and batches (rtol 2e-5), and
  the overlapped and ZeRO-1 ``mean`` arms equal it bit for bit;
* the quantized arms' parameters are equal on both ranks, and their
  losses stay within the stated bound of the exact run's
  (``QUANT_LOSS_RTOL``: one quantization step per hop on gradients of
  this size moves a 4-step loss by well under it);
* the quantized host door (quant, q4, adaptive, the overlapped buckets
  at quant, and quant under sgd, whose step shows the division by the
  world) equals the JAX package's host door on the same inputs after
  each of the first and the last step, to a few float32 ulps
  (``JAX_PARAM_ATOL``), and its first step equals the numpy specs
  (error feedback, ``simulate_quant_ring``, ``/ world``, the update)
  bit for bit;
* ZeRO-1 ``quant`` over the host group equals the numpy leg specs
  (``simulate_quant_reduce_scatter`` / ``simulate_quant_allgather`` and
  the port's adamw on the owned slice) after its first step, exactly;
* the overlap accounting: one ring call per bucket per step, buckets
  reported by ``on_bucket_ready`` covering the gradients, and no time
  booked as overlapped on CPU ranks (an update is done when its call
  returns).

Then the validations, in this process. Launches are bounded by 120 s.
Serial run time ~45 s.
"""

import json

import numpy as np
import pytest
import torch

import _torch_host_workers as hw
from _torch_port import launch_cpu_ranks
from distributed_pytorch_tpu.runtime.multiprocess import \
    launch_multiprocess as jax_launch
from distributed_pytorch_tpu_torch import optim
from distributed_pytorch_tpu_torch.comm import wire
from distributed_pytorch_tpu_torch.optim import adafactor, adamw
from distributed_pytorch_tpu_torch.optim.schedules import with_clipping
from distributed_pytorch_tpu_torch.optim.sharded import build_layout
from distributed_pytorch_tpu_torch.ops.quant import ErrorFeedback
from distributed_pytorch_tpu_torch.parallel import make_train_step
from distributed_pytorch_tpu_torch.runtime import context

WORLD = 2
QUANT_LOSS_RTOL = {"quant": 2e-2, "int8": 2e-2, "q4": 1e-1,
                   "adaptive": 1e-1, "overlap_quant": 2e-2,
                   "sharded_quant": 2e-2}
# the parameters here are below 1.5 in magnitude: 1e-6 is under ten
# float32 ulps of them, and two orders under what one more grid step of
# the gradient, a skipped division by the world or a skipped error
# feedback moves them by over these steps
JAX_PARAM_ATOL = 1e-6


def _run(tmp_path_factory, backend):
    out = tmp_path_factory.mktemp(f"grad_wire_{backend}")
    launch_cpu_ranks(hw.train_worker, WORLD, str(out),
                     backend="host" if backend == "host" else None)
    recs = [json.loads((out / f"rank{r}.json").read_text())
            for r in range(WORLD)]
    return out, recs


@pytest.fixture(scope="module")
def host_run(tmp_path_factory):
    return _run(tmp_path_factory, "host")


@pytest.fixture(scope="module")
def gloo_run(tmp_path_factory):
    return _run(tmp_path_factory, "gloo")


@pytest.fixture(params=["host", "gloo"])
def run(request, host_run, gloo_run):
    return request.param, *(host_run if request.param == "host"
                            else gloo_run)


def _params(out, label, rank):
    return np.load(out / f"{label}_rank{rank}.npy")


@pytest.fixture(scope="module")
def world1():
    """The exact arm at world 1 (no group) on both ranks' batches at
    once."""
    model = hw.port_mlp()
    opt = adamw(hw.TRAIN_LR)
    step = make_train_step(hw.port_mlp_loss, opt)
    state = opt.init(model.parameters())
    for t in range(hw.TRAIN_STEPS):
        xs, ys = zip(*(hw.mlp_batch(r, t) for r in range(WORLD)))
        state = step(model, state, (torch.from_numpy(np.concatenate(xs)),
                                    torch.from_numpy(np.concatenate(ys)))
                     ).opt_state
    return torch.cat([p.detach().reshape(-1)
                      for p in model.parameters()]).numpy()


@pytest.fixture(scope="module")
def jax_host(tmp_path_factory):
    out = tmp_path_factory.mktemp("grad_wire_jax")
    jax_launch(hw.jax_train_worker, WORLD, str(out))
    return out


def test_the_runs_use_their_backend(run):
    backend, _, recs = run
    assert [r["backend"] for r in recs] == [backend] * WORLD


def test_mean_equals_world1_and_the_jax_host_door(run, world1, jax_host):
    _, out, recs = run
    for r in range(WORLD):
        got = _params(out, "mean", r)
        np.testing.assert_allclose(got, world1, rtol=2e-5, atol=1e-7)
        np.testing.assert_allclose(got, np.load(jax_host / f"jax_mean_rank"
                                                f"{r}.npy"),
                                   rtol=2e-5, atol=1e-7)
    assert recs[0]["mean"]["params"] == recs[1]["mean"]["params"]


@pytest.mark.parametrize("label", ["overlap_mean", "sharded_mean"])
def test_exact_arms_equal_the_replicated_mean_bit_for_bit(run, label):
    _, _, recs = run
    for rec in recs:
        assert rec[label]["params"] == rec["mean"]["params"]
        assert rec[label]["losses"] == rec["mean"]["losses"]


@pytest.mark.parametrize("label", sorted(QUANT_LOSS_RTOL))
def test_quantized_arms_agree_across_ranks_and_track_the_exact_run(
        run, label):
    backend, _, recs = run
    assert recs[0][label]["params"] == recs[1][label]["params"]
    for rec in recs:
        np.testing.assert_allclose(rec[label]["losses"],
                                   rec["mean"]["losses"],
                                   rtol=QUANT_LOSS_RTOL[label])
    if label == "overlap_quant" and backend == "gloo":
        # the torch.distributed door has no buckets: the quant arm
        assert recs[0][label]["params"] == recs[0]["quant"]["params"]
    if label in ("quant", "q4", "sharded_quant") and backend == "host":
        assert recs[0][label]["params"] != recs[0]["mean"]["params"]


def test_adaptive_chooser_history(run):
    _, _, recs = run
    for rec in recs:
        assert len(rec["adaptive"]["widths"]) == hw.TRAIN_STEPS
        assert rec["adaptive"]["widths"][:2] == [8, 8]
    assert recs[0]["adaptive"]["widths"] == recs[1]["adaptive"]["widths"]


def test_overlap_accounting(host_run):
    _, recs = host_run
    n_params = sum(v.size for v in hw.mlp_init().values())
    for rec in recs:
        for label, op in (("overlap_quant", "allreduce_q8"),
                          ("overlap_mean", "allreduce_sum")):
            seen = rec[label]["buckets_seen"]
            assert len(seen) == 2 * hw.TRAIN_STEPS
            assert [b for b, _, _ in seen] == [0, 1] * hw.TRAIN_STEPS
            assert sum(nb for _, _, nb in seen[:2]) == 4 * n_params
            stats = rec[label]["stats"][op]
            assert stats["calls"] == 2 * hw.TRAIN_STEPS
            assert stats["overlapped_s"] == 0.0
            assert stats["exposed_s"] == pytest.approx(stats["seconds"])
        assert rec["mean"]["buckets_seen"] == [
            [0, 1, 4 * n_params]] * hw.TRAIN_STEPS
        assert rec["quant"]["stats"]["allreduce_q8"]["bytes"] == \
            hw.TRAIN_STEPS * (wire.quant_ring_allreduce_wire_bytes(
                n_params, WORLD) // WORLD)


@pytest.mark.parametrize("label", hw.JAX_ARMS[1:])
def test_quantized_host_door_equals_the_jax_host_door(host_run, jax_host,
                                                      label):
    """The port's host door and the JAX package's, on the same weights,
    batches and bucket order, after the first step and after the last:
    equal to ``JAX_PARAM_ATOL``, a few float32 ulps of these parameters
    (the two packages' forward, backward and update round differently
    there, and nowhere else: no element moves a whole grid step)."""
    out, _ = host_run
    for r in range(WORLD):
        got = _params(out, label, r)
        np.testing.assert_allclose(
            got, np.load(jax_host / f"jax_{label}_rank{r}.npy"),
            rtol=0, atol=JAX_PARAM_ATOL)
        want1 = np.load(jax_host / f"jax_{label}_step1_rank{r}.npy")
        got1 = np.load(out / f"{label}_step1_rank{r}.npy")
        np.testing.assert_allclose(got1, want1, rtol=0, atol=JAX_PARAM_ATOL)


@pytest.mark.parametrize("label", ["quant", "q4", "quant_sgd"])
def test_replicated_quant_step1_equals_the_numpy_specs(host_run, label):
    """Step 1 of a replicated quantized arm, recomputed from each rank's
    gradient bucket: error feedback onto the wire grid, the ring spec
    (``simulate_quant_ring``), the division by the world, and the port's
    optimizer. Equal bit for bit."""
    out, _ = host_run
    gr, _, _, optimizer = hw.ARMS[label]
    bits = 4 if gr == "q4" else 8
    buckets = [ErrorFeedback().compensate(
        np.load(out / f"{label}_grads0_rank{r}.npy"), bits=bits)
        for r in range(WORLD)]
    summed, _ = wire.simulate_quant_ring(buckets, bits=bits)
    for r in range(WORLD):
        mean = summed[r] / WORLD
        model = hw.port_mlp()
        ps = list(model.parameters())
        gs, off = [], 0
        for p in ps:
            gs.append(torch.from_numpy(mean[off:off + p.numel()].copy())
                      .view_as(p))
            off += p.numel()
        opt = getattr(optim, optimizer)(hw.TRAIN_LR)
        with torch.no_grad():
            opt.update(gs, opt.init(ps), ps)
        want = torch.cat([p.detach().reshape(-1) for p in ps]).numpy()
        rec = json.loads((out / f"rank{r}.json").read_text())
        assert rec[label]["step1"] == hw.sha(want)


def test_sharded_quant_equals_the_numpy_leg_specs(host_run):
    """Step 1 of ZeRO-1 quant, recomputed from each rank's gradient
    bucket: error feedback onto the q8 grid, the reduce-scatter spec,
    the port's adamw on each owned slice, the all-gather spec."""
    out, _ = host_run
    model = hw.port_mlp()
    ps = list(model.parameters())
    lay = build_layout(ps, WORLD)
    flat_p = lay.flatten(ps)
    starts = np.cumsum([0] + list(lay.sizes))
    buckets = []
    for r in range(WORLD):
        g = np.load(out / f"sharded_quant_grads0_rank{r}.npy")
        leaves = [torch.from_numpy(g[a:b]) for a, b in zip(starts[:-1],
                                                           starts[1:])]
        buckets.append(ErrorFeedback().compensate(lay.flatten_np(leaves)))
    bufs, _ = wire.simulate_quant_reduce_scatter(buckets)
    gathered = []
    for r in range(WORLD):
        lo, hi = lay.span(lay.ring_segment(r))
        g = torch.from_numpy(bufs[r][lo:hi] / WORLD)
        master = flat_p[lo:hi].clone()
        opt = adamw(hw.TRAIN_LR)
        opt.update([g], opt.init([master]), [master])
        buf = bufs[r].copy()
        buf[lo:hi] = master.numpy()
        gathered.append(buf)
    full, _ = wire.simulate_quant_allgather(gathered)
    want = torch.cat([t.reshape(-1) for t in
                      lay.unflatten(torch.from_numpy(full[0]))]).numpy()
    for r in range(WORLD):
        rec = json.loads((out / f"rank{r}.json").read_text())
        assert rec["sharded_quant"]["step1"] == hw.sha(want)


# -- validations, in this process ------------------------------------------

def _loss(model, batch):
    return hw.port_mlp_loss(model, batch)


@pytest.mark.parametrize("gr", ["q4", "adaptive"])
def test_sharded_refuses_q4_and_adaptive(gr):
    with pytest.raises(ValueError, match="sharded"):
        make_train_step(_loss, adamw(1e-3), grad_reduce=gr,
                        weight_update="sharded")


def test_modes_and_updates_are_validated(monkeypatch):
    with pytest.raises(ValueError, match="grad_reduce"):
        make_train_step(_loss, adamw(1e-3), grad_reduce="fp8")
    with pytest.raises(ValueError, match="weight_update"):
        make_train_step(_loss, adamw(1e-3), weight_update="zero3")
    monkeypatch.setenv("DPX_WEIGHT_UPDATE", "sharded")
    step = make_train_step(_loss, adamw(1e-3))
    assert hasattr(step, "init_opt_state")
    with pytest.raises(TypeError, match="ELEMENTWISE"):
        make_train_step(_loss, adafactor(1e-3)).init_opt_state(
            hw.port_mlp().parameters())
    with pytest.raises(ValueError, match="clipping"):
        make_train_step(_loss, with_clipping(adamw(1e-3), 1.0))


@pytest.fixture
def host_world1(monkeypatch):
    from distributed_pytorch_tpu_torch.runtime.launcher import \
        find_free_port
    monkeypatch.setenv("DPX_MASTER_PORT", str(find_free_port()))
    monkeypatch.setenv("DPX_MULTIPROC_ACCEL", "cpu")
    context.init_process_group(0, 1, backend="host")
    yield context.get_host_comm()
    context.destroy_process_group()


def test_host_door_at_world1(host_world1):
    """The world-1 host door: every mode trains, ``mean`` equals the
    torch.distributed door's step bit for bit, the overlapped door
    refuses a clipping optimizer and a state not built per bucket."""
    assert context.get_backend() == "host"
    ref = hw.run_port_arm("mean", "replicated", False, 0)
    batch = [torch.from_numpy(a) for a in hw.mlp_batch(0, 0)]
    for gr in ("mean", "quant", "q4", "adaptive"):
        losses, flat, step, _, _ = hw.run_port_arm(gr, "replicated", False,
                                                   0)
        assert np.all(np.isfinite(losses))
        assert set(step.host_times) == {"d2h_s", "codec_s", "ring_s",
                                        "h2d_s"}
        if gr == "mean":
            assert hw.sha(flat) == hw.sha(ref[1])
    with pytest.raises(ValueError, match="clipping"):
        make_train_step(_loss, with_clipping(adamw(1e-3), 1.0),
                        overlap=True)
    step = make_train_step(_loss, adamw(1e-3), overlap=True,
                           comm_buckets=2)
    model = hw.port_mlp()
    with pytest.raises(TypeError, match="init_opt_state"):
        step(model, adamw(1e-3).init(model.parameters()), batch)


# -- the torch.distributed primitives (comm/primitives.py) -----------------

@pytest.fixture(scope="module")
def prims(tmp_path_factory):
    out = tmp_path_factory.mktemp("prims")
    launch_cpu_ranks(hw.primitives_worker, WORLD, str(out))
    return [dict(np.load(out / f"prim_rank{r}.npz")) for r in range(WORLD)]


def _jax_island(fn, xs):
    """``fn`` of the JAX package's primitives over a 2-device mesh, one
    row of ``xs`` per device."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from jax.sharding import PartitionSpec as P

    from distributed_pytorch_tpu.runtime.jax_compat import shard_map
    mesh = Mesh(np.array(jax.devices()[:WORLD]), ("dp",))
    f = shard_map(lambda x: fn(x[0])[None], mesh=mesh, in_specs=(P("dp"),),
                  out_specs=P("dp"), check_vma=False)
    return np.asarray(jax.jit(f)(jnp.asarray(np.stack(xs))))


def test_exact_primitives(prims):
    xs = [hw.prim_input(r) for r in range(WORLD)]
    ms = [x.reshape(4, -1) for x in xs]
    for r, got in enumerate(prims):
        np.testing.assert_array_equal(got["psum"], xs[0] + xs[1])
        np.testing.assert_array_equal(got["pmean"], (xs[0] + xs[1]) / 2)
        np.testing.assert_array_equal(got["pmax"], np.maximum(*xs))
        np.testing.assert_array_equal(got["pmin"], np.minimum(*xs))
        np.testing.assert_array_equal(got["all_gather"], np.stack(ms, 1))
        np.testing.assert_array_equal(got["all_gather_tiled"],
                                      np.concatenate(ms, 1))
        cols = ms[0].shape[1] // WORLD
        np.testing.assert_array_equal(
            got["reduce_scatter"],
            (ms[0] + ms[1])[:, r * cols:(r + 1) * cols])
        rows = ms[0].shape[0] // WORLD
        np.testing.assert_array_equal(
            got["all_to_all"], np.concatenate(
                [m[r * rows:(r + 1) * rows] for m in ms], 1))


def test_quantized_primitives_against_jax_and_the_bound(prims):
    from distributed_pytorch_tpu.comm import primitives as jprim
    xs = [hw.prim_input(r) for r in range(WORLD)]
    block = wire.QUANT_BLOCK
    mean = (xs[0] + xs[1]) / 2
    ref = _jax_island(lambda x: jprim.quantized_pmean(x, "dp"), xs)
    ref_rs = _jax_island(lambda x: jprim.quantized_reduce_scatter(x, "dp"),
                         xs)
    ref_ag = _jax_island(lambda x: jprim.quantized_all_gather(x, "dp"),
                         [x[:2048] for x in xs])
    step = np.repeat(np.maximum(*[wire.block_scales(x) for x in xs]), block)
    for r, got in enumerate(prims):
        # bit-identical on every rank, within one step per leg of the
        # mean, and within one step of the JAX package's
        np.testing.assert_array_equal(got["quantized_pmean"],
                                      prims[0]["quantized_pmean"])
        assert np.all(np.abs(got["quantized_pmean"] - mean) <= step)
        assert np.all(np.abs(got["quantized_pmean"] - ref[r]) <= step)
        q4 = got["quantized_pmean_q4"]
        assert q4.shape == (5000,) and np.abs(q4 - mean[:5000]).max() <= \
            2 * np.abs(mean[:5000]).max() / 7
        half = xs[0].size // WORLD
        np.testing.assert_allclose(got["quantized_reduce_scatter"],
                                   ref_rs[r], atol=1e-5)
        assert np.abs(got["quantized_reduce_scatter"]
                      - (xs[0] + xs[1])[r * half:(r + 1) * half]).max() \
            <= step.max()
        np.testing.assert_array_equal(got["quantized_all_gather"],
                                      prims[0]["quantized_all_gather"])
        np.testing.assert_allclose(got["quantized_all_gather"], ref_ag[r],
                                   atol=1e-5)


def test_primitives_at_world1_and_divisibility():
    from distributed_pytorch_tpu_torch.comm import primitives as prim
    x = torch.arange(8.0)
    for fn in (prim.psum, prim.pmean, prim.pmax, prim.pmin,
               prim.quantized_pmean, prim.quantized_reduce_scatter):
        assert fn(x) is x
    assert prim.all_gather(x).shape == (1, 8)
    assert torch.equal(prim.all_gather(x, tiled=True), x)
    assert torch.equal(prim.quantized_all_gather(torch.ones(1024)),
                       torch.ones(1024))
    with pytest.raises(ValueError, match="divisible"):
        prim.quantized_all_gather(torch.ones(10))


# -- the reference workload over the host group ----------------------------

def _min_ddp_world2(tmp_path, *flags):
    from distributed_pytorch_tpu_torch.examples import min_ddp
    path = tmp_path / f"history{'_'.join(flags)}.json"
    launch_cpu_ranks(min_ddp.main_worker, WORLD,
                     ["--device", "cpu", "--batch-size", "4", *flags], True,
                     str(path), backend="host")
    return json.loads(path.read_text())


def test_min_ddp_over_the_host_group(tmp_path):
    """``examples/min_ddp.py`` at world 2 over the host group: the
    exact wire's reduced losses (a SUM) over 2 equal the unshuffled
    world-1 run at batch 8 (rtol 2e-4, as over gloo), and the quantized
    wire's stay within 1e-2 of them."""
    from distributed_pytorch_tpu_torch.examples import min_ddp
    want_path = tmp_path / "world1.json"
    min_ddp.main_worker(0, 1, ["--device", "cpu"], True, str(want_path),
                        shuffle=False)
    want = json.loads(want_path.read_text())
    mean = _min_ddp_world2(tmp_path)
    quant = _min_ddp_world2(tmp_path, "--grad-reduce", "quant")
    np.testing.assert_allclose(np.array(mean) / 2, want, rtol=2e-4,
                               atol=1e-5)
    np.testing.assert_allclose(quant, mean, rtol=1e-2)
    assert quant != mean
