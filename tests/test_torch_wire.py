"""The port's gradient wire against the JAX package's, on the CPU.

``comm/wire.py`` (codec, segment grid, byte accounting, the numpy ring
specs, ``WidthChooser``), ``ops/quant.py`` (``ErrorFeedback``,
``block_outlier_frac``, the tensor codec) and ``optim/sharded/layout.py``
take the same seeded numpy inputs as the JAX package's and must give
the same bytes, exactly. Then the JAX package's own property cases of
``test_quant_collectives.py``, ``test_adaptive_collectives.py``
(``TestQ4Codec``, ``TestWidthChooser``, ``TestHierSim``) and
``test_sharded_optim.py`` (``TestFlatLayout``, ``TestWireLegSpecs``,
``TestParamResidual``) run against the port's modules, one parametrised
case each. No process is spawned. Serial run time ~10 s.
"""

import numpy as np
import pytest
import torch

from distributed_pytorch_tpu.comm import wire as jwire
from distributed_pytorch_tpu.ops import quant as jquant
from distributed_pytorch_tpu_torch.comm import primitives as tprim
from distributed_pytorch_tpu_torch.comm import wire
from distributed_pytorch_tpu_torch.ops import quant as tquant
from distributed_pytorch_tpu_torch.optim import adamw
from distributed_pytorch_tpu_torch.optim.sharded import (build_layout,
                                                         lcm_pad_multiple,
                                                         shard_optimizer)

BLOCK = wire.QUANT_BLOCK
MIB_ELEMS = 262144


def _ranks(world, n, seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(n) * scale).astype(np.float32)
            for _ in range(world)]


def _same(a, b):
    """Equal values, dtypes and shapes (nested tuples / lists too)."""
    if isinstance(a, (tuple, list)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    else:
        assert a == b


# ---------------------------------------------------------------------------
# the port against the JAX package, bit for bit
# ---------------------------------------------------------------------------

_SIZES = (1, 7, BLOCK - 1, BLOCK, 3 * BLOCK + 123, 70000)
DIFF_CASES = (
    [("segment_blocks", (n, w)) for n in _SIZES for w in (1, 2, 3, 4, 8)]
    + [("ring_owned_span", (n, w, r)) for n in _SIZES for w in (2, 4)
       for r in range(w)]
    + [("block_span_elems", (3, 5, 70000)), ("block_span_elems", (70, 5,
                                                                  70000))]
    + [("span_wire_bytes", (2, 9, 70000, BLOCK, b)) for b in (8, 4)]
    + [(f, (n, w, BLOCK, b)) for f in ("quant_ring_allreduce_wire_bytes",
                                       "quant_leg_wire_bytes")
       for n in _SIZES for w in (1, 2, 4, 8) for b in (8, 4)]
    + [("ring_allreduce_wire_bytes", (n, w, e)) for n in _SIZES
       for w in (1, 2, 4, 8) for e in (4, 8)]
    + [("quant_wire_bytes", (n, BLOCK, b)) for n in _SIZES for b in (8, 4)]
)


@pytest.mark.parametrize("fn,args", DIFF_CASES,
                         ids=[f"{f}{a}" for f, a in DIFF_CASES])
def test_grid_and_accounting_equal_jax(fn, args):
    _same(getattr(wire, fn)(*args), getattr(jwire, fn)(*args))


SIM_CASES = [(sim, w, n, b) for sim in ("simulate_quant_ring",
                                        "simulate_quant_reduce_scatter",
                                        "simulate_quant_allgather")
             for w, n in ((1, 3000), (2, 70000), (3, 5 * BLOCK + 9),
                          (4, 70000), (8, 3 * BLOCK + 123))
             for b in (8, 4)]


@pytest.mark.parametrize("sim,world,n,bits", SIM_CASES)
def test_ring_specs_equal_jax(sim, world, n, bits):
    xs = _ranks(world, n, seed=world * 31 + n % 97, scale=2.0)
    _same(getattr(wire, sim)(xs, bits=bits),
          getattr(jwire, sim)(xs, bits=bits))


@pytest.mark.parametrize("world,local,bits", [(4, 2, 8), (4, 2, 4),
                                              (8, 4, 8), (4, 4, 8),
                                              (4, 1, 4)])
def test_hier_spec_equals_jax(world, local, bits):
    xs = _ranks(world, 3 * BLOCK + 77, seed=local + bits)
    _same(wire.simulate_hier_ring(xs, local, bits=bits),
          jwire.simulate_hier_ring(xs, local, bits=bits))


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("kind", ["gauss", "ints", "zeros", "spikes",
                                  "ragged"])
def test_codec_equals_jax(kind, bits):
    rng = np.random.default_rng(len(kind) + bits)
    n = 4 * BLOCK
    x = {"gauss": rng.standard_normal(n) * 3,
         "ints": rng.integers(-7, 8, n),
         "zeros": np.zeros(n),
         "spikes": np.where(rng.random(n) < 0.01, 1e4, 1e-3),
         "ragged": rng.standard_normal(BLOCK + 77)}[kind].astype(np.float32)
    _same(wire.quantize_blocks(x, bits=bits),
          jwire.quantize_blocks(x, bits=bits))
    _same(wire.block_scales(x, bits=bits), jwire.block_scales(x, bits=bits))
    q, s = jwire.quantize_blocks(x, bits=bits)
    _same(wire.dequantize_blocks(q, s), jwire.dequantize_blocks(q, s))
    _same(wire.block_outlier_frac(x), jwire.block_outlier_frac(x))
    if kind != "ragged":
        # the tensor codec (ops/quant.py) against the numpy grid
        tq, ts = tquant.quantize_grad_blocks(
            torch.from_numpy(x.reshape(-1, BLOCK)), bits)
        assert np.array_equal(tq.numpy().ravel(), q)
        assert np.array_equal(ts.numpy().ravel(), s)


@pytest.mark.parametrize("seq", [(8, 8, 4, 4, 8, 4), (4, 4, 4), (8,) * 5])
def test_error_feedback_equals_jax(seq):
    g = (np.random.default_rng(len(seq)).standard_normal(3 * BLOCK + 5)
         * 3).astype(np.float32)
    mine, ref = tquant.ErrorFeedback(), jquant.ErrorFeedback()
    for bits in seq:
        _same(mine.compensate(g, bits=bits), ref.compensate(g, bits=bits))
        _same(mine.residual, ref.residual)


@pytest.mark.parametrize("n", [4 * BLOCK, 4 * BLOCK + 100, 17])
def test_outlier_stat_equals_numpy_and_jax(n):
    g = np.random.default_rng(n).standard_normal(n).astype(np.float32)
    g[min(17, n - 1)] = 500.0
    ref = jwire.block_outlier_frac(g)
    got = float(tquant.block_outlier_frac(torch.from_numpy(g)))
    jx = float(jquant.block_outlier_frac_jnp(g, BLOCK, jwire.DYNRANGE_THRESH))
    assert got == pytest.approx(ref, abs=1e-6)
    assert got == pytest.approx(jx, abs=1e-6)


def test_width_chooser_walks_jax_states():
    fracs = np.random.default_rng(3).uniform(0, 0.12, 80)
    a, b = wire.WidthChooser(), jwire.WidthChooser()
    for f in fracs:
        assert a.observe_frac(float(f)) == b.observe_frac(float(f))
    g = np.random.default_rng(4).standard_normal(8 * BLOCK).astype(
        np.float32)
    for _ in range(3):
        assert a.observe(g) == b.observe(g)
    assert a.widths == b.widths and a.histogram() == b.histogram()


def _leaves(seed=0):
    """Mixed shapes, each smaller than a block (the per-leaf padding runs),
    as numpy arrays in one order."""
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((16, 8)).astype(np.float32),
            np.ones(8, np.float32), np.zeros(8, np.float32),
            (rng.standard_normal((8, 4)) * 0.1).astype(np.float32)]


@pytest.mark.parametrize("world", [1, 2, 4])
def test_flat_layout_equals_jax(world):
    from distributed_pytorch_tpu.optim.sharded.layout import \
        build_layout as jbuild
    leaves = _leaves()
    mine = build_layout([torch.from_numpy(x) for x in leaves], world)
    ref = jbuild(leaves, world)
    assert (mine.offsets, mine.sizes, mine.n_padded, mine.seg) == \
        (ref.offsets, ref.sizes, ref.n_padded, ref.seg)
    _same(mine.flatten_np([torch.from_numpy(x) for x in leaves]),
          ref.flatten_np(leaves))
    for r in range(world):
        assert mine.span(mine.ring_segment(r)) == ref.span(
            ref.ring_segment(r))


# ---------------------------------------------------------------------------
# the JAX package's property cases, on the port's modules
# ---------------------------------------------------------------------------

def _codec_roundtrip_within_one_step(bits):
    x = (np.random.default_rng(0).standard_normal(8192) * 3).astype(
        np.float32)
    q, s = wire.quantize_blocks(x, bits=bits)
    assert np.abs(q).max() <= wire.quant_levels(bits)
    back = wire.dequantize_blocks(q, s)
    for b in range(s.size):
        blk = slice(b * BLOCK, (b + 1) * BLOCK)
        assert np.abs(back[blk] - x[blk]).max() <= s[b] / 2 + 1e-7


def _integer_snap(bits):
    lv = wire.quant_levels(bits)
    small = np.random.default_rng(1).integers(-lv, lv + 1, 4096).astype(
        np.float32)
    q, s = wire.quantize_blocks(small, bits=bits)
    assert np.array_equal(s, np.ones_like(s))
    assert np.array_equal(wire.dequantize_blocks(q, s), small)
    if bits == 4:
        _, s = wire.quantize_blocks(np.full(BLOCK, 100.0, np.float32),
                                    bits=4)
        assert s[0] == np.float32(100.0 / 7.0)


def _zeros_and_ragged():
    q, s = wire.quantize_blocks(np.zeros(3000, np.float32))
    assert not wire.dequantize_blocks(q, s).any()
    x = np.random.default_rng(3).standard_normal(BLOCK + 77).astype(
        np.float32)
    q, s = wire.quantize_blocks(x)
    assert q.size == x.size and s.size == 2
    assert np.abs(wire.dequantize_blocks(q, s) - x).max() <= s.max()


def _pack_unpack():
    for n in (1, 2, 7, 100, 1023, 1024, 5001):
        q = np.random.default_rng(n).integers(-7, 8, n).astype(np.int8)
        packed = wire.pack_nibbles(q)
        assert packed.size == (n + 1) // 2 == wire.payload_bytes(n, 4)
        assert np.array_equal(wire.unpack_nibbles(packed, n), q)


def _invalid_width():
    with pytest.raises(ValueError, match="width"):
        wire.quant_levels(16)
    with pytest.raises(ValueError, match="width"):
        wire.quantize_blocks(np.zeros(8, np.float32), bits=2)


def _acceptance_bytes_and_error_1mib():
    xs = _ranks(2, MIB_ELEMS)
    res, qbytes = wire.simulate_quant_ring(xs)
    assert wire.ring_allreduce_wire_bytes(MIB_ELEMS, 2) / qbytes >= 3.5
    assert qbytes == wire.quant_ring_allreduce_wire_bytes(MIB_ELEMS, 2)
    exact = np.sum(np.stack(xs), axis=0, dtype=np.float64)
    assert np.abs(res[0] - exact).max() / np.abs(exact).max() <= 1e-2


def _byte_ratios():
    n = 1 << 20
    for world in (2, 4, 8):
        f32 = wire.ring_allreduce_wire_bytes(n, world)
        assert f32 / wire.quant_ring_allreduce_wire_bytes(n, world) >= 3.5
        assert f32 / wire.quant_ring_allreduce_wire_bytes(
            n, world, bits=4) >= 6.5
        leg = wire.quant_leg_wire_bytes(n, world)
        assert 2 * leg == wire.quant_ring_allreduce_wire_bytes(n, world)
    assert wire.quant_leg_wire_bytes(n, 1) == 0
    for m in (1, 1000, BLOCK, MIB_ELEMS + 13):
        assert wire.quant_wire_bytes(m) == m + 4 * wire.num_blocks(m)
        assert wire.quant_wire_bytes(m, bits=4) == \
            (m + 1) // 2 + 4 * wire.num_blocks(m)


def _segment_grid_covers_once():
    for n in (5000, MIB_ELEMS + 777):
        for world in (2, 4, 8):
            segs = wire.segment_blocks(n, world)
            assert sum(c for _, c in segs) == wire.num_blocks(n)
            starts = [s for s, _ in segs]
            assert starts == sorted(starts)


def _ring_determinism(bits):
    for world in (2, 4, 8):
        res, _ = wire.simulate_quant_ring(
            _ranks(world, 3 * BLOCK + 123, seed=world), bits=bits)
        for r in range(1, world):
            assert np.array_equal(res[r], res[0])


def _ring_error_per_hop(bits):
    bounds = ({2: 1e-2, 4: 1.5e-2, 8: 2.5e-2} if bits == 8
              else {2: 0.15, 4: 0.3, 8: 0.5})
    for world, bound in bounds.items():
        xs = _ranks(world, MIB_ELEMS // 2, seed=7)
        res, _ = wire.simulate_quant_ring(xs, bits=bits)
        exact = np.sum(np.stack(xs), axis=0, dtype=np.float64)
        assert np.abs(res[0] - exact).max() / np.abs(exact).max() <= bound


def _integer_payloads_survive(bits):
    rng = np.random.default_rng(5)
    lim = 10 if bits == 8 else 1
    xs = [rng.integers(-lim, lim + 1, 5000).astype(np.float32)
          for _ in range(4)]
    res, _ = wire.simulate_quant_ring(xs, bits=bits)
    assert np.array_equal(res[0], np.sum(np.stack(xs), axis=0).astype(
        np.float32))


def _ragged_and_tiny():
    for n in (1, 7, BLOCK - 1, BLOCK + 1, 5000):
        res, nbytes = wire.simulate_quant_ring(_ranks(4, n, seed=n))
        assert res[0].size == n
        assert nbytes == wire.quant_ring_allreduce_wire_bytes(n, 4)


def _ef_bias_cancels(bits):
    ef = tquant.ErrorFeedback()
    g = (np.random.default_rng(0).standard_normal(4096) * 1e-2).astype(
        np.float32)
    outs = [ef.compensate(g, bits=bits) for _ in range(64)]
    assert np.abs(np.mean(outs, axis=0) - g).max() < \
        np.abs(outs[0] - g).max() / 10
    _, s = wire.quantize_blocks(g, bits=bits)
    assert np.abs(ef.residual).max() <= s.max()


def _ef_on_grid_across_flips():
    ef = tquant.ErrorFeedback()
    g = (np.random.default_rng(1).standard_normal(2048) * 3).astype(
        np.float32)
    for bits in (8, 8, 4, 4, 8, 4):
        out = ef.compensate(g, bits=bits)
        q, s = wire.quantize_blocks(out, bits=bits)
        assert np.array_equal(wire.dequantize_blocks(q, s), out)
    _, s4 = wire.quantize_blocks(g, bits=4)
    assert np.abs(ef.residual).max() <= s4.max()


def _ef_tiny_gradients_recovered():
    ef = tquant.ErrorFeedback()
    g = np.zeros(BLOCK, np.float32)
    g[0], g[1] = 100.0, 0.11      # g[1] far below scale/2
    assert np.sum([ef.compensate(g)[1] for _ in range(40)]) > 0.0


def _chooser_drops_to_q4():
    ch = wire.WidthChooser(hysteresis=2)
    g = np.random.default_rng(0).standard_normal(8 * BLOCK).astype(
        np.float32)
    assert ch.width == 8
    ch.observe(g)
    assert ch.width == 8
    ch.observe(g)
    assert ch.width == 4 and ch.widths == [8, 8]


def _chooser_outliers_stay_q8():
    ch = wire.WidthChooser(hysteresis=2)
    g = np.zeros(8 * BLOCK, np.float32)
    g[::BLOCK // 2] = 100.0
    g += np.float32(1e-3)
    for _ in range(6):
        ch.observe(g)
    assert ch.width == 8 and set(ch.histogram()) == {8}


def _chooser_no_flapping():
    ch = wire.WidthChooser(hysteresis=2)
    for _ in range(10):
        ch.observe_frac(0.0)
        ch.observe_frac(1.0)
    assert ch.width == 8 and all(b == 8 for b in ch.widths)


def _outlier_frac_values():
    assert wire.block_outlier_frac(np.zeros(4096, np.float32)) == 0.0
    g = np.random.default_rng(1).standard_normal(4 * BLOCK).astype(
        np.float32)
    assert wire.block_outlier_frac(g) <= 0.05
    g[0] = 1e4
    assert wire.block_outlier_frac(g) == pytest.approx(0.25)


def _hier_within_acceptance():
    for world, local, bound in ((4, 2, 1e-2), (8, 2, 1.5e-2), (8, 4, 1e-2)):
        xs = _ranks(world, 1 << 17, seed=world * local)
        res, _ = wire.simulate_hier_ring(xs, local)
        exact = np.sum(np.stack(xs), axis=0, dtype=np.float64)
        assert np.abs(res[0] - exact).max() / np.abs(exact).max() <= bound


def _hier_bit_identical():
    for bits in (8, 4):
        res, _ = wire.simulate_hier_ring(
            _ranks(8, 3 * BLOCK + 77, seed=bits), 2, bits=bits)
        for r in range(1, 8):
            assert np.array_equal(res[r], res[0])


def _hier_slow_hop_bytes():
    n = (1 << 18) + 13
    for world, local, bits in ((8, 2, 8), (8, 2, 4), (8, 4, 8)):
        _, slow = wire.simulate_hier_ring(_ranks(world, n, seed=1), local,
                                          bits=bits)
        nh = world // local
        assert slow == wire.quant_ring_allreduce_wire_bytes(n, nh,
                                                            bits=bits)
        flat = wire.quant_ring_allreduce_wire_bytes(n, world, bits=bits)
        assert flat / slow == pytest.approx((world - 1) / (nh - 1),
                                            rel=0.02)


def _hier_divides_and_one_host_exact():
    with pytest.raises(ValueError, match="divide"):
        wire.simulate_hier_ring(_ranks(4, 100), 3)
    xs = _ranks(4, 5000, seed=9)
    res, slow = wire.simulate_hier_ring(xs, 4)
    acc = xs[0].copy()
    for x in xs[1:]:
        acc = acc + x
    assert slow == 0 and np.array_equal(res[0], acc)


def _layout_roundtrip_and_alignment():
    ts = [torch.from_numpy(x) for x in _leaves()]
    lay = build_layout(ts, 4)
    assert all(off % BLOCK == 0 for off in lay.offsets)
    assert lay.n_padded % (4 * BLOCK) == 0 and lay.seg % BLOCK == 0
    back = lay.unflatten(lay.flatten(ts))
    for a, b in zip(ts, back):
        assert torch.equal(a, b)
    for rank in range(4):
        lo, cnt = wire.ring_owned_span(lay.n_padded, 4, rank)
        assert (lo, lo + cnt) == lay.span(lay.ring_segment(rank))


def _layout_pad_multiple_portable():
    ts = [torch.from_numpy(x) for x in _leaves()]
    pm = lcm_pad_multiple([4, 2])
    l4 = build_layout(ts, 4, pad_multiple=pm)
    l2 = build_layout(ts, 2, pad_multiple=pm)
    assert l4.n_padded == l2.n_padded and l4.offsets == l2.offsets
    with pytest.raises(ValueError, match="multiple"):
        build_layout(ts, 4, pad_multiple=2 * BLOCK)


def _legs_compose_to_the_ring():
    for world in (2, 4, 8):
        xs = _ranks(world, 3 * BLOCK + 123, seed=world, scale=2.0)
        ref, ref_bytes = wire.simulate_quant_ring(xs)
        bufs, b1 = wire.simulate_quant_reduce_scatter(xs)
        outs, b2 = wire.simulate_quant_allgather(bufs)
        assert b1 + b2 == ref_bytes
        for r in range(world):
            assert np.array_equal(outs[r], ref[r].ravel())


def _reduce_scatter_owned_span_sum():
    world, n = 4, 2 * BLOCK * 4 + 77
    xs = _ranks(world, n, seed=3, scale=2.0)
    bufs, nbytes = wire.simulate_quant_reduce_scatter(xs)
    assert nbytes == wire.quant_leg_wire_bytes(n, world)
    exact = np.sum(np.stack(xs), axis=0, dtype=np.float64)
    for r in range(world):
        lo, cnt = wire.ring_owned_span(n, world, r)
        want = exact[lo:lo + cnt]
        err = np.abs(bufs[r][lo:lo + cnt] - want).max() / np.abs(want).max()
        assert err <= 2.5e-2


def _allgather_bit_identical():
    outs, _ = wire.simulate_quant_allgather(_ranks(4, 3 * BLOCK * 4,
                                                   seed=5))
    for r in range(1, 4):
        assert np.array_equal(outs[r], outs[0])


def _master_to_grid_gap_bounded():
    ts = [torch.from_numpy(x) for x in _leaves()]
    lay = build_layout(ts, 1)
    sharded = shard_optimizer(adamw(1e-3), lay)
    state = sharded.init_slice(ts, 0)
    g = lay.flatten([torch.from_numpy(
        np.random.default_rng(2).standard_normal(t.shape).astype(
            np.float32) * 1e-2) for t in ts])
    for _ in range(50):
        master, state = sharded.update_flat(g, state)
        m = master.numpy()
        q, s = wire.quantize_blocks(m)
        working = wire.dequantize_blocks(q, s)
        for b in range(s.size):
            blk = slice(b * BLOCK, (b + 1) * BLOCK)
            assert np.abs(working[blk] - m[blk]).max() <= s[b] / 2 + 1e-7


def _grad_leg_error_feedback():
    ts = [torch.from_numpy(x) for x in _leaves()]
    lay = build_layout(ts, 4)
    g = lay.flatten_np([torch.from_numpy(
        np.random.default_rng(3).standard_normal(t.shape).astype(
            np.float32) * 1e-3) for t in ts])
    ef = tquant.ErrorFeedback()
    outs = [ef.compensate(g) for _ in range(64)]
    assert np.abs(np.mean(outs, axis=0) - g).max() < \
        np.abs(outs[0] - g).max() / 10
    _, s = wire.quantize_blocks(g)
    assert np.abs(ef.residual).max() <= s.max()


def _quantized_pmean_wire_bytes():
    assert tprim.quantized_pmean_wire_bytes(MIB_ELEMS, 1) == 0
    b = tprim.quantized_pmean_wire_bytes(MIB_ELEMS, 8)
    assert 2 * MIB_ELEMS * 4 * 7 / b > 3.5


PROPERTY_CASES = {
    "codec_q8_roundtrip": lambda: _codec_roundtrip_within_one_step(8),
    "codec_q4_roundtrip": lambda: _codec_roundtrip_within_one_step(4),
    "codec_q8_integer_snap": lambda: _integer_snap(8),
    "codec_q4_integer_snap": lambda: _integer_snap(4),
    "codec_zeros_and_ragged": _zeros_and_ragged,
    "q4_pack_unpack": _pack_unpack,
    "invalid_width": _invalid_width,
    "ring_acceptance_1mib": _acceptance_bytes_and_error_1mib,
    "byte_ratios": _byte_ratios,
    "segment_grid": _segment_grid_covers_once,
    "ring_q8_determinism": lambda: _ring_determinism(8),
    "ring_q4_determinism": lambda: _ring_determinism(4),
    "ring_q8_error_per_hop": lambda: _ring_error_per_hop(8),
    "ring_q4_error_per_hop": lambda: _ring_error_per_hop(4),
    "ring_q8_integers": lambda: _integer_payloads_survive(8),
    "ring_q4_integers": lambda: _integer_payloads_survive(4),
    "ring_ragged_and_tiny": _ragged_and_tiny,
    "ef_q8_bias_cancels": lambda: _ef_bias_cancels(8),
    "ef_q4_bias_cancels": lambda: _ef_bias_cancels(4),
    "ef_width_flips": _ef_on_grid_across_flips,
    "ef_tiny_gradients": _ef_tiny_gradients_recovered,
    "chooser_drops_to_q4": _chooser_drops_to_q4,
    "chooser_outliers_q8": _chooser_outliers_stay_q8,
    "chooser_no_flapping": _chooser_no_flapping,
    "outlier_frac": _outlier_frac_values,
    "hier_acceptance": _hier_within_acceptance,
    "hier_bit_identical": _hier_bit_identical,
    "hier_slow_hop_bytes": _hier_slow_hop_bytes,
    "hier_divides_one_host_exact": _hier_divides_and_one_host_exact,
    "layout_roundtrip_alignment": _layout_roundtrip_and_alignment,
    "layout_pad_multiple": _layout_pad_multiple_portable,
    "legs_compose": _legs_compose_to_the_ring,
    "reduce_scatter_owned_sum": _reduce_scatter_owned_span_sum,
    "allgather_bit_identical": _allgather_bit_identical,
    "master_grid_gap_bounded": _master_to_grid_gap_bounded,
    "grad_leg_error_feedback": _grad_leg_error_feedback,
    "quantized_pmean_wire_bytes": _quantized_pmean_wire_bytes,
}


@pytest.mark.parametrize("case", sorted(PROPERTY_CASES))
def test_jax_property_case(case):
    PROPERTY_CASES[case]()


def test_layout_rounds_through_narrow_dtypes():
    """A bf16 tensor's elements of the bucket hold bf16 values after
    ``round_``; float32 ones are untouched."""
    ts = [torch.randn(300, generator=torch.Generator().manual_seed(0)),
          torch.randn(200, generator=torch.Generator().manual_seed(1))
          .to(torch.bfloat16)]
    lay = build_layout(ts, 2)
    flat = lay.flatten(ts) + 1e-3
    lo = 500
    span = flat[lo:].clone()
    lay.round_(span, lo)
    b_off = lay.offsets[1]
    assert torch.equal(span[:b_off - lo], flat[lo:b_off])
    bf = flat[b_off:b_off + 200]
    assert torch.equal(span[b_off - lo:b_off - lo + 200],
                       bf.to(torch.bfloat16).float())


def test_shard_optimizer_refuses_adafactor_and_non_optimizers():
    from distributed_pytorch_tpu_torch.optim import adafactor
    lay = build_layout([torch.zeros(10)], 1)
    with pytest.raises(TypeError, match="ELEMENTWISE"):
        shard_optimizer(adafactor(1e-3), lay).init_flat(torch.zeros(1024))
    with pytest.raises(TypeError, match="Optimizer"):
        shard_optimizer(object(), lay)
