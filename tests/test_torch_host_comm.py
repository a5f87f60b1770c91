"""The port's native host process group against the reference semantics
and the JAX package's rings, on CPU ranks.

One world-4 run of ``DPX_BACKEND=host`` rank processes drives every
collective of the API (as ``tests/test_host_backend.py:20-80`` does for
the JAX package: ring sum / avg, a 300,000-element all-reduce, rooted
reduce and gather with their quirks, all_gather, max, an exact integer
reduce, broadcast, sync_params), the quantized wires of ``all_reduce``
and ``sync_params``, the quantized ring at 8 and 4 bits and its two legs
on seeded inputs of 70,000 elements (equal on every rank, and equal to
``comm/wire.py``'s ``simulate_*`` specs byte for byte), and the
hierarchical ring at L = 2 against ``simulate_hier_ring``. A world-2 run
holds the port's ``HostComm`` to the JAX package's on the same inputs.
Then the failures: a peer killed mid-collective (the typed
``CommPeerDied`` and the supervisor's attribution), a wedged peer
(``CommTimeout``), the sanitizer's ``CollectiveMismatch`` within one
exchange, and ``HostCommTransport`` (a round trip of two frames, and a
prefill rank that exits mid-handoff). The failure cases whose ranks need
not be processes run as two threads of this process (the native calls
release the GIL). Every launch is bounded by 120 s. Serial run time
~35 s.
"""

import json
import threading

import numpy as np
import pytest

import _torch_host_workers as hw
from distributed_pytorch_tpu.comm import wire as jwire
from distributed_pytorch_tpu_torch.comm import wire
from distributed_pytorch_tpu_torch.comm.hier import HierRing
from distributed_pytorch_tpu_torch.comm.sanitizer import CollectiveMismatch
from distributed_pytorch_tpu_torch.runtime import native
from distributed_pytorch_tpu_torch.runtime.launcher import find_free_port
from distributed_pytorch_tpu_torch.runtime.multiprocess import \
    launch_multiprocess
from distributed_pytorch_tpu_torch.runtime.native import (CommError,
                                                          CommPeerDied,
                                                          CommTimeout,
                                                          HostComm)
from distributed_pytorch_tpu_torch.runtime.watchdog import WorkerFailure

WORLD = 4
LAUNCH_TIMEOUT_S = 120


def launch_host(fn, world, *args):
    """``launch_multiprocess`` of host-group CPU ranks, bounded; a
    rendezvous that loses its free ports to another process in between
    is retried once on new ones."""
    for attempt in range(2):
        try:
            return launch_multiprocess(fn, world, *args, device="cpu",
                                       backend="host",
                                       timeout_s=LAUNCH_TIMEOUT_S)
        except WorkerFailure as e:
            if attempt or "rendezvous failed" not in str(e):
                raise


def _read(out_dir, world):
    return [json.loads((out_dir / f"rank{r}.json").read_text())
            for r in range(world)]


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    out = tmp_path_factory.mktemp("host_w4")
    launch_host(hw.collectives_worker, WORLD, str(out))
    return _read(out, WORLD)


def test_every_collective_keeps_the_reference_semantics(world4):
    total = float(sum(range(1, WORLD + 1)))
    for r, d in enumerate(world4):
        assert (d["rank"], d["world"], d["backend"], d["primary"],
                d["device"]) == (r, WORLD, "host", r == 0, "cpu")
        assert d["sum"] == [total] * 5
        assert d["avg"] == [total / WORLD] * 5
        assert d["big"] == [total] * 3
        assert d["bcast"] == [2.0] * 4
        assert d["sync"] == [0.0, 0.0]
        assert d["all_gather"] == [[float(q)] * 2 for q in range(WORLD)]
        assert d["max"] == [float(WORLD - 1)] * 2
        assert d["int_reduce_dtype"] == "torch.int64"
        assert d["int_quant"] == [int(total)] * 3        # exact
        assert d["int_quant_dtype"] == "torch.int64"
        assert d["bf16_sum"] == [total] * 4 and d["bf16_dtype"] == \
            "torch.bfloat16"
        assert d["reduce_is_input"]
        if r == 0:
            assert d["reduce"] == [total] * 3
            assert d["int_reduce"] == [int(total)] * 2
            assert d["gather"] == [[float(q)] * 2 for q in range(WORLD)]
        else:
            assert d["reduce"] == [float(r + 1)] * 3
            assert d["int_reduce"] == [r + 1] * 2
            assert d["gather"] == [[0.0, 0.0]] * WORLD


def _spec(sim, bits=8, n=hw.RING_N):
    return sim([hw.rank_input(r, n) for r in range(WORLD)], bits=bits)


@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_ring_equals_the_spec_on_every_rank(world4, bits):
    res, nbytes = _spec(wire.simulate_quant_ring, bits)
    jres, _ = _spec(jwire.simulate_quant_ring, bits)
    assert hw.sha(res[0]) == hw.sha(jres[0])
    for d in world4:
        assert d[f"ring_q{bits}"] == hw.sha(res[0])
        stats = d["stats"][f"allreduce_q{bits}"]
        assert stats["bytes"] == nbytes // WORLD
        assert stats["bytes"] == wire.quant_ring_allreduce_wire_bytes(
            hw.RING_N, WORLD, bits=bits) // WORLD


def test_quantized_legs_equal_their_specs(world4):
    bufs, rs_bytes = _spec(wire.simulate_quant_reduce_scatter)
    outs, ag_bytes = wire.simulate_quant_allgather(bufs)
    for r, d in enumerate(world4):
        lo, cnt = wire.ring_owned_span(hw.RING_N, WORLD, r)
        assert d["owned"] == [lo, cnt]
        assert d["rs_owned"] == hw.sha(bufs[r][lo:lo + cnt])
        assert d["rs_ag"] == hw.sha(outs[0])
        assert d["stats"]["reduce_scatter"]["bytes"] == rs_bytes // WORLD
        assert d["stats"]["allgather"]["bytes"] == ag_bytes // WORLD


def test_exact_ring_is_the_same_on_every_rank(world4):
    assert len({d["ring_f32"] for d in world4}) == 1
    assert world4[0]["stats"]["allreduce_sum"]["bytes"] == \
        wire.ring_allreduce_wire_bytes(hw.RING_N, WORLD) // WORLD


@pytest.mark.parametrize("wire_fmt", ["quant", "q4", "adaptive"])
def test_quantized_wires_of_the_api(world4, wire_fmt):
    """``all_reduce(wire=)`` is the quantized ring (adaptive starts at
    q8) and ``sync_params(wire=)`` leaves every rank rank 0's
    dequantized values."""
    bits = 4 if wire_fmt == "q4" else 8
    res, _ = _spec(wire.simulate_quant_ring, bits)
    x0 = hw.rank_input(0, 3000)
    if wire_fmt == "adaptive":
        bits = 4 if wire.block_outlier_frac(x0) <= \
            wire.Q4_MAX_OUTLIER_FRAC else 8
    q, s = wire.quantize_blocks(x0, bits=bits)
    for d in world4:
        assert d[f"allreduce_{wire_fmt}"] == hw.sha(res[0])
        assert d[f"sync_{wire_fmt}"] == hw.sha(wire.dequantize_blocks(q, s))


def test_hier_ring_equals_its_spec(world4):
    res, slow = wire.simulate_hier_ring(
        [hw.rank_input(r) for r in range(WORLD)], 2, bits=8)
    for r, d in enumerate(world4):
        assert d["hier_q8"] == hw.sha(res[0])
        leader = r % 2 == 0
        want = wire.quant_leg_wire_bytes(hw.RING_N, 2) // 2 if leader \
            else 0
        assert d["slow_hop_bytes"] == want
        assert d["hier_stats"] == {"hier_reduce": want,
                                   "hier_gather": want}
    assert slow == 2 * 2 * world4[0]["slow_hop_bytes"]


def test_port_ring_equals_the_jax_package_ring(tmp_path):
    launch_host(hw.two_packages_worker, 2, str(tmp_path),
                find_free_port(8))
    recs = _read(tmp_path, 2)
    for d in recs:
        assert d["port"] == d["jax"]
    assert recs[0]["port"]["q8"] == recs[1]["port"]["q8"]
    # and equal to the spec
    xs = [hw.rank_input(r) for r in range(2)]
    for bits in (8, 4):
        assert recs[0]["port"][f"q{bits}"] == hw.sha(
            wire.simulate_quant_ring(xs, bits=bits)[0][0])
    assert recs[0]["timeout_ms"] == 300_000


def test_a_killed_peer_fails_typed_and_is_named():
    with pytest.raises(WorkerFailure) as info:
        launch_host(hw.killed_peer_worker, 2, "unused")
    e = info.value
    assert (e.rank, e.kind, e.op) == (1, "CommPeerDied", "allreduce")
    assert "CommPeerDied" in str(e)


@pytest.mark.parametrize("die", [False, True], ids=["round_trip",
                                                    "prefill_dies"])
def test_hostcomm_transport(tmp_path, die):
    frame = 1 << 20
    launch_host(hw.transport_worker, 2, str(tmp_path), frame, die)
    dec = json.loads((tmp_path / "rank0.json").read_text())
    assert dec["frame0"] is True
    if die:
        assert dec["severed"] and dec["cause"] == "CommPeerDied"
        assert (dec["peer"], dec["received"]) == (1, 1)
    else:
        pre = json.loads((tmp_path / "rank1.json").read_text())
        assert dec["frame1"] is True and dec["received"] == 2
        assert pre["sent"] == 2 and pre["booked"] == 2 * frame


# -- two ranks as threads of this process ---------------------------------

def _pair(fn0, fn1, timeout_ms=None, env=None, monkeypatch=None):
    """Run ``fn_r(comm)`` for ranks 0 and 1 of a fresh 2-rank group in
    two threads; returns each one's result or exception."""
    if env:
        for k, v in env.items():
            monkeypatch.setenv(k, v)
    port = find_free_port(2)
    out = [None, None]

    def run(rank, fn):
        comm = None
        try:
            comm = HostComm("127.0.0.1", port, rank, 2,
                            op_timeout_ms=timeout_ms)
            out[rank] = fn(comm)
        except BaseException as e:       # noqa: BLE001 (reported below)
            out[rank] = e
            if comm is not None:
                comm.abort()
        finally:
            if comm is not None:
                comm.close()

    ts = [threading.Thread(target=run, args=(r, f), name=f"rank{r}")
          for r, f in enumerate((fn0, fn1))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(60)
    assert not any(t.is_alive() for t in ts)
    return out


def test_a_wedged_peer_is_a_typed_timeout():
    gate = threading.Event()

    def waits(comm):
        try:
            comm.allreduce(np.ones(8, np.float32))
        finally:
            gate.set()

    def wedged(comm):
        gate.wait(30)
        return "late"

    r0, r1 = _pair(waits, wedged, timeout_ms=300)
    assert isinstance(r0, CommTimeout) and r1 == "late"
    assert (r0.op, r0.rank, r0.deadline_ms) == ("allreduce", 0, 300)


def test_an_aborted_peer_is_peer_died_and_a_closed_comm_raises():
    def waits(comm):
        comm.barrier()
        return comm.allreduce(np.ones(8, np.float32))

    def aborts(comm):
        comm.barrier()
        comm.abort()
        return "aborted"

    r0, r1 = _pair(waits, aborts, timeout_ms=10_000)
    assert isinstance(r0, CommPeerDied) and r1 == "aborted"
    assert (r0.op, r0.peer) == ("allreduce", 1)
    comm = HostComm("127.0.0.1", find_free_port(), 0, 1)
    comm.close()
    with pytest.raises(CommError, match="closed comm"):
        comm.barrier()


def test_the_sanitizer_names_a_divergent_rank(monkeypatch):
    def all_reduces(comm):
        return comm.allreduce(np.ones(16, np.float32))

    def broadcasts(comm):
        return comm.broadcast(np.ones(16, np.float32), src=0)

    r0, r1 = _pair(all_reduces, broadcasts, timeout_ms=10_000,
                   env={"DPX_COMM_SANITIZE": "1"}, monkeypatch=monkeypatch)
    for mine, theirs, rank in ((r0, "broadcast", 0), (r1, "allreduce", 1)):
        assert isinstance(mine, CollectiveMismatch), mine
        assert (mine.rank, mine.peer, mine.peer_op, mine.seq) == \
            (rank, 1 - rank, theirs, 1)


def test_world_one_comm_and_rendezvous_retry(monkeypatch):
    comm = HostComm("localhost", find_free_port(), 0, 1)
    x = np.arange(5, dtype=np.float32)
    assert np.array_equal(comm.allreduce(x.copy()), x)
    assert np.array_equal(comm.allreduce_q8(x.copy()), x)
    assert np.array_equal(comm.broadcast(x.copy()), x)
    assert comm.gather(x)[0].tolist() == x.tolist()
    comm.close()
    monkeypatch.setenv("DPX_RETRY_MAX", "1")
    monkeypatch.setenv("DPX_RETRY_BACKOFF_MS", "1")
    with pytest.raises(native.CommRetryExhausted) as info:
        HostComm("127.0.0.1", find_free_port(), 0, 2, timeout_ms=200)
    assert info.value.attempts == 2 and info.value.op == "init"


def test_hier_ring_refuses_a_local_world_that_does_not_divide():
    comm = HostComm("127.0.0.1", find_free_port(), 0, 1)
    with pytest.raises(ValueError, match="divide"):
        HierRing(comm, 3)
    comm.close()
