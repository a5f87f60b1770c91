"""The native host ring between rank processes: wall time, wire bytes and
the bytes of the result of each ring op on one gradient-sized bucket.

Each rank holds its own seeded float32 bucket of ``--n`` elements (default
134,994,432, the FLAGSHIP TransformerLM's parameter count) and runs, over
a ``"host"`` group: the exact f32 all-reduce, the quantized all-reduce at
8 and 4 bits, and the two legs ``reduce_scatter_q8`` + ``allgather_q8``.
Per op it records the wall ms (after a barrier), the wire bytes this rank
sent (``CommStats``) beside ``comm/wire.py``'s formula, and the sha256 of
the result, which must be equal on every rank. A second bucket of
``--parity-n`` elements (default 1,048,576) runs the quantized rings
again, for holding them to ``simulate_quant_ring``. Then rank 1 sends
rank 0 one disaggregated-serving handoff frame through
``HostCommTransport`` (80 pages of the FLAGSHIP width at f32, ~94 MB:
``serve/disagg/frames.py`` ``encode_frame``), which rank 0 decodes.

Each rank writes ``<out_dir>/rank<r>.json``; rank 0 prints its own::

    python -m distributed_pytorch_tpu_torch.examples.host_ring \\
        --nprocs 2 --n 1000000
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import tempfile
import time

import numpy as np

FLAGSHIP_PARAMS = 134_994_432
PARITY_N = 1 << 20
# the handoff frame: FLAGSHIP's layers, heads and head dim, 80 pages of 16
FRAME = dict(n_layers=12, n_pages=80, h_kv=12, page_len=16, dh=64,
             vocab=32000)


def rank_bucket(rank: int, n: int, salt: int = 0) -> np.ndarray:
    """Rank ``rank``'s seeded float32 bucket."""
    return np.random.default_rng(1000 * salt + rank).standard_normal(
        n, dtype=np.float32)


def sha(a: np.ndarray) -> str:
    return hashlib.sha256(memoryview(np.ascontiguousarray(a))).hexdigest()


def handoff_frame():
    """One f32 handoff frame of :data:`FRAME`'s geometry from a seed:
    ``(bytes, kv_bytes)``."""
    from ..serve.disagg.frames import encode_frame
    f = FRAME
    rng = np.random.default_rng(7)
    shape = (f["n_pages"], f["h_kv"], f["page_len"], f["dh"])
    ks = [rng.standard_normal(shape, dtype=np.float32)
          for _ in range(f["n_layers"])]
    vs = [rng.standard_normal(shape, dtype=np.float32)
          for _ in range(f["n_layers"])]
    logits = rng.standard_normal(f["vocab"], dtype=np.float32)
    return encode_frame(3, f["n_pages"] * f["page_len"], logits, ks, vs,
                        None)


def _timed(comm, fn):
    comm.barrier()
    t0 = time.perf_counter()
    fn()
    return (time.perf_counter() - t0) * 1e3


def main_worker(rank: int, world: int, n: int, out_dir: str,
                parity_n: int = PARITY_N) -> None:
    from ..comm import wire
    from ..runtime import context
    from ..serve.disagg import HostCommTransport
    from ..serve.disagg.frames import decode_frame

    context.init_process_group(rank, world, backend="host")
    comm = context.get_host_comm()
    x = rank_bucket(rank, n)
    rec = {"rank": rank, "world": world, "n": n, "ops": {}}

    def run(label, fn, stat_ops, want_bytes):
        comm.stats.reset()
        buf = x.copy()
        ms = _timed(comm, lambda: fn(buf))
        got = sum(comm.stats.summary()[op]["bytes"] for op in stat_ops)
        rec["ops"][label] = {"wall_ms": ms, "wire_bytes": got,
                             "formula_bytes": want_bytes,
                             "sha256": sha(buf)}
        return buf

    run("allreduce_f32", lambda b: comm.allreduce(b), ["allreduce_sum"],
        wire.ring_allreduce_wire_bytes(n, world) // world)
    for bits in (8, 4):
        run(f"allreduce_q{bits}", lambda b, k=bits: comm.allreduce_quant(
            b, k), [f"allreduce_q{bits}"],
            wire.quant_ring_allreduce_wire_bytes(n, world, bits=bits)
            // world)

    def legs(b):
        t0 = time.perf_counter()
        comm.reduce_scatter_q8(b)
        rec["reduce_scatter_q8_ms"] = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        comm.allgather_q8(b)
        rec["allgather_q8_ms"] = (time.perf_counter() - t0) * 1e3

    run("reduce_scatter_q8+allgather_q8", legs,
        ["reduce_scatter", "allgather"],
        2 * (wire.quant_leg_wire_bytes(n, world) // world))
    del x

    rec["parity"] = {}
    for bits in (8, 4):
        small = rank_bucket(rank, parity_n, salt=1)
        comm.allreduce_quant(small, bits)
        rec["parity"][f"q{bits}"] = sha(small)

    tr = HostCommTransport(comm, src=1)
    if rank == 1:
        frame, kv = handoff_frame()
        t0 = time.perf_counter()
        tr.send(frame, kv)
        rec["handoff"] = {"frame_bytes": len(frame), "kv_bytes": kv,
                          "send_ms": (time.perf_counter() - t0) * 1e3,
                          "booked": tr.stats.summary()["handoff_send"]
                          ["bytes"]}
    elif rank == 0:
        t0 = time.perf_counter()
        got = tr.recv()
        ms = (time.perf_counter() - t0) * 1e3
        frame = decode_frame(got)
        rec["handoff"] = {"frame_bytes": len(got), "recv_ms": ms,
                          "sha256": hashlib.sha256(got).hexdigest(),
                          "request_id": frame.request_id,
                          "n_layers": len(frame.ks)}
    comm.barrier()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(rec, f)
    context.destroy_process_group()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nprocs", type=int, default=2)
    ap.add_argument("--n", type=int, default=FLAGSHIP_PARAMS)
    ap.add_argument("--parity-n", type=int, default=PARITY_N)
    ap.add_argument("--out-dir", default=None)
    ap.add_argument("--timeout-s", type=float, default=600)
    args = ap.parse_args(argv)
    from ..runtime.multiprocess import launch_multiprocess
    out_dir = args.out_dir or tempfile.mkdtemp(prefix="host_ring_")
    launch_multiprocess(main_worker, args.nprocs, args.n, out_dir,
                        args.parity_n, device="cpu", backend="host",
                        timeout_s=args.timeout_s)
    with open(os.path.join(out_dir, "rank0.json")) as f:
        print(json.dumps(json.load(f)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
