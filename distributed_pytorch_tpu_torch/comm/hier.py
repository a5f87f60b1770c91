"""Hierarchical two-level gradient ring: fast hop intra-host, quantized
slow hop between one designated leader per host.

A flat quantized ring over W ranks puts EVERY byte of every hop on the
same transport; when ranks live L-per-host, 1/L of those hops cross the
slow inter-host link, but the slow links still carry the full
``2*(W-1)/W * quant_bytes`` stream each — total slow-hop traffic
``~2*(W-1)*quant_bytes(n)``. The two-level schedule here (the classic
hierarchical allreduce, cf. the CUDA-aware-MPI characterization in
arXiv 1810.11112) instead:

1. **hier_reduce** — each host reduces EXACT f32 to its leader over the
   fast hop (the rooted native hub, modeling the intra-host
   ``psum_scatter`` an SPMD-per-host deployment runs over ICI), then
   the ``nh = W/L`` leaders run the quantized ring's reduce-scatter leg
   among themselves;
2. **hier_gather** — the leaders run the byte-forwarding all-gather
   leg (bit-identical result on every leader), then each leader
   broadcasts exact f32 back over the fast hop.

Total slow-hop traffic: ``2*(nh-1)*quant_bytes(n)`` — each gradient
byte crosses the slow hop exactly once per leg, ``(W-1)/(nh-1) ~ L``
times less than the flat ring. Results are BIT-IDENTICAL on every rank
(leader-ring bit-identity + exact local broadcast), so replicas cannot
drift — the same contract as the flat quantized ring.

The numpy executable spec is :func:`..comm.wire.simulate_hier_ring`
(bit-exact against this class: the rooted hub accumulates in the same
local-rank order, and the leader ring is the native ``dpx_*_qn`` family
the flat-ring parity tests already pin).

The port's copy of the JAX package's ``comm/hier.py``. Failure surface:
both phases run the parent comm's sanitizer check when it is armed (so a
rank disagreeing about width or shape fails typed), and account the
SLOW-HOP bytes on the parent's CommStats under those op
names (the fast-hop traffic is accounted on the local sub-comm's own
stats under ``reduce``/``broadcast`` — the two transports are different
budgets and must not be summed). A failure in either phase aborts every
link (sub-groups and parent) so the whole world fails typed within one
deadline tick, re-raised as the same :class:`~..runtime.native.CommError`
subtype attributed to the hier op.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..runtime import faults
from ..runtime.native import CommError, CommTimeout, HostComm
from . import wire as _wire

#: Port offset of the hierarchy's sub-groups relative to the parent
#: group's base port: local group h occupies
#: ``base + world + 1 + h*local_world .. + local_world`` and the leader
#: group ``base + 2*world + 1 .. + nh`` — disjoint from the parent's
#: ``base .. base + world - 1`` listeners by construction.
_LOCAL_PORT_OFFSET = 1
_LEADER_PORT_OFFSET = 1


class HierRing:
    """Two-level ring over an existing :class:`HostComm` group.

    ``local_world`` consecutive ranks form one "host"; rank
    ``host*local_world`` is its designated leader. Build it once per
    group (or use :func:`hier_ring`, which caches on the comm) — the
    constructor rendezvouses the sub-groups, which is a collective
    moment all ranks must reach."""

    def __init__(self, comm: HostComm, local_world: Optional[int] = None,
                 *, rendezvous_timeout_ms: int = 30000):
        if local_world is None:
            from ..runtime import env as _env
            local_world = int(_env.get("DPX_HIER_RING"))
        if local_world < 1 or comm.world % local_world:
            raise ValueError(
                f"DPX_HIER_RING/local_world {local_world} must be >= 1 "
                f"and divide world {comm.world}")
        self.comm = comm
        self.local_world = local_world
        self.nh = comm.world // local_world
        self.host = comm.rank // local_world
        self.local_rank = comm.rank % local_world
        self.is_leader = self.local_rank == 0

        base = comm.base_port
        self.local = None
        self.leaders = None
        if local_world > 1:
            local_base = (base + comm.world + _LOCAL_PORT_OFFSET
                          + self.host * local_world)
            self.local = HostComm(
                comm.master_addr, local_base, self.local_rank,
                local_world, timeout_ms=rendezvous_timeout_ms,
                op_timeout_ms=comm.op_timeout_ms)
        if self.is_leader and self.nh > 1:
            leader_base = base + 2 * comm.world + _LEADER_PORT_OFFSET
            self.leaders = HostComm(
                comm.master_addr, leader_base, self.host, self.nh,
                timeout_ms=rendezvous_timeout_ms,
                op_timeout_ms=comm.op_timeout_ms)

    # -- lifecycle ---------------------------------------------------------

    def close(self):
        for sub in (self.local, self.leaders):
            if sub is not None:
                sub.close()
        self.local = self.leaders = None

    def abort(self):
        """Tear down every link NOW — sub-groups AND the parent group —
        so peers blocked in ANY phase observe peer-closed within one
        deadline tick."""
        for sub in (self.local, self.leaders):
            if sub is not None:
                sub.abort()
        self.comm.abort()

    def barrier(self):
        """Parent-group barrier."""
        self.comm.barrier()

    # -- the collective ----------------------------------------------------

    @property
    def rank(self) -> int:
        return self.comm.rank

    def slow_hop_bytes(self, n: int, bits: int = 8,
                       block: int = None) -> int:
        """Per-LEADER slow-hop wire bytes of ONE leg for an n-element
        buffer (0 on non-leaders — they never touch the slow hop)."""
        block = block or _wire.QUANT_BLOCK
        if not self.is_leader or self.nh <= 1:
            return 0
        return _wire.quant_leg_wire_bytes(n, self.nh, block, bits) \
            // self.nh

    def _pre_op(self, op: str, n: int, bits: int) -> None:
        # the fault hook first, where the phase starts, as
        # HostComm._pre_op does (runtime/faults.py)
        faults.on_comm_op(op, rank=self.comm.rank, comm=self)
        # sanitize the LOGICAL hier op on the parent group (every
        # global rank enters it) — the sub-group legs each carry their
        # own comm's sanitizer
        if self.comm._sanitizer is not None:
            self.comm._sanitizer.check(op, dtype="float32", size=int(n))

    def _global_peer(self, e: CommError, scope: str) -> int:
        """Translate a sub-group CommError's blamed peer into a GLOBAL
        rank — the supervisor's died-without-reporting attribution
        joins blames across ranks, so a local-group index would point
        at the wrong process."""
        p = getattr(e, "peer", -1)
        if p is None or p < 0:
            return -1
        if scope == "local":
            return self.host * self.local_world + p
        return p * self.local_world  # leader h sits at global h*L

    def _reraise(self, op: str, e: CommError, scope: str):
        # abort EVERYTHING first: a healthy host's members would
        # otherwise sit out their full deadline inside the local
        # broadcast while only the leaders know the slow hop died
        self.abort()
        kw = dict(op=op, rank=self.comm.rank,
                  peer=self._global_peer(e, scope))
        msg = f"hierarchical ring failed in {op}: {e}"
        if isinstance(e, CommTimeout):
            raise CommTimeout(msg, deadline_ms=e.deadline_ms,
                              **kw) from e
        raise type(e)(msg, **kw) from e

    def allreduce(self, arr: np.ndarray, bits: int = 8,
                  block: int = None, hidden: bool = False) -> np.ndarray:
        """In-place two-level allreduce (sum) of a flat f32 buffer.

        Exact intra-host, quantized (``bits`` wide) between leaders;
        result bit-identical on every rank. ``hidden`` routes the wall
        time into CommStats' overlapped bucket (the overlapping train
        step's non-final gradient buckets)."""
        _wire.quant_levels(bits)
        arr = np.ascontiguousarray(arr, dtype=np.float32)
        n = arr.size
        leg = self.slow_hop_bytes(n, bits, block)
        kwargs = {} if block is None else {"block": block}

        self._pre_op("hier_reduce", n, bits)
        with self.comm.stats.timed("hier_reduce", leg, hidden=hidden):
            if self.local is not None:
                # rooted exact f32 sum to the leader (fast hop, in
                # place on the leader); non-leader buffers stay
                # untouched until the phase-2 broadcast
                try:
                    out = self.local.reduce(arr)
                except CommError as e:
                    self._reraise("hier_reduce", e, "local")
                if self.is_leader and out is not arr:
                    arr[...] = out
            if self.leaders is not None:
                try:
                    self.leaders.reduce_scatter_quant(arr, bits,
                                                      **kwargs)
                except CommError as e:
                    self._reraise("hier_reduce", e, "leaders")

        self._pre_op("hier_gather", n, bits)
        with self.comm.stats.timed("hier_gather", leg, hidden=hidden):
            if self.leaders is not None:
                try:
                    self.leaders.allgather_quant(arr, bits, **kwargs)
                except CommError as e:
                    self._reraise("hier_gather", e, "leaders")
            if self.local is not None:
                try:
                    self.local.broadcast(arr, src=0)
                except CommError as e:
                    self._reraise("hier_gather", e, "local")
        return arr


def hier_ring(comm: HostComm,
              local_world: Optional[int] = None) -> HierRing:
    """The comm's cached :class:`HierRing` (built on first use; torn
    down with the comm). All ranks must first call this at the same
    point — construction rendezvouses the sub-groups. A second call
    requesting a DIFFERENT topology raises: silently reusing the old
    ring would run the wrong byte/schedule accounting (and rebuilding
    would be a hidden collective rendezvous mid-step)."""
    if local_world is None:
        from ..runtime import env as _env
        local_world = int(_env.get("DPX_HIER_RING"))
    ring = getattr(comm, "_hier_ring", None)
    if ring is None:
        ring = HierRing(comm, local_world)
        comm._hier_ring = ring
    elif ring.local_world != local_world:
        raise ValueError(
            f"hier_ring already built with local_world="
            f"{ring.local_world}; cannot switch to {local_world} on a "
            "live group (close the comm or build HierRing explicitly)")
    return ring
