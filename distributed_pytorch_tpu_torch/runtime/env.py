# dpxlint: disable-file=DPX002 the port's own typed registry: the one module of distributed_pytorch_tpu_torch that reads os.environ (it must not import the JAX package's registry)
"""Typed environment-variable registry of the PyTorch port.

The JAX package keeps every knob in ``distributed_pytorch_tpu/runtime/
env.py``; the port cannot import it (the port never imports the JAX
package), so it keeps its own closed registry holding only the
variables its modules read. Same contract: every read goes through
:func:`get`, an unregistered name raises ``KeyError``, and a malformed
value falls back to the declared default.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, Iterable, Mapping, Optional

__all__ = ["EnvVar", "REGISTRY", "apply_overrides", "environ_copy", "get",
           "is_set", "raw", "register", "restore", "set", "snapshot",
           "unset"]


@dataclasses.dataclass(frozen=True)
class EnvVar:
    """One declared environment variable."""

    name: str
    type: str            # 'str' | 'int' | 'float' | 'bool'
    default: Any
    doc: str

    def parse(self, text: str) -> Any:
        if self.type == "int":
            return int(text)
        if self.type == "float":
            return float(text)
        if self.type == "bool":
            return text.strip().lower() in ("1", "true", "yes", "on")
        return text


REGISTRY: Dict[str, EnvVar] = {}


def register(name: str, type: str = "str", default: Any = None,
             doc: str = "") -> EnvVar:
    """Declare a variable; a conflicting re-declaration raises."""
    if type not in ("str", "int", "float", "bool"):
        raise ValueError(f"unsupported env var type {type!r} for {name}")
    var = EnvVar(name=name, type=type, default=default, doc=doc)
    old = REGISTRY.get(name)
    if old is not None and old != var:
        raise ValueError(
            f"conflicting registration for {name}: {old} vs {var}")
    REGISTRY[name] = var
    return var


def get(name: str) -> Any:
    """Typed value of ``name``: parsed when set, the declared default when
    unset or malformed."""
    var = _lookup(name)
    text = os.environ.get(name)
    if text is None:
        return var.default
    try:
        return var.parse(text)
    except ValueError:
        return var.default


def _lookup(name: str) -> EnvVar:
    try:
        return REGISTRY[name]
    except KeyError:
        raise KeyError(f"environment variable {name!r} is not registered "
                       f"in the port's runtime/env.py") from None


def raw(name: str) -> Optional[str]:
    """The unparsed value (None when unset), for a variable whose
    grammar is richer than one scalar (``DPX_FAULT``, ``DPX_CHAOS``)."""
    _lookup(name)
    return os.environ.get(name)


def is_set(name: str) -> bool:
    _lookup(name)
    return name in os.environ


def set(name: str, value: Any) -> None:
    """Export a registered variable (stringified) to this process and
    the processes it starts; an unregistered name raises ``KeyError``."""
    _lookup(name)
    os.environ[name] = str(value)


def unset(name: str) -> None:
    _lookup(name)
    os.environ.pop(name, None)


def apply_overrides(mapping: Mapping[str, str]) -> None:
    """Apply a caller's environment dict as it is (a child process's
    bootstrap: the elastic child's, a rank's). Its keys need not be
    registered: such dicts carry the caller's own variables too."""
    os.environ.update({k: str(v) for k, v in mapping.items()})


def snapshot(keys: Iterable[str]) -> Dict[str, Optional[str]]:
    """The raw values of ``keys`` (None = unset), for :func:`restore`."""
    return {k: os.environ.get(k) for k in keys}


def environ_copy() -> Dict[str, str]:
    """A copy of the whole environment, to build a child's from: a child
    inherits variables the registry does not know as well."""
    return dict(os.environ)


def restore(saved: Mapping[str, Optional[str]]) -> None:
    """Undo an :func:`apply_overrides` from a prior :func:`snapshot`."""
    for k, v in saved.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v


# The JAX package's value (its measured TPU crossover). Not yet measured
# on an H100: the flash/dense crossover of this port is open work.
register("DPX_FLASH_MIN_SEQ", "int", 1024,
         "Key count below which the flash attn_fn dispatches to dense "
         "attention instead of the CUDA flash kernel (numerics identical "
         "either way).")

register("DPX_DONATE", "bool", True,
         "Default `donate` of the front door (`parallel.front_door"
         ".make_step` and every builder shimmed over it): keyed in its "
         "builder cache and recorded on `step.donated`. Every engine "
         "updates the parameters and the optimizer state in place "
         "either way.")

register("DPX_REMAT", "str", "none",
         "Default per-layer remat policy of `models.TransformerLM"
         "(remat=None)`: `none` (save all activations), `full` "
         "(recompute each block in backward), or `dots_saveable` "
         "(save matmul outputs only, recompute elementwise — "
         "torch.utils.checkpoint with a selective policy).")

# -- serving: the paged KV pool (serve/pages/), speculative decoding
# (serve/spec/) and the tenant quota of the front door
register("DPX_SERVE_PAGE_LEN", "int", 16,
         "Tokens per KV page of the paged serving cache "
         "(serve/pages/; only full pages are prefix-shared).")
register("DPX_SERVE_N_PAGES", "int", 0,
         "Total pages of the paged serving KV pool (0 = derive "
         "n_slots*ceil(max_len/page_len), the same KV budget the "
         "contiguous slot pool would preallocate).")
register("DPX_SERVE_PREFIX_SHARE", "bool", True,
         "Enable radix prefix sharing in the paged serving cache "
         "(refcounted reuse of resident full prompt pages; 0 = paged "
         "layout without sharing).")
register("DPX_SERVE_KV_DTYPE", "str", "f32",
         "Resident storage of the paged serving KV pool: `f32` (exact "
         "pages in the model's dtype), `q8` or `q4` (block-quantized "
         "pages with per-page-per-block f32 scales on the wire's block "
         "grid, each slot's partial page kept exact until it completes). "
         "Ignored by non-paged engines.")
register("DPX_SPEC_DECODE", "bool", False,
         "Enable speculative decoding in the serving engine "
         "(serve/spec/): a draft model proposes DPX_SPEC_DRAFT_LEN "
         "tokens per iteration, one batched verify scores them, only "
         "accepted tokens commit. Requires EngineConfig(draft_model=); "
         "greedy requests only.")
register("DPX_SPEC_DRAFT_LEN", "int", 4,
         "Draft tokens proposed per speculative iteration (k); the "
         "verify scores k+1 positions and emits between 1 and k+1 "
         "tokens.")
register("DPX_SERVE_TENANT_MAX_INFLIGHT", "int", 0,
         "Per-tenant inflight-request quota of the serving front door "
         "(0 = unlimited): a tenant at its cap gets a synchronous "
         "typed AdmissionRejected(reason=\"tenant_quota\") with tenant "
         "attribution instead of queueing.")

# -- serving: the disaggregated split (serve/disagg/) and the fleet
# (serve/fleet/)
register("DPX_SERVE_DISAGG", "bool", False,
         "Serve through the disaggregated prefill/decode split "
         "(serve/disagg/) where the front door supports it "
         "(examples/serve_lm.py takes it as the --disagg default).")
register("DPX_HANDOFF_WIDTH", "str", "f32",
         "Wire width of the disaggregated KV-page handoff frame: `f32` "
         "(exact), `q8` (block-int8 with per-page scales, ~4x fewer "
         "handoff bytes) or `q4` (nibble-packed, ~7.9x; "
         "serve/disagg/frames.py).")
register("DPX_HANDOFF_TIMEOUT_MS", "int", 30_000,
         "Deadline for a sent handoff frame to be adopted by the decode "
         "engine; past it the request fails as a typed `HandoffTimeout` "
         "instead of waiting on a wedged prefill engine or transport "
         "(0 disables).")
register("DPX_FLEET_REPLICAS", "int", 2,
         "Default replica count of the multi-replica serving fleet "
         "(serve/fleet/ FleetRouter; FleetConfig(n_replicas=) "
         "overrides).")
register("DPX_FLEET_SPILL_QUEUE", "int", 4,
         "Home-replica queue depth at which the fleet router spills a "
         "request to the least-loaded replica instead of queueing behind "
         "known back-pressure (a `queue_full` / `no_free_pages` "
         "rejection spills regardless).")
register("DPX_FLEET_MIN_REPLICAS", "int", 1,
         "Elasticity floor of the fleet autoscaler: sustained-ok "
         "drains never shrink the fleet below this many live replicas "
         "(serve/fleet/autoscale.py).")
register("DPX_FLEET_MAX_REPLICAS", "int", 4,
         "Elasticity ceiling of the fleet autoscaler: SLO-degraded "
         "scale-outs never grow the fleet past this many live "
         "replicas.")
register("DPX_FLEET_SCALE_RULES", "str", "",
         "SLO rule spec the fleet autoscaler evaluates (the "
         "obs/health.py rule grammar, e.g. "
         "`serve.ttft_ms.p99<=500;fleet.max_queue_depth<=8`); empty = "
         "serve/fleet/autoscale.py DEFAULT_FLEET_RULES (TTFT p99 "
         "ceiling + worst per-replica queue depth).")
register("DPX_FLEET_DRAIN_AFTER_OK", "int", 8,
         "Consecutive ok autoscaler evaluations required before a "
         "sustained-ok drain retires a replica: the scale-in half of "
         "the hysteresis (scale-out reacts on the first degraded "
         "verdict).")

register("DPX_MP_POLICY", "str", "off",
         "Default mixed-precision policy of `parallel.make_train_step"
         "(mixed_precision=None)`: `off` (the parameters' own dtype "
         "throughout) or `bf16` (forward and backward on the bf16 cast "
         "of the float32 master parameters, which the optimizer updates).")

# the per-rank process group (runtime/multiprocess.py sets these in
# every rank process it starts; runtime/context.py reads them)
register("DPX_MASTER_ADDR", "str", "127.0.0.1",
         "Rendezvous address of the torch.distributed process group (the "
         "MASTER_ADDR analog): `tcp://<addr>:<port>`.")
register("DPX_MASTER_PORT", "int", None,
         "Rendezvous port of the torch.distributed process group; rank 0 "
         "serves the TCP store there. Required when a group is made.")
register("DPX_MULTIPROC_ACCEL", "str", "",
         "Device of a rank process: `cuda` (rank r owns cuda:r, NCCL) or "
         "`cpu` (gloo); set by `launch_multiprocess`. Unset, a group is "
         "made for the card when one is present and raises otherwise.")
register("DPX_METRICS_LOG", "str", None,
         "Line-JSON file receiving structured events from every rank "
         "and supervisor: the `worker_failure` of `launch_multiprocess`, "
         "checkpoint saves, metrics snapshots and (by default) the "
         "dpxtrace spans (`utils.logging.append_event`).")

# -- observability (obs/): dpxtrace spans and the dpxmon registry; the
# JAX package's names, types, defaults and meanings
register("DPX_TRACE", "bool", False,
         "Enable dpxtrace span recording (obs/trace.py): comm ops, the "
         "host train step, the serve request lifecycle and checkpoint "
         "phases emit trace_span events and feed the per-rank flight "
         "recorder. Off = one global read and one `if` per span.")
register("DPX_TRACE_RING", "int", 256,
         "Flight-recorder capacity in spans: the bounded per-process "
         "ring whose last-N spans every typed failure path dumps as a "
         "flight_recorder event (0 disables the ring; drops are "
         "counted, never silent).")
register("DPX_TRACE_LOG", "str", None,
         "Span sink path for trace_span events (default: the "
         "DPX_METRICS_LOG stream, so spans ride the same multi-writer "
         "line-JSON channel as failure events; tools/dpxtrace.py "
         "merges and exports them).")
register("DPX_MON", "bool", True,
         "Enable the dpxmon live metrics registry (obs/metrics.py): "
         "counters/gauges/histograms record in-process and snapshots "
         "can be emitted. 0 makes every instrument a no-op costing one "
         "global read. No IO happens either way until a snapshot sink "
         "is configured (DPX_METRICS_LOG or an explicit path).")
register("DPX_MON_EVERY", "int", 0,
         "Auto-emit a rank-attributed metrics_snapshot every N train "
         "steps from the instrumented step hooks (0 = no automatic "
         "cadence; explicit obs.metrics.emit_snapshot calls and the "
         "serve engine's log_every emission are unaffected).")
register("DPX_MON_RULES", "str", None,
         "Extra SLO health rules appended to obs/health.py's default "
         "set, in the rule grammar: e.g. "
         "`serve.ttft_ms.p99<=500;drift(train.steps_per_sec)@k=3`.")

# -- the trial statistics of perfbench/stats.py
register("DPX_TORCH_THREADS", "int", 8,
         "Torch intra-op thread count pinned by "
         "`perfbench.stats.pin_torch_threads` for stable A/B "
         "comparisons.")
register("DPX_BENCH_TRIALS", "int", 5,
         "Repeated-trial count of the perfbench statistical policy "
         "(perfbench/stats.py).")
register("DPX_BENCH_WARMUP", "int", 1,
         "Leading trials discarded as warmup before median/IQR "
         "aggregation.")
register("DPX_BENCH_MAX_SPREAD", "float", 0.15,
         "Hard spread gate (IQR/median) above which trial stats are "
         "marked untrusted and ratios built on them are withheld "
         "(perfbench/stats.py).")
register("DPX_BENCH_AFFINITY", "int", 8,
         "Pin benchmark processes to the first N allowed CPUs for "
         "run-to-run comparability (0 = leave affinity alone; "
         "perfbench/stats.pin_process).")
register("DPX_BENCH_BUDGET_S", "float", 120.0,
         "Wall-clock budget of stats.measure_until's hunt for a "
         "stationary trial window on a contended host "
         "(perfbench/stats.py).")

# -- the native host process group (runtime/native.py HostComm), the
# gradient wire it carries (comm/host_backend.py, parallel/
# data_parallel.py) and the sharded update (optim/sharded/); defaults
# and types are the JAX package's
register("DPX_BACKEND", "str", None,
         "Force the process-group backend; `host` selects the native TCP "
         "per-rank-process group (runtime/native.py HostComm over "
         "native/dpxhost.cpp) instead of torch.distributed.")
register("DPX_COMM_TIMEOUT_MS", "int", 300_000,
         "Per-collective deadline in ms for the native host group "
         "(0 disables). A wedged peer becomes a typed `CommTimeout`, "
         "never an infinite hang.")
register("DPX_COMM_SANITIZE", "bool", False,
         "Arm the runtime collective sanitizer: every host-group "
         "collective first exchanges a fixed-size fingerprint (seq no, "
         "op, dtype, nbytes, call site) and a cross-rank divergence "
         "raises a typed `CollectiveMismatch` within one exchange "
         "(comm/sanitizer.py).")
register("DPX_WIRE_WIDTH", "str", "8",
         "Default wire width of the quantized collectives under "
         "`wire=\"quant\"`/`grad_reduce=\"quant\"`: `8` (block int8), "
         "`4` (nibble-packed, ~7.9x less traffic than f32), or "
         "`adaptive` (per-bucket WidthChooser with hysteresis).")
register("DPX_HIER_RING", "int", 0,
         "Ranks per host of the two-level hierarchical ring (0/1 = "
         "flat). When it divides the world, the quantized gradient "
         "reduce runs exact intra-host to one leader per host and the "
         "quantized ring only between leaders (comm/hier.py).")
register("DPX_COMM_OVERLAP", "bool", False,
         "Overlap gradient-bucket ring traffic with the previous "
         "bucket's optimizer update in the host train step (bucketed "
         "issue + CommStats overlapped/exposed accounting).")
register("DPX_COMM_BUCKETS", "int", 4,
         "Gradient bucket count of the overlapped host train step "
         "(clamped to the leaf count; only read when the overlap path "
         "is active).")
register("DPX_WEIGHT_UPDATE", "str", "replicated",
         "Default weight-update mode of `parallel.make_train_step`: "
         "`replicated` (every rank runs the full optimizer step) or "
         "`sharded` (ZeRO-1: reduce-scatter, a step on the owned 1/world "
         "slice, all-gather; optim/sharded/).")

# -- faults, chaos and elastic restart (runtime/faults.py, chaos.py,
# elastic.py, watchdog.py); the JAX package's names, types and defaults
register("DPX_FAULT", "str", None,
         "Deterministic fault-injection spec(s): "
         "`action@key=value,...` with actions kill|delay|drop_conn|"
         "diverge|flaky (grammar in runtime/faults.py).")
register("DPX_CHAOS", "str", None,
         "Declarative multi-fault chaos campaign: inline JSON, a path "
         "to a JSON spec, or `;`-joined `[leg:expect:]fault` clauses "
         "(grammar in runtime/chaos.py).")
register("DPX_RETRY_MAX", "int", 2,
         "Bounded retry budget for transient comm faults: the host "
         "group's rendezvous and the handoff-transport hooks retry up to "
         "this many times (total attempts = 1 + budget) before raising "
         "the typed CommRetryExhausted. Collectives mid-flight never "
         "retry.")
register("DPX_RETRY_BACKOFF_MS", "float", 25.0,
         "Base backoff of the transient-fault retry: attempt k sleeps "
         "base*2^(k-1) ms before re-entering; every retry emits a "
         "comm_retry event.")
register("DPX_CHAOS_WORLD", "int", 4,
         "World size of a chaos campaign's train legs (the shrink-resume "
         "leg relaunches at half this).")
register("DPX_ELASTIC_ATTEMPT", "int", 0,
         "Restart attempt number exported to elastically supervised "
         "workers (0 = first launch).")
register("DPX_ELASTIC", "bool", False,
         "Set to 1 in workers supervised by `elastic_run`.")
register("DPX_PLATFORM", "str", None,
         "Device the elastic child defaults to: `cpu` makes the CPU the "
         "child's default device (torch.set_default_device), anything "
         "else leaves the card.")
register("DPX_WORKER_TAG", "str", None,
         "Per-launch tag `<launcher pid>-<us>` stamped on spawned rank "
         "processes so `watchdog.kill_orphan_workers` can clean up after "
         "a crashed launcher.")
register("LOCAL_WORLD_SIZE", "int", None,
         "Ranks per host (torchrun's variable): `runtime/multihost.py` "
         "counts hosts as the world over it (unset: one rank per visible "
         "card, one per CPU process under gloo).")
register("DPX_ELASTIC_TEST_LEAK", "str", None,
         "Test-only canary asserting the elastic child's environment "
         "never leaks into the supervisor.")
