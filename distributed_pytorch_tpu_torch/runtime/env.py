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
from typing import Any, Dict

__all__ = ["EnvVar", "REGISTRY", "register", "get", "set"]


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
    try:
        var = REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"environment variable {name!r} is not registered in the "
            f"port's runtime/env.py") from None
    text = os.environ.get(name)
    if text is None:
        return var.default
    try:
        return var.parse(text)
    except ValueError:
        return var.default


def set(name: str, value: Any) -> None:
    """Export a registered variable (stringified) to this process and
    the processes it starts; an unregistered name raises ``KeyError``."""
    if name not in REGISTRY:
        raise KeyError(f"environment variable {name!r} is not registered "
                       f"in the port's runtime/env.py")
    os.environ[name] = str(value)


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
         "Line-JSON file receiving structured events: the "
         "`worker_failure` of `launch_multiprocess` (`utils.logging."
         "append_event`).")

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
register("DPX_RETRY_MAX", "int", 2,
         "Bounded retry budget of the host group's rendezvous: a failed "
         "connect is re-entered up to this many times (total attempts = "
         "1 + budget) before raising the typed CommRetryExhausted. "
         "Collectives mid-flight never retry.")
register("DPX_RETRY_BACKOFF_MS", "float", 25.0,
         "Base backoff of the rendezvous retry: attempt k sleeps "
         "base*2^(k-1) ms before re-entering.")
