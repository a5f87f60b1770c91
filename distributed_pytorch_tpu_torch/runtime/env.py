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

register("DPX_REMAT", "str", "none",
         "Default per-layer remat policy of `models.TransformerLM"
         "(remat=None)`: `none` (save all activations), `full` "
         "(recompute each block in backward), or `dots_saveable` "
         "(save matmul outputs only, recompute elementwise — "
         "torch.utils.checkpoint with a selective policy).")

# The non-paged serving engine of this slice reads no DPX_SERVE_* knob:
# the JAX engine's reads are all of paged KV, tenant quotas or
# speculative decoding, which this slice leaves out (ROADMAP.md).

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
