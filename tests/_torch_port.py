"""Shared helpers of the PyTorch-port parity tests (``test_torch_*``).

Inputs are made with numpy from a seed and handed to both the JAX
package and the port; weights are initialized by the JAX model and
loaded into the port with ``convert.from_jax_params``.
"""

import jax
import numpy as np
import torch

from distributed_pytorch_tpu import models as jmodels
from distributed_pytorch_tpu_torch import TransformerLM, from_jax_params

CPU = torch.device("cpu")


def small_lm_kwargs(**kw):
    kw.setdefault("vocab", 61)
    kw.setdefault("dim", 32)
    kw.setdefault("n_layers", 2)
    kw.setdefault("n_heads", 4)
    kw.setdefault("n_kv_heads", 2)
    kw.setdefault("pos", "rope")
    kw.setdefault("max_seq", 128)
    return kw


def jax_and_port_lm(seed=0, jax_attn_fn=None, port_attn_fn=None, **kw):
    """(JAX model, its params, port model with the same weights) on the
    CPU in float32."""
    kw = small_lm_kwargs(**kw)
    jm = jmodels.TransformerLM(attn_fn=jax_attn_fn, **kw)
    params = jm.init(jax.random.PRNGKey(seed))
    pm = TransformerLM(attn_fn=port_attn_fn, device=CPU, **kw)
    from_jax_params(jax.tree_util.tree_map(np.asarray, params), pm)
    return jm, params, pm


def to_np(t):
    return t.detach().to(torch.float32).cpu().numpy()


def launch_cpu_ranks(worker_fn, nprocs, *args, timeout_s=120,
                     backend=None):
    """``launch_multiprocess`` over gloo with CPU ranks (or the native
    host group with ``backend="host"``), bounded by ``timeout_s`` (a
    hung run fails with the ranks' output, which the children write to
    the test's captured stdout/stderr). The worker is a function of the
    port package, so the ranks import torch only.

    The rendezvous port is free when picked but may be taken before
    rank 0 binds it (tests run in parallel): that one failure is
    retried once with a new port; any other failure raises."""
    from distributed_pytorch_tpu_torch.runtime.multiprocess import \
        launch_multiprocess
    from distributed_pytorch_tpu_torch.runtime.watchdog import WorkerFailure

    for attempt in range(2):
        try:
            return launch_multiprocess(worker_fn, nprocs, *args,
                                       device="cpu", timeout_s=timeout_s,
                                       backend=backend)
        except WorkerFailure as e:
            if attempt or not ("EADDRINUSE" in str(e)
                               or "rendezvous failed" in str(e)):
                raise
