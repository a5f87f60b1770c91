"""Rank workers of the port's observability tests
(``test_torch_obs_export.py``), spawned by ``launch_multiprocess``.

They import the port, torch and numpy only. The trace and metrics knobs
(``DPX_TRACE``, ``DPX_METRICS_LOG``, ``DPX_MON_EVERY``) come from the
environment the launcher passes on, so every rank writes its spans and
snapshots into the one shared log.
"""

import os

import numpy as np
import torch

#: the small LM of the traced run (vocab 61, dim 32, one layer)
LM = dict(vocab=61, dim=32, n_layers=1, n_heads=4, n_kv_heads=2,
          pos="rope", max_seq=32)
STEPS = 3


def lm_batch(rank, step, batch=2, seq=16):
    rng = np.random.default_rng(100 * step + rank)
    x = rng.integers(0, LM["vocab"], (batch, seq + 1))
    return (torch.from_numpy(x[:, :-1].astype(np.int64)),
            torch.from_numpy(x[:, 1:].astype(np.int64)))


def traced_host_door_worker(rank, world, out_dir):
    """STEPS steps of the small LM through ``make_train_step``'s host door
    (the native host group the launcher made), then a barrier; rank 0
    writes the losses to ``<out_dir>/losses.npy``."""
    import distributed_pytorch_tpu_torch as dist
    from distributed_pytorch_tpu_torch import TransformerLM, optim
    from distributed_pytorch_tpu_torch.ops.losses import cross_entropy
    from distributed_pytorch_tpu_torch.parallel import make_train_step

    dist.init_process_group(rank, world)
    torch.manual_seed(0)
    model = TransformerLM(device="cpu", **LM)

    def loss_fn(m, batch):
        x, y = batch
        return cross_entropy(m(x), y), {}

    opt = optim.adamw(1e-3)
    step = make_train_step(loss_fn, opt)
    state = opt.init(model.parameters())
    losses = []
    for t in range(STEPS):
        out = step(model, state, lm_batch(rank, t))
        state = out.opt_state
        losses.append(float(out.loss.reshape(-1)[0]))
    dist.barrier()
    if rank == 0:
        np.save(os.path.join(out_dir, "losses.npy"), np.asarray(losses))
