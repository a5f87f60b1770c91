"""Runnable workloads of the port (``python -m
distributed_pytorch_tpu_torch.examples.<name>``): ``min_ddp`` (the
reference workload), ``collectives`` (every helper of the API once per
rank) and ``ddp_lm`` (a TransformerLM trained through the API)."""
