"""Runnable workloads of the port (``python -m
distributed_pytorch_tpu_torch.examples.<name>``): ``min_ddp`` (the
reference workload), ``collectives`` (every helper of the API once per
rank), ``ddp_lm`` (a TransformerLM trained through the API) and
``train_resnet`` (ResNet-18 on synthetic or local CIFAR-10)."""
