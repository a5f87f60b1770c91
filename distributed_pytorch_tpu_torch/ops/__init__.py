"""Ops of the port: ``flash_attention`` (the CUDA flash kernels with
their plain versions), ``decode_attention`` and ``losses``. Import the
submodules by name; of their functions only the vocab-parallel loss is
re-exported here (as the JAX package's ``ops`` exports it), and no
re-exported name shadows a submodule."""

from .losses import make_vocab_parallel_ce_fn, vocab_parallel_cross_entropy

__all__ = ["make_vocab_parallel_ce_fn", "vocab_parallel_cross_entropy"]
