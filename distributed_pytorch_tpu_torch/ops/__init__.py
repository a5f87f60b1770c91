"""Ops of the port: ``flash_attention`` (the CUDA flash kernels with
their plain versions), ``decode_attention`` and ``losses``. Import the
submodules by name; nothing is re-exported here, so no function shadows
a submodule."""
