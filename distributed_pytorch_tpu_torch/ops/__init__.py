"""Attention ops of the port: ``flash_attention`` (the CUDA flash forward
kernel with its plain version) and ``decode_attention``. Import the
submodules by name; nothing is re-exported here, so no function shadows
a submodule."""
