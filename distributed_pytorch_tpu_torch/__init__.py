"""PyTorch/CUDA port of ``distributed_pytorch_tpu``.

A package of its own beside the JAX package, which stays the reference
it is tested against. It imports ``torch`` and never ``jax`` or the JAX
package. Layout mirrors the JAX package so each counterpart is easy to
find; kernels the JAX package wrote in Pallas are hand-written CUDA
under ``csrc/``, built at first use.

The package is also the reference's helper API (``api.py``): ``import
distributed_pytorch_tpu_torch as dist`` gives ``dist.launch``,
``dist.reduce``, ``dist.data_sampler`` and the rest of its 18 functions.

Entry points run on the card unless the caller passes ``device="cpu"``:

>>> from distributed_pytorch_tpu_torch import TransformerLM, generate
>>> from distributed_pytorch_tpu_torch.serve import InferenceEngine
>>> from distributed_pytorch_tpu_torch.parallel import make_train_step
"""

from . import api
from .api import *  # noqa: F401,F403  (the 18 functions, api.__all__)
from .convert import (from_jax_params, from_jax_state, to_jax_params,
                      to_jax_state)
from .models.generate import generate, make_generate_fn
from .models.resnet import ResNet18
from .models.transformer import TransformerLM

__all__ = ["ResNet18", "TransformerLM", "from_jax_params", "from_jax_state",
           "generate", "make_generate_fn", "to_jax_params",
           "to_jax_state"] + api.__all__
