"""PyTorch/CUDA port of ``distributed_pytorch_tpu``.

A package of its own beside the JAX package, which stays the reference
it is tested against. It imports ``torch`` and never ``jax`` or the JAX
package. Layout mirrors the JAX package so each counterpart is easy to
find; kernels the JAX package wrote in Pallas are hand-written CUDA
under ``csrc/``, built at first use.

Entry points run on the card unless the caller passes ``device="cpu"``:

>>> from distributed_pytorch_tpu_torch import TransformerLM, generate
>>> from distributed_pytorch_tpu_torch.serve import InferenceEngine
"""

from .convert import from_jax_params
from .models.generate import generate, make_generate_fn
from .models.transformer import TransformerLM

__all__ = ["TransformerLM", "from_jax_params", "generate",
           "make_generate_fn"]
