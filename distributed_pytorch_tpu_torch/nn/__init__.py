"""Layers of the port (``torch.nn`` modules)."""

from .attention import MultiHeadAttention, TransformerBlock, dense_attention
from .conv import BatchNorm2d, Conv2d, global_avg_pool, max_pool
from .core import (Dropout, Embedding, LayerNorm, Linear, Sequential, gelu,
                   relu)
from .rotary import apply_rope, rope_angles

__all__ = ["BatchNorm2d", "Conv2d", "Dropout", "Embedding", "LayerNorm",
           "Linear", "MultiHeadAttention", "Sequential", "TransformerBlock",
           "apply_rope", "dense_attention", "gelu", "global_avg_pool",
           "max_pool", "relu", "rope_angles"]
