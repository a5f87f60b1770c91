"""Layers of the port (``torch.nn`` modules)."""

from .attention import MultiHeadAttention, TransformerBlock, dense_attention
from .core import Embedding, LayerNorm, Linear, gelu
from .rotary import apply_rope, rope_angles

__all__ = ["Embedding", "LayerNorm", "Linear", "MultiHeadAttention",
           "TransformerBlock", "apply_rope", "dense_attention", "gelu",
           "rope_angles"]
