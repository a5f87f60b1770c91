"""Models of the port. ``generate()`` lives in the ``generate`` submodule
(and at the package top level); it is not re-exported here, where it
would shadow the submodule."""

from .mlp import DummyModel
from .moe_lm import MoEBlock, MoETransformerLM
from .resnet import BasicBlock, ResNet18
from .transformer import TransformerLM

__all__ = ["BasicBlock", "DummyModel", "MoEBlock", "MoETransformerLM",
           "ResNet18", "TransformerLM"]
