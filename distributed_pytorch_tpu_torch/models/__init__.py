"""Models of the port. ``generate()`` lives in the ``generate`` submodule
(and at the package top level); it is not re-exported here, where it
would shadow the submodule."""

from .mlp import DummyModel
from .resnet import BasicBlock, ResNet18
from .transformer import TransformerLM

__all__ = ["BasicBlock", "DummyModel", "ResNet18", "TransformerLM"]
