"""Models of the port. ``generate()`` lives in the ``generate`` submodule
(and at the package top level); it is not re-exported here, where it
would shadow the submodule."""

from .transformer import TransformerLM

__all__ = ["TransformerLM"]
