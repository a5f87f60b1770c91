"""Training steps of the port. Only the world-1 data-parallel step is
ported so far (``data_parallel.make_train_step``)."""

from .data_parallel import StepOutput, make_train_step

__all__ = ["StepOutput", "make_train_step"]
