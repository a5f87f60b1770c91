"""Training steps of the port: the data-parallel step at any world size,
the bf16 policy and the DDP wrapper (``data_parallel``)."""

from .data_parallel import (DataParallel, StepOutput, make_train_step,
                            mp_cast_params, prepare_ddp_model)

__all__ = ["DataParallel", "StepOutput", "make_train_step", "mp_cast_params",
           "prepare_ddp_model"]
