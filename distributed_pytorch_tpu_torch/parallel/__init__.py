"""Training steps of the port: the data-parallel train and eval steps at
any world size, the bf16 policy and the DDP wrapper (``data_parallel``)."""

from .data_parallel import (DataParallel, StatefulStepOutput, StepOutput,
                            make_eval_step, make_scan_train_steps,
                            make_stateful_eval_step, make_stateful_train_step,
                            make_train_step, mp_cast_params,
                            prepare_ddp_model, stack_state)

__all__ = ["DataParallel", "StatefulStepOutput", "StepOutput",
           "make_eval_step", "make_scan_train_steps",
           "make_stateful_eval_step", "make_stateful_train_step",
           "make_train_step", "mp_cast_params",
           "prepare_ddp_model", "stack_state"]
