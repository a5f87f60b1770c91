"""Training steps of the port: the data-parallel train and eval steps at
any world size, the bf16 policy and the DDP wrapper (``data_parallel``),
the FSDP / ZeRO-1/2/3 ladder over the mesh (``fsdp``) and tensor
parallelism with its spec trees (``tensor``)."""

from . import data_parallel, fsdp, tensor
from .data_parallel import (DataParallel, StatefulStepOutput, StepOutput,
                            make_eval_step, make_scan_train_steps,
                            make_stateful_eval_step, make_stateful_train_step,
                            make_train_step, mp_cast_params,
                            prepare_ddp_model, stack_state)
from .fsdp import (fsdp_param_specs, make_fsdp_train_step,
                   make_zero1_train_step, make_zero2_train_step,
                   opt_state_specs, shard_layouts, shard_model_and_opt)
from .tensor import (replicated_specs, shard_params, tensor_parallel_lm,
                     transformer_lm_param_specs)

__all__ = ["DataParallel", "StatefulStepOutput", "StepOutput",
           "data_parallel", "fsdp", "fsdp_param_specs", "make_eval_step",
           "make_fsdp_train_step", "make_scan_train_steps",
           "make_stateful_eval_step", "make_stateful_train_step",
           "make_train_step", "make_zero1_train_step",
           "make_zero2_train_step", "mp_cast_params", "opt_state_specs",
           "prepare_ddp_model", "replicated_specs", "shard_layouts",
           "shard_model_and_opt", "shard_params", "stack_state", "tensor",
           "tensor_parallel_lm", "transformer_lm_param_specs"]
