"""Training steps of the port, all built over one front door
(``front_door.make_step``: spec-driven DP / ZeRO-1/2/3 / tp, the builder
cache, the reshard-free train -> eval -> serve handoff): the
data-parallel train and eval steps, the bf16 policy and the DDP wrapper
(``data_parallel``), the FSDP / ZeRO ladder over the mesh (``fsdp``),
the step whose layout its inputs carry (``spmd``) and tensor
parallelism with its spec trees (``tensor``)."""

from . import data_parallel, front_door, fsdp, spmd, tensor
from .data_parallel import (DataParallel, StatefulStepOutput, StepOutput,
                            make_eval_step, make_scan_train_steps,
                            make_stateful_eval_step, make_stateful_train_step,
                            make_train_step, mp_cast_params,
                            prepare_ddp_model, stack_state)
from .front_door import (FROM_INPUTS, FrontDoorStep, HandoffMismatch,
                         StepSpecs, handoff_shardings, make_step,
                         verify_handoff)
from .fsdp import (fsdp_param_specs, make_fsdp_train_step,
                   make_zero1_train_step, make_zero2_train_step,
                   opt_state_specs, shard_layouts, shard_model_and_opt)
from .spmd import make_spmd_train_step, shard_batch_spec
from .tensor import (replicated_specs, shard_params, tensor_parallel_lm,
                     transformer_lm_param_specs)

__all__ = ["DataParallel", "FROM_INPUTS", "FrontDoorStep",
           "HandoffMismatch", "StatefulStepOutput", "StepOutput",
           "StepSpecs", "data_parallel", "front_door", "fsdp",
           "fsdp_param_specs", "handoff_shardings", "make_eval_step",
           "make_fsdp_train_step", "make_scan_train_steps",
           "make_spmd_train_step", "make_stateful_eval_step",
           "make_stateful_train_step", "make_step", "make_train_step",
           "make_zero1_train_step", "make_zero2_train_step",
           "mp_cast_params", "opt_state_specs", "prepare_ddp_model",
           "replicated_specs", "shard_batch_spec", "shard_layouts",
           "shard_model_and_opt", "shard_params", "spmd", "stack_state",
           "tensor", "tensor_parallel_lm", "transformer_lm_param_specs",
           "verify_handoff"]
