"""Training steps of the port, all built over one front door
(``front_door.make_step``: spec-driven DP / ZeRO-1/2/3 / tp, the builder
cache, the reshard-free train -> eval -> serve handoff): the
data-parallel train and eval steps, the bf16 policy and the DDP wrapper
(``data_parallel``), the FSDP / ZeRO ladder over the mesh (``fsdp``),
the step whose layout its inputs carry (``spmd``, with the
sequence-parallel attention island), tensor parallelism with its spec
trees (``tensor``), sequence parallelism (``sequence``: ring, ring
flash, striped and Ulysses attention), pipeline parallelism
(``pipeline``: GPipe and 1F1B over ``pp``) and expert parallelism
(``moe``: the Switch / GShard layer over ``ep``)."""

from . import (data_parallel, front_door, fsdp, moe, pipeline, sequence,
               spmd, tensor)
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
from .moe import MoELayer, moe_param_specs
from .pipeline import (make_gspmd_pipeline_fn, make_pipeline_train_fn,
                       make_stage_fn, pipeline_apply, stack_layer_params)
from .sequence import (make_ring_attn_fn, make_ring_flash_attn_fn,
                       ring_attention, ring_flash_attention,
                       stripe_tokens, striped_ring_flash_attention,
                       ulysses_attention, unstripe_tokens)
from .spmd import (make_gspmd_ring_attn_fn, make_gspmd_striped_ring_attn_fn,
                   make_spmd_train_step, shard_batch_spec)
from .tensor import (replicated_specs, shard_params, tensor_parallel_lm,
                     transformer_lm_param_specs)

__all__ = ["DataParallel", "FROM_INPUTS", "FrontDoorStep",
           "HandoffMismatch", "MoELayer", "StatefulStepOutput",
           "StepOutput", "StepSpecs", "data_parallel", "front_door", "fsdp",
           "fsdp_param_specs", "handoff_shardings", "make_eval_step",
           "make_fsdp_train_step", "make_gspmd_pipeline_fn",
           "make_gspmd_ring_attn_fn", "make_gspmd_striped_ring_attn_fn",
           "make_pipeline_train_fn", "make_ring_attn_fn",
           "make_ring_flash_attn_fn", "make_scan_train_steps",
           "make_spmd_train_step", "make_stage_fn",
           "make_stateful_eval_step", "make_stateful_train_step",
           "make_step", "make_train_step", "make_zero1_train_step",
           "make_zero2_train_step", "moe", "moe_param_specs",
           "mp_cast_params", "opt_state_specs", "pipeline",
           "pipeline_apply", "prepare_ddp_model", "replicated_specs",
           "ring_attention", "ring_flash_attention", "sequence",
           "shard_batch_spec", "shard_layouts", "shard_model_and_opt",
           "shard_params", "spmd", "stack_layer_params", "stack_state",
           "stripe_tokens", "striped_ring_flash_attention", "tensor",
           "tensor_parallel_lm", "transformer_lm_param_specs",
           "ulysses_attention", "unstripe_tokens", "verify_handoff"]
