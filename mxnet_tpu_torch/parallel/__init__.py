"""Parallelism over a device mesh (counterpart of mxnet_tpu.parallel).

The mesh and its specs (mesh.py), the sharding rules (rules.py), the
collectives over a mesh axis (collectives.py) and their accounting
(comm.py), the training step single-device or over a mesh with 2-bit
compression (step.py, compression.py), sequence parallelism (sp.py),
pipeline parallelism (pp.py), MoE (moe.py), and the serving engine's
tensor-parallel split (tp.py).
"""
from .mesh import (  # noqa: F401
    AXIS_DP, AXIS_EP, AXIS_FSDP, AXIS_PP, AXIS_SP, AXIS_TP, Mesh,
    NamedSharding, PartitionSpec, axis_enabled, current_mesh, make_mesh,
    mesh_scope, named_sharding, serving_tp_devices, set_default_mesh)
from .rules import (  # noqa: F401
    ShardingRules, apply_sharding_rules, ep_rules, fsdp_rules,
    megatron_dense_rules, serving_tp_rules, split_kind)
from .sp import ring_attention, sp_enabled, ulysses_attention  # noqa: F401
from .comm import (collective_summary, comm_report,  # noqa: F401
                   ring_cost_bytes)
from .pp import (PPTrainStep, gpipe, pipeline_grads,  # noqa: F401
                 pipeline_loss, pipeline_loss_and_grads,
                 stack_stage_params)
from .moe import (  # noqa: F401
    all_to_all_tokens, moe_dispatch_combine, top_k_gating)
from .step import EvalStep, TrainStep  # noqa: F401
from .tp import TPGroup, shard_gpt2  # noqa: F401

__all__ = ["AXIS_DP", "AXIS_EP", "AXIS_FSDP", "AXIS_PP", "AXIS_SP",
           "AXIS_TP", "Mesh", "NamedSharding", "PartitionSpec",
           "axis_enabled", "current_mesh", "make_mesh", "mesh_scope",
           "named_sharding", "set_default_mesh", "ShardingRules",
           "apply_sharding_rules", "ep_rules", "fsdp_rules",
           "megatron_dense_rules", "ring_attention", "sp_enabled",
           "ulysses_attention", "collective_summary", "comm_report",
           "ring_cost_bytes", "PPTrainStep", "gpipe", "pipeline_grads",
           "pipeline_loss", "pipeline_loss_and_grads",
           "stack_stage_params", "all_to_all_tokens",
           "moe_dispatch_combine", "top_k_gating", "TrainStep", "EvalStep",
           "TPGroup", "serving_tp_devices", "serving_tp_rules",
           "shard_gpt2", "split_kind"]
