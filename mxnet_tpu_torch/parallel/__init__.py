"""Training steps and tensor-parallel serving (counterpart of
mxnet_tpu.parallel: the single-device TrainStep and EvalStep; the
serving tp split over a device list, its rules and the shard group)."""
from .mesh import serving_tp_devices
from .rules import serving_tp_rules, split_kind
from .step import EvalStep, TrainStep
from .tp import TPGroup, shard_gpt2

__all__ = ["TrainStep", "EvalStep", "TPGroup", "serving_tp_devices",
           "serving_tp_rules", "shard_gpt2", "split_kind"]
