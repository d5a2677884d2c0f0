"""Training steps (counterpart of mxnet_tpu.parallel: the single-device
TrainStep)."""
from .step import TrainStep

__all__ = ["TrainStep"]
