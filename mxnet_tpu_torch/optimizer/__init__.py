"""Optimizers (counterpart of mxnet_tpu/optimizer/)."""
from .optimizer import (DCASGD, LAMB, LARS, NAG, SGD, SGLD,  # noqa: F401
                        AdaDelta, Adagrad, Adam, AdamW, Ftrl, Optimizer,
                        RMSProp, Signum, Test, create, register)
from .updater import Updater, get_updater  # noqa: F401
