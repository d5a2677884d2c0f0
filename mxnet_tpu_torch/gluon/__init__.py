"""Gluon: the imperative model API (counterpart of mxnet_tpu/gluon/):
Block / HybridBlock, Parameter, and lazily nn, loss, Trainer and utils
(the port's own layers import gluon.block, so the package loads its
layer modules on first use)."""
from .block import Block, HybridBlock, SymbolBlock  # noqa: F401
from .parameter import (Constant, DeferredInitializationError,  # noqa: F401
                        Parameter, ParameterDict)


def __getattr__(name):
    import importlib
    lazy = {"nn": "mxnet_tpu_torch.gluon.nn",
            "loss": "mxnet_tpu_torch.gluon.loss",
            "utils": "mxnet_tpu_torch.gluon.utils",
            "trainer": "mxnet_tpu_torch.gluon.trainer",
            "Trainer": ("mxnet_tpu_torch.gluon.trainer", "Trainer")}
    spec = lazy.get(name)
    if spec is None:
        raise AttributeError(
            f"module 'mxnet_tpu_torch.gluon' has no attribute {name!r}")
    if isinstance(spec, tuple):
        obj = getattr(importlib.import_module(spec[0]), spec[1])
    else:
        obj = importlib.import_module(spec)
    globals()[name] = obj
    return obj
