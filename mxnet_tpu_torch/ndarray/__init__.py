"""mx.nd namespace (counterpart of mxnet_tpu/ndarray/__init__.py).

Generated from the op registry, as the reference generates it: every
registered op under its own name and its lower-cased registry key, the
reference's aliases of the op modules (broadcast_add, Concat, ...), the
creation ops, `random`, `contrib` (control flow and detection),
`sparse`, `Custom` (operator.py), and `array` / `waitall`.
"""
from .ndarray import NDArray, array, from_torch, newaxis, waitall  # noqa: F401
from ..ops import init, math, random, tensor  # noqa: F401
from ..ops import nn as _nn_ops
from ..ops.init import (arange, empty, eye, full, indices,  # noqa: F401
                        linspace, meshgrid, ones, tri, zeros)
from ..ops.registry import OPS
from . import contrib, sparse  # noqa: F401,E402


def _populate():
    g = globals()
    for mod in (math, tensor):
        for name, obj in vars(mod).items():
            if not name.startswith("_") and getattr(obj, "op_name", None) \
                    and name not in g:
                g[name] = obj
    for key in OPS.keys():
        fn = OPS.get(key)
        g.setdefault(getattr(fn, "op_name", key), fn)
        g.setdefault(key, fn)
    # the reference's lower-case aliases of the nn ops
    g.setdefault("dropout", OPS.get("Dropout"))
    g.setdefault("fully_connected", OPS.get("FullyConnected"))
    g.setdefault("pooling", OPS.get("Pooling"))
    g["nn"] = _nn_ops


_populate()
del _populate


def __getattr__(name):
    # ops registered after import (operator.register_op) still resolve
    # as mx.nd.<name>; mx.nd.Custom is the legacy custom-op entry
    if name == "Custom":
        from ..operator import Custom
        globals()["Custom"] = Custom
        return Custom
    try:
        fn = OPS.get(name)
    except Exception:
        raise AttributeError(
            f"module 'mxnet_tpu_torch.ndarray' has no attribute {name!r}")
    globals()[name] = fn
    return fn
