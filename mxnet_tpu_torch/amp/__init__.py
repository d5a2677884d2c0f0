"""mx.amp: automatic mixed precision.

Counterpart of mxnet_tpu/amp/__init__.py: `init`, `init_trainer`,
`scale_loss`, `unscale`, `convert_model` / `convert_hybrid_block` and
`amp_state`, with loss_scaler.py's dynamic `LossScaler`. Precision is a
model-level policy, as in the reference: `convert_model` casts every
parameter to the target dtype except those of the norm layers
(`_FP32_LAYERS`), and the ops promote where dtypes meet. bfloat16 needs
no loss scaling (float32's exponent range), so `init_trainer` gives it
a no-op scaler; float16 gets the dynamic one. float16 never reaches the
fused attention kernels (they take float32 and bfloat16).
"""
from __future__ import annotations

from contextlib import contextmanager

import torch

from ..base import MXNetError
from .loss_scaler import LossScaler

__all__ = ["init", "init_trainer", "scale_loss", "unscale", "convert_model",
           "convert_hybrid_block", "LossScaler", "amp_state"]

_state = {"initialized": False, "target_dtype": None}

# layers whose parameters stay float32 (the reference's FP32_FUNCS list
# at layer granularity: norms accumulate and divide)
_FP32_LAYERS = ("BatchNorm", "LayerNorm", "GroupNorm", "InstanceNorm",
                "SyncBatchNorm")


def amp_state():
    return dict(_state)


def init(target_dtype="bfloat16", target_precision_ops=None,
         conditional_fp32_ops=None, fp32_ops=None):
    """Enable AMP with target_dtype 'bfloat16' or 'float16' (the op lists
    are accepted for source compatibility; the dtypes propagate from the
    converted model)."""
    if target_dtype not in ("bfloat16", "float16", "bf16", "fp16"):
        raise MXNetError(f"unsupported AMP target_dtype {target_dtype!r}")
    _state["target_dtype"] = {"bf16": "bfloat16", "fp16": "float16"}.get(
        target_dtype, target_dtype)
    _state["initialized"] = True


def _check_initialized():
    if not _state["initialized"]:
        raise MXNetError("call amp.init() before other amp functions")


def init_trainer(trainer, loss_scaler=None):
    """Attach a loss scaler to a gluon Trainer (a no-op one, scale 1.0,
    for bfloat16)."""
    _check_initialized()
    if loss_scaler is None:
        if _state["target_dtype"] == "bfloat16":
            loss_scaler = LossScaler(init_scale=1.0, scale_window=10 ** 9)
        else:
            loss_scaler = LossScaler()
    trainer._amp_loss_scaler = loss_scaler
    return trainer


def _scaler(trainer):
    _check_initialized()
    scaler = getattr(trainer, "_amp_loss_scaler", None)
    if scaler is None:
        raise MXNetError("trainer not amp-initialized: call "
                         "amp.init_trainer(trainer) first")
    return scaler


@contextmanager
def scale_loss(loss, trainer):
    """Yield the scaled loss to backward through:

        with amp.scale_loss(loss, trainer) as scaled:
            autograd.backward(scaled)
        trainer.step(batch_size)   # unscales, checks overflow, updates
    """
    s = _scaler(trainer).loss_scale
    if isinstance(loss, (list, tuple)):
        yield type(loss)(l * s for l in loss)
    else:
        yield loss * s


def unscale(trainer):
    """Divide the trainer's gradients by the loss scale in place (for
    clipping between backward and step)."""
    scaler = _scaler(trainer)
    inv = 1.0 / scaler.loss_scale
    with torch.no_grad():
        for p in trainer._params:
            g = p.var.grad
            if p.grad_req != "null" and not p.var.is_meta and g is not None:
                g.mul_(inv)
    scaler._unscaled = True


def convert_model(net, target_dtype=None):
    """Cast the model's parameters to the AMP dtype, keeping those of the
    norm layers in float32."""
    if target_dtype is None:
        _check_initialized()
        target_dtype = _state["target_dtype"]
    from ..gluon.parameter import Parameter
    for mod in net.modules():
        if type(mod).__name__ in _FP32_LAYERS:
            continue
        for var in mod._parameters.values():
            if var is not None:
                Parameter._of(var).cast(target_dtype)
    return net


convert_hybrid_block = convert_model
