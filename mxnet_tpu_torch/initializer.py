"""Weight initializers.

Counterpart of mxnet_tpu/initializer.py `Initializer` (the dispatch by
parameter-name suffix), `Xavier` and its `_fan_in_out`, and of
`Block.initialize` (mxnet_tpu/gluon/block.py) as `initialize(model,
init, seed)`: every parameter of the model is filled in place, in
`named_parameters()` order, from one torch.Generator seeded on the
model's own device, so a full-width model is drawn on the card without
a host copy. The draws are not the reference's numpy streams: the same
seed gives the same weights in this package, not across packages
(tests carry weights over with models/convert.load_jax_params).

Not ported yet: the other initializers of the reference's registry.
"""
from __future__ import annotations

import math

import torch

from .base import MXNetError

__all__ = ["Initializer", "Xavier", "initialize"]


def _fan_in_out(shape):
    """(fan_in, fan_out) of a weight shape: OIHW gives (I*kH*kW,
    O*kH*kW), (out, in) gives (in, out), as the reference."""
    if len(shape) < 2:
        n = shape[0] if shape else 1.0
        return n, n
    hw = float(math.prod(shape[2:])) if len(shape) > 2 else 1.0
    return shape[1] * hw, shape[0] * hw


class Initializer:
    """Fills a parameter by its name's suffix, as the reference's
    `Initializer.__call__`: *bias and *beta 0, *gamma 1, running_mean 0,
    running_var 1, anything else `_init_weight`."""

    def __call__(self, name, param, generator):
        if name.endswith(("bias", "beta", "running_mean", "moving_mean")):
            param.zero_()
        elif name.endswith(("gamma", "running_var", "moving_var")):
            param.fill_(1.0)
        else:
            self._init_weight(name, param, generator)

    def _init_weight(self, name, param, generator):
        raise NotImplementedError


class Xavier(Initializer):
    """Parity: mx.init.Xavier(rnd_type, factor_type, magnitude): scale =
    sqrt(magnitude / factor), factor the average of fan in and fan out
    ("avg"), or either; U(-scale, scale) or N(0, scale)."""

    def __init__(self, rnd_type="uniform", factor_type="avg", magnitude=3):
        if rnd_type not in ("uniform", "gaussian"):
            raise MXNetError(f"invalid rnd_type {rnd_type}")
        if factor_type not in ("avg", "in", "out"):
            raise MXNetError(f"invalid factor_type {factor_type}")
        self.rnd_type = rnd_type
        self.factor_type = factor_type
        self.magnitude = float(magnitude)

    def scale(self, shape):
        fan_in, fan_out = _fan_in_out(tuple(shape))
        factor = {"avg": (fan_in + fan_out) / 2.0, "in": fan_in,
                  "out": fan_out}[self.factor_type]
        return math.sqrt(self.magnitude / max(factor, 1e-12))

    def _init_weight(self, name, param, generator):
        s = self.scale(param.shape)
        if self.rnd_type == "uniform":
            param.uniform_(-s, s, generator=generator)
        else:
            param.normal_(0.0, s, generator=generator)


def initialize(model, init, seed=0):
    """Fill every parameter of `model` with `init` (an Initializer),
    drawing from a generator seeded with `seed` on the model's device.
    Returns the model."""
    params = list(model.named_parameters())
    if not params:
        raise MXNetError("initialize: the model has no parameter")
    gen = torch.Generator(device=params[0][1].device).manual_seed(int(seed))
    with torch.no_grad():
        for name, p in params:
            init(name, p, gen)
    return model
