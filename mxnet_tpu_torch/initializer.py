"""Weight initializers.

Counterpart of mxnet_tpu/initializer.py: `Initializer` (the dispatch by
parameter-name suffix), its registry (`register`, `get`, `create`) and
the zoo: `Zero`, `One`, `Constant`, `Uniform`, `Normal`, `Xavier`,
`MSRAPrelu`, `Orthogonal`, `Identity`, `Bilinear`, `LSTMBias` and
`Mixed`. An initializer fills a torch parameter in place:
`init(name, param, generator)`. `force_weight=True` (an initializer
chosen for that parameter) skips the suffix dispatch, as the reference's
does. The random ones draw from the torch.Generator they are given, on
the parameter's own device, so a full-width model is drawn on the card
without a host copy; `Block.initialize` hands them the process-wide
generator of that device (`rng.generator`, seeded by mx.random.seed).
The draws are not the reference's numpy streams: the same seed gives the
same weights in this package, not across packages (tests carry weights
over with models/convert.py).

`initialize(model, init, seed)` fills every parameter of a model from
one generator seeded with `seed` (the ResNet cells' seeded Xavier).
"""
from __future__ import annotations

import json
import math
import re

import numpy as np
import torch

from .base import MXNetError
from .ops.registry import Registry

__all__ = ["Initializer", "InitDesc", "Zero", "One", "Constant", "Uniform",
           "Normal", "Xavier", "MSRAPrelu", "Orthogonal", "Identity",
           "Bilinear", "LSTMBias", "Mixed", "register", "create", "get",
           "initialize"]

_REGISTRY = Registry("initializer")
register = _REGISTRY.register
create = _REGISTRY.create


def get(obj, default=None):
    """A str, an Initializer or None as an Initializer (default for
    None)."""
    if obj is None:
        return default
    if isinstance(obj, Initializer):
        return obj
    if isinstance(obj, str):
        return _REGISTRY.get(obj)()
    raise MXNetError(f"cannot interpret {obj!r} as an initializer")


class InitDesc(str):
    """Parameter name and attributes (parity: InitDesc)."""

    def __new__(cls, name, attrs=None, global_init=None):
        obj = super().__new__(cls, name)
        obj.attrs = attrs or {}
        obj.global_init = global_init
        return obj


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

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def __call__(self, name, param, generator=None, force_weight=False):
        name = str(name)
        if force_weight:
            self._init_weight(name, param, generator)
        elif name.endswith(("bias", "beta", "running_mean", "moving_mean")):
            param.zero_()
        elif name.endswith(("gamma", "running_var", "moving_var")):
            param.fill_(1.0)
        else:
            self._init_weight(name, param, generator)

    def _init_weight(self, name, param, generator):
        raise NotImplementedError

    def __repr__(self):
        kw = ", ".join(f"{k}={v}" for k, v in self._kwargs.items())
        return f"{type(self).__name__}({kw})"

    def dumps(self):
        return json.dumps([type(self).__name__.lower(), self._kwargs])


def _fill(param, array):
    param.copy_(torch.as_tensor(np.asarray(array)).to(param.dtype))


@register("zeros", aliases=("zero",))
class Zero(Initializer):
    def _init_weight(self, name, param, generator):
        param.zero_()


@register("ones", aliases=("one",))
class One(Initializer):
    def _init_weight(self, name, param, generator):
        param.fill_(1.0)


@register
class Constant(Initializer):
    def __init__(self, value=0.0):
        super().__init__(value=value)
        self.value = value

    def _init_weight(self, name, param, generator):
        if isinstance(self.value, (int, float)):
            param.fill_(self.value)
        else:
            _fill(param, np.broadcast_to(np.asarray(self.value),
                                         tuple(param.shape)))


@register
class Uniform(Initializer):
    def __init__(self, scale=0.07):
        super().__init__(scale=scale)
        self.scale = scale

    def _init_weight(self, name, param, generator):
        param.uniform_(-self.scale, self.scale, generator=generator)


@register
class Normal(Initializer):
    def __init__(self, sigma=0.01):
        super().__init__(sigma=sigma)
        self.sigma = sigma

    def _init_weight(self, name, param, generator):
        param.normal_(0.0, self.sigma, generator=generator)


@register("xavier", aliases=("glorot",))
class Xavier(Initializer):
    """Parity: mx.init.Xavier(rnd_type, factor_type, magnitude): scale =
    sqrt(magnitude / factor), factor the average of fan in and fan out
    ("avg"), or either; U(-scale, scale) or N(0, scale)."""

    def __init__(self, rnd_type="uniform", factor_type="avg", magnitude=3):
        super().__init__(rnd_type=rnd_type, factor_type=factor_type,
                         magnitude=magnitude)
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


@register("msraprelu")
class MSRAPrelu(Xavier):
    def __init__(self, factor_type="avg", slope=0.25):
        super().__init__("gaussian", factor_type, 2.0 / (1 + slope ** 2))
        self._kwargs = {"factor_type": factor_type, "slope": slope}


@register
class Orthogonal(Initializer):
    """scale x an orthonormal basis from the SVD of a random (out, in)
    matrix (uniform or normal)."""

    def __init__(self, scale=1.414, rand_type="uniform"):
        super().__init__(scale=scale, rand_type=rand_type)
        self.scale = scale
        self.rand_type = rand_type

    def _init_weight(self, name, param, generator):
        nout = param.shape[0]
        nin = int(math.prod(param.shape[1:])) if param.dim() > 1 else 1
        tmp = torch.empty((nout, nin), dtype=torch.float32,
                          device=param.device)
        if self.rand_type == "uniform":
            tmp.uniform_(-1.0, 1.0, generator=generator)
        else:
            tmp.normal_(0.0, 1.0, generator=generator)
        u, _, v = torch.linalg.svd(tmp, full_matrices=False)
        q = u if tuple(u.shape) == (nout, nin) else v
        param.copy_((self.scale * q).reshape(param.shape))


@register
class Identity(Initializer):
    def __init__(self, init_value=1):
        super().__init__(init_value=init_value)
        self.init_value = init_value

    def _init_weight(self, name, param, generator):
        if param.dim() != 2:
            raise MXNetError("Identity initializer requires 2D shape")
        _fill(param, self.init_value * np.eye(*param.shape))


@register
class Bilinear(Initializer):
    """Bilinear upsampling kernels (the deconvolution upsampling init)."""

    def _init_weight(self, name, param, generator):
        shape = tuple(param.shape)
        n = int(np.prod(shape))
        f = np.ceil(shape[3] / 2.0)
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        i = np.arange(n)
        x, y = i % shape[3], (i // shape[3]) % shape[2]
        w = (1 - np.abs(x / f - c)) * (1 - np.abs(y / f - c))
        _fill(param, w.astype(np.float32).reshape(shape))


@register("lstmbias")
class LSTMBias(Initializer):
    """Zeros, the forget gate's quarter (i, f, c, o order) forget_bias."""

    def __init__(self, forget_bias=1.0):
        super().__init__(forget_bias=forget_bias)
        self.forget_bias = forget_bias

    def _init_weight(self, name, param, generator):
        param.zero_()
        n = param.shape[0] // 4
        param[n:2 * n] = self.forget_bias


@register
class Mixed(Initializer):
    """The first pattern that matches the name picks the initializer."""

    def __init__(self, patterns, initializers):
        super().__init__()
        if len(patterns) != len(initializers):
            raise MXNetError("patterns and initializers length mismatch")
        self.map = [(re.compile(p), get(i))
                    for p, i in zip(patterns, initializers)]

    def __call__(self, name, param, generator=None, force_weight=False):
        for pat, init in self.map:
            if pat.search(str(name)):
                return init(name, param, generator, force_weight)
        raise MXNetError(f"no initializer pattern matches {name!r}")


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
