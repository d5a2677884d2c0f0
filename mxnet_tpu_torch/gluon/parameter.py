"""Parameter: a trainable weight with deferred shape initialisation.

Counterpart of mxnet_tpu/gluon/parameter.py (`Parameter`, `Constant`,
`ParameterDict`, `DeferredInitializationError`). A Parameter is a view
of ONE torch.nn.Parameter (its `_var`), registered in the owning
module's `_parameters`: `collect_params()[name].data()`,
`model.named_parameters()` and what `parallel.TrainStep` updates are
the same storage. `lr_mult` / `wd_mult` are attributes of that torch
parameter (where TrainStep reads them); grad_req is its `requires_grad`
and `_mx_grad_req` (autograd.py); its gradient is the torch parameter's
`.grad`, written by `autograd.backward` per grad_req.

A parameter whose shape is not known yet (a 0 in it) or that has not
been initialised lives on the meta device. `initialize()` fills it on
its device (ctx=, else where it already lives, else the default device)
from the process-wide generator of that device (rng.generator, seeded
by mx.random.seed); a shape that is still unknown is filled at the
block's first call, then initialised. Replacing a meta placeholder by
the real tensor re-registers it in every owning module.

Port models are built with seeded weights (models/convert.py
init_params), which count as not yet initialised: the first
`initialize()` overwrites them, later ones keep them unless
force_reinit.
"""
from __future__ import annotations

import weakref

import torch

from .. import device as _device
from .. import initializer as _init
from .. import rng as _rng
from ..base import MXNetError, not_ported
from ..ndarray.ndarray import NDArray, np_dtype, to_torch_dtype

__all__ = ["Parameter", "Constant", "ParameterDict",
           "DeferredInitializationError"]


class DeferredInitializationError(MXNetError):
    """Raised by .data() before a shape-deferred parameter is
    materialised."""


def _unknown(shape):
    return shape is None or any(s in (0, -1, None) for s in shape)


class Parameter:
    def __init__(self, name="weight", grad_req="write", shape=None,
                 dtype="float32", lr_mult=1.0, wd_mult=1.0, init=None,
                 allow_deferred_init=False, differentiable=True,
                 stype="default", grad_stype="default"):
        if stype != "default" or grad_stype != "default":
            raise not_ported("sparse parameter storage")
        if grad_req not in ("write", "add", "null"):
            raise MXNetError(f"invalid grad_req {grad_req!r}")
        self._name = name
        self.init = init
        self.allow_deferred_init = allow_deferred_init
        self._differentiable = differentiable
        self._deferred_init = None
        self._structure_name = None
        self._initialized = False
        self._owners = []
        self._nd = None
        shape = tuple(shape) if shape is not None else (0,)
        req = grad_req if differentiable else "null"
        var = torch.nn.Parameter(
            torch.empty(tuple(0 if s in (-1, None) else s for s in shape),
                        dtype=to_torch_dtype(dtype), device="meta"),
            requires_grad=req != "null")
        self._adopt(var, req, lr_mult, wd_mult)

    @classmethod
    def _of(cls, var):
        """The Parameter of a torch parameter (made on first sight for the
        port's layers, whose modules create their torch parameters)."""
        p = getattr(var, "_mx_param", None)
        if p is None:
            p = cls.__new__(cls)
            p._name = "weight"
            p.init = None
            p.allow_deferred_init = False
            p._differentiable = var.requires_grad
            p._deferred_init = None
            p._structure_name = None
            p._initialized = bool(getattr(var, "_mx_inited", False))
            p._owners = []
            p._nd = None
            p._adopt(var, "write" if var.requires_grad else "null",
                     getattr(var, "lr_mult", 1.0),
                     getattr(var, "wd_mult", 1.0))
        return p

    def _adopt(self, var, req, lr_mult, wd_mult):
        var._mx_param = self
        var._mx_grad_req = req
        var.lr_mult = lr_mult
        var.wd_mult = wd_mult
        self._var = var
        self._nd = None

    def _add_owner(self, module, name):
        for ref, n in self._owners:
            if ref() is module and n == name:
                return
        self._owners.append((weakref.ref(module), name))

    def _replace(self, tensor):
        """A new torch parameter for `tensor` in place of the current one,
        in every owning module."""
        old = self._var
        var = torch.nn.Parameter(tensor, requires_grad=old.requires_grad)
        self._adopt(var, old._mx_grad_req, old.lr_mult, old.wd_mult)
        if getattr(old, "sharding", None) is not None:
            var.sharding = old.sharding
        for ref, name in self._owners:
            mod = ref()
            if mod is not None and mod._parameters.get(name) is old:
                mod._parameters[name] = var

    # -- identity ----------------------------------------------------------
    @property
    def name(self):
        return self._structure_name or self._name

    def __repr__(self):
        return (f"Parameter {self.name} (shape={self.shape}, "
                f"dtype={self.dtype})")

    @property
    def var(self):
        """The torch parameter."""
        return self._var

    # -- shape, dtype, multipliers -------------------------------------------
    @property
    def shape(self):
        return tuple(self._var.shape)

    @shape.setter
    def shape(self, new_shape):
        new_shape = tuple(int(s) for s in new_shape)
        cur = self.shape
        if cur == new_shape:
            return
        ok = len(cur) == len(new_shape) and all(
            a in (0, -1) or a == b for a, b in zip(cur, new_shape))
        if not ok or not self._var.is_meta:
            raise MXNetError(f"cannot reset shape of {self.name} from {cur} "
                             f"to {new_shape}: only unknown (0) dims may be "
                             "filled in")
        self._replace(torch.empty(new_shape, dtype=self._var.dtype,
                                  device="meta"))

    @property
    def _shape_is_known(self):
        return not _unknown(self.shape)

    @property
    def dtype(self):
        return np_dtype(self._var.dtype)

    @property
    def lr_mult(self):
        return self._var.lr_mult

    @lr_mult.setter
    def lr_mult(self, v):
        self._var.lr_mult = v

    @property
    def wd_mult(self):
        return self._var.wd_mult

    @wd_mult.setter
    def wd_mult(self, v):
        self._var.wd_mult = v

    @property
    def sharding(self):
        """The parameter's PartitionSpec over a mesh (None: replicated);
        an attribute of the torch parameter, where a mesh TrainStep
        reads it."""
        return getattr(self._var, "sharding", None)

    @sharding.setter
    def sharding(self, spec):
        self._var.sharding = spec

    # -- grad_req ------------------------------------------------------------
    @property
    def grad_req(self):
        return self._var._mx_grad_req

    @grad_req.setter
    def grad_req(self, req):
        if req not in ("write", "add", "null"):
            raise MXNetError(f"invalid grad_req {req!r}")
        if not self._differentiable:
            req = "null"
        var = self._var
        var._mx_grad_req = req
        var.requires_grad_(req != "null")
        if req == "null":
            var.grad = None
        elif var.grad is None and not var.is_meta:
            var.grad = torch.zeros_like(var)

    # -- initialisation --------------------------------------------------------
    def initialize(self, init=None, ctx=None, default_init=None,
                   force_reinit=False):
        if self._initialized and not force_reinit:
            return
        explicit = _init.get(init) or _init.get(self.init)
        init = explicit or _init.get(default_init, _init.Uniform())
        if ctx is not None:
            dev = _device.to_torch(ctx)
        elif not self._var.is_meta:
            dev = self._var.device
        else:
            dev = _device.to_torch(None)
        if not self._shape_is_known:
            if not self.allow_deferred_init:
                raise MXNetError(f"cannot initialize {self.name}: shape "
                                 f"{self.shape} unknown and "
                                 "allow_deferred_init is False")
            self._deferred_init = (init, dev, explicit is not None)
            return
        self._materialize(init, dev, explicit is not None)

    def _materialize(self, init, dev, explicit=False):
        var = self._var
        if var.is_meta:
            self._replace(torch.empty(var.shape, dtype=var.dtype,
                                      device=dev))
        elif var.device != dev:
            var.data = torch.empty(var.shape, dtype=var.dtype, device=dev)
            var.grad = None
        var = self._var
        with torch.no_grad():
            init(_init.InitDesc(self.name), var, _rng.generator(dev),
                 force_weight=explicit)
        if var.requires_grad and var.grad is None:
            var.grad = torch.zeros_like(var)
        self._deferred_init = None
        self._initialized = True
        var._mx_inited = True

    def _finish_deferred_init(self):
        if self._deferred_init is None:
            if self._var.is_meta:
                raise MXNetError(f"parameter {self.name} has not been "
                                 "initialized; call .initialize() first")
            return
        if not self._shape_is_known:
            raise DeferredInitializationError(
                f"parameter {self.name} shape still unknown: {self.shape}")
        init, dev, explicit = self._deferred_init
        self._materialize(init, dev, explicit)

    # -- access --------------------------------------------------------------
    def _check(self):
        if self._var.is_meta:
            if self._deferred_init is not None:
                raise DeferredInitializationError(
                    f"parameter {self.name} deferred; forward once or set "
                    "its shape to materialize")
            raise MXNetError(f"parameter {self.name} has not been "
                             "initialized; call .initialize() first")

    def data(self, ctx=None):
        self._check()
        nd = self._nd
        if nd is None or nd._data is not self._var:
            nd = self._nd = NDArray(self._var)
        return nd

    def list_data(self):
        return [self.data()]

    def grad(self, ctx=None):
        self._check()
        if self.grad_req == "null":
            raise MXNetError(f"cannot get gradient of {self.name}: grad_req "
                             "is 'null'")
        if self._var.grad is None:
            self._var.grad = torch.zeros_like(self._var)
        return NDArray(self._var.grad)

    def list_grad(self):
        return [self.grad()]

    def list_ctx(self):
        if self._var.is_meta:
            if self._deferred_init is not None:
                return [_device.from_torch_device(self._deferred_init[1])]
            raise MXNetError(f"parameter {self.name} not initialized")
        return [_device.from_torch_device(self._var.device)]

    def set_data(self, data):
        t = data._data if isinstance(data, NDArray) else \
            torch.as_tensor(data)
        self.shape = tuple(t.shape)
        var = self._var
        t = t.detach().to(dtype=var.dtype)
        if var.is_meta:
            dev = t.device if self._deferred_init is None \
                else self._deferred_init[1]
            self._replace(t.to(dev).clone())
            if self._var.requires_grad:
                self._var.grad = torch.zeros_like(self._var)
            self._deferred_init = None
            self._initialized = True
            self._var._mx_inited = True
            return
        with torch.no_grad():
            var.copy_(t)

    def zero_grad(self):
        g = self._var.grad
        if g is not None:
            with torch.no_grad():
                g.zero_()

    def reset_ctx(self, ctx):
        if not self._var.is_meta:
            dev = _device.to_torch(ctx)
            self._var.data = self._var.data.to(dev)
            if self._var.grad is not None:
                self._var.grad = self._var.grad.to(dev)

    def cast(self, dtype):
        td = to_torch_dtype(dtype)
        var = self._var
        if var.is_meta:
            self._replace(torch.empty(var.shape, dtype=td, device="meta"))
            return
        var.data = var.data.to(td)
        if var.grad is not None:
            var.grad = var.grad.to(td)


class Constant(Parameter):
    """A non-trainable constant (parity: gluon.Constant)."""

    def __init__(self, value, name="const"):
        t = value._data if isinstance(value, NDArray) else torch.as_tensor(
            value)
        super().__init__(name=name, grad_req="null", shape=tuple(t.shape),
                         dtype=t.dtype, differentiable=False,
                         init=_init.Constant(0))
        self._value = t
        self.set_data(t)

    def initialize(self, init=None, ctx=None, *args, **kwargs):
        if ctx is not None:
            self.reset_ctx(ctx)


class ParameterDict(dict):
    """name -> Parameter with batched helpers (parity: the v2
    collect_params() return type)."""

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False):
        for p in self.values():
            p.initialize(init=None, ctx=ctx, default_init=init,
                         force_reinit=force_reinit)

    def zero_grad(self):
        for p in self.values():
            p.zero_grad()

    def setattr(self, name, value):
        for p in self.values():
            setattr(p, name, value)

    def reset_ctx(self, ctx):
        for p in self.values():
            p.reset_ctx(ctx)

    def save(self, filename, strip_prefix=""):
        from ..serialization import save_parameter_dict
        save_parameter_dict(filename, self, strip_prefix=strip_prefix)

    def load(self, filename, ctx=None, allow_missing=False,
             ignore_extra=False, cast_dtype=False, dtype_source="current"):
        from ..serialization import load_parameter_dict
        load_parameter_dict(filename, self, ctx=ctx,
                            allow_missing=allow_missing,
                            ignore_extra=ignore_extra, cast_dtype=cast_dtype)

    def get(self, name, **kwargs):
        if name in self:
            return self[name]
        p = Parameter(name, **kwargs)
        self[name] = p
        return p
