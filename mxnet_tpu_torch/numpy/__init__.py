"""mx.np: the NumPy-named array namespace.

Counterpart of mxnet_tpu/numpy/__init__.py. The NDArray already follows
NumPy semantics (broadcasting, the reference's dtypes), so this is:

  1. the nd op surface under its NumPy names, looked up as the reference
     does: ops.math first, then mx.nd (its sorts are stable);
  2. then a table of torch counterparts for the NumPy names the nd surface
     lacks (the reference lifts any `jax.numpy` function instead),
     lifted through the NDArray funnel so they record under autograd:
     `axis` / `axes` become `dim` and `keepdims` `keepdim`, and the
     elementwise binaries promote as the reference does (a 0-d array
     counts like any other; only a Python number is weak) where torch's
     rule differs;
  3. `linalg` and `fft`, sub-namespaces over torch.linalg / torch.fft.

A NumPy name with no counterpart raises `not_ported` with its name.
"""
from __future__ import annotations

import numpy as _onp
import torch

from ..base import not_ported
from ..ndarray.ndarray import NDArray, array, newaxis  # noqa: F401
from ..ndarray import (  # noqa: F401
    zeros, ones, full, empty, arange, linspace, eye, tri, meshgrid,
    concatenate, stack, transpose, reshape, squeeze, expand_dims, tile,
    repeat, flip, roll, tril, triu, take, zeros_like, ones_like, full_like,
    diag, pad, split_v2 as split, swapaxes, broadcast_to,
)
from ..ops import math as _m
from ..ops import random  # noqa: F401  (mx.np.random)
from ..ops.registry import op as _op

ndarray = NDArray

pi = _onp.pi
e = _onp.e
inf = _onp.inf
nan = _onp.nan
euler_gamma = _onp.euler_gamma

float16 = "float16"
float32 = "float32"
float64 = "float64"
bfloat16 = "bfloat16"
int8 = "int8"
int16 = "int16"
int32 = "int32"
int64 = "int64"
uint8 = "uint8"
bool_ = "bool"

_KW = {"axis": "dim", "axes": "dim", "keepdims": "keepdim"}


def _promote(args):
    """The arguments as tensors of the reference's result dtype: arrays
    (0-d ones too) by the type lattice, Python numbers weakly."""
    tens = [a for a in args if isinstance(a, torch.Tensor)]
    if not tens:
        return args
    dt = tens[0].dtype
    for t in tens[1:]:
        dt = torch.promote_types(dt, t.dtype)
    for a in args:
        if isinstance(a, bool) or not isinstance(a, (int, float, complex)):
            continue
        if isinstance(a, complex) and not dt.is_complex:
            dt = torch.complex64
        elif isinstance(a, float) and not (dt.is_floating_point
                                           or dt.is_complex):
            dt = torch.float32
    dev = tens[0].device
    return [a.to(dt) if isinstance(a, torch.Tensor) else
            torch.tensor(a, dtype=dt, device=dev)
            if isinstance(a, (int, float, complex)) else a for a in args]


def _lift(name, tfn, binary=False, prefix="np"):
    """A torch function as an mx.np op over NDArrays (numpy keywords)."""

    def fn(*args, **kwargs):
        kw = {_KW.get(k, k): v for k, v in kwargs.items()}
        if "dim" in kw and kw["dim"] is None:
            del kw["dim"]
        if binary:
            args = _promote(args)
        return tfn(*args, **kw)

    fn.__name__ = name
    return _op(name=f"{prefix}_{name}", register=False)(fn)


def _reduce(fn):
    """A reduction over dim=None (everything) or a dim / tuple of dims."""
    def red(x, dim=None, keepdim=False, **kw):
        if dim is None:
            out = fn(x.reshape(-1), dim=0, **kw)
            return out.reshape((1,) * x.dim()) if keepdim else out
        return fn(x, dim=dim, keepdim=keepdim, **kw)
    return red


def _quantile(x, q, dim=None, keepdim=False, method="linear"):
    q = torch.as_tensor(q, dtype=x.dtype, device=x.device)
    return torch.quantile(x, q, dim=dim, keepdim=keepdim,
                          interpolation=method)


def _percentile(x, q, dim=None, keepdim=False, method="linear"):
    return _quantile(x, torch.as_tensor(q, dtype=torch.float32) / 100, dim,
                     keepdim, method)


def _median(x, dim=None, keepdim=False):
    return _quantile(x, 0.5, dim, keepdim)


def _nanvar(x, dim=None, keepdim=False, ddof=0):
    n = (~torch.isnan(x)).sum(dim=dim, keepdim=True)
    mean = torch.nansum(x, dim=dim, keepdim=True) / n
    out = torch.nansum((x - mean) ** 2, dim=dim, keepdim=True) / (n - ddof)
    return out if keepdim else out.squeeze() if dim is None else \
        out.squeeze(dim)


def _ptp(x, dim=None, keepdim=False):
    return _reduce(torch.amax)(x, dim, keepdim) - \
        _reduce(torch.amin)(x, dim, keepdim)


def _count_nonzero(x, dim=None, keepdim=False):
    out = torch.count_nonzero(x, dim=dim)
    if keepdim:
        out = out.reshape((1,) * x.dim()) if dim is None else \
            out.unsqueeze(dim)
    return out


def _nancumsum(x, dim=None):
    x = torch.nan_to_num(x, nan=0.0)
    return torch.cumsum(x.reshape(-1), 0) if dim is None else \
        torch.cumsum(x, dim)


def _round(x, decimals=0):
    return torch.round(x, decimals=decimals)


def _diff(x, n=1, dim=-1):
    return torch.diff(x, n=n, dim=dim)


_TABLE = {
    # elementwise, one argument
    "absolute": (torch.abs, False), "fabs": (torch.abs, False),
    "positive": (torch.positive, False), "exp2": (torch.exp2, False),
    "deg2rad": (torch.deg2rad, False), "rad2deg": (torch.rad2deg, False),
    "signbit": (torch.signbit, False), "sinc": (torch.sinc, False),
    "i0": (torch.i0, False), "invert": (torch.bitwise_not, False),
    "bitwise_invert": (torch.bitwise_not, False),
    "nan_to_num": (torch.nan_to_num, False), "round": (_round, False),
    "around": (_round, False), "isneginf": (torch.isneginf, False),
    "isposinf": (torch.isposinf, False), "isreal": (torch.isreal, False),
    "conjugate": (torch.conj_physical, False),
    "acos": (torch.acos, False), "asin": (torch.asin, False),
    "atan": (torch.atan, False), "acosh": (torch.acosh, False),
    "asinh": (torch.asinh, False), "atanh": (torch.atanh, False),
    # elementwise, two arguments (the reference's promotion)
    "fmax": (torch.fmax, True), "fmin": (torch.fmin, True),
    "heaviside": (torch.heaviside, True), "atan2": (torch.atan2, True),
    "logaddexp2": (torch.logaddexp2, True), "remainder": (torch.remainder,
                                                          True),
    "pow": (torch.pow, True), "isclose": (torch.isclose, True),
    "bitwise_left_shift": (torch.bitwise_left_shift, True),
    "bitwise_right_shift": (torch.bitwise_right_shift, True),
    # reductions and statistics
    "all": (_reduce(torch.all), False), "any": (_reduce(torch.any), False),
    "amax": (_reduce(torch.amax), False), "amin": (_reduce(torch.amin),
                                                   False),
    "nanmean": (torch.nanmean, False), "nanvar": (_nanvar, False),
    "nanstd": (lambda *a, **k: torch.sqrt(_nanvar(*a, **k)), False),
    "median": (_median, False), "quantile": (_quantile, False),
    "percentile": (_percentile, False), "ptp": (_ptp, False),
    "count_nonzero": (_count_nonzero, False),
    "nancumsum": (_nancumsum, False),
    "cov": (torch.cov, False), "corrcoef": (torch.corrcoef, False),
    # shape and order
    "ravel": (lambda x: x.reshape(-1), False),
    "moveaxis": (torch.moveaxis, False), "rot90": (torch.rot90, False),
    "fliplr": (torch.fliplr, False), "flipud": (torch.flipud, False),
    "vstack": (lambda xs: torch.vstack(xs), False),
    "hstack": (lambda xs: torch.hstack(xs), False),
    "dstack": (lambda xs: torch.dstack(xs), False),
    "column_stack": (lambda xs: torch.column_stack(xs), False),
    "atleast_3d": (torch.atleast_3d, False),
    "diagflat": (torch.diagflat, False), "diff": (_diff, False),
    "argwhere": (torch.argwhere, False),
    "empty_like": (torch.empty_like, False),
    "copy": (torch.clone, False),
}

_LINALG = {
    "norm": lambda x, ord=None, dim=None, keepdim=False: torch.linalg.norm(
        x, ord=ord, dim=dim, keepdim=keepdim),
    "inv": torch.linalg.inv, "det": torch.linalg.det,
    "slogdet": lambda x: tuple(torch.linalg.slogdet(x)),
    "solve": torch.linalg.solve, "pinv": torch.linalg.pinv,
    "cholesky": torch.linalg.cholesky, "eigvalsh": torch.linalg.eigvalsh,
    "eigh": lambda x, UPLO="L": tuple(torch.linalg.eigh(x, UPLO=UPLO)),
    "qr": lambda x, mode="reduced": tuple(torch.linalg.qr(x, mode=mode)),
    "svd": lambda x, full_matrices=True, compute_uv=True: tuple(
        torch.linalg.svd(x, full_matrices=full_matrices)) if compute_uv
    else torch.linalg.svdvals(x),
    "matrix_rank": torch.linalg.matrix_rank,
    "matrix_power": torch.linalg.matrix_power,
    "multi_dot": lambda xs: torch.linalg.multi_dot(xs),
    "cond": torch.linalg.cond,
    "lstsq": lambda a, b, rcond=None: tuple(torch.linalg.lstsq(a, b)),
}

_FFT = {name: getattr(torch.fft, name) for name in (
    "fft", "ifft", "rfft", "irfft", "fft2", "ifft2", "rfft2", "irfft2",
    "fftn", "ifftn", "rfftn", "irfftn", "hfft", "ihfft", "fftshift",
    "ifftshift")}
_FFT["fftfreq"] = lambda n, d=1.0: torch.fft.fftfreq(n, d)
_FFT["rfftfreq"] = lambda n, d=1.0: torch.fft.rfftfreq(n, d)


class _SubNamespace:
    """mx.np.linalg / mx.np.fft: torch.linalg / torch.fft lifted through
    the funnel (so the results record under autograd)."""

    def __init__(self, table, prefix, reference):
        self._table = table
        self._prefix = prefix
        self._reference = reference
        self._cache = {}

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        if name not in self._cache:
            fn = self._table.get(name)
            if fn is None:
                if hasattr(self._reference, name):
                    raise not_ported(f"mx.np.{self._prefix}.{name}")
                raise AttributeError(
                    f"module 'mxnet_tpu_torch.numpy.{self._prefix}' has no "
                    f"attribute {name!r}")
            self._cache[name] = _lift(name, fn, prefix=f"np_{self._prefix}")
        return self._cache[name]


linalg = _SubNamespace(_LINALG, "linalg", _onp.linalg)
fft = _SubNamespace(_FFT, "fft", _onp.fft)

_cache = {}


def __getattr__(name):
    if name in _cache:
        return _cache[name]
    if name.startswith("_"):
        raise AttributeError(name)
    from .. import ndarray as _nd
    target = None
    if hasattr(_m, name):
        target = getattr(_m, name)
    elif hasattr(_nd, name):
        target = getattr(_nd, name)
    elif name in _TABLE:
        fn, binary = _TABLE[name]
        target = _lift(name, fn, binary)
    if target is None:
        if hasattr(_onp, name):
            raise not_ported(f"mx.np.{name}")
        raise AttributeError(
            f"module 'mxnet_tpu_torch.numpy' has no attribute {name!r}")
    _cache[name] = target
    return target
