"""Elementwise, reduction and linear-algebra ops.

Counterpart of mxnet_tpu/ops/math.py, op for op, on torch functions with
numpy broadcasting. A Python number against an array keeps the array's
dtype where the reference's weak typing does (an int against a float32
array gives float32; a float against an int32 array gives float32).
"""
from __future__ import annotations

import torch

from .registry import op

__all__ = []   # the ops are reached through the registry and mx.nd


def _t(x, like=None):
    """A Python number as a 0-d tensor on `like`'s device: floats as
    float32 and ints as int64 (which a narrower array's dtype absorbs)."""
    if isinstance(x, torch.Tensor):
        return x
    dev = like.device if isinstance(like, torch.Tensor) else None
    if isinstance(x, bool):
        return torch.tensor(x, device=dev)
    if isinstance(x, int):
        return torch.tensor(x, dtype=torch.int64, device=dev)
    if isinstance(x, float):
        return torch.tensor(x, dtype=torch.float32, device=dev)
    return torch.as_tensor(x, device=dev)


def _pair(a, b):
    ta = _t(a, b)
    return ta, _t(b, ta)


def _float(x):
    return x if x.is_floating_point() or x.is_complex() else \
        x.to(torch.float32)


# ---------------------------------------------------------------------------
# unary elementwise
# ---------------------------------------------------------------------------

def _cbrt(x):
    x = _float(x)
    return torch.sign(x) * torch.abs(x).pow(1.0 / 3.0)


def _imag(x):
    return torch.imag(x) if x.is_complex() else torch.zeros_like(x)


_UNARY = {
    "negative": torch.neg, "abs": torch.abs, "sign": torch.sign,
    "rint": torch.round, "ceil": torch.ceil, "floor": torch.floor,
    "trunc": torch.trunc, "square": torch.square,
    "sqrt": lambda x: torch.sqrt(_float(x)), "cbrt": _cbrt,
    "exp": lambda x: torch.exp(_float(x)),
    "expm1": lambda x: torch.expm1(_float(x)),
    "log": lambda x: torch.log(_float(x)),
    "log10": lambda x: torch.log10(_float(x)),
    "log2": lambda x: torch.log2(_float(x)),
    "log1p": lambda x: torch.log1p(_float(x)),
    "sin": lambda x: torch.sin(_float(x)),
    "cos": lambda x: torch.cos(_float(x)),
    "tan": lambda x: torch.tan(_float(x)),
    "arcsin": lambda x: torch.asin(_float(x)),
    "arccos": lambda x: torch.acos(_float(x)),
    "arctan": lambda x: torch.atan(_float(x)),
    "degrees": lambda x: torch.rad2deg(_float(x)),
    "radians": lambda x: torch.deg2rad(_float(x)),
    "sinh": lambda x: torch.sinh(_float(x)),
    "cosh": lambda x: torch.cosh(_float(x)),
    "tanh": lambda x: torch.tanh(_float(x)),
    "arcsinh": lambda x: torch.asinh(_float(x)),
    "arccosh": lambda x: torch.acosh(_float(x)),
    "arctanh": lambda x: torch.atanh(_float(x)),
    "reciprocal": torch.reciprocal, "logical_not": torch.logical_not,
    "isnan": torch.isnan, "isinf": torch.isinf, "isfinite": torch.isfinite,
    "bitwise_not": torch.bitwise_not,
    "conj": lambda x: torch.conj(x).resolve_conj() if x.is_complex() else x,
    "real": lambda x: torch.real(x), "imag": _imag,
    "angle": lambda x: torch.angle(_float(x)),
}

_g = globals()
for _name, _fn in _UNARY.items():
    _g[_name] = op(_name)((lambda f: lambda x: f(x))(_fn))
    _g[_name].__name__ = _name

fix = op("fix")(lambda x: torch.trunc(x))
rsqrt = op("rsqrt")(lambda x: torch.rsqrt(_float(x)))
rcbrt = op("rcbrt")(lambda x: 1.0 / _cbrt(x))
erf = op("erf")(lambda x: torch.erf(_float(x)))
erfinv = op("erfinv")(lambda x: torch.erfinv(_float(x)))
gamma = op("gamma")(lambda x: torch.exp(torch.lgamma(_float(x))))
gammaln = op("gammaln")(lambda x: torch.lgamma(_float(x)))
digamma = op("digamma")(lambda x: torch.digamma(_float(x)))
sigmoid = op("sigmoid")(lambda x: torch.sigmoid(_float(x)))
relu = op("relu")(lambda x: torch.relu(x))
softsign = op("softsign")(lambda x: x / (1 + torch.abs(x)))

# ---------------------------------------------------------------------------
# binary elementwise (numpy broadcasting)
# ---------------------------------------------------------------------------


def _float_power(a, b):
    a, b = _pair(a, b)
    return torch.float_power(a, b).to(torch.float32)


_BINARY = {
    "add": torch.add, "subtract": torch.sub, "multiply": torch.mul,
    "divide": torch.true_divide, "floor_divide": torch.floor_divide,
    "mod": torch.remainder, "power": torch.pow, "maximum": torch.maximum,
    "minimum": torch.minimum, "hypot": torch.hypot, "arctan2": torch.atan2,
    "equal": torch.eq, "not_equal": torch.ne, "less": torch.lt,
    "less_equal": torch.le, "greater": torch.gt, "greater_equal": torch.ge,
    "logical_and": torch.logical_and, "logical_or": torch.logical_or,
    "logical_xor": torch.logical_xor, "bitwise_and": torch.bitwise_and,
    "bitwise_or": torch.bitwise_or, "bitwise_xor": torch.bitwise_xor,
    "fmod": torch.fmod, "copysign": torch.copysign, "ldexp": torch.ldexp,
    "nextafter": torch.nextafter, "left_shift": torch.bitwise_left_shift,
    "right_shift": torch.bitwise_right_shift,
    "true_divide": torch.true_divide, "gcd": torch.gcd, "lcm": torch.lcm,
}
_FLOAT_ONLY = {"hypot", "arctan2", "copysign", "nextafter"}

for _name, _fn in _BINARY.items():
    def _make(f, name):
        def fn(a, b):
            a, b = _pair(a, b)
            if name in _FLOAT_ONLY:
                a, b = _float(a), _float(b)
            return f(a, b)
        return fn
    _g[_name] = op(_name)(_make(_fn, _name))
    _g[_name].__name__ = _name

float_power = op("float_power")(_float_power)

broadcast_add = broadcast_plus = elemwise_add = add
broadcast_sub = broadcast_minus = elemwise_sub = subtract
broadcast_mul = elemwise_mul = multiply
broadcast_div = elemwise_div = divide
broadcast_mod = mod
broadcast_power = power
broadcast_maximum = maximum
broadcast_minimum = minimum
broadcast_equal = equal
broadcast_not_equal = not_equal
broadcast_greater = greater
broadcast_greater_equal = greater_equal
broadcast_lesser = less
broadcast_lesser_equal = less_equal
broadcast_logical_and = logical_and
broadcast_logical_or = logical_or
broadcast_logical_xor = logical_xor
broadcast_hypot = hypot


@op("clip")
def clip(x, a_min=None, a_max=None):
    return torch.clamp(x, a_min, a_max)


@op("where")
def where(cond, a, b):
    if not isinstance(cond, torch.Tensor):
        cond = torch.as_tensor(cond)
    like = a if isinstance(a, torch.Tensor) else b
    a, b = _t(a, cond if like is None else like), _t(b, cond if like is None
                                                     else like)
    return torch.where(cond.bool() if cond.dtype != torch.bool else cond,
                       a, b)


@op("add_n")
def add_n(*args):
    if len(args) == 1 and isinstance(args[0], (tuple, list)):
        args = tuple(args[0])
    out = args[0]
    for a in args[1:]:
        out = out + a
    return out


ElementWiseSum = elemwise_sum = add_n


@op("smooth_l1")
def smooth_l1(x, scalar=1.0):
    s2 = scalar * scalar
    ax = torch.abs(x)
    return torch.where(ax < 1.0 / s2, 0.5 * s2 * x * x, ax - 0.5 / s2)


@op("logaddexp")
def logaddexp(a, b):
    a, b = _pair(a, b)
    return torch.logaddexp(_float(a), _float(b))


# ---------------------------------------------------------------------------
# reductions
# ---------------------------------------------------------------------------

def _axes(x, axis):
    """axis as torch's dim: None (all), or a tuple; () means none."""
    if axis is None:
        return None
    if isinstance(axis, int):
        return (axis,)
    return tuple(int(a) for a in axis)


def _exclude(x, axis, exclude):
    if not exclude:
        return axis
    if axis is None:
        return ()
    axis = (axis,) if isinstance(axis, int) else tuple(axis)
    axis = tuple(a % x.dim() for a in axis)
    return tuple(i for i in range(x.dim()) if i not in axis)


def _reduce(fn, x, axis, keepdims, **kw):
    dims = _axes(x, axis)
    if dims == ():
        return x
    if dims is None:
        out = fn(x, **kw)
        if keepdims:
            out = out.reshape((1,) * x.dim())
        return out
    return fn(x, dim=dims, keepdim=keepdims, **kw)


def _acc_dtype(x, dtype):
    from ..ndarray.ndarray import to_torch_dtype
    if dtype is not None:
        return to_torch_dtype(dtype)
    if x.dtype == torch.bool:
        return torch.int32
    return None


@op("sum")
def sum(x, axis=None, keepdims=False, dtype=None, exclude=False):
    axis = _exclude(x, axis, exclude)
    d = _acc_dtype(x, dtype)
    if d is not None:
        x = x.to(d)
    return _reduce(torch.sum, x, axis, keepdims)


@op("mean")
def mean(x, axis=None, keepdims=False, dtype=None, exclude=False):
    axis = _exclude(x, axis, exclude)
    d = _acc_dtype(x, dtype)
    x = x.to(d) if d is not None else x
    return _reduce(torch.mean, _float(x), axis, keepdims)


@op("prod")
def prod(x, axis=None, keepdims=False):
    dims = _axes(x, axis)
    if dims == ():
        return x
    if dims is None:
        out = torch.prod(x)
        return out.reshape((1,) * x.dim()) if keepdims else out
    for d in sorted((a % x.dim() for a in dims), reverse=True):
        x = torch.prod(x, dim=d, keepdim=keepdims)
    return x


@op("max")
def max(x, axis=None, keepdims=False):
    return _reduce(torch.amax, x, axis, keepdims) if axis is not None \
        else _reduce(lambda t: torch.amax(t), x, None, keepdims)


@op("min")
def min(x, axis=None, keepdims=False):
    return _reduce(torch.amin, x, axis, keepdims) if axis is not None \
        else _reduce(lambda t: torch.amin(t), x, None, keepdims)


@op("var")
def var(x, axis=None, ddof=0, keepdims=False):
    return _reduce(torch.var, _float(x), axis, keepdims, correction=ddof)


@op("std")
def std(x, axis=None, ddof=0, keepdims=False):
    return _reduce(torch.std, _float(x), axis, keepdims, correction=ddof)


@op("nansum")
def nansum(x, axis=None, keepdims=False):
    return _reduce(torch.nansum, x, axis, keepdims)


@op("nanprod")
def nanprod(x, axis=None, keepdims=False):
    x = torch.where(torch.isnan(x), torch.ones_like(x), x) \
        if x.is_floating_point() else x
    return prod.raw_fn(x, axis=axis, keepdims=keepdims)


@op("cumsum")
def cumsum(x, axis=None, dtype=None):
    from ..ndarray.ndarray import to_torch_dtype
    if axis is None:
        x, axis = x.reshape(-1), 0
    return torch.cumsum(x, dim=axis, dtype=to_torch_dtype(dtype))


@op("cumprod")
def cumprod(x, axis=None, dtype=None):
    from ..ndarray.ndarray import to_torch_dtype
    if axis is None:
        x, axis = x.reshape(-1), 0
    return torch.cumprod(x, dim=axis, dtype=to_torch_dtype(dtype))


@op("logsumexp")
def logsumexp(x, axis=None, keepdims=False):
    dims = _axes(x, axis)
    dims = tuple(range(x.dim())) if dims is None else dims
    return torch.logsumexp(_float(x), dim=dims, keepdim=keepdims)


@op("square_sum")
def square_sum(x, axis=None, keepdims=False):
    return _reduce(torch.sum, x * x, axis, keepdims)


@op("norm")
def norm(x, ord=2, axis=None, keepdims=False):
    if ord == 2 and axis is None:
        return torch.sqrt(torch.sum(x.float() ** 2)).to(x.dtype)
    dims = _axes(x, axis)
    if dims is None:
        dims = tuple(range(x.dim()))
    if len(dims) == 1:
        return torch.linalg.vector_norm(_float(x), ord=ord, dim=dims,
                                        keepdim=keepdims)
    return torch.linalg.matrix_norm(_float(x), ord=ord, dim=dims,
                                    keepdim=keepdims)


@op("moments")
def moments(x, axes=None, keepdims=False):
    m = _reduce(torch.mean, _float(x), axes, keepdims)
    v = _reduce(torch.var, _float(x), axes, keepdims, correction=0)
    return (m, v)


# ---------------------------------------------------------------------------
# linear algebra
# ---------------------------------------------------------------------------

def _swap(x):
    return x.transpose(-1, -2) if x.dim() > 1 else x


@op("dot")
def dot(a, b, transpose_a=False, transpose_b=False):
    if transpose_a:
        a = _swap(a)
    if transpose_b:
        b = _swap(b)
    if a.dim() == 0 or b.dim() == 0:
        return a * b
    if a.dim() <= 2 and b.dim() <= 2:
        return torch.matmul(a, b)
    return torch.tensordot(a, b, dims=([a.dim() - 1],
                                       [b.dim() - 2 if b.dim() > 1 else 0]))


@op("batch_dot")
def batch_dot(a, b, transpose_a=False, transpose_b=False):
    if transpose_a:
        a = a.transpose(-1, -2)
    if transpose_b:
        b = b.transpose(-1, -2)
    return torch.matmul(a, b)


@op("matmul")
def matmul(a, b):
    return torch.matmul(a, b)


@op("einsum")
def einsum(*operands, optimize=True):
    return torch.einsum(*operands)


@op("tensordot")
def tensordot(a, b, axes=2):
    return torch.tensordot(a, b, dims=axes)


@op("inner")
def inner(a, b):
    return torch.inner(a, b)


@op("outer")
def outer(a, b):
    return torch.outer(a.reshape(-1), b.reshape(-1))


@op("kron")
def kron(a, b):
    return torch.kron(a, b)


@op("trace")
def trace(x, offset=0, axis1=0, axis2=1):
    return torch.diagonal(x, offset=offset, dim1=axis1, dim2=axis2).sum(-1)


@op("linalg_gemm2")
def linalg_gemm2(a, b, transpose_a=False, transpose_b=False, alpha=1.0):
    a = a.transpose(-1, -2) if transpose_a else a
    b = b.transpose(-1, -2) if transpose_b else b
    return alpha * torch.matmul(a, b)


@op("linalg_gemm")
def linalg_gemm(a, b, c, transpose_a=False, transpose_b=False, alpha=1.0,
                beta=1.0):
    a = a.transpose(-1, -2) if transpose_a else a
    b = b.transpose(-1, -2) if transpose_b else b
    return alpha * torch.matmul(a, b) + beta * c


linalg_potrf = op("linalg_potrf")(lambda a: torch.linalg.cholesky(a))
cholesky = linalg_potrf


@op("linalg_trsm")
def linalg_trsm(a, b, transpose=False, rightside=False, lower=True,
                alpha=1.0):
    if transpose:
        a = a.transpose(-1, -2)
        lower = not lower
    x = torch.linalg.solve_triangular(a, b, upper=not lower,
                                      left=not rightside)
    return alpha * x


@op("linalg_syrk")
def linalg_syrk(a, transpose=False, alpha=1.0):
    at = a.transpose(-1, -2)
    return alpha * (torch.matmul(at, a) if transpose else torch.matmul(a, at))


linalg_det = op("linalg_det")(lambda a: torch.linalg.det(a))
linalg_slogdet = op("linalg_slogdet")(
    lambda a: tuple(torch.linalg.slogdet(a)))
linalg_inverse = op("linalg_inverse")(lambda a: torch.linalg.inv(a))
linalg_extractdiag = op("linalg_extractdiag")(
    lambda a, offset=0: torch.diagonal(a, offset=offset, dim1=-2, dim2=-1))


@op("linalg_makediag")
def linalg_makediag(a, offset=0):
    return torch.diag_embed(a, offset=offset, dim1=-2, dim2=-1)


svd = op("svd")(lambda a, full_matrices=False: tuple(
    torch.linalg.svd(a, full_matrices=full_matrices)))
eigh = op("eigh")(lambda a: tuple(torch.linalg.eigh(a)))
qr = op("qr")(lambda a: tuple(torch.linalg.qr(a)))
solve = op("solve")(lambda a, b: torch.linalg.solve(a, b))


@op("lstsq", nodiff=True)
def lstsq(a, b, rcond=None):
    """(x, residuals, rank, singular values) as numpy's lstsq returns
    them: residuals only when the rank is full and rows exceed columns."""
    dt = a.dtype
    a, b = a.double(), b.double()
    m, n = a.shape[-2], a.shape[-1]
    x = torch.linalg.pinv(a, rtol=rcond) @ b if rcond is not None \
        else torch.linalg.pinv(a) @ b
    sv = torch.linalg.svdvals(a)
    rank = torch.linalg.matrix_rank(a)
    if int(rank) == n and m > n:
        r = a @ x - b
        resid = (r * r).sum(0)
        resid = resid.reshape(-1) if b.dim() > 1 else resid.reshape(1)
    else:
        resid = torch.zeros((0,), dtype=a.dtype, device=a.device)
    return (x.to(dt), resid.to(dt), rank.to(torch.int32), sv.to(dt))


pinv = op("pinv")(lambda a: torch.linalg.pinv(a))
matrix_rank = op("matrix_rank", nodiff=True)(
    lambda a: torch.linalg.matrix_rank(a).to(torch.int32))

