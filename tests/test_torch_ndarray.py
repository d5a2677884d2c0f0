"""The port's NDArray and op registry against the JAX package.

One parametrised case per registered op of the port's table
(mxnet_tpu_torch.ops.registry.OPS, the same 247 names as the
reference's): the same numpy inputs (seeded) go through `mx.nd.<op>` of
both packages, the port on the CPU. Tolerances: float results within
1e-6 of the reference relative to its largest magnitude; integer, index
and boolean results exactly; the dtype of each result equal. The
decompositions (svd, eigh, qr) compare what is unique (singular values,
eigenvalues, |vectors|). The samplers draw other streams than
jax.random, so their cases hold shape and dtype here and their moments
and seed determinism in tests below. Ops the reference refuses because
their shape depends on the data (boolean_mask, where_index) are held to
numpy. The reference ops the port lacks are listed in NOT_PORTED and
must raise `not_ported`. gammaln and gamma (OWN_ERROR): the reference's
float32 Lanczos sum is itself up to 1.2e-6 off the exact value near the
zeros of lgamma, where torch's lgamma is exact to float32; there the
port is held to the float64 value within 1e-6, and to the reference
within 1e-6 plus the reference's own distance from that value.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import mxnet_tpu as jmx  # noqa: E402
from mxnet_tpu.ops.registry import OPS as JOPS  # noqa: E402

import mxnet_tpu_torch as mx  # noqa: E402
from mxnet_tpu_torch import MXNetError  # noqa: E402
from mxnet_tpu_torch.ops.registry import OPS  # noqa: E402

CPU = mx.cpu()
NOT_PORTED = {"deconvolution", "rnn", "roi_align"}
REL = 1e-6


def _r(seed=0):
    return np.random.default_rng(seed)


def _f(*shape, seed=0, lo=None, hi=None):
    r = _r(seed)
    if lo is not None:
        return r.uniform(lo, hi, shape).astype(np.float32)
    return r.standard_normal(shape).astype(np.float32)


def _i(*shape, lo=0, hi=10, seed=0):
    return _r(seed).integers(lo, hi, shape).astype(np.int32)


def _well(n, seed=0):
    """A well-conditioned square matrix."""
    return (np.eye(n) * 2 + 0.1 * _r(seed).standard_normal((n, n))
            ).astype(np.float32)


def _spd(n, seed=0):
    a = _f(n, n, seed=seed)
    return (a @ a.T + n * np.eye(n)).astype(np.float32)


X = _f(3, 4)
POS = _f(3, 4, lo=0.5, hi=2.0)
UNIT = _f(3, 4, lo=-0.9, hi=0.9, seed=1)
I = _i(3, 4, lo=1, hi=20)
I2 = _i(3, 4, lo=1, hi=20, seed=1)
BOOL = _r(2).random((3, 4)) > 0.5
BOOL2 = _r(3).random((3, 4)) > 0.5
NANX = X.copy()
NANX[0, 1] = np.nan
NANX[2, 2] = np.inf

_UNARY_DOMAIN = {
    "sqrt": POS, "log": POS, "log10": POS, "log2": POS, "log1p": POS,
    "rsqrt": POS, "rcbrt": POS, "gamma": POS, "gammaln": POS,
    "digamma": POS, "arcsin": UNIT, "arccos": UNIT, "arctanh": UNIT,
    "erfinv": UNIT, "arccosh": POS + 1.0, "reciprocal": POS,
    "logical_not": BOOL, "bitwise_not": I, "isnan": NANX, "isinf": NANX,
    "isfinite": NANX,
    "rint": np.array([0.5, 1.5, 2.5, -0.5, -1.5, 0.4, 2.6], np.float32)}
_UNARY = ["negative", "abs", "sign", "rint", "ceil", "floor", "trunc",
          "square", "sqrt", "cbrt", "exp", "expm1", "log", "log10", "log2",
          "log1p", "sin", "cos", "tan", "arcsin", "arccos", "arctan",
          "degrees", "radians", "sinh", "cosh", "tanh", "arcsinh",
          "arccosh", "arctanh", "reciprocal", "logical_not", "isnan",
          "isinf", "isfinite", "bitwise_not", "conj", "real", "imag",
          "angle", "fix", "rsqrt", "rcbrt", "erf", "erfinv", "gamma",
          "gammaln", "digamma", "sigmoid", "relu", "softsign", "softplus",
          "silu", "hard_sigmoid", "log_sigmoid", "gelu", "softmin",
          "log_softmax", "identity", "zeros_like", "ones_like",
          "stop_gradient", "l2normalization", "flatten"]
_BINARY_DOMAIN = {
    "floor_divide": (X, POS), "mod": (X, POS), "fmod": (X, POS),
    "divide": (X, POS), "true_divide": (X, POS), "power": (POS, X),
    "float_power": (POS, X), "logical_and": (BOOL, BOOL2),
    "logical_or": (BOOL, BOOL2), "logical_xor": (BOOL, BOOL2),
    "bitwise_and": (I, I2), "bitwise_or": (I, I2), "bitwise_xor": (I, I2),
    "left_shift": (I, I2 % 5), "right_shift": (I, I2 % 5), "gcd": (I, I2),
    "lcm": (I, I2), "ldexp": (X, I2 % 5)}
_BINARY = ["add", "subtract", "multiply", "divide", "floor_divide", "mod",
           "power", "maximum", "minimum", "hypot", "arctan2", "equal",
           "not_equal", "less", "less_equal", "greater", "greater_equal",
           "logical_and", "logical_or", "logical_xor", "bitwise_and",
           "bitwise_or", "bitwise_xor", "fmod", "copysign", "ldexp",
           "nextafter", "left_shift", "right_shift", "true_divide",
           "float_power", "gcd", "lcm", "logaddexp"]

A34, B45 = _f(3, 4, seed=4), _f(4, 5, seed=5)
X3 = _f(2, 3, 4, seed=6)
IMG = _f(1, 2, 6, 6, seed=7)
SEQ = _f(4, 3, 2, seed=8)
LENS = np.array([2, 4, 1], np.int32)
ANCH = np.array([[[0.1, 0.1, 0.4, 0.5], [0.3, 0.2, 0.7, 0.6],
                  [0.5, 0.5, 0.9, 0.9], [0.0, 0.0, 0.3, 0.3]]], np.float32)
LABEL = np.array([[[1, 0.12, 0.1, 0.42, 0.5], [0, 0.5, 0.45, 0.9, 0.95],
                   [-1, 0, 0, 0, 0]]], np.float32)
CLS = _f(1, 3, 4, seed=9)
NMS = np.array([[[0, 0.9, 0.1, 0.1, 0.4, 0.4], [0, 0.8, 0.12, 0.1, 0.4, 0.42],
                 [1, 0.7, 0.1, 0.1, 0.4, 0.4], [0, 0.6, 0.5, 0.5, 0.9, 0.9],
                 [1, 0.05, 0.2, 0.2, 0.3, 0.3], [-1, 0.5, 0, 0, 1, 1]]],
               np.float32)
Q = _f(2, 2, 5, 4, seed=10)
KP = np.array([[True] * 5, [True, True, True, False, False]])

# name -> (positional args, keyword args); numpy arrays become NDArrays
SPECS = {
    "clip": ((X, -0.5, 0.5), {}),
    "where": ((BOOL, X, POS), {}),
    "add_n": ((X, POS, UNIT), {}),
    "smooth_l1": ((X,), {"scalar": 1.5}),
    "sum": ((X3,), {"axis": 1, "keepdims": True}),
    "mean": ((X3,), {"axis": (0, 2)}),
    "prod": ((X3,), {"axis": 2}),
    "max": ((X3,), {"axis": 1}),
    "min": ((X3,), {}),
    "var": ((X3,), {"axis": 1, "ddof": 1}),
    "std": ((X3,), {"axis": 2}),
    "nansum": ((np.where(np.isinf(NANX), np.nan, NANX),),
               {"axis": 1}),
    "nanprod": ((np.where(np.isinf(NANX), np.nan, NANX),), {"axis": 0}),
    "cumsum": ((X,), {"axis": 1}),
    "cumprod": ((X,), {"axis": 0}),
    "logsumexp": ((X3,), {"axis": 2}),
    "square_sum": ((X3,), {"axis": 1}),
    "norm": ((X3,), {}),
    "moments": ((X3,), {"axes": (1,)}),
    "dot": ((A34, B45), {}),
    "batch_dot": ((X3, _f(2, 5, 4, seed=11)), {"transpose_b": True}),
    "matmul": ((X3, _f(4, 2, seed=12)), {}),
    "einsum": (("ij,jk->ik", A34, B45), {}),
    "tensordot": ((A34, B45), {"axes": 1}),
    "inner": ((A34, _f(5, 4, seed=13)), {}),
    "outer": ((_f(3), _f(4, seed=1)), {}),
    "kron": ((_f(2, 2), _f(2, 3, seed=1)), {}),
    "trace": ((_f(3, 3),), {}),
    "linalg_gemm2": ((A34, _f(5, 4, seed=13)), {"transpose_b": True,
                                                 "alpha": 0.5}),
    "linalg_gemm": ((A34, B45, _f(3, 5, seed=14)), {"beta": 2.0}),
    "linalg_potrf": ((_spd(4),), {}),
    "linalg_trsm": ((np.tril(_well(3)), _f(3, 2)), {}),
    "linalg_syrk": ((A34,), {"alpha": 2.0}),
    "linalg_det": ((_well(3),), {}),
    "linalg_slogdet": ((_well(3),), {}),
    "linalg_inverse": ((_well(3),), {}),
    "linalg_extractdiag": ((_f(3, 3),), {"offset": 1}),
    "linalg_makediag": ((_f(3),), {"offset": -1}),
    "svd": ((A34,), {}),
    "eigh": ((_spd(3),), {}),
    "qr": ((_well(3),), {}),
    "solve": ((_well(3), _f(3, 2)), {}),
    "lstsq": ((_f(5, 3), _f(5, seed=1)), {}),
    "pinv": ((_f(4, 3),), {}),
    "matrix_rank": ((_f(4, 3),), {}),
    "reshape": ((X3,), {"shape": (0, -1)}),
    "transpose": ((X3,), {"axes": (1, 0, 2)}),
    "swapaxes": ((X3, 0, 2), {}),
    "expand_dims": ((X,), {"axis": 1}),
    "squeeze": ((_f(1, 3, 1),), {"axis": 0}),
    "broadcast_to": ((_f(1, 4),), {"shape": (3, 0)}),
    "broadcast_axis": ((_f(1, 4),), {"axis": 0, "size": 3}),
    "concat": ((X, POS), {"dim": 1}),
    "concatenate": (([X, POS],), {"axis": 0}),
    "stack": ((X, POS), {"axis": 1}),
    "split": ((_f(2, 6),), {"num_outputs": 3, "axis": 1}),
    "split_v2": ((_f(2, 6),), {"indices_or_sections": [1, 4], "axis": 1}),
    "tile": ((X,), {"reps": (2, 1)}),
    "repeat": ((X,), {"repeats": 2, "axis": 1}),
    "pad": ((_f(1, 1, 3, 4),), {"pad_width": (0, 0, 0, 0, 1, 2, 2, 1),
                                "mode": "reflect"}),
    "flip": ((X,), {"axis": 1}),
    "roll": ((X,), {"shift": 2, "axis": 1}),
    "slice": ((_f(4, 5),), {"begin": (1, None), "end": (3, None),
                            "step": (1, -2)}),
    "slice_axis": ((_f(4, 5),), {"axis": 1, "begin": 1, "end": 3}),
    "slice_like": ((_f(4, 5), _f(2, 3)), {}),
    "dynamic_slice": ((_f(4, 5), (3, 1)), {"slice_sizes": (2, 2)}),
    "dynamic_update_slice": ((_f(4, 5), _f(2, 2, seed=1), (3, 4)), {}),
    "atleast_1d": ((np.float32(3.0),), {}),
    "atleast_2d": ((_f(3),), {}),
    "diag": ((_f(3),), {"k": 1}),
    "diagonal": ((X3,), {"offset": 1, "axis1": 1, "axis2": 2}),
    "tril": ((A34,), {"k": -1}),
    "triu": ((A34,), {"k": 1}),
    "depth_to_space": ((_f(1, 8, 2, 3),), {"block_size": 2}),
    "space_to_depth": ((_f(1, 2, 4, 6),), {"block_size": 2}),
    "cast": ((X * 3,), {"dtype": "int32"}),
    "amp_cast": ((X,), {"dtype": "float16"}),
    "amp_multicast": ((X, X.astype(np.float16)), {"num_outputs": 2}),
    "full_like": ((X,), {"fill_value": 3.5}),
    "shape_array": ((X3,), {}),
    "size_array": ((X3,), {}),
    "take": ((_f(5, 4), np.array([0, 4, 7, -1], np.int32)),
             {"axis": 0, "mode": "clip"}),
    "pick": ((A34, np.array([0, 3, 1], np.int32)), {"axis": 1}),
    "take_along_axis": ((A34, _i(3, 2, hi=4)), {"axis": 1}),
    "gather_nd": ((A34, np.array([[0, 2, 1, 2, 0], [3, 0, 1, 2, 3]],
                                 np.int32)), {}),
    "scatter_nd": ((_f(3), np.array([[0, 2, 1], [3, 0, 1]], np.int32)),
                   {"shape": (3, 4)}),
    "index_update": ((_f(5, 3), np.array([0, 2], np.int32),
                      _f(2, 3, seed=1)), {}),
    "index_add": ((_f(5, 3), np.array([0, 2, 0], np.int32),
                   _f(3, 3, seed=1)), {}),
    "one_hot": ((np.array([0, 3, 4, 1], np.int32),), {"depth": 5}),
    "embedding": ((np.array([[0, 3], [4, 1]], np.int32), _f(5, 3)),
                  {"input_dim": 5, "output_dim": 3}),
    "sequence_mask": ((SEQ, LENS), {"use_sequence_length": True,
                                    "value": -1.0, "axis": 0}),
    "sequence_last": ((SEQ, LENS), {"use_sequence_length": True}),
    "sequence_reverse": ((SEQ, LENS), {"use_sequence_length": True}),
    "argmax": ((A34,), {"axis": 1}),
    "argmin": ((A34,), {"axis": 0, "keepdims": True}),
    "sort": ((A34,), {"axis": 1, "is_ascend": False}),
    "argsort": ((A34,), {"axis": 1}),
    "topk": ((A34,), {"axis": 1, "k": 2, "ret_typ": "both"}),
    "searchsorted": ((np.array([0.0, 1, 2, 3], np.float32),
                      np.array([-1, 0.5, 2, 2.5, 9], np.float32)),
                     {"side": "right"}),
    "unique": ((np.array([3, 1, 3, 7, 1], np.int32),), {"size": 6}),
    "histogram": ((X,), {"bins": 5}),
    "bincount": ((np.array([0, 1, 1, 3, 7], np.int32),), {"minlength": 6}),
    "fullyconnected": ((X3, _f(5, 12, seed=1), _f(5, seed=2)),
                       {"num_hidden": 5}),
    "convolution": ((_f(1, 2, 5, 5), _f(3, 2, 3, 3, seed=1), _f(3, seed=2)),
                    {"kernel": (3, 3), "pad": (1, 1), "num_filter": 3}),
    "batchnorm": ((_f(2, 3, 4, 4), _f(3, seed=1), _f(3, seed=2),
                   _f(3, seed=3), POS[0, :3]), {"fix_gamma": False}),
    "layernorm": ((X3, _f(4, seed=1), _f(4, seed=2)), {}),
    "groupnorm": ((_f(2, 4, 3, 3), _f(4, seed=1), _f(4, seed=2)),
                  {"num_groups": 2}),
    "instancenorm": ((_f(2, 3, 4, 4), _f(3, seed=1), _f(3, seed=2)), {}),
    "lrn": ((_f(1, 5, 3, 3),), {"nsize": 3}),
    "rms_norm": ((X3, _f(4, seed=1)), {}),
    "activation": ((X,), {"act_type": "softrelu"}),
    "leakyrelu": ((X,), {"act_type": "elu", "slope": 0.3}),
    "softmax": ((X,), {"axis": -1, "temperature": 2.0}),
    "masked_softmax": ((X, BOOL), {}),
    "softmax_cross_entropy": ((_f(3, 5), np.array([0, 4, 2], np.int32)),
                              {}),
    "softmaxoutput": ((X, np.array([0, 1, 2], np.int32)), {}),
    "dropout": ((X,), {"p": 0.5}),
    "pooling": ((IMG,), {"kernel": (3, 3), "stride": (2, 2), "pad": (1, 1),
                         "pool_type": "avg", "pooling_convention": "full",
                         "count_include_pad": False}),
    "upsampling": ((_f(1, 2, 3, 3),), {"scale": 2}),
    "bilinearresize2d": ((_f(1, 2, 4, 4),), {"height": 8, "width": 8}),
    "dot_product_attention": ((Q, _f(2, 2, 5, 4, seed=11),
                               _f(2, 2, 5, 4, seed=12), KP), {}),
    "box_iou": ((_f(3, 4, lo=0, hi=1), _f(5, 4, lo=0, hi=1, seed=1)),
                {"format": "center"}),
    "box_nms": ((NMS,), {"overlap_thresh": 0.5, "valid_thresh": 0.1,
                         "id_index": 0}),
    "multibox_prior": ((_f(1, 3, 4, 4),), {"sizes": (0.5, 0.25),
                                           "ratios": (1.0, 2.0)}),
    "multibox_target": ((ANCH, LABEL, CLS), {}),
    "multibox_detection": ((np.abs(CLS) / np.abs(CLS).sum(1, keepdims=True),
                            _f(1, 16, seed=3) * 0.1, ANCH),
                           {"threshold": 0.01}),
    # samplers: shape and dtype here, moments below
    "random_uniform": ((), {"low": -1.0, "high": 2.0, "shape": (3, 4)}),
    "random_normal": ((), {"loc": 1.0, "scale": 2.0, "shape": (3, 4)}),
    "random_randint": ((0, 10), {"shape": (3, 4)}),
    "random_gamma": ((), {"alpha": 2.0, "shape": (3, 4)}),
    "random_exponential": ((), {"scale": 2.0, "shape": (3, 4)}),
    "random_poisson": ((), {"lam": 3.0, "shape": (3, 4)}),
    "random_negative_binomial": ((), {"k": 3, "p": 0.4, "shape": (3, 4)}),
    "random_generalized_negative_binomial": ((), {"mu": 2.0, "alpha": 0.5,
                                                  "shape": (3, 4)}),
    "sample_multinomial": ((np.array([[0.1, 0.2, 0.3, 0.4],
                                      [0.7, 0.1, 0.1, 0.1]], np.float32),),
                           {"shape": 3}),
    "categorical": ((_f(2, 4),), {}),
    "shuffle": ((A34,), {}),
    "random_permutation": ((6,), {}),
    "bernoulli": ((), {"prob": 0.3, "shape": (4,)}),
    "sample_gamma": ((POS[0, :2], POS[1, :2]), {"shape": (3,)}),
    "sample_normal": ((X[0, :2], POS[0, :2]), {"shape": (3,)}),
    "sample_uniform": ((X[0, :2], X[0, :2] + 1), {"shape": (3,)}),
    "gumbel": ((), {"shape": (3, 4)}),
    "laplace": ((), {"loc": 0.5, "scale": 2.0, "shape": (3, 4)}),
}
for _n in _UNARY:
    SPECS.setdefault(_n, ((_UNARY_DOMAIN.get(_n, X),), {}))
for _n in _BINARY:
    SPECS.setdefault(_n, (_BINARY_DOMAIN.get(_n, (X, POS)), {}))
RANDOM = {"random_uniform", "random_normal", "random_randint",
          "random_gamma", "random_exponential", "random_poisson",
          "random_negative_binomial", "random_generalized_negative_binomial",
          "sample_multinomial", "categorical", "shuffle",
          "random_permutation", "bernoulli", "sample_gamma",
          "sample_normal", "sample_uniform", "gumbel", "laplace"}
NUMPY_HELD = {"boolean_mask", "where_index"}
SPECTRAL = {"svd", "eigh", "qr"}
OWN_ERROR = {"gammaln": lambda x: torch.lgamma(torch.from_numpy(x).double()),
             "gamma": lambda x: torch.exp(torch.lgamma(
                 torch.from_numpy(x).double()))}


def _nd(pkg, a):
    if isinstance(a, np.ndarray) or isinstance(a, np.generic):
        a = np.asarray(a)
        if pkg == "port":
            return mx.nd.array(a, ctx=CPU, dtype=a.dtype)
        return jmx.nd.array(a, dtype=a.dtype)
    if isinstance(a, list):
        return [_nd(pkg, x) for x in a]
    return a


def _call(pkg, name, args, kwargs):
    fn = (OPS if pkg == "port" else JOPS).get(name)
    args = [_nd(pkg, a) for a in args]
    kwargs = {k: _nd(pkg, v) for k, v in kwargs.items()}
    if pkg == "port" and name in RANDOM and not any(
            isinstance(a, mx.nd.NDArray) for a in args):
        kwargs["ctx"] = CPU
    return fn(*args, **kwargs)


def _np(out):
    if isinstance(out, (tuple, list)):
        return [_np(o) for o in out]
    return np.asarray(out.asnumpy())


def _same(got, want, name, rel=REL):
    if isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), name
        for g, w in zip(got, want):
            _same(g, w, name, rel)
        return
    assert got.shape == want.shape, (name, got.shape, want.shape)
    assert got.dtype == want.dtype, (name, got.dtype, want.dtype)
    if want.dtype.kind in "fc":
        fin = np.isfinite(want)
        np.testing.assert_array_equal(np.isfinite(got), fin, err_msg=name)
        np.testing.assert_array_equal(got[~fin], want[~fin], err_msg=name)
        if fin.any():
            scale = max(float(np.abs(want[fin]).max()), 1e-30)
            err = float(np.abs(got[fin].astype(np.float64)
                               - want[fin]).max())
            assert err <= rel * scale, (name, err, scale)
    else:
        np.testing.assert_array_equal(got, want, err_msg=name)


PORT_OPS = OPS.keys()


def test_registry_matches_reference():
    """The port registers exactly the reference's op names."""
    assert set(PORT_OPS) == set(JOPS.keys())
    assert set(PORT_OPS) == set(SPECS) | NOT_PORTED | NUMPY_HELD


@pytest.mark.parametrize("name", PORT_OPS)
def test_op_parity(name):
    if name in NOT_PORTED:
        with pytest.raises(MXNetError, match="not ported"):
            OPS.get(name)(mx.nd.array(X, ctx=CPU), mx.nd.array(X, ctx=CPU))
        return
    if name in NUMPY_HELD:
        if name == "boolean_mask":
            got = OPS.get(name)(mx.nd.array(A34, ctx=CPU),
                                mx.nd.array(BOOL[:, 0], ctx=CPU))
            np.testing.assert_array_equal(got.asnumpy(), A34[BOOL[:, 0]])
        else:
            got = OPS.get(name)(mx.nd.array(BOOL, ctx=CPU))
            np.testing.assert_array_equal(got.asnumpy(), np.argwhere(BOOL))
        return
    args, kwargs = SPECS[name]
    got = _np(_call("port", name, args, kwargs))
    want = _np(_call("jax", name, args, kwargs))
    if name in RANDOM:
        for g, w in zip(*(x if isinstance(x, list) else [x]
                          for x in (got, want))):
            assert g.shape == w.shape and g.dtype == w.dtype, name
        return
    if name in OWN_ERROR:
        exact = OWN_ERROR[name](args[0]).numpy()
        scale = float(np.abs(exact).max())
        assert float(np.abs(got - exact).max()) <= REL * scale, name
        own = float(np.abs(want - exact).max())
        assert float(np.abs(got - want).max()) <= REL * scale + own, name
        assert got.dtype == want.dtype
        return
    if name in SPECTRAL:
        # unique up to signs: values exactly as far as float allows,
        # vectors by magnitude
        got = [np.abs(g) for g in got]
        want = [np.abs(w) for w in want]
        _same(got, want, name, rel=1e-5)
        return
    _same(got, want, name)


# ---------------------------------------------------------------------------
# NDArray semantics
# ---------------------------------------------------------------------------

def test_default_dtypes_int32_float32():
    assert mx.nd.array([1, 2], ctx=CPU).dtype == np.float32
    assert mx.nd.NDArray(3, ctx=CPU).dtype == np.int32
    assert mx.nd.NDArray(3.5, ctx=CPU).dtype == np.float32
    assert mx.nd.array(np.arange(3), ctx=CPU).dtype == np.int32
    assert mx.nd.array(np.zeros(2, np.float64), ctx=CPU).dtype == np.float32
    assert (mx.nd.array(np.arange(3), ctx=CPU) + 1).dtype == np.int32
    assert (mx.nd.array(np.arange(3), ctx=CPU) * 1.5).dtype == np.float32
    for a in (np.arange(3), np.zeros(2, np.float64)):
        assert mx.nd.array(a, ctx=CPU).dtype == jmx.nd.array(a).dtype


@pytest.mark.parametrize("spec", [(0, -1), (-1, 0), (-2,), (-3, 0),
                                  (0, -4, 2, -1, 0), (2, -1), (-3, -2)])
def test_reshape_codes(spec):
    a = _f(2, 4, 3)
    got = mx.nd.array(a, ctx=CPU).reshape(spec)
    want = jmx.nd.array(a).reshape(spec)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.asnumpy(), want.asnumpy())


def test_inplace_bumps_version_and_writes_in_place():
    x = mx.nd.array(X, ctx=CPU)
    t = x._data
    v = x._version
    x += 1
    x[0, 1] = 7.0
    x *= 2
    assert x._version == v + 3
    assert x._data is t          # the same storage outside record()
    want = (X + 1) * 2
    want[0, 1] = 14.0
    np.testing.assert_allclose(x.asnumpy(), want, rtol=1e-6)
    y = mx.nd.zeros((3, 4), ctx=CPU)
    x.copyto(y)
    np.testing.assert_array_equal(y.asnumpy(), x.asnumpy())


def test_scalar_conversions_and_indexing():
    x = mx.nd.array(X, ctx=CPU)
    assert float(x[1, 2]) == pytest.approx(float(X[1, 2]))
    assert int(mx.nd.NDArray(5, ctx=CPU)) == 5
    assert bool(mx.nd.array([1.0], ctx=CPU))
    with pytest.raises(MXNetError):
        bool(x)
    np.testing.assert_array_equal(x[1:, ::2].asnumpy(), X[1:, ::2])
    idx = mx.nd.array([2, 0], ctx=CPU, dtype="int32")
    np.testing.assert_array_equal(x[idx].asnumpy(), X[[2, 0]])
    assert x.context == CPU and x.shape == (3, 4) and x.size == 12
    assert x.T.shape == (4, 3)
    np.testing.assert_allclose(x.astype("float16").asnumpy(),
                               X.astype(np.float16), rtol=1e-3)


def test_creation_ops_match_reference():
    pairs = [("zeros", ((2, 3),), {}), ("ones", ((3,),), {}),
             ("full", ((2, 2), 1.5), {}),
             ("arange", (0, 10, 3), {}), ("linspace", (0, 1, 5), {}),
             ("eye", (3, 4, 1), {}), ("tri", (3, 3, -1), {}),
             ("indices", ((2, 3),), {}), ("empty", ((2,),), {})]
    for name, args, kw in pairs:
        got = getattr(mx.nd, name)(*args, ctx=CPU, **kw)
        want = getattr(jmx.nd, name)(*args, **kw)
        _same(_np(got), _np(want), name)
    got = mx.nd.meshgrid(mx.nd.array([1, 2], ctx=CPU),
                         mx.nd.array([3, 4, 5], ctx=CPU))
    want = jmx.nd.meshgrid(jmx.nd.array([1, 2]), jmx.nd.array([3, 4, 5]))
    _same(_np(got), _np(want), "meshgrid")


def test_scope_places_arrays_on_cpu():
    with mx.cpu():
        a = mx.nd.zeros((2,))
        b = mx.nd.array([1.0, 2.0])
        c = mx.nd.random.uniform(shape=(3,))
    for x in (a, b, c):
        assert x.context == CPU


def test_no_card_raises_without_cpu():
    """No fallback: with no CUDA card the default device raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(MXNetError):
        mx.nd.array([1.0, 2.0])
    with pytest.raises(MXNetError):
        mx.nd.zeros((2,))
    with pytest.raises(MXNetError):
        mx.tpu()


# ---------------------------------------------------------------------------
# samplers: moments and determinism within the port
# ---------------------------------------------------------------------------

N = 20000
MOMENTS = [
    ("uniform", dict(low=-1.0, high=3.0), 1.0, 16 / 12),
    ("normal", dict(loc=1.0, scale=2.0), 1.0, 4.0),
    ("gamma", dict(alpha=2.0, beta=1.5), 3.0, 4.5),
    ("gamma", dict(alpha=0.5, beta=1.0), 0.5, 0.5),
    ("exponential", dict(scale=2.0), 2.0, 4.0),
    ("poisson", dict(lam=3.0), 3.0, 3.0),
    ("negative_binomial", dict(k=3, p=0.4), 4.5, 11.25),
    ("generalized_negative_binomial", dict(mu=2.0, alpha=0.5), 2.0, 4.0),
    ("gumbel", {}, 0.5772156649, np.pi ** 2 / 6),
    ("laplace", dict(loc=0.5, scale=2.0), 0.5, 8.0),
]


@pytest.mark.parametrize("name,kw,mean,var", MOMENTS)
def test_sampler_moments(name, kw, mean, var):
    mx.random.seed(7)
    x = getattr(mx.nd.random, name)(shape=(N,), ctx=CPU, **kw).asnumpy()
    se = np.sqrt(var / N)
    assert abs(x.mean() - mean) < 5 * se, (name, x.mean(), mean)
    assert abs(x.var() / var - 1) < 0.1, (name, x.var(), var)
    mx.random.seed(7)
    y = getattr(mx.nd.random, name)(shape=(N,), ctx=CPU, **kw).asnumpy()
    np.testing.assert_array_equal(x, y)


def test_discrete_samplers():
    mx.random.seed(3)
    p = np.array([[0.1, 0.2, 0.7]], np.float32)
    s = mx.nd.random.multinomial(mx.nd.array(p, ctx=CPU),
                                 shape=N).asnumpy()
    freq = np.bincount(s.reshape(-1), minlength=3) / N
    np.testing.assert_allclose(freq, p[0], atol=0.02)
    b = mx.nd.random.bernoulli(prob=0.3, shape=(N,), ctx=CPU).asnumpy()
    assert abs(b.mean() - 0.3) < 0.02
    c = mx.nd.random.categorical(mx.nd.array(np.log(p), ctx=CPU),
                                 shape=(N,)).asnumpy()
    np.testing.assert_allclose(np.bincount(c, minlength=3) / N, p[0],
                               atol=0.02)
    perm = mx.nd.random.permutation(50, ctx=CPU).asnumpy()
    assert sorted(perm.tolist()) == list(range(50))
    r = mx.nd.random.randint(2, 6, shape=(N,), ctx=CPU).asnumpy()
    assert r.min() == 2 and r.max() == 5 and r.dtype == np.int32
    sh = mx.nd.random.shuffle(mx.nd.array(np.arange(10), ctx=CPU)).asnumpy()
    assert sorted(sh.tolist()) == list(range(10))
