"""Parameter and array files: `.params` both ways.

Counterpart of mxnet_tpu/serialization.py, on the same bytes: a NumPy
`.npz` (a zip of `.npy` entries keyed by array name) with a
`__mxnet_tpu_format__` entry, and for the dtypes NumPy lacks (bfloat16,
float8_e4m3fn, float8_e5m2) the raw bits as a uint16 / uint8 array
beside a `__dtype__:<name>` entry that names the real dtype. A file
written by either package loads in the other. NumPy has no bfloat16, so
this side keeps such arrays as torch tensors and restores them with
`Tensor.view(dtype)` on the integer bits; it needs no `ml_dtypes`.

`load_mxnet_params` reads the legacy Apache-MXNet `.params` binary
(layouts v0 to v3, dense records only), so model-zoo weights import;
`load_ndarray_dict` falls back to it for a file that is not a zip.
`load_parameter_dict` fills a ParameterDict through
`models.convert.load_gluon_params`, so parameters whose shapes are still
deferred, or that have not been initialised, are filled too.
"""
from __future__ import annotations

import struct

import numpy as _np
import torch

from .base import MXNetError

__all__ = ["save_ndarray_dict", "load_ndarray_dict", "save_parameter_dict",
           "load_parameter_dict", "load_mxnet_params", "load_tensor_dict",
           "FORMAT_KEY", "DTYPE_SIDECAR"]

FORMAT_KEY = "__mxnet_tpu_format__"
FORMAT_VERSION = 1
DTYPE_SIDECAR = "__dtype__:"

# the dtypes NumPy lacks: the torch dtype and the integer view the bits
# are stored as (the reference's _RAW_VIEWS)
_RAW_VIEWS = {"bfloat16": (torch.bfloat16, torch.int16, _np.uint16),
              "float8_e4m3fn": (torch.float8_e4m3fn, torch.uint8, _np.uint8),
              "float8_e5m2": (torch.float8_e5m2, torch.uint8, _np.uint8)}
_RAW_OF = {v[0]: k for k, v in _RAW_VIEWS.items()}


def _host_array(k, v):
    """(numpy array to store, sidecar dtype name or None)."""
    if hasattr(v, "_data"):
        v = v._data
    if isinstance(v, torch.Tensor):
        t = v.detach().cpu().contiguous()
        name = _RAW_OF.get(t.dtype)
        if name is not None:
            _, ibits, npview = _RAW_VIEWS[name]
            return t.view(ibits).numpy().view(npview), name
        if t.dtype.is_complex or t.dtype.is_floating_point or \
                t.dtype in (torch.bool, torch.uint8, torch.int8, torch.int16,
                            torch.int32, torch.int64):
            return t.numpy(), None
        raise MXNetError(f"cannot serialize array {k!r} of unsupported "
                         f"dtype {t.dtype}")
    a = _np.asarray(v)
    if a.dtype.kind == "V" or a.dtype.name in _RAW_VIEWS:
        raise MXNetError(f"cannot serialize array {k!r} of unsupported "
                         f"dtype {a.dtype}; pass it as a torch tensor")
    return a, None


def save_ndarray_dict(filename, arrays):
    """Save {name: NDArray | torch.Tensor | np.ndarray} to a path or an
    open binary file (parity: mx.nd.save)."""
    out = {}
    for k, v in arrays.items():
        if k.startswith(DTYPE_SIDECAR) or k == FORMAT_KEY:
            raise MXNetError(
                f"array name {k!r} collides with the reserved "
                f"{DTYPE_SIDECAR!r}/{FORMAT_KEY!r} namespace")
        a, raw = _host_array(k, v)
        if raw is not None:
            out[DTYPE_SIDECAR + k] = _np.asarray(raw)
        out[k] = a
    out[FORMAT_KEY] = _np.asarray(FORMAT_VERSION)
    if hasattr(filename, "write"):
        _np.savez(filename, **out)
        return
    with open(filename, "wb") as f:
        _np.savez(f, **out)


def _restore(a, name):
    if name not in _RAW_VIEWS:
        raise MXNetError(f"unknown stored dtype {name!r}")
    tdtype, ibits, _ = _RAW_VIEWS[name]
    bits = _np.ascontiguousarray(a).view(
        _np.int16 if ibits is torch.int16 else _np.uint8)
    if not bits.flags.writeable:
        bits = bits.copy()
    return torch.from_numpy(bits).view(tdtype)


def load_tensor_dict(filename):
    """{name: CPU torch.Tensor} from a native `.npz` or a legacy
    `.params` file, with the stored dtypes (64-bit ones included)."""
    try:
        z = _np.load(filename, allow_pickle=False)
    except (OSError, ValueError):
        z = None   # not a zip: the legacy binary format
    if z is None:
        return {k: v if isinstance(v, torch.Tensor) else torch.from_numpy(v)
                for k, v in load_mxnet_params(filename).items()}
    with z:
        sidecars = {k[len(DTYPE_SIDECAR):]: str(z[k])
                    for k in z.files if k.startswith(DTYPE_SIDECAR)}
        out = {}
        for k in z.files:
            if k == FORMAT_KEY or k.startswith(DTYPE_SIDECAR):
                continue
            a = z[k]
            out[k] = _restore(a, sidecars[k]) if k in sidecars else \
                torch.from_numpy(a if a.flags.writeable else a.copy())
        return out


def load_ndarray_dict(filename, ctx=None):
    """Load a dict of NDArrays on `ctx` (default: the default device;
    parity: mx.nd.load). Reads the native `.npz` or a legacy `.params`
    binary; 64-bit arrays narrow to 32 bits, as NDArrays hold them."""
    from . import device as _device
    from .ndarray.ndarray import NDArray, _narrow
    dev = _device.to_torch(ctx)
    return {k: NDArray(_narrow(t).to(dev))
            for k, t in load_tensor_dict(filename).items()}


def save_parameter_dict(filename, params, strip_prefix=""):
    arrays = {}
    for name, p in params.items():
        if strip_prefix and name.startswith(strip_prefix):
            name = name[len(strip_prefix):]
        arrays[name] = p.data()
    save_ndarray_dict(filename, arrays)


def load_parameter_dict(filename, params, ctx=None, allow_missing=False,
                        ignore_extra=False, cast_dtype=False):
    """Fill `params` (name -> Parameter) from a file; every value is cast
    to its parameter's dtype, as Parameter.set_data does in both
    packages, so cast_dtype changes nothing."""
    from .models.convert import load_gluon_params
    loaded = load_tensor_dict(filename)
    # strip the legacy 'arg:' / 'aux:' prefixes of Module-era files
    loaded = {k.split(":", 1)[-1] if k.startswith(("arg:", "aux:")) else k: v
              for k, v in loaded.items()}
    missing = [n for n in params if n not in loaded]
    if missing and not allow_missing:
        raise MXNetError(f"parameter {missing[0]} missing in file "
                         f"{filename} (set allow_missing=True to skip)")
    extra = sorted(set(loaded) - set(params))
    if extra and not ignore_extra:
        raise MXNetError(f"file {filename} has extra parameters "
                         f"{extra[:8]}… (set ignore_extra=True to skip)")
    present = {n: p for n, p in params.items() if n in loaded}
    load_gluon_params(present, {n: loaded[n] for n in present}, ctx=ctx)


# ---------------------------------------------------------------------------
# The legacy MXNet .params binary (read only)
# ---------------------------------------------------------------------------
# src/ndarray/ndarray.cc NDArray::Save/Load and c_api MXNDArraySave:
#   uint64 list magic 0x112, uint64 reserved,
#   uint64 count N, N records, uint64 count K, K x (uint64 len, bytes) names.
# A record starts with a uint32:
#   0xF993FAC8 (v1): u32 ndim, i64[ndim] shape, i32 dev_type, i32 dev_id,
#       i32 type_flag, raw data;
#   0xF993FAC9 / 0xF993FACA (v2 storage type / v3 numpy shapes): i32 stype
#       (0 dense; sparse refused), i32 ndim (v3: -1 unknown), i64[ndim],
#       then as v1;
#   anything else (v0): that u32 is ndim, u32[ndim] dims, then as v1.

_MX_LIST_MAGIC = 0x112
_MX_ND_V1_MAGIC = 0xF993FAC8
_MX_ND_V2_MAGIC = 0xF993FAC9
_MX_ND_V3_MAGIC = 0xF993FACA
_MX_DTYPES = {0: "float32", 1: "float64", 2: "float16", 3: "uint8",
              4: "int32", 5: "int8", 6: "int64", 7: "bool", 12: "bfloat16"}


class _Reader:
    def __init__(self, data):
        self.d = data
        self.o = 0

    def _unpack(self, fmt, size):
        v = struct.unpack_from(fmt, self.d, self.o)
        self.o += size
        return v

    def u32(self):
        return self._unpack("<I", 4)[0]

    def i32(self):
        return self._unpack("<i", 4)[0]

    def u64(self):
        return self._unpack("<Q", 8)[0]

    def i64s(self, n):
        return self._unpack(f"<{n}q", 8 * n)

    def raw(self, n):
        v = self.d[self.o:self.o + n]
        self.o += n
        return v


def _read_legacy_ndarray(r):
    magic = r.u32()
    if magic in (_MX_ND_V2_MAGIC, _MX_ND_V3_MAGIC):
        stype = r.i32()
        # kUndefinedStorage -1, kDefaultStorage 0, kRowSparse 1, kCSR 2
        if stype not in (-1, 0):
            raise MXNetError(
                f"legacy .params contains a sparse NDArray (stype={stype}); "
                "sparse import is not supported (dense only)")
        ndim = r.i32()
        if ndim < 0:
            raise MXNetError("legacy .params NDArray has unknown shape")
        shape = r.i64s(ndim)
    elif magic == _MX_ND_V1_MAGIC:
        shape = r.i64s(r.u32())
    else:
        ndim = magic   # v0: the u32 just read was ndim
        if ndim > 32:
            raise MXNetError(
                f"legacy .params record has implausible ndim {ndim}: "
                "corrupt file or unsupported layout")
        shape = tuple(r.u32() for _ in range(ndim))
    r.i32(), r.i32()   # dev_type, dev_id
    type_flag = r.i32()
    dtype = _MX_DTYPES.get(type_flag)
    if dtype is None:
        raise MXNetError(f"unknown MXNet dtype flag {type_flag}")
    npdt = _np.dtype(_np.uint16 if dtype == "bfloat16" else dtype)
    count = int(_np.prod(shape)) if shape else 1
    a = _np.frombuffer(r.raw(count * npdt.itemsize),
                       dtype=npdt).reshape(shape).copy()
    return _restore(a, dtype) if dtype == "bfloat16" else a


def load_mxnet_params(filename):
    """Read a legacy Apache-MXNet `.params` / `.nd` file: {name: numpy
    array}, a bfloat16 record as a torch.bfloat16 tensor (NumPy has no
    bfloat16). Unnamed lists are keyed "0", "1", ..."""
    with open(filename, "rb") as f:
        data = f.read()
    r = _Reader(data)
    magic = r.u64()
    if magic != _MX_LIST_MAGIC:
        raise MXNetError(
            f"{filename}: not an MXNet NDArray-list file (magic {magic:#x})")
    r.u64()   # reserved
    arrays = [_read_legacy_ndarray(r) for _ in range(r.u64())]
    names = [r.raw(r.u64()).decode("utf-8") for _ in range(r.u64())]
    if names and len(names) == len(arrays):
        return dict(zip(names, arrays))
    return {str(i): a for i, a in enumerate(arrays)}
