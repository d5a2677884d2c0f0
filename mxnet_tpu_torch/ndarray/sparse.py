"""Sparse NDArrays: a dense-backed shim with the reference's de-scope.

Counterpart of mxnet_tpu/ndarray/sparse.py. `csr_matrix` and
`row_sparse_array` take the reference's (data, indices[, indptr]) forms
or a dense array and return dense-backed NDArrays that keep their
nominal stype, so code that reads `.stype`, `.indices`, `.data` or
calls `.tostype()` keeps working; arithmetic is the dense NDArray's.
What only true sparse storage can do (retain, a sparse save, a
row-sparse pull) raises with the de-scope note.
"""
from __future__ import annotations

import numpy as _np
import torch

from ..base import MXNetError
from .ndarray import NDArray, array

__all__ = ["CSRNDArray", "RowSparseNDArray", "csr_matrix",
           "row_sparse_array", "BaseSparseNDArray"]

_DESCOPE = ("sparse storage is de-scoped (no sparse buffers); this shim "
            "is dense-backed: convert with tostype('default') for anything "
            "beyond basic access")


class BaseSparseNDArray(NDArray):
    __slots__ = ()
    _stype = "default"

    @property
    def stype(self):
        return self._stype

    def tostype(self, stype):
        if stype == "default":
            return NDArray(self._data)
        if stype == self._stype:
            return self
        raise MXNetError(f"cannot convert {self._stype} to {stype}; "
                         + _DESCOPE)

    def retain(self, *args, **kwargs):
        raise MXNetError("retain: " + _DESCOPE)


def _index(t):
    return NDArray(t.to(torch.int32))


class CSRNDArray(BaseSparseNDArray):
    """CSR view of a dense buffer: `.data`, `.indices` and `.indptr` are
    computed from the dense values."""
    __slots__ = ()
    _stype = "csr"

    @property
    def indptr(self):
        counts = (self._data != 0).sum(dim=1)
        return _index(torch.cat([counts.new_zeros(1),
                                 torch.cumsum(counts, 0)]))

    @property
    def indices(self):
        return _index(torch.nonzero(self._data)[:, 1])

    @property
    def data(self):
        return NDArray(self._data[self._data != 0])


class RowSparseNDArray(BaseSparseNDArray):
    """Row-sparse view of a dense buffer."""
    __slots__ = ()
    _stype = "row_sparse"

    def _rows(self):
        return torch.nonzero(
            self._data.reshape(self._data.shape[0], -1).any(dim=1))[:, 0]

    @property
    def indices(self):
        return _index(self._rows())

    @property
    def data(self):
        return NDArray(self._data[self._rows()])


def csr_matrix(arg1, shape=None, ctx=None, dtype=None):
    """A CSR array from a dense array-like or (data, indices, indptr)."""
    if isinstance(arg1, tuple) and len(arg1) == 3:
        data, indices, indptr = (_np.asarray(x) for x in arg1)
        if shape is None:
            raise MXNetError("csr_matrix((data, indices, indptr)) needs "
                             "an explicit shape=")
        dense = _np.zeros(shape, dtype=dtype or data.dtype)
        for row in range(shape[0]):
            lo, hi = int(indptr[row]), int(indptr[row + 1])
            dense[row, indices[lo:hi]] = data[lo:hi]
        arg1 = dense
    return CSRNDArray(array(arg1, dtype=dtype, ctx=ctx)._data)


def row_sparse_array(arg1, shape=None, ctx=None, dtype=None):
    """A row-sparse array from a dense array-like or (data, indices)."""
    if isinstance(arg1, tuple) and len(arg1) == 2:
        data, indices = _np.asarray(arg1[0]), _np.asarray(arg1[1])
        if shape is None:
            raise MXNetError("row_sparse_array((data, indices)) needs an "
                             "explicit shape=")
        dense = _np.zeros(shape, dtype=dtype or data.dtype)
        dense[indices] = data
        arg1 = dense
    return RowSparseNDArray(array(arg1, dtype=dtype, ctx=ctx)._data)
