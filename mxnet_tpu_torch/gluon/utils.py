"""Gluon utilities (counterpart of mxnet_tpu/gluon/utils.py):
split_data, split_and_load, clip_global_norm, check_sha1. `download`
raises: the port reads only local files."""
from __future__ import annotations

import hashlib
import math

import torch

from ..base import MXNetError
from ..ndarray.ndarray import NDArray, array

__all__ = ["split_data", "split_and_load", "clip_global_norm",
           "check_sha1", "download"]


def split_data(data, num_slice, batch_axis=0, even_split=True):
    size = data.shape[batch_axis]
    if even_split and size % num_slice:
        raise MXNetError(
            f"data with shape {data.shape} cannot be evenly split into "
            f"{num_slice} slices along axis {batch_axis}; set "
            "even_split=False to allow uneven slices")
    step = size // num_slice
    out = []
    for i in range(num_slice):
        hi = (i + 1) * step if even_split or i < num_slice - 1 else size
        idx = [slice(None)] * data.ndim
        idx[batch_axis] = slice(i * step, hi)
        out.append(data[tuple(idx)])
    return out


def split_and_load(data, ctx_list, batch_axis=0, even_split=True):
    """Split `data` along batch_axis and place slice i on ctx_list[i]."""
    if not isinstance(data, NDArray):
        data = array(data, ctx=ctx_list[0])
    if len(ctx_list) == 1:
        return [data.as_in_context(ctx_list[0])]
    slices = split_data(data, len(ctx_list), batch_axis, even_split)
    return [s.as_in_context(c) for s, c in zip(slices, ctx_list)]


def clip_global_norm(arrays, max_norm, check_isfinite=True):
    """Scale `arrays` in place so their joint L2 norm is at most
    max_norm; returns the norm before clipping (one host read)."""
    if not arrays:
        raise MXNetError("clip_global_norm requires at least one array")
    with torch.no_grad():
        total = None
        for a in arrays:
            n = torch.sum(torch.square(a._data.float()))
            total = n if total is None else total + n
        norm = math.sqrt(float(total))
        if check_isfinite and not math.isfinite(norm):
            raise MXNetError(
                f"global norm is {norm}: gradients contain NaN/Inf (set "
                "check_isfinite=False to skip the check)")
        scale = max_norm / (norm + 1e-8)
        if scale < 1.0:
            for a in arrays:
                a._data.mul_(scale)
                a._version += 1
    return norm


def check_sha1(filename, sha1_hash):
    sha1 = hashlib.sha1()
    with open(filename, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            sha1.update(block)
    return sha1.hexdigest() == sha1_hash


def download(url, path=None, overwrite=False, sha1_hash=None, retries=5,
             verify_ssl=True):
    raise MXNetError("gluon.utils.download is unavailable: place files "
                     "locally and pass local paths")
