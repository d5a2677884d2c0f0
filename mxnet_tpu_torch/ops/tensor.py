"""Shape manipulation, indexing, ordering and casting ops.

Counterpart of mxnet_tpu/ops/tensor.py, op for op, on torch functions.
Index arrays may be int32 (the NDArray default) and are widened where
torch wants int64. Indices past a table clip, as the reference's take
and gather do; `lax.dynamic_slice`'s start clamping is kept. The two ops
whose output shape depends on the data, which the reference refuses
under XLA (`boolean_mask`, `where_index`), run here, with numpy's
semantics; `unique` pads to `size` as jnp.unique does.
"""
from __future__ import annotations

import builtins

import torch
import torch.nn.functional as F

from ..base import MXNetError
from .registry import apply_op, op

__all__ = []   # the ops are reached through the registry and mx.nd


def _dt(dtype):
    from ..ndarray.ndarray import to_torch_dtype
    return to_torch_dtype(dtype)


def _idx(i, like=None):
    if not isinstance(i, torch.Tensor):
        i = torch.as_tensor(i, device=None if like is None else like.device)
    return i.long()


# ---------------------------------------------------------------------------
# shape ops
# ---------------------------------------------------------------------------

def _mx_reshape(shape_in, shape_spec):
    """The reference's reshape codes: 0 copies a dim, -1 infers, -2
    copies the rest, -3 merges two, -4 splits one into the next two."""
    spec = tuple(int(s) for s in shape_spec)
    if not any(s in (0, -2, -3, -4) for s in spec):
        return spec
    out, i, j = [], 0, 0
    while j < len(spec):
        s = spec[j]
        if s == 0:
            out.append(shape_in[i])
            i += 1
        elif s == -1:
            out.append(-1)
            i += 1
        elif s == -2:
            out.extend(shape_in[i:])
            i = len(shape_in)
        elif s == -3:
            out.append(shape_in[i] * shape_in[i + 1])
            i += 2
        elif s == -4:
            a, b = spec[j + 1], spec[j + 2]
            j += 2
            dim = shape_in[i]
            i += 1
            if a == -1:
                a = dim // b
            if b == -1:
                b = dim // a
            out.extend([a, b])
        else:
            out.append(s)
            i += 1
        j += 1
    return tuple(out)


@op("reshape")
def reshape(x, shape=None, reverse=False):
    if isinstance(shape, int):
        shape = (shape,)
    return x.reshape(_mx_reshape(tuple(x.shape), shape))


@op("transpose")
def transpose(x, axes=None):
    if axes is None or len(axes) == 0:
        return x.permute(*reversed(range(x.dim())))
    return x.permute(*axes)


@op("swapaxes")
def swapaxes(x, dim1=0, dim2=1):
    return x.transpose(dim1, dim2)


SwapAxis = swapaxes


@op("flatten")
def flatten(x):
    return x.reshape(x.shape[0], -1)


Flatten = flatten


@op("expand_dims")
def expand_dims(x, axis=0):
    return x.unsqueeze(axis)


@op("squeeze")
def squeeze(x, axis=None):
    if axis is None:
        return x.squeeze()
    axes = (axis,) if isinstance(axis, int) else tuple(axis)
    for a in axes:
        if x.shape[a] != 1:
            raise MXNetError(f"cannot squeeze axis {a} of size {x.shape[a]}")
    return x.squeeze(axes)


@op("broadcast_to")
def broadcast_to(x, shape=None):
    tgt = tuple(int(x.shape[i]) if s == 0 else int(s)
                for i, s in enumerate(shape))
    return x.broadcast_to(tgt)


@op("broadcast_axis")
def broadcast_axis(x, axis=None, size=None):
    axes = (axis,) if isinstance(axis, int) else tuple(axis)
    sizes = (size,) if isinstance(size, int) else tuple(size)
    tgt = list(x.shape)
    for a, s in zip(axes, sizes):
        tgt[a] = s
    return x.broadcast_to(tuple(tgt))


def _seq(args):
    if len(args) == 1 and isinstance(args[0], (tuple, list)):
        return tuple(args[0])
    return args


@op("concat")
def concat(*args, dim=1, axis=None):
    return torch.cat(_seq(args), dim=dim if axis is None else axis)


Concat = concat


@op("concatenate")
def concatenate(*args, axis=0):
    return torch.cat(_seq(args), dim=axis)


@op("stack")
def stack(*args, axis=0):
    return torch.stack(_seq(args), dim=axis)


def _split(x, sections, axis, squeeze_axis):
    n = x.shape[axis]
    if isinstance(sections, int):
        if n % sections:
            raise MXNetError(f"array split does not result in an equal "
                             f"division: {n} into {sections}")
        parts = torch.split(x, n // sections, dim=axis)
    else:
        bounds = [0] + [builtins.min(int(i), n) for i in sections] + [n]
        parts = [x.narrow(axis, a, builtins.max(b - a, 0))
                 for a, b in zip(bounds[:-1], bounds[1:])]
    if squeeze_axis:
        parts = [p.squeeze(axis) for p in parts]
    return tuple(parts)


@op("split")
def split(x, num_outputs=None, axis=1, squeeze_axis=False):
    return _split(x, num_outputs, axis, squeeze_axis)


SliceChannel = split


@op("split_v2")
def split_v2(x, indices_or_sections=None, axis=0, squeeze_axis=False):
    return _split(x, indices_or_sections, axis, squeeze_axis)


@op("tile")
def tile(x, reps=None):
    reps = (reps,) if isinstance(reps, int) else tuple(reps)
    return torch.tile(x, reps)


@op("repeat")
def repeat(x, repeats=None, axis=None):
    if axis is None:
        return x.reshape(-1).repeat_interleave(repeats)
    return x.repeat_interleave(repeats, dim=axis)


def _edge_index(n, before, after, mode, device):
    i = torch.arange(-before, n + after, device=device)
    if mode == "edge":
        return i.clamp(0, n - 1)
    # reflect (without the edge repeated), numpy's rule
    period = 2 * (n - 1) if n > 1 else 1
    i = i.remainder(period)
    return torch.where(i >= n, period - i, i)


@op("pad")
def pad(x, pad_width=None, mode="constant", constant_value=0):
    if isinstance(pad_width, (list, tuple)) and pad_width and \
            not isinstance(pad_width[0], (list, tuple)):
        pw = [(int(pad_width[2 * i]), int(pad_width[2 * i + 1]))
              for i in range(len(pad_width) // 2)]
    else:
        pw = [tuple(int(v) for v in p) for p in pad_width]
    if mode not in ("constant", "edge", "reflect"):
        raise MXNetError(f"unknown pad mode {mode!r}")
    if mode == "constant":
        flat = []
        for b, a in reversed(pw):
            flat += [b, a]
        return F.pad(x, flat, value=constant_value)
    for axis, (b, a) in enumerate(pw):
        if b or a:
            x = x.index_select(axis, _edge_index(x.shape[axis], b, a, mode,
                                                 x.device))
    return x


@op("flip")
def flip(x, axis=None):
    if axis is None:
        return torch.flip(x, tuple(range(x.dim())))
    return torch.flip(x, (axis,) if isinstance(axis, int) else tuple(axis))


reverse = flip


@op("roll")
def roll(x, shift=None, axis=None):
    return torch.roll(x, shift, axis)


def _slice_dim(x, axis, start, stop, step):
    """x[start:stop:step] along axis, numpy's rules, any step sign."""
    idx = range(x.shape[axis])[builtins.slice(start, stop, step)]
    if idx.step == 1:
        return x.narrow(axis, idx.start if len(idx) else 0, len(idx))
    return x.index_select(axis, torch.arange(idx.start, idx.stop, idx.step,
                                             device=x.device))


@op("slice")
def slice(x, begin=None, end=None, step=None):
    nd = len(begin)
    step = step or [None] * nd
    for i in range(nd):
        b = None if begin[i] is None else int(begin[i])
        e = None if end[i] is None else int(end[i])
        s = None if step[i] is None else int(step[i])
        x = _slice_dim(x, i, b, e, s)
    return x


@op("slice_axis")
def slice_axis(x, axis=0, begin=0, end=None):
    return _slice_dim(x, axis, begin, end, None)


@op("slice_like")
def slice_like(x, shape_like, axes=None):
    axes_ = range(x.dim()) if axes is None else axes
    for a in axes_:
        x = x.narrow(a, 0, builtins.min(shape_like.shape[a], x.shape[a]))
    return x


def _starts(x, start_indices, sizes):
    starts = [int(s) for s in (start_indices.tolist()
                               if isinstance(start_indices, torch.Tensor)
                               else start_indices)]
    # lax.dynamic_slice clamps each start so the slice stays inside
    return [builtins.min(builtins.max(s, 0), n - k)
            for s, n, k in zip(starts, x.shape, sizes)]


@op("dynamic_slice")
def dynamic_slice(x, start_indices, slice_sizes=None):
    for axis, (s, k) in enumerate(zip(_starts(x, start_indices, slice_sizes),
                                      slice_sizes)):
        x = x.narrow(axis, s, k)
    return x


@op("dynamic_update_slice")
def dynamic_update_slice(x, update, start_indices):
    starts = _starts(x, start_indices, update.shape)
    out = x.clone()
    view = out
    for axis, (s, k) in enumerate(zip(starts, update.shape)):
        view = view.narrow(axis, s, k)
    view.copy_(update)
    return out


@op("atleast_1d")
def atleast_1d(x):
    return torch.atleast_1d(x)


@op("atleast_2d")
def atleast_2d(x):
    return torch.atleast_2d(x)


@op("diag")
def diag(x, k=0):
    return torch.diag(x, k)


@op("diagonal")
def diagonal(x, offset=0, axis1=0, axis2=1):
    return torch.diagonal(x, offset=offset, dim1=axis1, dim2=axis2)


@op("tril")
def tril(x, k=0):
    return torch.tril(x, k)


@op("triu")
def triu(x, k=0):
    return torch.triu(x, k)


@op("depth_to_space")
def depth_to_space(x, block_size=2):
    n, c, h, w = x.shape
    b = block_size
    y = x.reshape(n, b, b, c // (b * b), h, w).permute(0, 3, 4, 1, 5, 2)
    return y.reshape(n, c // (b * b), h * b, w * b)


@op("space_to_depth")
def space_to_depth(x, block_size=2):
    n, c, h, w = x.shape
    b = block_size
    y = x.reshape(n, c, h // b, b, w // b, b).permute(0, 3, 5, 1, 2, 4)
    return y.reshape(n, c * b * b, h // b, w // b)


# ---------------------------------------------------------------------------
# casting
# ---------------------------------------------------------------------------

@op("cast")
def cast(x, dtype=None):
    return x.to(_dt(dtype))


Cast = astype = cast


@op("amp_cast")
def amp_cast(x, dtype=None):
    return x.to(_dt(dtype))


@op("amp_multicast")
def amp_multicast(*args, num_outputs=None, cast_narrow=False):
    sizes = [a.element_size() for a in args]
    pick = (builtins.min if cast_narrow else builtins.max)(
        range(len(args)), key=lambda i: sizes[i])
    return tuple(a.to(args[pick].dtype) for a in args)


@op("zeros_like")
def zeros_like(x):
    return torch.zeros_like(x)


@op("ones_like")
def ones_like(x):
    return torch.ones_like(x)


@op("full_like")
def full_like(x, fill_value=0):
    return torch.full_like(x, fill_value)


@op("shape_array", nodiff=True)
def shape_array(x):
    return torch.tensor(tuple(x.shape), dtype=torch.int32, device=x.device)


@op("size_array", nodiff=True)
def size_array(x):
    return torch.tensor([x.numel()], dtype=torch.int32, device=x.device)


@op("stop_gradient", nodiff=True)
def stop_gradient(x):
    return x.detach()


BlockGrad = block_grad = stop_gradient


@op("identity")
def identity(x):
    return x.clone()


# ---------------------------------------------------------------------------
# indexing ops
# ---------------------------------------------------------------------------

@op("take")
def take(x, indices, axis=0, mode="clip"):
    if mode not in ("clip", "wrap", "raise"):
        raise MXNetError(f"unknown take mode {mode!r}")
    if axis is None:
        x, axis = x.reshape(-1), 0
    n = x.shape[axis]
    i = _idx(indices, x)
    i = i.remainder(n) if mode == "wrap" else i.clamp(0, n - 1)
    out = x.index_select(axis, i.reshape(-1))
    return out.reshape(x.shape[:axis] + i.shape + x.shape[axis + 1:])


@op("pick")
def pick(x, index, axis=-1, keepdims=False, mode="clip"):
    idx = _idx(index, x)
    if idx.dim() < x.dim():
        idx = idx.unsqueeze(axis)
    idx = idx.clamp(0, x.shape[axis] - 1)
    out = torch.gather(x, axis, idx)
    return out if keepdims else out.squeeze(axis)


choose_element_0index = pick


@op("take_along_axis")
def take_along_axis(x, indices, axis=None):
    if axis is None:
        x, axis = x.reshape(-1), 0
    i = _idx(indices, x)
    i = torch.where(i < 0, i + x.shape[axis], i)
    return torch.gather(x, axis, i)


@op("gather_nd")
def gather_nd(data, indices):
    idx = _idx(indices, data)
    return data[tuple(idx[i] for i in range(idx.shape[0]))]


@op("scatter_nd")
def scatter_nd(data, indices, shape=None):
    idx = _idx(indices, data)
    out = torch.zeros(tuple(shape), dtype=data.dtype, device=data.device)
    return out.index_put(tuple(idx[i] for i in range(idx.shape[0])), data)


@op("index_update")
def index_update(data, indices, value):
    v = value if isinstance(value, torch.Tensor) else \
        torch.as_tensor(value, dtype=data.dtype, device=data.device)
    return data.index_put((_idx(indices, data),), v.to(data.dtype))


@op("index_add")
def index_add(data, indices, value):
    v = value if isinstance(value, torch.Tensor) else \
        torch.as_tensor(value, dtype=data.dtype, device=data.device)
    return data.index_put((_idx(indices, data),), v.to(data.dtype),
                          accumulate=True)


@op("boolean_mask", nodiff=True)
def boolean_mask(data, index, axis=0):
    keep = index.reshape(-1) != 0
    return data.index_select(axis, torch.nonzero(keep).reshape(-1))


@op("one_hot")
def one_hot(indices, depth=None, on_value=1.0, off_value=0.0,
            dtype="float32"):
    i = _idx(indices)
    valid = (i >= 0) & (i < depth)
    oh = F.one_hot(torch.where(valid, i, torch.zeros_like(i)), depth)
    oh = (oh * valid.unsqueeze(-1)).to(_dt(dtype))
    if on_value != 1.0 or off_value != 0.0:
        oh = oh * (on_value - off_value) + off_value
    return oh


@op("Embedding")
def Embedding(data, weight, input_dim=None, output_dim=None, dtype=None,
              sparse_grad=False):
    i = _idx(data, weight).clamp(0, weight.shape[0] - 1)
    return weight[i]


embedding = Embedding


@op("where_index", nodiff=True)
def where_index(cond):
    """The coordinates of nonzero elements, (N, ndim) int32 (numpy's
    argwhere; the reference refuses this data-dependent shape)."""
    return torch.nonzero(cond).to(torch.int32)


@op("sequence_mask")
def sequence_mask(data, sequence_length=None, use_sequence_length=False,
                  value=0.0, axis=0):
    if not use_sequence_length or sequence_length is None:
        return data
    T = data.shape[axis]
    pos = torch.arange(T, device=data.device)
    sl = sequence_length
    if axis == 0:
        mask = pos[:, None] < sl[None, :]
    else:
        mask = pos[None, :] < sl[:, None]
    mask = mask.reshape(mask.shape + (1,) * (data.dim() - 2))
    return torch.where(mask, data, torch.tensor(value, dtype=data.dtype,
                                                device=data.device))


SequenceMask = sequence_mask


@op("sequence_last")
def sequence_last(data, sequence_length=None, use_sequence_length=False,
                  axis=0):
    if not use_sequence_length or sequence_length is None:
        return data.select(axis, -1)
    sl = (_idx(sequence_length, data) - 1).clamp(0, data.shape[axis] - 1)
    rest = (1,) * (data.dim() - 2)
    if axis == 0:
        i = sl.reshape((1, -1) + rest).expand((1,) + tuple(data.shape[1:]))
        return torch.gather(data, 0, i)[0]
    i = sl.reshape((-1, 1) + rest).expand((data.shape[0], 1)
                                          + tuple(data.shape[2:]))
    return torch.gather(data, 1, i)[:, 0]


SequenceLast = sequence_last


@op("sequence_reverse")
def sequence_reverse(data, sequence_length=None, use_sequence_length=False,
                     axis=0):
    if not use_sequence_length or sequence_length is None:
        return torch.flip(data, (axis,))
    if axis != 0:
        raise MXNetError("sequence_reverse with lengths requires axis=0 "
                         "(TNC)")
    T = data.shape[0]
    pos = torch.arange(T, device=data.device)[:, None]
    sl = _idx(sequence_length, data)[None, :]
    rev = torch.where(pos < sl, sl - 1 - pos, pos)
    rev = rev.reshape(rev.shape + (1,) * (data.dim() - 2)).expand(data.shape)
    return torch.gather(data, 0, rev)


SequenceReverse = sequence_reverse

# ---------------------------------------------------------------------------
# ordering
# ---------------------------------------------------------------------------


@op("argmax", nodiff=True)
def argmax(x, axis=None, keepdims=False):
    out = torch.argmax(x, dim=axis)
    if keepdims and axis is not None:
        out = out.unsqueeze(axis)
    return out


@op("argmin", nodiff=True)
def argmin(x, axis=None, keepdims=False):
    out = torch.argmin(x, dim=axis)
    if keepdims and axis is not None:
        out = out.unsqueeze(axis)
    return out


@op("sort")
def sort(x, axis=-1, is_ascend=True):
    out = torch.sort(x, dim=axis, stable=True).values
    return out if is_ascend else torch.flip(out, (axis,))


@op("argsort", nodiff=True)
def argsort(x, axis=-1, is_ascend=True, dtype="float32"):
    out = torch.argsort(x, dim=axis, stable=True)
    if not is_ascend:
        out = torch.flip(out, (axis,))
    return out.to(_dt(dtype))


@op("topk", nodiff=True)
def topk(x, axis=-1, k=1, ret_typ="indices", is_ascend=False,
         dtype="float32"):
    # ties go to the lower index, as lax.top_k's: a stable sort
    order = torch.argsort(x if is_ascend else -x.float() if
                          x.dtype == torch.bool else -x, dim=axis,
                          stable=True)
    idx = order.narrow(axis, 0, k)
    vals = torch.gather(x, axis, idx)
    idx = idx.to(_dt(dtype))
    if ret_typ == "indices":
        return idx
    if ret_typ == "value":
        return vals
    if ret_typ == "both":
        return (vals, idx)
    raise MXNetError(f"topk ret_typ={ret_typ!r} not supported")


@op("searchsorted", nodiff=True)
def searchsorted(a, v, side="left"):
    v = v if isinstance(v, torch.Tensor) else torch.as_tensor(
        v, dtype=a.dtype, device=a.device)
    return torch.searchsorted(a, v, side=side).to(torch.int32)


@op("unique", nodiff=True)
def unique(x, size=None):
    if size is None:
        raise MXNetError("unique requires size= (the reference's static "
                         "shape)")
    u = torch.unique(x.reshape(-1), sorted=True)
    if u.numel() >= size:
        return u[:size]
    fill = x.min().reshape(1).expand(size - u.numel())
    return torch.cat([u, fill])


@op("histogram", nodiff=True)
def histogram(x, bins=10, range=None):
    lo, hi = (float(x.min()), float(x.max())) if range is None else range
    if lo == hi:
        lo, hi = lo - 0.5, hi + 0.5
    edges = torch.linspace(lo, hi, bins + 1, dtype=torch.float64,
                           device=x.device).to(torch.float32)
    xf = x.reshape(-1).to(torch.float32)
    i = torch.bucketize(xf, edges, right=True) - 1
    i = torch.where(xf == edges[-1], torch.full_like(i, bins - 1), i)
    inside = (i >= 0) & (i < bins)
    counts = torch.bincount(i[inside], minlength=bins)
    return (counts.to(torch.float32), edges)


@op("bincount", nodiff=True)
def bincount(x, weights=None, minlength=0):
    out = torch.bincount(_idx(x).reshape(-1), weights=weights,
                         minlength=minlength)
    return out if minlength <= 0 else out[:minlength]


# ---------------------------------------------------------------------------
# NDArray __getitem__ / __setitem__
# ---------------------------------------------------------------------------

def _prep_key(key, device):
    from ..ndarray.ndarray import NDArray
    if isinstance(key, NDArray):
        key = key._data
        return key.long() if key.dtype not in (torch.bool, torch.long) \
            else key
    if isinstance(key, tuple):
        return tuple(_prep_key(k, device) for k in key)
    if isinstance(key, list):
        return torch.as_tensor(key, device=device)
    return key


def _positive_steps(key, shape):
    """A basic-indexing key (slices, ints, None, Ellipsis) with its
    negative-step slices made positive, and the output dims to flip
    afterwards (torch slices take positive steps only)."""
    items = list(key) if isinstance(key, tuple) else [key]
    if any(isinstance(k, torch.Tensor) for k in items) or not any(
            isinstance(k, builtins.slice) and k.step is not None
            and k.step < 0 for k in items):
        return key, ()
    used = sum(k is not None and k is not Ellipsis for k in items)
    out, flips, dim, odim = [], [], 0, 0
    for k in items:
        if k is Ellipsis:
            n = len(shape) - used
            out.append(k)
            dim, odim = dim + n, odim + n
        elif k is None:
            out.append(k)
            odim += 1
        elif isinstance(k, builtins.slice):
            r = range(*k.indices(shape[dim]))
            if k.step is not None and k.step < 0:
                out.append(builtins.slice(r[-1], r[0] + 1, -k.step)
                           if len(r) else builtins.slice(0, 0))
                flips.append(odim)
            else:
                out.append(k)
            dim, odim = dim + 1, odim + 1
        else:   # an int drops the dim
            out.append(k)
            dim += 1
    return tuple(out), tuple(flips)


def _getitem(arr, key):
    key = _prep_key(key, arr._data.device)
    key, flips = _positive_steps(key, arr.shape)
    if flips:
        return apply_op("getitem", lambda x: torch.flip(x[key], flips),
                        [arr])
    return apply_op("getitem", lambda x: x[key], [arr])


def _setitem(arr, key, value):
    from .. import autograd as _ag
    from ..ndarray.ndarray import NDArray
    key = _prep_key(key, arr._data.device)
    v = value._data if isinstance(value, NDArray) else value
    t = arr._data
    if _ag.is_recording() and (t.requires_grad or (
            isinstance(v, torch.Tensor) and v.requires_grad)):
        new = t.clone()
        new[key] = v.to(t.dtype) if isinstance(v, torch.Tensor) else v
        arr._rebind(new)
        return
    with torch.no_grad():
        t[key] = v.to(t.dtype) if isinstance(v, torch.Tensor) else v
    arr._version += 1
