"""Neural-network ops on tensors.

Counterparts of mxnet_tpu/ops/nn.py `FullyConnected` (weight (out, in)),
`Convolution` (2-D), `BatchNorm`, `LayerNorm`, `Activation`, `gelu`,
`Dropout`, `Pooling` (2-D) and `dot_product_attention`. The matrix
products go to torch.matmul and the convolutions to F.conv2d, as the JAX
package leaves them to XLA (no Pallas body); attention goes to the fused
kernel (ops/fused_attention.py) where it takes the call. BatchNorm and
pooling are plain torch ops that reproduce the reference's arithmetic.

These functions take the dropout rate as given: the layers pass it only
in training (autograd.training_active). The registered forms at the end
of the module (mx.nd.Dropout, mx.nd.BatchNorm, ...) follow the
reference's autograd training flag. Random draws come from
mxnet_tpu_torch.rng.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .. import rng as _rng
from ..base import MXNetError, not_ported
from . import fused_attention as _fa

__all__ = ["fully_connected", "convolution", "batch_norm", "layer_norm",
           "activation", "gelu", "dropout", "pooling",
           "dot_product_attention", "local_attention", "flash_eligible"]


def _shard_context():
    """The running mesh-step shard (parallel.mesh.shard_context), or None
    (imported here: the parallel package imports the models, which
    import this module)."""
    from ..parallel.mesh import shard_context
    return shard_context()


def fully_connected(x, weight, bias=None, scale=None):
    """x @ weight.T (+ bias): weight is (num_hidden, in_features) as in
    the reference (parity: src/operator/nn/fully_connected.cc).

    An int8 weight is a w8 code array (serving/weight_quant.py) and needs
    its per-out-tile float32 `scale`: y[..., o] = (x @ codes.T)[..., o] *
    scale[o // tile], before the bias (the reference's
    `_w8_dequant_matmul`). The codes are cast to x's dtype for the
    product, which writes a float copy of the weight on every call.

    Mixed dtypes (an amp-converted weight under a float32 activation)
    promote as the reference's matmul does: the product in the promoted
    dtype, then the bias added with promotion."""
    if weight.dtype != torch.int8:
        if x.dtype == weight.dtype and (bias is None
                                        or bias.dtype == x.dtype):
            return F.linear(x, weight, bias)
        dt = torch.promote_types(x.dtype, weight.dtype)
        y = F.linear(x.to(dt), weight.to(dt))
        return y if bias is None else y + bias
    if scale is None:
        raise MXNetError("an int8 weight reached fully_connected without "
                         "its w8 scales")
    n_out, n_tiles = weight.shape[0], scale.shape[0]
    if n_out % n_tiles:
        raise MXNetError(f"w8 scale count {n_tiles} does not divide out "
                         f"dim {n_out}")
    y = torch.matmul(x, weight.to(x.dtype).T)
    y = y.reshape(*y.shape[:-1], n_tiles, n_out // n_tiles)
    y = (y * scale.to(x.dtype)[:, None]).reshape(*y.shape[:-2], n_out)
    return y if bias is None else y + bias


def _tup(v, n, fill=0):
    """An int/tuple/None window parameter as an n-tuple. As in the
    reference, an absent or all-zero stride/dilate means the default
    when `fill` is nonzero."""
    if v is None:
        return (fill,) * n
    v = (v,) * n if isinstance(v, int) else tuple(int(i) for i in v)
    if fill and v and all(i == 0 for i in v):
        return (fill,) * n
    return v


def convolution(x, weight, bias=None, stride=None, pad=None, dilate=None,
                groups=1):
    """2-D convolution, NCHW input and OIHW weight (O, I/groups, kH, kW),
    symmetric padding, then the bias per output channel (parity:
    src/operator/nn/convolution.cc). The 1-D and 3-D forms and
    Deconvolution are not ported."""
    if weight.dim() != 4:
        raise not_ported(f"{weight.dim() - 2}-D Convolution")
    y = F.conv2d(x, weight, None, _tup(stride, 2, fill=1), _tup(pad, 2),
                 _tup(dilate, 2, fill=1), groups)
    return y if bias is None else y + bias.reshape(1, -1, 1, 1)


def batch_norm(x, gamma, beta, moving_mean, moving_var, eps=1e-5,
               momentum=0.9, fix_gamma=True, use_global_stats=False,
               training=False, axis=1):
    """Batch normalisation with the reference's arithmetic (parity:
    src/operator/nn/batch_norm.cc through mxnet_tpu's BatchNorm op).

    In training (and not `use_global_stats`) the statistics are those of
    the batch, taken in float32 over every axis but `axis`: for bfloat16
    input the variance is one pass, max(E[x^2] - E[x]^2, 0), else two
    passes; it is biased in both. Otherwise the moving statistics
    normalise. The per-channel a = g * rsqrt(var + eps) and
    b = beta - g * rsqrt(var + eps) * mean are computed in float32, cast
    to x's dtype, and y = x * a + b in that dtype (g is 1 under
    `fix_gamma`). Returns y, or in training (y, mean, var) with the
    statistics cast to the moving statistics' dtype; the caller updates
    those (new = old * momentum + batch * (1 - momentum)), as the
    reference's layer does — `momentum` is not read here."""
    red = tuple(i for i in range(x.dim()) if i != axis)
    bshape = tuple(x.shape[axis] if i == axis else 1 for i in range(x.dim()))
    g32 = torch.ones_like(gamma, dtype=torch.float32) if fix_gamma \
        else gamma.float()
    training = training and not use_global_stats
    ctx = _shard_context() if training else None
    if ctx is not None and ctx.spans_batch:
        # a mesh step's batch shard: the statistics of the global batch,
        # from sums psum'd over the shards inside the forward
        x32 = x.float()
        count = x32.numel() // x32.shape[axis] * ctx.size
        mean = ctx.psum(x32.sum(dim=red)) / count
        if x.dtype == torch.bfloat16:
            var = (ctx.psum((x32 * x32).sum(dim=red)) / count
                   - mean * mean).clamp_min(0.0)
        else:
            var = ctx.psum((x32 - mean.reshape(bshape)).square()
                           .sum(dim=red)) / count
    elif training:
        x32 = x.float()
        mean = x32.mean(dim=red)
        if x.dtype == torch.bfloat16:
            var = ((x32 * x32).mean(dim=red) - mean * mean).clamp_min(0.0)
        else:
            var = (x32 - mean.reshape(bshape)).square().mean(dim=red)
    else:
        mean = moving_mean.float()
        var = moving_var.float()
    scale = g32 * torch.rsqrt(var + eps)
    a = scale.to(x.dtype)
    b = (beta.float() - scale * mean).to(x.dtype)
    y = x * a.reshape(bshape) + b.reshape(bshape)
    if training:
        return y, mean.to(moving_mean.dtype), var.to(moving_var.dtype)
    return y


def layer_norm(x, gamma, beta, eps=1e-5):
    """LayerNorm over the last axis. Normalises in float32 and casts
    back to x's dtype BEFORE gamma/beta, as the JAX op does — in
    bfloat16 the affine step rounds in bfloat16."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, unbiased=False, keepdim=True)
    y = ((x32 - mean) * torch.rsqrt(var + eps)).to(x.dtype)
    return y * gamma + beta


_ACTS = {"relu": F.relu,
         "gelu": F.gelu,
         "gelu_tanh": lambda x: F.gelu(x, approximate="tanh"),
         "tanh": torch.tanh}


def activation(x, act_type):
    """Parity: src/operator/nn/activation.cc (the reference's `_act`;
    its other act_types are not ported)."""
    fn = _ACTS.get(act_type)
    if fn is None:
        raise MXNetError(f"unknown act_type {act_type}")
    return fn(x)


def gelu(x, approximate=False):
    """GELU; approximate=True is the tanh form (the MLM head's)."""
    return F.gelu(x, approximate="tanh" if approximate else "none")


def dropout(x, p):
    """Inverted dropout with rate p (parity: the reference's `Dropout`):
    keep with probability 1 - p and scale by 1 / (1 - p). The mask is
    drawn from the current generator of x's device."""
    if p <= 0:
        return x
    ctx = _shard_context()
    if ctx is not None and ctx.spans_batch and x.dim() > 0:
        # a mesh step's batch shard: the mask of the global batch (dim 0
        # over the shards), drawn from the step's one stream and sliced,
        # so the shards draw the single-device step's masks
        b = x.shape[0]
        u = torch.rand((b * ctx.size,) + tuple(x.shape[1:]),
                       device=x.device,
                       generator=_rng.generator(x.device)
                       )[ctx.rank * b:(ctx.rank + 1) * b]
    else:
        u = torch.rand(x.shape, device=x.device,
                       generator=_rng.generator(x.device))
    return torch.where(u < 1.0 - p, x / (1.0 - p), torch.zeros((), dtype=x.dtype,
                                                          device=x.device))


def _full_pad(size, kernel, stride, pad):
    """Extra right padding of the "full" (ceil) pooling convention."""
    extra = []
    for n, k, s, p in zip(size, kernel, stride, pad):
        out = math.ceil((n + 2 * p - k) / s) + 1
        extra.append(max(0, (out - 1) * s + k - (n + 2 * p)))
    return extra


def pooling(x, kernel=None, pool_type="max", global_pool=False, stride=None,
            pad=None, pooling_convention="valid", count_include_pad=True):
    """2-D max or avg pooling of NCHW input (parity:
    src/operator/nn/pooling.cc through lax.reduce_window): max pads with
    -inf, avg divides by the window's size or, without
    `count_include_pad`, by its elements inside the input.
    `pooling_convention="full"` widens the right padding so the output
    size rounds up. A global pool reduces H and W with keepdims; its
    bfloat16 mean accumulates in float32, as jnp.mean does. The "sum"
    and "lp" pool types are not ported."""
    if x.dim() != 4:
        raise not_ported(f"{x.dim() - 2}-D Pooling")
    if pool_type in ("sum", "lp"):
        raise not_ported(f"pool_type {pool_type!r}")
    if pool_type not in ("max", "avg"):
        raise MXNetError(f"unknown pool_type {pool_type}")
    if global_pool:
        if pool_type == "max":
            return x.amax(dim=(2, 3), keepdim=True)
        return x.mean(dim=(2, 3), keepdim=True,
                      dtype=torch.float32).to(x.dtype)
    if pooling_convention not in ("valid", "full"):
        raise MXNetError(f"unknown pooling_convention {pooling_convention}")
    kernel, stride, pad = _tup(kernel, 2), _tup(stride, 2, fill=1), \
        _tup(pad, 2)
    extra = _full_pad(x.shape[2:], kernel, stride, pad) \
        if pooling_convention == "full" else [0, 0]
    if not any(extra) and all(2 * p <= k for p, k in zip(pad, kernel)):
        # torch pads symmetrically up to half the window
        if pool_type == "max":
            return F.max_pool2d(x, kernel, stride, pad)
        return F.avg_pool2d(x, kernel, stride, pad,
                            count_include_pad=count_include_pad)
    # explicit padding: (left, right, top, bottom)
    widths = (pad[1], pad[1] + extra[1], pad[0], pad[0] + extra[0])
    if pool_type == "max":
        return F.max_pool2d(F.pad(x, widths, value=-math.inf), kernel,
                            stride)
    s = F.avg_pool2d(F.pad(x, widths), kernel, stride, divisor_override=1)
    if count_include_pad:
        return s / float(math.prod(kernel))
    ones = F.pad(torch.ones_like(x[:1, :1]), widths)
    return s / F.avg_pool2d(ones, kernel, stride, divisor_override=1)


_ATTN_IMPLS = ("auto", "fused", "torch", "xla", "flash")


def flash_eligible(q, dropout_p):
    """The reference's gate for the 'flash' route (ops/attention.py
    `flash_eligible`): no dropout and a float dtype."""
    return dropout_p == 0.0 and q.dtype in (torch.float32, torch.bfloat16,
                                            torch.float16)


def _einsum_attention(q, k, v, mask, scale, causal, dropout_p, bthd):
    """The reference's plain softmax attention (its 'xla' path): scores
    in float32, masked with -inf, fully masked rows zero, dropout from
    the current generator."""
    d = q.shape[-1]
    s = scale if scale is not None else 1.0 / math.sqrt(d)
    logits = (torch.einsum("bqhd,bkhd->bhqk" if bthd else "bhqd,bhkd->bhqk",
                           q, k) * s).float()
    Tq, Tk = logits.shape[-2], logits.shape[-1]
    if causal:
        cm = torch.ones((Tq, Tk), dtype=torch.bool,
                        device=q.device).tril(Tk - Tq)
        logits = logits.masked_fill(~cm, -math.inf)
    if mask is not None:
        logits = logits.masked_fill(~mask, -math.inf)
    w = torch.softmax(logits, dim=-1).to(q.dtype)
    if causal or mask is not None:
        any_valid = torch.isfinite(logits).any(dim=-1, keepdim=True)
        w = torch.where(any_valid, w, torch.zeros((), dtype=w.dtype,
                                                  device=w.device))
    if dropout_p > 0:
        w = dropout(w, dropout_p)
    return torch.einsum("bhqk,bkhd->bqhd" if bthd else "bhqk,bhkd->bhqd",
                        w, v)


def dot_product_attention(q, k, v, mask=None, scale=None, causal=False,
                          dropout_p=0.0, impl="auto", layout="BHTD"):
    """q, k, v: (B, H, T, D), or (B, T, H, D) with layout="BTHD" (the
    shape a head-split reshape produces; both routes take it natively).

    impl 'auto' and 'fused' go to the fused attention kernel whenever
    fused_attention.supported() holds (float32/bfloat16, head dim <= 128,
    key-padding mask or none; any T), with seed words drawn
    from the current generator when dropout_p > 0; 'torch' takes the same
    route through the kernel's plain PyTorch version (the reference the
    kernel is held to). Otherwise 'auto', 'torch' and 'xla' take one
    plain softmax attention, and 'fused' raises. 'flash' is the
    reference's long-sequence route (`flash_eligible`: no dropout, a
    float dtype): the fused kernel is tiled and takes any T, so an
    eligible call it supports goes there; any other call takes the plain
    softmax attention, which gives the values of the reference's
    blockwise scan. 'ring' and 'ulysses' are the sequence-parallel
    routes over the active mesh's "sp" axis (parallel/sp.py), and
    'auto' takes one of them whenever the mesh has a real sp axis and
    the call allows it (`_sp_auto_impl`, the reference's rule), so a
    model needs no change to run sequence-parallel; they refuse
    attention dropout, as the reference does.

    mask: (B, Tk) key padding, or a boolean mask broadcastable to
    (B, H, Tq, Tk); True = attend. Fully masked rows yield zeros.
    dropout_p applies as given: pass 0 outside training."""
    if impl not in _ATTN_IMPLS + ("ring", "ulysses"):
        raise MXNetError(f"unknown attention impl {impl!r}")
    if layout not in ("BHTD", "BTHD"):
        raise MXNetError(f"unknown attention layout {layout!r}")
    if mask is not None and mask.dim() == 2:
        # (B, Tk) key padding -> canonical (B, 1, 1, Tk) for every path
        mask = mask[:, None, None, :]
    bhtd = (lambda x: x.transpose(1, 2)) if layout == "BTHD" \
        else (lambda x: x)
    if impl == "auto":
        sp_impl = _sp_auto_impl(bhtd(q), bhtd(k), mask, dropout_p > 0)
        if sp_impl is not None:
            impl = sp_impl
    if impl in ("ring", "ulysses"):
        from ..parallel import sp as _sp
        if dropout_p > 0:
            raise MXNetError(
                f"impl={impl!r} does not support attention-probability "
                "dropout (the mask would need to be consistent across "
                "devices); set attention dropout to 0 under sequence "
                "parallelism")
        fn = _sp.ring_attention if impl == "ring" else _sp.ulysses_attention
        return bhtd(fn(bhtd(q), bhtd(k), bhtd(v), mask=mask, causal=causal,
                       scale=scale))
    return _attention(q, k, v, mask, scale, causal, dropout_p, impl, layout)


def local_attention(q, k, v, mask=None, scale=None, causal=False):
    """The attention of one sequence-parallel shard, (B, H, T, D): the
    'auto' route without the sp step (the fused kernel on a CUDA tensor
    it supports, its plain version on the CPU)."""
    if mask is not None and mask.dim() == 2:
        mask = mask[:, None, None, :]
    return _attention(q, k, v, mask, scale, causal, 0.0, "auto", "BHTD")


def _sp_auto_impl(q, k, mask, train_drop):
    """The sequence-parallel route impl='auto' takes on (B, H, T, D)
    operands, or None (parity: mxnet_tpu/ops/nn.py `_sp_auto_impl`): an
    active mesh with a real sp axis, self-attention with T divisible by
    sp, no attention dropout, a key-padding mask or none; 'ulysses' when
    the per-device heads (H / tp) divide by sp and T <= 4096, else
    'ring'. Inside a mesh step's batch shard the rows are the shard's
    already, so the dp check is the reference's on the global batch."""
    from ..parallel.mesh import AXIS_SP, current_mesh, shard_context
    from ..parallel.sp import sp_enabled
    mesh = current_mesh()
    if train_drop or not sp_enabled(mesh):
        return None
    n_sp = mesh.shape[AXIS_SP]
    B, H, Tq, _ = q.shape
    Tk = k.shape[-2]
    if Tq != Tk or Tq % n_sp:
        return None
    if mask is not None and (mask.dim() != 4 or mask.shape[1] != 1
                             or mask.shape[-2] != 1):
        return None
    ctx = shard_context()
    if ctx is not None and ctx.mesh is mesh:
        B = B * ctx.size
    for ax, dim in (("dp", B), ("tp", H)):
        if ax in mesh.axis_names and dim % mesh.shape[ax]:
            return None
    n_tp = mesh.shape["tp"] if "tp" in mesh.axis_names else 1
    if (H // n_tp) % n_sp == 0 and Tq <= 4096:
        return "ulysses"
    return "ring"


def _attention(q, k, v, mask, scale, causal, dropout_p, impl, layout):
    """dot_product_attention's routes on one device."""
    if impl == "flash":
        if flash_eligible(q, dropout_p) and _fa.supported(q, k, mask,
                                                          layout=layout):
            return _fa.fused_attention(q, k, v, mask=mask, scale=scale,
                                       causal=causal, layout=layout)
    elif impl != "xla":
        if _fa.supported(q, k, mask, layout=layout):
            seed = _rng.seed_words(q.device) if dropout_p > 0 else None
            return _fa.fused_attention(
                q, k, v, mask=mask, scale=scale, causal=causal,
                dropout_p=dropout_p, seed=seed, layout=layout,
                impl="torch" if impl == "torch" else "auto")
        if impl == "fused":
            # an explicit request must not silently measure another path
            raise MXNetError("dot_product_attention impl='fused': the fused "
                             "kernel does not take this call")
    return _einsum_attention(q, k, v, mask, scale, causal, dropout_p,
                             layout == "BTHD")


# ---------------------------------------------------------------------------
# the registered ops (mx.nd.*): the reference's names and signatures over
# the functions above. Where the reference follows autograd's training
# flag (Dropout, BatchNorm's batch statistics, rrelu, attention dropout),
# so do these: they are the NDArray surface, not the port's layers.
# ---------------------------------------------------------------------------

from .. import autograd as _ag  # noqa: E402
from .registry import not_ported_op, op  # noqa: E402


@op("FullyConnected")
def FullyConnected(data, weight, bias=None, num_hidden=None, no_bias=False,
                   flatten=True):
    x = data.reshape(data.shape[0], -1) if flatten and data.dim() > 2 \
        else data
    return fully_connected(x, weight, None if no_bias else bias)


@op("Convolution")
def Convolution(data, weight, bias=None, kernel=None, stride=None,
                dilate=None, pad=None, num_filter=None, num_group=1,
                no_bias=False, layout=None, cudnn_tune=None, cudnn_off=False,
                workspace=None):
    return convolution(data, weight, None if no_bias else bias, stride, pad,
                       dilate, num_group)


not_ported_op("Deconvolution")
not_ported_op("RNN")


@op("BatchNorm")
def BatchNorm(data, gamma, beta, moving_mean, moving_var, eps=1e-5,
              momentum=0.9, fix_gamma=True, use_global_stats=False,
              output_mean_var=False, axis=1, cudnn_off=False):
    training = _ag.is_training() and not use_global_stats
    out = batch_norm(data, gamma, beta, moving_mean, moving_var, eps=eps,
                     momentum=momentum, fix_gamma=fix_gamma,
                     use_global_stats=use_global_stats, training=training,
                     axis=axis)
    if isinstance(out, tuple) or not output_mean_var:
        return out
    return (out, moving_mean.float().to(moving_mean.dtype),
            moving_var.float().to(moving_var.dtype))


@op("LayerNorm")
def LayerNorm(data, gamma, beta, axis=-1, eps=1e-5, output_mean_var=False):
    x32 = data.float()
    mean = x32.mean(dim=axis, keepdim=True)
    var = x32.var(dim=axis, unbiased=False, keepdim=True)
    y = ((x32 - mean) * torch.rsqrt(var + eps)).to(data.dtype)
    bshape = [1] * data.dim()
    bshape[axis] = data.shape[axis]
    y = y * gamma.reshape(bshape) + beta.reshape(bshape)
    if output_mean_var:
        return (y, mean.squeeze(axis), var.squeeze(axis))
    return y


@op("GroupNorm")
def GroupNorm(data, gamma, beta, num_groups=1, eps=1e-5,
              output_mean_var=False):
    n, c = data.shape[0], data.shape[1]
    xg = data.float().reshape(n, num_groups, c // num_groups, -1)
    mean = xg.mean(dim=(2, 3), keepdim=True)
    var = xg.var(dim=(2, 3), unbiased=False, keepdim=True)
    y = ((xg - mean) * torch.rsqrt(var + eps)).reshape(data.shape)
    y = y.to(data.dtype)
    bshape = (1, c) + (1,) * (data.dim() - 2)
    y = y * gamma.reshape(bshape) + beta.reshape(bshape)
    if output_mean_var:
        return (y, mean.reshape(n, num_groups), var.reshape(n, num_groups))
    return y


@op("InstanceNorm")
def InstanceNorm(data, gamma, beta, eps=1e-3):
    red = tuple(range(2, data.dim()))
    x32 = data.float()
    mean = x32.mean(dim=red, keepdim=True)
    var = x32.var(dim=red, unbiased=False, keepdim=True)
    y = ((x32 - mean) * torch.rsqrt(var + eps)).to(data.dtype)
    bshape = (1, data.shape[1]) + (1,) * (data.dim() - 2)
    return y * gamma.reshape(bshape) + beta.reshape(bshape)


@op("L2Normalization")
def L2Normalization(data, eps=1e-10, mode="instance"):
    red = {"instance": tuple(range(1, data.dim())), "channel": (1,),
           "spatial": tuple(range(2, data.dim()))}.get(mode)
    if red is None:
        raise MXNetError(f"unknown L2Normalization mode {mode}")
    return data / torch.sqrt((data * data).sum(dim=red, keepdim=True) + eps)


@op("LRN")
def LRN(data, alpha=1e-4, beta=0.75, knorm=2.0, nsize=5):
    """Local response normalisation across channels (NC...)."""
    half = nsize // 2
    sq = (data * data).movedim(1, -1)
    padded = F.pad(sq, (half, half))
    ssum = padded.unfold(-1, nsize, 1).sum(-1).movedim(-1, 1)
    return data / torch.pow(knorm + alpha / nsize * ssum, beta)


@op("rms_norm")
def rms_norm(data, gamma, axis=-1, eps=1e-6):
    x32 = data.float()
    ms = (x32 * x32).mean(dim=axis, keepdim=True)
    y = (x32 * torch.rsqrt(ms + eps)).to(data.dtype)
    bshape = [1] * data.dim()
    bshape[axis] = data.shape[axis]
    return y * gamma.reshape(bshape)


_MORE_ACTS = {
    "sigmoid": torch.sigmoid, "softrelu": F.softplus,
    "softsign": lambda x: x / (1 + x.abs()),
    "log_sigmoid": F.logsigmoid,
    "mish": lambda x: x * torch.tanh(F.softplus(x)),
    "silu": F.silu, "swish": F.silu}


@op("Activation")
def Activation(data, act_type="relu"):
    """Every act_type of the reference's `_act`."""
    fn = _MORE_ACTS.get(act_type)
    return fn(data) if fn is not None else activation(data, act_type)


@op("LeakyReLU")
def LeakyReLU(data, gamma=None, act_type="leaky", slope=0.25,
              lower_bound=0.125, upper_bound=0.334):
    x = data
    if act_type == "leaky":
        return torch.where(x > 0, x, slope * x)
    if act_type == "prelu":
        g = gamma
        if g.dim() < x.dim():
            g = g.reshape((1, -1) + (1,) * (x.dim() - 2))
        return torch.where(x > 0, x, g * x)
    if act_type == "elu":
        return torch.where(x > 0, x, slope * torch.expm1(x))
    if act_type == "selu":
        alpha, scale = 1.6732632423543772, 1.0507009873554805
        return scale * torch.where(x > 0, x, alpha * torch.expm1(x))
    if act_type == "gelu":
        return F.gelu(x)
    if act_type == "rrelu":
        if _ag.is_training():
            s = torch.rand(x.shape, device=x.device,
                           generator=_rng.generator(x.device))
            s = (s * (upper_bound - lower_bound) + lower_bound).to(x.dtype)
        else:
            s = (lower_bound + upper_bound) / 2.0
        return torch.where(x > 0, x, s * x)
    raise MXNetError(f"unknown LeakyReLU act_type {act_type}")


op("gelu")(gelu)
softplus = op("softplus")(lambda x: F.softplus(x))
silu = op("silu")(lambda x: F.silu(x))
hard_sigmoid = op("hard_sigmoid")(
    lambda x, alpha=0.2, beta=0.5: torch.clamp(alpha * x + beta, 0, 1))
log_sigmoid = op("log_sigmoid")(lambda x: F.logsigmoid(x))


@op("softmax")
def softmax(data, length=None, axis=-1, temperature=None, use_length=False):
    x = data
    if temperature is not None and temperature != 1.0:
        x = x / temperature
    if length is not None:
        pos = torch.arange(x.shape[axis], device=x.device)
        bshape = [1] * x.dim()
        bshape[axis] = x.shape[axis]
        mask = pos.reshape(bshape) < length.reshape(
            (-1,) + (1,) * (x.dim() - 1))
        x = x.masked_fill(~mask, -math.inf)
        out = torch.softmax(x, dim=axis)
        return torch.where(mask, out, torch.zeros((), dtype=out.dtype,
                                                  device=out.device))
    return torch.softmax(x, dim=axis)


@op("log_softmax")
def log_softmax(data, axis=-1, temperature=None):
    x = data
    if temperature is not None and temperature != 1.0:
        x = x / temperature
    return torch.log_softmax(x, dim=axis)


@op("masked_softmax")
def masked_softmax(data, mask, axis=-1, temperature=1.0):
    x = data / temperature if temperature != 1.0 else data
    mask = mask.bool()
    out = torch.softmax(x.masked_fill(~mask, -math.inf), dim=axis)
    return torch.where(mask, out, torch.zeros((), dtype=out.dtype,
                                              device=out.device))


@op("softmin")
def softmin(data, axis=-1):
    return torch.softmax(-data, dim=axis)


@op("softmax_cross_entropy")
def softmax_cross_entropy(data, label):
    lsm = torch.log_softmax(data, dim=-1)
    return -torch.gather(lsm, -1, label.long()[..., None])[..., 0].sum()


@op("SoftmaxOutput")
def SoftmaxOutput(data, label, grad_scale=1.0, ignore_label=-1,
                  multi_output=False, use_ignore=False, preserve_shape=False,
                  normalization="null", out_grad=False, smooth_alpha=0.0):
    return torch.softmax(data, dim=-1)


@op("Dropout")
def Dropout(data, p=0.5, mode="training", axes=None, cudnn_off=False):
    """Inverted dropout, active under autograd training (or
    mode='always'), from the current generator."""
    if p <= 0 or (mode != "always" and not _ag.is_training()):
        return data
    shape = data.shape
    if axes:
        shape = tuple(1 if i in axes else s for i, s in enumerate(shape))
    u = torch.rand(shape, device=data.device,
                   generator=_rng.generator(data.device))
    return torch.where(u < 1.0 - p, data / (1.0 - p),
                       torch.zeros((), dtype=data.dtype, device=data.device))


@op("Pooling")
def Pooling(data, kernel=None, pool_type="max", global_pool=False,
            stride=None, pad=None, pooling_convention="valid",
            count_include_pad=True, cudnn_off=False, layout=None):
    return pooling(data, kernel, pool_type, global_pool, stride, pad,
                   pooling_convention, count_include_pad)


@op("UpSampling")
def UpSampling(data, scale=2, sample_type="nearest", num_args=1):
    if sample_type != "nearest":
        raise MXNetError("UpSampling bilinear: use BilinearResize2D")
    return data.repeat_interleave(scale, dim=2).repeat_interleave(scale,
                                                                  dim=3)


@op("BilinearResize2D")
def BilinearResize2D(data, height=None, width=None, scale_height=None,
                     scale_width=None, mode="size", align_corners=True):
    """Half-pixel bilinear resize (jax.image.resize's; antialiased when it
    shrinks, as jax's is)."""
    h, w = data.shape[2], data.shape[3]
    if height is None:
        height, width = int(h * scale_height), int(w * scale_width)
    return F.interpolate(data, size=(height, width), mode="bilinear",
                         align_corners=False,
                         antialias=height < h or width < w)


@op("dot_product_attention")
def _dot_product_attention_op(q, k, v, mask=None, scale=None, causal=False,
                              dropout_p=0.0, impl="auto", layout="BHTD"):
    """dot_product_attention with the reference's rule: dropout only
    under autograd training."""
    return dot_product_attention(
        q, k, v, mask, scale, causal,
        dropout_p if _ag.is_training() else 0.0, impl, layout)
