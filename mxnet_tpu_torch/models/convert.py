"""Weights for the port's models: seeded random, or carried across from
the JAX package.

`load_jax_params(model, arrays)` takes the JAX model's parameters as
numpy arrays keyed by structure path, as produced by
`{n: p.data().asnumpy() for n, p in jax_net.collect_params().items()}`
(e.g. `backbone.layer3.attn.query.weight` for GPT-2,
`backbone.encoder.layer0.attn.query.weight` and `mlm.decoder_bias` for
BERT). The port's modules carry the same names, so the copy is by name;
any missing, extra or mis-shaped key raises. The tied LM head / MLM
decoder has no weight of its own in either package and stays tied.

`load_gluon_params(block, arrays, ctx)` does the same through the gluon
surface: it fills `block.collect_params()` by name, so it also takes a
user's Block with its own Parameters and layers whose shapes are still
deferred or not yet initialised (they land on `ctx`, else where the
parameter lives, else the default device); a missing, extra or
mis-shaped name raises. `block` may also be a dict of name -> Parameter
(a ParameterDict), and the arrays torch tensors (bfloat16 among them).

`init_params(model, seed, std)` draws weights from N(0, std) with a
generator seeded on the model's own device (gamma 1; beta, biases and
BERT's `decoder_bias` 0, as the reference's `init="zeros"`; BatchNorm's
running_mean 0 and running_var 1, as `Block.initialize` gives them), so
a full-width model is made on the card without a host copy.
"""
from __future__ import annotations

import numpy as np
import torch

from ..base import MXNetError

__all__ = ["load_jax_params", "load_gluon_params", "init_params"]


def load_jax_params(model, arrays):
    params = dict(model.named_parameters())
    missing = sorted(set(params) - set(arrays))
    extra = sorted(set(arrays) - set(params))
    if missing or extra:
        raise MXNetError(f"load_jax_params: missing {missing}, "
                         f"unexpected {extra}")
    for name, p in params.items():
        a = np.asarray(arrays[name])
        if tuple(a.shape) != tuple(p.shape):
            raise MXNetError(f"load_jax_params: {name} has shape "
                             f"{tuple(a.shape)}, the model wants "
                             f"{tuple(p.shape)}")
        with torch.no_grad():
            p.copy_(torch.from_numpy(np.array(a)))
    return model


def load_gluon_params(block, arrays, ctx=None):
    from .. import device as _device
    params = block.collect_params() if hasattr(block, "collect_params") \
        else block
    missing = sorted(set(params) - set(arrays))
    extra = sorted(set(arrays) - set(params))
    if missing or extra:
        raise MXNetError(f"load_gluon_params: missing {missing}, "
                         f"unexpected {extra}")
    for name, p in params.items():
        a = arrays[name]
        t = a if isinstance(a, torch.Tensor) else \
            torch.from_numpy(np.array(a))
        shape = tuple(t.shape)
        if shape != p.shape and (p._shape_is_known or len(shape) != len(
                p.shape) or any(s and s != u for s, u in zip(p.shape,
                                                               shape))):
            raise MXNetError(f"load_gluon_params: {name} has shape "
                             f"{shape}, the block wants {p.shape}")
        dev = _device.to_torch(ctx) if ctx is not None else (
            p.var.device if not p.var.is_meta else None)
        if p.var.is_meta and p._deferred_init is None:
            p._deferred_init = (None, dev if dev is not None
                                else _device.to_torch(None), False)
        p.set_data(t if dev is None else t.to(dev))
    return block


def init_params(model, seed=0, std=0.02):
    """Seeded N(0, std) weights in parameter-name order; gamma and
    running_var 1, beta, biases, decoder_bias and running_mean 0."""
    params = dict(model.named_parameters())
    dev = next(iter(params.values())).device
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    with torch.no_grad():
        for name in sorted(params):
            p = params[name]
            leaf = name.rsplit(".", 1)[-1]
            if leaf in ("gamma", "running_var"):
                p.fill_(1.0)
            elif leaf in ("beta", "bias", "decoder_bias", "running_mean"):
                p.zero_()
            else:
                p.normal_(0.0, std, generator=gen)
    return model
