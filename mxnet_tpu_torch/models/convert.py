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

__all__ = ["load_jax_params", "init_params"]


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
