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

`load_jax_tree(tree, like=None, device=None)` carries a tree of arrays
across (dicts, lists and tuples of numpy arrays, as
`jax.tree_util.tree_map(np.asarray, t)` gives them): the pipeline's
embed, head and stacked stage parameters (parallel.stack_stage_params,
models.gpt2.gpt2_pp_functions). With `like` (the port's tree of the
same structure, e.g. its own gpt2_pp_functions' stacked parameters) the
keys, shapes and dtypes are checked against it and taken from it; a
missing, extra or mis-shaped leaf raises. MoEFFN's stacked expert
weights (`expert_w1` (E, C, H) ...) cross as any Block's do, through
`load_gluon_params` (or `load_jax_params` once initialised).

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

__all__ = ["load_jax_params", "load_gluon_params", "load_jax_tree",
           "init_params"]


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


def load_jax_tree(tree, like=None, device=None, _path="tree"):
    """A nested dict / list / tuple of arrays as the same structure of
    torch tensors (on `device`, or on the `like` leaf's device in its
    dtype)."""
    if isinstance(tree, dict):
        if like is not None and (not isinstance(like, dict)
                                 or set(like) != set(tree)):
            raise MXNetError(f"load_jax_tree: {_path} has keys "
                             f"{sorted(tree)}, the port's tree does not")
        return {k: load_jax_tree(v, None if like is None else like[k],
                                 device, f"{_path}.{k}")
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        if like is not None and (not isinstance(like, (list, tuple))
                                 or len(like) != len(tree)):
            raise MXNetError(f"load_jax_tree: {_path} has {len(tree)} "
                             f"entries, the port's does not match")
        return type(tree)(
            load_jax_tree(v, None if like is None else like[i], device,
                          f"{_path}[{i}]") for i, v in enumerate(tree))
    t = torch.from_numpy(np.array(tree))
    if like is None:
        return t if device is None else t.to(device)
    if tuple(t.shape) != tuple(like.shape):
        raise MXNetError(f"load_jax_tree: {_path} has shape "
                         f"{tuple(t.shape)}, the port's "
                         f"{tuple(like.shape)}")
    return t.to(like.device, like.dtype)


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
