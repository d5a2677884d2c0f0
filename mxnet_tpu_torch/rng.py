"""Random streams for dropout: explicit torch.Generators.

Counterpart of the part of mxnet_tpu/rng.py the training step uses
(`seed`, `next_key`, `key_scope`). A JAX key becomes a torch.Generator
on the device the draws land on; `generator_scope(gen)` installs one for
the draws inside it, as `key_scope` installs a base key. Outside any
scope, draws come from a process-wide generator per device, seeded by
`seed(n)` (default 0).

Two kinds of draw: `seed_words(device)` — the two int32 seed words a
fused attention call hands its kernel (the counterpart of the key the
JAX op derives them from) — and `generator(device)` for a dropout mask
drawn with torch.rand. The two packages' streams differ for the same
seed, so tests that compare them feed both the same explicit words.
"""
from __future__ import annotations

import threading

import torch

__all__ = ["seed", "generator", "generator_scope", "seed_words",
           "step_generator"]

_M64 = (1 << 64) - 1


class _RngState(threading.local):
    def __init__(self):
        self.seed = 0
        self.defaults = {}   # device -> the process-wide generator
        self.scopes = []     # generators installed by generator_scope


_state = _RngState()


def seed(seed_state):
    """Reseed the process-wide generators (parity: mx.random.seed)."""
    _state.seed = int(seed_state)
    _state.defaults.clear()


def generator(device):
    """The generator draws on `device` come from: the innermost scope's,
    else the process-wide one of that device."""
    device = torch.device(device)
    if _state.scopes:
        gen = _state.scopes[-1]
        if gen.device.type != device.type:
            raise ValueError(f"the scope's generator lives on {gen.device}, "
                             f"the draw on {device}")
        return gen
    key = str(device)
    gen = _state.defaults.get(key)
    if gen is None:
        gen = torch.Generator(device=device).manual_seed(_state.seed)
        _state.defaults[key] = gen
    return gen


class generator_scope:
    """Install `gen` for the draws inside the scope (parity:
    mxnet_tpu.rng.key_scope)."""

    def __init__(self, gen):
        self.gen = gen

    def __enter__(self):
        _state.scopes.append(self.gen)
        return self.gen

    def __exit__(self, *exc):
        _state.scopes.pop()


def seed_words(device):
    """Two int32 seed words drawn from the current generator, as a (2,)
    int32 tensor on `device` (no host round trip on a card)."""
    device = torch.device(device)
    words = torch.randint(-2 ** 31, 2 ** 31, (2,), dtype=torch.int32,
                          device=device, generator=generator(device))
    from .parallel.mesh import shard_context
    ctx = shard_context()
    if ctx is not None and ctx.spans_batch and ctx.rank:
        # a mesh step's shards draw the same words from one stream; the
        # kernel hashes the row inside the shard, so fold the shard's
        # rank in (the counterpart of fold_in(key, axis_index))
        words = words ^ torch.tensor([0, ctx.rank], dtype=torch.int32,
                                     device=device)
    return words


def _splitmix64(x):
    x = (x + 0x9E3779B97F4A7C15) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return x ^ (x >> 31)


def step_generator(base_seed, t, device):
    """A generator on `device` seeded from (base_seed, t): one per
    training step, the counterpart of fold_in(base_key, t)."""
    s = _splitmix64(_splitmix64(int(base_seed) & _M64) ^ (int(t) & _M64))
    return torch.Generator(device=device).manual_seed(s >> 1)
