"""Base utilities: the root exception and device resolution.

Counterpart of mxnet_tpu/base.py (MXNetError). The port runs on a CUDA
card unless the caller asks for the CPU by name: `resolve_device(None)`
is `cuda`, and it raises when no card is present instead of quietly
continuing on the CPU.
"""
from __future__ import annotations

import torch


class MXNetError(RuntimeError):
    """Root exception for the framework (parity: mxnet.base.MXNetError)."""


def not_ported(what):
    """The error raised by every entry point or option of the JAX
    package that this port does not cover yet."""
    return MXNetError(f"{what} is not ported yet")


def resolve_device(device=None):
    """`device` as a torch.device; None means the CUDA card. A CUDA
    device without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise MXNetError(
                "no CUDA device is available; pass device='cpu' to run on "
                "the CPU")
        if dev.index is None:
            # name the card, so that devices compare equal to tensors'
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
