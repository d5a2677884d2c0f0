"""Ownership markers of the serving loop.

Counterpart of mxnet_tpu/analysis/annotations.py: `loop_only` marks a
method callable only by the thread that owns the serving loop, and
`thread_safe` one callable from any thread. Here both only record the
marker on the function; the static ownership pass and its runtime
assertions are not ported.
"""
from __future__ import annotations

__all__ = ["loop_only", "thread_safe"]


def loop_only(fn):
    fn.__mx_ownership__ = "loop_only"
    return fn


def thread_safe(fn):
    fn.__mx_ownership__ = "thread_safe"
    return fn
