"""Ownership markers of the serving loop.

Counterpart of mxnet_tpu/analysis/annotations.py: `loop_only` marks a
method callable only by the thread that owns the serving loop, and
`thread_safe` one callable from any thread. Here both only record the
marker on the function. The reference's runtime ownership assertions
(MX_ASSERT_OWNERSHIP=1) and its static ownership pass are not ported:
`assertions_enabled()` is always False, and `claim_ownership` (which
the frontend's serving loop calls only when assertions are on) does
nothing.
"""
from __future__ import annotations

__all__ = ["loop_only", "thread_safe", "assertions_enabled",
           "claim_ownership"]


def loop_only(fn):
    fn.__mx_ownership__ = "loop_only"
    return fn


def thread_safe(fn):
    fn.__mx_ownership__ = "thread_safe"
    return fn


def assertions_enabled():
    """Whether ownership is asserted at run time: never in the port."""
    return False


def claim_ownership(obj, thread_ident=None):
    """Declare the calling thread the owner of `obj`: a no-op, since
    nothing asserts ownership in the port."""
