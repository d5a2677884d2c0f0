"""Dynamic loss scaler for the eager gluon Trainer.

Counterpart of mxnet_tpu/amp/loss_scaler.py: the loss is multiplied by
`loss_scale` before backward so float16 gradients stay in range; after
backward the gradients are checked for inf / nan, an overflowing step
is skipped and halves the scale (floored at 1.0), and `scale_window`
clean steps in a row double it.
"""
from __future__ import annotations

import torch


def grads_finite(grads):
    """A device bool: no tensor of `grads` (a non-empty list) holds an
    inf or a nan. One isfinite().all() a tensor, stacked and reduced on
    the device, so no host sync."""
    return torch.stack([torch.isfinite(g).all() for g in grads]).all()


class LossScaler:
    def __init__(self, init_scale=2.0 ** 16, scale_factor=2.0,
                 scale_window=2000, tolerance=0.0):
        self.loss_scale = float(init_scale)
        self._scale_factor = float(scale_factor)
        self._scale_window = int(scale_window)
        self._unskipped = 0

    @property
    def is_noop(self):
        """True for the bfloat16 shell (scale 1.0, a window never
        reached): no overflow check is needed."""
        return self.loss_scale == 1.0 and self._scale_window >= 10 ** 9

    def has_overflow(self, params):
        """True iff a gradient of `params` is not finite: `grads_finite`
        on the device, then one host fetch."""
        grads = [p.var.grad for p in params
                 if not p.var.is_meta and p.var.grad is not None]
        if not grads:
            return False
        return not bool(grads_finite(grads))

    def update_scale(self, overflow):
        if overflow:
            self.loss_scale = max(self.loss_scale / self._scale_factor, 1.0)
            self._unskipped = 0
        else:
            self._unskipped += 1
            if self._unskipped >= self._scale_window:
                self.loss_scale *= self._scale_factor
                self._unskipped = 0
