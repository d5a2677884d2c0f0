"""Loss blocks.

Counterpart of mxnet_tpu/gluon/loss.py `Loss`, `SoftmaxCrossEntropyLoss`
and its helpers `_softmax_ce`, `_apply_weighting` and `_mean_nonbatch`:
per-sample losses, the mean over every axis but the batch axis (the
reference's reduction convention). The reference's other losses are in
gluon/loss.py. A loss is a gluon HybridBlock over tensors: it takes
NDArrays too.
"""
from __future__ import annotations

import torch

from .nn.layers import TensorBlock

__all__ = ["Loss", "SoftmaxCrossEntropyLoss", "SoftmaxCELoss"]


def _apply_weighting(loss, weight=None, sample_weight=None):
    if sample_weight is not None:
        loss = loss * sample_weight
    if weight is not None and weight != 1.0:
        loss = loss * weight
    return loss


def _mean_nonbatch(loss, batch_axis=0):
    axes = tuple(i for i in range(loss.dim()) if i != batch_axis)
    return loss.mean(dim=axes) if axes else loss


def _softmax_ce(pred, label, axis, sparse, from_logits):
    if not from_logits:
        pred = torch.log_softmax(pred, dim=axis)
    if sparse:
        lbl = label.long().unsqueeze(axis)
        return -torch.gather(pred, axis, lbl).squeeze(axis)
    return -(pred * label).sum(dim=axis)


class Loss(TensorBlock):
    """Base loss (parity: gluon.loss.Loss)."""

    def __init__(self, weight=1.0, batch_axis=0):
        super().__init__()
        self._weight = weight
        self._batch_axis = batch_axis


class SoftmaxCrossEntropyLoss(Loss):
    """Parity: gluon.loss.SoftmaxCrossEntropyLoss (sparse_label, axis,
    from_logits). pred (B, ..., V) logits; label (B, ...) class ids, or
    a distribution like pred with sparse_label=False. Returns (B,)."""

    def __init__(self, axis=-1, sparse_label=True, from_logits=False,
                 weight=1.0, batch_axis=0):
        super().__init__(weight, batch_axis)
        self._axis = axis
        self._sparse = sparse_label
        self._from_logits = from_logits

    def forward(self, pred, label, sample_weight=None):
        loss = _softmax_ce(pred, label, self._axis, self._sparse,
                           self._from_logits)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _mean_nonbatch(loss, self._batch_axis)


SoftmaxCELoss = SoftmaxCrossEntropyLoss
