"""Loss blocks (counterpart of mxnet_tpu/gluon/loss.py).

`Loss` and `SoftmaxCrossEntropyLoss` are the port's (loss.py); the rest
are here with the reference's arithmetic: L2, L1,
SigmoidBinaryCrossEntropy, KLDiv, CTC, Huber, Hinge, SquaredHinge,
Logistic, Triplet, PoissonNLL and CosineEmbedding. Each returns
per-sample losses, the mean over every axis but the batch axis, as the
reference does. The forwards are written over tensors and take NDArrays
too (gluon/block.py).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..base import MXNetError
from ..loss import (Loss, SoftmaxCELoss, SoftmaxCrossEntropyLoss,
                    _apply_weighting, _mean_nonbatch)

__all__ = ["Loss", "L2Loss", "L1Loss", "SigmoidBinaryCrossEntropyLoss",
           "SigmoidBCELoss", "SoftmaxCrossEntropyLoss", "SoftmaxCELoss",
           "KLDivLoss", "CTCLoss", "HuberLoss", "HingeLoss",
           "SquaredHingeLoss", "LogisticLoss", "TripletLoss",
           "PoissonNLLLoss", "CosineEmbeddingLoss"]


def _sigmoid_bce(pred, label, pos_weight=None):
    """(1 - z)·x + w·softplus(-x), w = 1 + (pos_weight - 1)·z, softplus
    taken stably as relu(-x) + log1p(exp(-|x|))."""
    softplus_neg = torch.clamp(-pred, min=0) + torch.log1p(
        torch.exp(-pred.abs()))
    base = (1.0 - label) * pred
    if pos_weight is None:
        return base + softplus_neg
    return base + (1.0 + (pos_weight - 1.0) * label) * softplus_neg


class L2Loss(Loss):
    def forward(self, pred, label, sample_weight=None):
        loss = torch.square(label.reshape(pred.shape) - pred)
        loss = _apply_weighting(loss, self._weight / 2, sample_weight)
        return _mean_nonbatch(loss, self._batch_axis)


class L1Loss(Loss):
    def forward(self, pred, label, sample_weight=None):
        loss = torch.abs(label.reshape(pred.shape) - pred)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _mean_nonbatch(loss, self._batch_axis)


class SigmoidBinaryCrossEntropyLoss(Loss):
    def __init__(self, from_sigmoid=False, weight=1.0, batch_axis=0,
                 **kwargs):
        super().__init__(weight, batch_axis)
        self._from_sigmoid = from_sigmoid

    def forward(self, pred, label, sample_weight=None, pos_weight=None):
        label = label.reshape(pred.shape)
        eps = 1e-12
        if not self._from_sigmoid:
            loss = _sigmoid_bce(pred, label, pos_weight)
        elif pos_weight is not None:
            loss = -(pos_weight * label * torch.log(pred + eps)
                     + (1.0 - label) * torch.log(1.0 - pred + eps))
        else:
            loss = -(label * torch.log(pred + eps)
                     + (1.0 - label) * torch.log(1.0 - pred + eps))
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _mean_nonbatch(loss, self._batch_axis)


SigmoidBCELoss = SigmoidBinaryCrossEntropyLoss


class KLDivLoss(Loss):
    def __init__(self, from_logits=True, axis=-1, weight=1.0, batch_axis=0,
                 **kwargs):
        super().__init__(weight, batch_axis)
        self._from_logits = from_logits
        self._axis = axis

    def forward(self, pred, label, sample_weight=None):
        if not self._from_logits:
            pred = torch.log_softmax(pred, dim=self._axis)
        loss = label * (torch.log(label + 1e-12) - pred)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _mean_nonbatch(loss, self._batch_axis)


class CTCLoss(Loss):
    """Connectionist temporal classification (layout NTC or TNC; blank
    at 0 ('first') or C - 1 ('last'); labels padded with values < 0).
    The loss is the negative log-likelihood of the label sequence, by
    torch's CTC forward recursion in float64, per sample."""

    def __init__(self, layout="NTC", label_layout="NT", weight=None,
                 blank_label="first", **kwargs):
        super().__init__(weight, 0)
        if layout not in ("NTC", "TNC"):
            raise MXNetError(f"bad CTC layout {layout}")
        self._layout = layout
        self._label_layout = label_layout
        self._blank_first = blank_label == "first"

    def forward(self, pred, label, pred_lengths=None, label_lengths=None,
                sample_weight=None):
        if self._layout == "NTC":
            pred = pred.transpose(0, 1)
        if self._label_layout == "TN":
            label = label.transpose(0, 1)
        T, N, C = pred.shape
        logp = torch.log_softmax(pred.double(), dim=-1)
        if pred_lengths is None:
            pred_lengths = torch.full((N,), T, dtype=torch.long,
                                      device=pred.device)
        if label_lengths is None:
            valid = label >= 0
            label_lengths = valid.sum(dim=-1)
            label = torch.where(valid, label, torch.zeros_like(label))
        loss = F.ctc_loss(logp, label.long(), pred_lengths.long(),
                          label_lengths.long(),
                          blank=0 if self._blank_first else C - 1,
                          reduction="none").to(pred.dtype)
        return _apply_weighting(loss, self._weight, sample_weight)


class HuberLoss(Loss):
    def __init__(self, rho=1.0, weight=1.0, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis)
        self._rho = rho

    def forward(self, pred, label, sample_weight=None):
        err = torch.abs(label.reshape(pred.shape) - pred)
        loss = torch.where(err > self._rho, err - self._rho / 2,
                           (0.5 / self._rho) * torch.square(err))
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _mean_nonbatch(loss, self._batch_axis)


class HingeLoss(Loss):
    def __init__(self, margin=1, weight=1.0, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis)
        self._margin = margin

    def forward(self, pred, label, sample_weight=None):
        label = label.reshape(pred.shape)
        loss = torch.clamp(self._margin - pred * label, min=0)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _mean_nonbatch(loss, self._batch_axis)


class SquaredHingeLoss(HingeLoss):
    def forward(self, pred, label, sample_weight=None):
        label = label.reshape(pred.shape)
        loss = torch.square(torch.clamp(self._margin - pred * label, min=0))
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _mean_nonbatch(loss, self._batch_axis)


class LogisticLoss(Loss):
    def __init__(self, weight=1.0, batch_axis=0, label_format="signed",
                 **kwargs):
        super().__init__(weight, batch_axis)
        self._label_format = label_format

    def forward(self, pred, label, sample_weight=None):
        label = label.reshape(pred.shape)
        if self._label_format == "signed":
            label = (label + 1.0) / 2.0
        loss = _apply_weighting(_sigmoid_bce(pred, label), self._weight,
                                sample_weight)
        return _mean_nonbatch(loss, self._batch_axis)


class TripletLoss(Loss):
    def __init__(self, margin=1, weight=1.0, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis)
        self._margin = margin

    def forward(self, pred, positive, negative, sample_weight=None):
        axes = tuple(range(1, pred.dim()))
        pos = torch.square(pred - positive).sum(dim=axes)
        neg = torch.square(pred - negative).sum(dim=axes)
        loss = torch.clamp(pos - neg + self._margin, min=0)
        return _apply_weighting(loss, self._weight, sample_weight)


class PoissonNLLLoss(Loss):
    def __init__(self, from_logits=True, compute_full=False, weight=1.0,
                 batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis)
        self._from_logits = from_logits
        self._compute_full = compute_full

    def forward(self, pred, label, sample_weight=None, epsilon=1e-08):
        label = label.reshape(pred.shape)
        if self._from_logits:
            loss = torch.exp(pred) - label * pred
        else:
            loss = pred - label * torch.log(pred + epsilon)
        if self._compute_full:
            stirling = label * torch.log(label + 1e-12) - label + \
                0.5 * torch.log(2 * math.pi * (label + 1e-12))
            loss = loss + torch.where(label > 1, stirling,
                                      torch.zeros_like(label))
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return loss.mean()


class CosineEmbeddingLoss(Loss):
    def __init__(self, weight=1.0, batch_axis=0, margin=0, **kwargs):
        super().__init__(weight, batch_axis)
        self._margin = margin

    def forward(self, input1, input2, label, sample_weight=None):
        num = (input1 * input2).sum(dim=-1)
        den = torch.sqrt((input1 * input1).sum(dim=-1)) * \
            torch.sqrt((input2 * input2).sum(dim=-1))
        sim = num / (den + 1e-12)
        label = label.reshape(sim.shape)
        loss = torch.where(label == 1, 1.0 - sim,
                           torch.clamp(sim - self._margin, min=0))
        return _apply_weighting(loss, self._weight, sample_weight)
