"""SSD single-shot detector (the SSD-512 workload).

Counterpart of mxnet_tpu/models/vision/ssd.py `_ExtraBlock`, `SSD`
(`forward`, `detect`), `SSDMultiBoxLoss`, `ssd_512_resnet50_v1` and
`ssd_512_resnet50_v1_voc`, over the port's multibox ops
(ops/detection.py; NMS on the hand-written kernel of csrc/nms.cu).

Structure: ResNet-50 v1b's stem and stages 1-3 (`stage3`, stride 16,
1024 channels) and stage 4 (`stage4`, stride 32, 2048 channels) as the
first two scales, then `num_extras` extra blocks halving the resolution
(512 channels each), one (class, box) 3x3 convolution head pair per
scale. The trunk's `output` Dense is dropped, as in the reference.
Module names follow the reference's structure paths (`stage3.4.0.body.0
.weight`, `extras.0.body.1.gamma`, `cls_heads.2.bias`), so
models/convert.load_jax_params copies the JAX net's 315 arrays by name.

A model lives on `device` (default: the CUDA card; raises without one)
in float32, starts in eval() mode and holds seeded Xavier weights
(initializer.initialize, seed 0). `model.to(torch.bfloat16)` plays the
part of the reference's `net.cast("bfloat16")`. parallel.TrainStep runs
the forward in train() mode, which updates BatchNorm's running
statistics once a step.
"""
from __future__ import annotations

import numpy as np
import torch

from ...base import MXNetError, resolve_device
from ...nn.layers import TensorBlock
from ...initializer import Xavier, initialize
from ...loss import Loss
from ...nn import BatchNorm, Conv2D, HybridSequential
from ...ops import detection as _det
from ...ops import nn as _ops
from .resnet import resnet50_v1b

__all__ = ["SSD", "SSDMultiBoxLoss", "ssd_512_resnet50_v1",
           "ssd_512_resnet50_v1_voc"]


class _ExtraBlock(TensorBlock):
    """1x1 squeeze + 3x3/2 expand (the SSD extra-layer recipe)."""

    def __init__(self, squeeze, expand, in_channels, device=None):
        super().__init__()
        kw = dict(device=device)
        self.body = HybridSequential(
            Conv2D(squeeze, kernel_size=1, use_bias=False,
                   in_channels=in_channels, **kw),
            BatchNorm(in_channels=squeeze, **kw),
            Conv2D(expand, kernel_size=3, strides=2, padding=1,
                   use_bias=False, in_channels=squeeze, **kw),
            BatchNorm(in_channels=expand, **kw))

    def forward(self, x):
        return _ops.activation(self.body(x), "relu")


class SSD(TensorBlock):
    """Generic SSD over a resnet50_v1b backbone.

    forward(x) -> (cls_preds (B, N, C+1), box_preds (B, N*4),
    anchors (1, N, 4) float32); N is fixed by the input size (5,624 at
    512x512). Use multibox_target on the anchors for training and
    SSD.detect() / multibox_detection for inference.
    """

    def __init__(self, classes, image_size=512, num_extras=3, sizes=None,
                 ratios=None, device=None):
        super().__init__()
        device = resolve_device(device)
        self._classes = classes
        self._image_size = image_size
        feats = list(resnet50_v1b(classes=10, device=device).features)
        # stem + stage1..3 -> stride 16 (1024 ch); stage 4 -> stride 32
        self.stage3 = HybridSequential(*feats[:7])
        self.stage4 = feats[7]
        self.extras = HybridSequential(*[
            _ExtraBlock(256, 512, 2048 if i == 0 else 512, device=device)
            for i in range(num_extras)])
        n_scales = 2 + num_extras
        if sizes is None:
            # GluonCV recipe: linear size ramp over scales (fractions)
            s = np.linspace(0.1, 0.95, n_scales + 1)
            sizes = [(s[i], float(np.sqrt(s[i] * s[i + 1])))
                     for i in range(n_scales)]
        if ratios is None:
            ratios = [(1.0, 2.0, 0.5)] * 2 + \
                [(1.0, 2.0, 0.5, 3.0, 1.0 / 3)] * (n_scales - 2)
        if len(sizes) != n_scales or len(ratios) != n_scales:
            raise MXNetError(
                f"need {n_scales} sizes/ratios, got {len(sizes)}/"
                f"{len(ratios)}")
        self._sizes = sizes
        self._ratios = ratios
        in_channels = [1024, 2048] + [512] * num_extras
        self.cls_heads = HybridSequential()
        self.box_heads = HybridSequential()
        for cin, sz, rt in zip(in_channels, sizes, ratios):
            A = len(sz) + len(rt) - 1
            self.cls_heads.add(Conv2D(A * (classes + 1), kernel_size=3,
                                      padding=1, in_channels=cin,
                                      device=device))
            self.box_heads.add(Conv2D(A * 4, kernel_size=3, padding=1,
                                      in_channels=cin, device=device))
        initialize(self, Xavier(), seed=0)
        self.eval()

    @property
    def num_classes(self):
        return self._classes

    @property
    def device(self):
        return self.cls_heads[0].weight.device

    def forward(self, x):
        y = self.stage3(x)
        feats = [y]
        y = self.stage4(y)
        feats.append(y)
        for blk in self.extras:
            y = blk(y)
            feats.append(y)
        B = x.shape[0]
        cls_preds, box_preds, anchors = [], [], []
        for feat, ch, bh, sz, rt in zip(feats, self.cls_heads,
                                        self.box_heads, self._sizes,
                                        self._ratios):
            cls_preds.append(ch(feat).permute(0, 2, 3, 1).reshape(
                B, -1, self._classes + 1))
            box_preds.append(bh(feat).permute(0, 2, 3, 1).reshape(B, -1))
            anchors.append(_det.multibox_prior(feat, sizes=sz, ratios=rt,
                                               clip=True))
        return (torch.cat(cls_preds, dim=1), torch.cat(box_preds, dim=1),
                torch.cat(anchors, dim=1))

    @torch.no_grad()
    def detect(self, x, nms_threshold=0.45, threshold=0.01, nms_topk=400):
        """End-to-end inference: forward + softmax + decode + NMS ->
        (B, N, 6) float32 rows [class_id, score, x1, y1, x2, y2]
        (invalid -1). Runs in the model's current mode, without
        autograd."""
        cls_pred, box_pred, anchor = self(x)
        probs = torch.softmax(cls_pred, dim=-1).transpose(1, 2)
        return _det.multibox_detection(
            probs, box_pred, anchor, nms_threshold=nms_threshold,
            threshold=threshold, nms_topk=nms_topk)


class SSDMultiBoxLoss(Loss):
    """Class cross-entropy with ratio:1 hard negative mining + smooth-L1
    box loss (parity: GluonCV SSDMultiBoxLoss). forward(cls_pred
    (B, N, C+1), box_pred (B, N*4), cls_target (B, N), box_target
    (B, N*4), box_mask (B, N*4)) -> (B,) float32: both terms over
    max(positives, 1). The negatives are the ratio * positives anchors
    of highest background loss, ranked by two stable sorts (positives
    last), as the reference's argsort ranks them."""

    def __init__(self, negative_mining_ratio=3.0, rho=1.0, lambd=1.0):
        super().__init__(None, 0)
        self._ratio = negative_mining_ratio
        self._rho = rho
        self._lambd = lambd

    def forward(self, cls_pred, box_pred, cls_target, box_target, box_mask):
        rho, ratio = self._rho, self._ratio
        B = cls_pred.shape[0]
        lsm = -torch.log_softmax(cls_pred.float(), dim=-1)   # (B, N, C+1)
        ce = torch.gather(lsm, -1, cls_target.long()[..., None])[..., 0]
        pos = cls_target > 0
        n_pos = pos.sum(dim=1).clamp(min=1)
        # hard negative mining: top (ratio * n_pos) background losses
        neg_ce = torch.where(pos, -torch.inf, lsm[..., 0].detach())
        rank = torch.argsort(torch.argsort(-neg_ce, dim=1, stable=True),
                             dim=1, stable=True)
        neg = rank < (ratio * n_pos)[:, None]
        cls_loss = torch.where(pos | neg, ce, 0.0).sum(dim=1) / n_pos
        diff = ((box_pred - box_target) * box_mask).abs().reshape(B, -1)
        sl1 = torch.where(diff > rho, diff - 0.5 * rho,
                          0.5 / rho * diff * diff)
        box_loss = sl1.sum(dim=1) / n_pos
        return cls_loss + self._lambd * box_loss


def ssd_512_resnet50_v1(classes=20, pretrained=False, **kwargs):
    """SSD-512 with ResNet-50 v1b (parity: GluonCV
    ssd_512_resnet50_v1_voc, BASELINE.md's mAP 80.1 row)."""
    if pretrained:
        raise MXNetError("pretrained weights unavailable (no network "
                         "egress); train from scratch or load weights")
    return SSD(classes=classes, image_size=512, **kwargs)


def ssd_512_resnet50_v1_voc(**kwargs):
    kwargs.setdefault("classes", 20)
    return ssd_512_resnet50_v1(**kwargs)
