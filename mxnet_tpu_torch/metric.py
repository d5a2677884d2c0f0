"""Evaluation metrics.

Counterpart of mxnet_tpu/metric.py `EvalMetric` (accumulation, `get`,
`get_name_value`, `reset`) and `VOCMApMetric`, the PASCAL-VOC mean
average precision that the SSD example reports. Host numpy, as the
reference: updates take torch tensors (on any device, in any float
dtype) or numpy arrays. The reference's other metrics and its registry
are not ported yet.
"""
from __future__ import annotations

import numpy as _np
import torch

from .base import MXNetError

__all__ = ["EvalMetric", "VOCMApMetric"]


def _asnumpy(x):
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.is_floating_point() else x).numpy()
    return _np.asarray(x)


class EvalMetric:
    """Base metric (parity: mx.metric.EvalMetric)."""

    def __init__(self, name, output_names=None, label_names=None, **kwargs):
        self.name = str(name)
        self.output_names = output_names
        self.label_names = label_names
        self._kwargs = kwargs
        self.reset()

    def reset(self):
        self.num_inst = 0
        self.sum_metric = 0.0

    def update(self, labels, preds):
        raise NotImplementedError

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, self.sum_metric / self.num_inst)

    def get_name_value(self):
        name, value = self.get()
        if not isinstance(name, list):
            name = [name]
        if not isinstance(value, list):
            value = [value]
        return list(zip(name, value))

    def __str__(self):
        return f"EvalMetric: {dict([self.get_name_value()[0]])}"


class VOCMApMetric(EvalMetric):
    """PASCAL-VOC mean average precision for detection (parity: the
    reference's VOCMApMetric, GluonCV's VOC07MApMetric/VOCMApMetric).

    update(labels, preds):
      preds: (B, N, 6) rows [class_id, score, x1, y1, x2, y2], exactly
        multibox_detection / SSD.detect's output; rows with class_id < 0
        are padding and ignored.
      labels: (B, M, 5+) rows [class_id, x1, y1, x2, y2, (difficult)],
        the multibox_target label format; rows with class_id < 0 are
        padding; a 6th column marks difficult boxes (excluded from AP,
        the VOC convention).
    Either may also be one image's 2-D array or a list of arrays.
    """

    def __init__(self, iou_thresh=0.5, class_names=None, use_voc07=False,
                 name="mAP", **kwargs):
        self._iou = float(iou_thresh)
        self._names = class_names
        self._voc07 = use_voc07
        super().__init__(name, **kwargs)

    def reset(self):
        self.num_inst = 0
        self.sum_metric = 0.0
        self._records = {}   # cls -> list of (score, is_tp)
        self._npos = {}      # cls -> number of non-difficult gt boxes

    @staticmethod
    def _iou_1many(box, boxes):
        tl = _np.maximum(box[:2], boxes[:, :2])
        br = _np.minimum(box[2:], boxes[:, 2:])
        wh = _np.clip(br - tl, 0, None)
        inter = wh[:, 0] * wh[:, 1]
        a1 = max(box[2] - box[0], 0) * max(box[3] - box[1], 0)
        a2 = _np.clip(boxes[:, 2] - boxes[:, 0], 0, None) * \
            _np.clip(boxes[:, 3] - boxes[:, 1], 0, None)
        union = a1 + a2 - inter
        return _np.where(union > 0, inter / _np.where(union > 0, union, 1),
                         0.0)

    @staticmethod
    def _per_image(x):
        """An array, a (B, N, K) array or a list of either, as a list of
        per-image 2-D arrays."""
        if isinstance(x, (list, tuple)):
            out = []
            for el in x:
                out.extend(VOCMApMetric._per_image(el))
            return out
        a = _asnumpy(x)
        return [a] if a.ndim == 2 else list(a)

    def update(self, labels, preds):
        lab = self._per_image(labels)
        det = self._per_image(preds)
        if len(lab) != len(det):
            raise MXNetError(
                f"VOCMApMetric.update: {len(lab)} label images vs "
                f"{len(det)} prediction images")
        for lrows, drows in zip(lab, det):
            gts = lrows[lrows[:, 0] >= 0]
            difficult = gts[:, 5].astype(bool) if gts.shape[1] > 5 else \
                _np.zeros(len(gts), bool)
            for c in set(gts[:, 0].astype(int)):
                self._npos[c] = self._npos.get(c, 0) + int(
                    (~difficult[gts[:, 0] == c]).sum())
            dets = drows[drows[:, 0] >= 0]
            order = _np.argsort(-dets[:, 1])
            matched = _np.zeros(len(gts), bool)
            for i in order:
                c, score = int(dets[i, 0]), float(dets[i, 1])
                box = dets[i, 2:6]
                cls_mask = gts[:, 0].astype(int) == c
                rec = self._records.setdefault(c, [])
                if not cls_mask.any():
                    rec.append((score, 0))
                    continue
                ious = self._iou_1many(box, gts[cls_mask, 1:5])
                j_rel = int(_np.argmax(ious))
                j = _np.nonzero(cls_mask)[0][j_rel]
                if ious[j_rel] >= self._iou:
                    if difficult[j]:
                        # VOC devkit: detections on difficult gts are
                        # ignored (no TP, no FP) and the gt is never
                        # consumed: any number may land on it
                        continue
                    if not matched[j]:
                        matched[j] = True
                        rec.append((score, 1))
                    else:
                        rec.append((score, 0))  # duplicate -> FP
                else:
                    rec.append((score, 0))
            self.num_inst += 1

    def _average_precision(self, rec_points, prec_points):
        if self._voc07:  # 11-point interpolation
            ap = 0.0
            for t in _np.arange(0.0, 1.1, 0.1):
                p = prec_points[rec_points >= t]
                ap += (p.max() if p.size else 0.0) / 11.0
            return ap
        # VOC10+/COCO-style: area under the monotone precision envelope
        mrec = _np.concatenate([[0.0], rec_points, [1.0]])
        mpre = _np.concatenate([[0.0], prec_points, [0.0]])
        for i in range(len(mpre) - 2, -1, -1):
            mpre[i] = max(mpre[i], mpre[i + 1])
        idx = _np.nonzero(mrec[1:] != mrec[:-1])[0]
        return float(((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]).sum())

    def get(self):
        classes = sorted(set(self._npos) | set(self._records))
        aps = []
        per_class = {}
        for c in classes:
            npos = self._npos.get(c, 0)
            rec = sorted(self._records.get(c, []), key=lambda r: -r[0])
            if npos == 0:
                continue
            if not rec:
                aps.append(0.0)
                per_class[c] = 0.0
                continue
            tp = _np.cumsum([r[1] for r in rec])
            fp = _np.cumsum([1 - r[1] for r in rec])
            recall = tp / npos
            precision = tp / _np.maximum(tp + fp, 1e-12)
            ap = self._average_precision(recall, precision)
            aps.append(ap)
            per_class[c] = ap
        mean_ap = float(_np.mean(aps)) if aps else float("nan")
        if self._names:
            # fixed-length output: every named class reports every call
            # (nan when its gts have not appeared), ids beyond the name
            # list get a generic label, so consumers can zip a stable
            # header
            names, values = [], []
            for c in range(len(self._names)):
                names.append(f"{self._names[c]}_ap")
                values.append(per_class.get(c, float("nan")))
            for c in sorted(k for k in per_class
                            if k >= len(self._names) or k < 0):
                names.append(f"class{c}_ap")
                values.append(per_class[c])
            names.append(self.name)
            values.append(mean_ap)
            return names, values
        return self.name, mean_ap
