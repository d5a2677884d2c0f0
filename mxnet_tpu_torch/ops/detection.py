"""Detection ops: IoU, NMS and the SSD multibox ops.

Counterpart of mxnet_tpu/ops/detection.py `_to_corner`, `_iou_corner`,
`box_iou`, `_nms_single`, `box_nms`, `multibox_prior`, `_center`,
`multibox_target` and `multibox_detection`: plain functions on tensors
that keep the reference's padded fixed-K contract (shapes never depend
on the data; suppressed and invalid rows are -1) and its operation
order, so that the same float32 inputs give the same bits on the CPU.
`roi_align` is not ported yet and raises.

The reference runs every op as XLA; none has a Pallas body. One of
them cannot be run eagerly: `_nms_single` walks all N boxes of an image
in score order (a lax.fori_loop, each step masking a row of the (N, N)
IoU matrix), 5,624 dependent steps an image at SSD-512's anchor count.
Here that walk is a hand-written CUDA kernel (`csrc/nms.cu`) behind
`nms_keep`, with its plain PyTorch version `_nms_keep_reference` beside
it. The score sort, the `topk` threshold and the unsort stay torch ops
around it (`box_nms`).

impl="auto" takes the plain version for a tensor on the CPU and the
kernel for a tensor on a CUDA card, where a call the kernel cannot take
raises (there is no fallback); impl="torch" takes the plain version on
any device (the reference the kernel is held to on the card). Every
kernel call adds one to LAUNCHES["nms"]; nothing else touches it.

Divisions by a constant that is not a power of two divide by a tensor
on the operand's device: on a CUDA tensor torch turns a division by a
Python number into a product with its reciprocal, which is not the
quotient the CPU (and the reference) computes.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..base import MXNetError, not_ported
from . import _build
from . import registry as _registry

__all__ = ["box_iou", "box_nms", "multibox_prior", "multibox_target",
           "multibox_detection", "roi_align", "nms_keep", "LAUNCHES",
           "reset_launches"]

# launches of the NMS kernel (one a call) since the last reset
LAUNCHES = {"nms": 0}
_IMPLS = ("auto", "torch")
# mirrors of csrc/nms.cu: rows a mask word covers; valid rows an image
# keeps on chip (beyond them the image takes the global path, whose
# scratch is given only where N exceeds this); mask words of a row at
# most (the global walk's bitmask in 24 KB of shared memory)
_NMS_TILE = 64
_NMS_ON_CHIP_ROWS = 1216
_NMS_MAX_WORDS = 3072
_NMS_MAX_IMAGES = 65535


def reset_launches():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _to_corner(b, fmt):
    if fmt == "corner":
        return b
    if fmt == "center":  # (cx, cy, w, h) -> (x1, y1, x2, y2)
        cx, cy, w, h = b.split(1, dim=-1)
        return torch.cat([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2],
                         dim=-1)
    raise MXNetError(f"unknown box format {fmt!r}")


def _area(x):
    return (x[..., 2] - x[..., 0]).clamp(min=0.0) * \
        (x[..., 3] - x[..., 1]).clamp(min=0.0)


def _iou_corner(a, b):
    """a: (..., N, 4), b: (..., M, 4) corner boxes -> (..., N, M) IoU.
    max and min keep a NaN (torch.maximum/minimum, clamp), as
    jnp.maximum/minimum do."""
    a = a[..., :, None, :]
    b = b[..., None, :, :]
    tl = torch.maximum(a[..., :2], b[..., :2])
    br = torch.minimum(a[..., 2:], b[..., 2:])
    wh = (br - tl).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = _area(a) + _area(b) - inter
    return torch.where(union > 0, inter / union, 0.0)


def box_iou(lhs, rhs, format="corner"):
    """Parity: bounding_box.cc box_iou. lhs (..., N, 4), rhs (..., M, 4)
    -> (..., N, M)."""
    return _iou_corner(_to_corner(lhs, format), _to_corner(rhs, format))


# ---------------------------------------------------------------------------
# NMS: the kernel and its plain version
# ---------------------------------------------------------------------------

def _nms_keep_reference(boxes, ids, valid, overlap_thresh, force_suppress):
    """The plain version of nms_keep: `_nms_single`'s loop over the rows
    of the (N, N) IoU matrix, one image at a time. Rows that are not
    valid are skipped: such a row is never kept, so it never
    suppresses."""
    keep = valid.clone()
    for b in range(valid.shape[0]):
        sup = (_iou_corner(boxes[b], boxes[b]) > overlap_thresh) & \
            ((ids[b][:, None] == ids[b][None, :]) | bool(force_suppress))
        sup = sup.triu(1)                       # lower-ranked boxes only
        for i in torch.nonzero(valid[b]).flatten().tolist():
            keep[b] &= ~(sup[i] & keep[b, i])
    return keep


def _nms_lib():
    lib = _build.load("nms")
    if not getattr(lib, "_mxt_bound", False):
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.mxt_nms.argtypes = [ptr] * 7 + [i32, i32, ctypes.c_float, i32,
                                            ptr]
        lib.mxt_nms.restype = i32
        lib._mxt_bound = True
    return lib


def nms_keep(boxes, ids, valid, overlap_thresh=0.5, force_suppress=False,
             impl="auto"):
    """Greedy NMS keep mask over boxes already in score-descending order
    (the loop of the reference's `_nms_single`).

    boxes: (B, N, 4) corner boxes; ids: (B, N) class ids; valid: (B, N)
    bool. Row i, if valid and still kept when the walk reaches it,
    suppresses every later row j whose IoU with it exceeds
    `overlap_thresh` and whose id equals its own (any id with
    `force_suppress`). Returns keep (B, N) bool in the same order.

    On a CUDA tensor this makes one launch of csrc/nms.cu, which works
    on each image's M valid rows alone: a thread-block cluster an image
    (of 16, 8, 4, 2 or 1 blocks: the largest of which all B clusters fit
    the card at once) compacts them in walk order, builds their
    M x ceil(M / 64) words of suppression mask in the leader block's
    shared memory (the others write theirs over distributed shared
    memory), and one warp walks it from registers and shared memory, a
    64-row tile at a time in rounds of warp reductions. An image with
    more than _NMS_ON_CHIP_ROWS valid rows takes a global-memory path in
    the same launch: its cluster builds its mask as the upper triangle
    of 64 x 64 tiles in scratch, then its leader walks the compacted
    words from L2. The kernel decides per image; nothing here waits for
    the card. The scratch (68 MB at B = 32, N = 5,624) is allocated
    only where N exceeds _NMS_ON_CHIP_ROWS. What bounds it is latency:
    the mask's chains of dependent IoU operations, then the walk's
    rounds and the launch.

    The kernel takes float32 boxes and ids, contiguous, 16-byte aligned
    boxes, N <= 196,608 and B <= 65,535.
    """
    if impl not in _IMPLS:
        raise ValueError(f"unknown nms impl {impl!r}")
    if not (impl == "auto" and boxes.is_cuda):
        return _nms_keep_reference(boxes, ids, valid, overlap_thresh,
                                   force_suppress)
    name = "nms"
    B, N = valid.shape
    if boxes.dtype != torch.float32 or ids.dtype != torch.float32:
        raise MXNetError(f"{name}: the kernel takes float32 boxes and ids, "
                         f"got {boxes.dtype} and {ids.dtype}")
    if valid.dtype != torch.bool:
        raise MXNetError(f"{name}: valid must be bool, got {valid.dtype}")
    if tuple(boxes.shape) != (B, N, 4) or tuple(ids.shape) != (B, N):
        raise MXNetError(f"{name}: boxes {tuple(boxes.shape)} and ids "
                         f"{tuple(ids.shape)} do not match valid {(B, N)}")
    if any(t.device != boxes.device for t in (ids, valid)):
        raise MXNetError(f"{name}: boxes, ids and valid must share a device")
    if not all(t.is_contiguous() for t in (boxes, ids, valid)) \
            or boxes.data_ptr() % 16:
        raise MXNetError(f"{name}: the kernel needs contiguous tensors and "
                         "16-byte aligned boxes")
    words = -(-N // _NMS_TILE)
    if words > _NMS_MAX_WORDS or B > _NMS_MAX_IMAGES:
        raise MXNetError(f"{name}: the kernel takes N <= "
                         f"{_NMS_MAX_WORDS * _NMS_TILE} and B <= "
                         f"{_NMS_MAX_IMAGES}, got N = {N}, B = {B}")
    keep = torch.empty((B, N), dtype=torch.bool, device=boxes.device)
    if B == 0 or N == 0:
        return keep
    scratch = (None,) * 3
    if N > _NMS_ON_CHIP_ROWS:
        # the global path, for images with more valid rows than fit on
        # chip (the kernel decides per image): each image's mask as the
        # upper triangle of words x words tiles of 64 words, and its
        # valid rows' boxes and ids in walk order
        dev = boxes.device
        scratch = (
            torch.empty(B * _NMS_TILE * words * (words + 1) // 2,
                        dtype=torch.int64, device=dev),
            torch.empty((B, N, 4), dtype=torch.float32, device=dev),
            torch.empty((B, N), dtype=torch.float32, device=dev))
    with torch.cuda.device(boxes.device):
        err = _nms_lib().mxt_nms(
            boxes.data_ptr(), ids.data_ptr(), valid.data_ptr(),
            keep.data_ptr(),
            *(None if t is None else t.data_ptr() for t in scratch), B, N,
            float(np.float32(overlap_thresh)), int(bool(force_suppress)),
            torch.cuda.current_stream(boxes.device).cuda_stream)
    if err:
        raise _build.KernelError(f"{name}: kernel launch failed "
                                 f"(cudaError {err})")
    LAUNCHES[name] += 1
    return keep


def _nms_inputs(data, boxes, valid_thresh, topk, score_index, id_index,
                background_id):
    """box_nms's walk order and nms_keep's inputs in that order: (order
    (B, N), (boxes (B, N, 4), ids (B, N), valid (B, N)))."""
    B, N, _ = data.shape
    scores = data[..., score_index]
    if id_index >= 0:
        ids = data[..., id_index]
        valid = (scores > valid_thresh) & (ids != background_id)
    else:
        ids = torch.zeros_like(scores)
        valid = scores > valid_thresh
    if topk > 0:
        cand = torch.where(valid, scores, -torch.inf)
        kth = torch.sort(cand, dim=-1, descending=True).values[
            :, min(topk, N) - 1]
        valid = valid & (scores >= kth[:, None])
    order = torch.argsort(-scores, dim=-1, stable=True)
    return order, (torch.gather(boxes, 1, order[..., None].expand(B, N, 4)),
                   torch.gather(ids, 1, order),
                   torch.gather(valid, 1, order))


def box_nms(data, overlap_thresh=0.5, valid_thresh=0.0, topk=-1,
            coord_start=2, score_index=1, id_index=-1, background_id=-1,
            force_suppress=False, in_format="corner", out_format="corner",
            impl="auto"):
    """Parity: bounding_box.cc box_nms. data (B, N, K) rows
    [.., score, .., x1, y1, x2, y2, ..] (or (N, K)); returns the same
    shape with suppressed and invalid rows set to -1. Only the `topk`
    highest valid scores of an image stay candidates (every score at or
    above the k-th, so ties at the k-th stay in); the walk visits rows
    in a stable descending sort of the scores."""
    squeeze = data.dim() == 2
    if squeeze:
        data = data[None]
    boxes = _to_corner(data[..., coord_start:coord_start + 4], in_format)
    order, sorted_args = _nms_inputs(data, boxes, valid_thresh, topk,
                                     score_index, id_index, background_id)
    keep_sorted = nms_keep(*sorted_args, overlap_thresh, force_suppress,
                           impl)
    keep = torch.zeros_like(keep_sorted).scatter_(1, order, keep_sorted)
    if out_format != in_format:
        if out_format == "corner":
            coords = boxes                       # already converted
        elif out_format == "center":
            x1, y1, x2, y2 = boxes.split(1, dim=-1)
            coords = torch.cat([(x1 + x2) / 2, (y1 + y2) / 2, x2 - x1,
                                y2 - y1], dim=-1)
        else:
            raise MXNetError(f"unknown box format {out_format!r}")
        data = torch.cat([data[..., :coord_start], coords,
                          data[..., coord_start + 4:]], dim=-1)
    out = torch.where(keep[..., None], data, -1.0)
    return out[0] if squeeze else out


# ---------------------------------------------------------------------------
# SSD multibox ops
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=64)
def _prior(H, W, sizes, ratios, clip, steps, offsets, device):
    f32 = torch.float32

    def c(v):                 # a constant as JAX casts it: to float32
        return torch.tensor(np.float32(v), dtype=f32)
    step_y = steps[0] if steps[0] > 0 else 1.0 / H
    step_x = steps[1] if steps[1] > 0 else 1.0 / W
    cy = (torch.arange(H, dtype=f32) + c(offsets[0])) * c(step_y)
    cx = (torch.arange(W, dtype=f32) + c(offsets[1])) * c(step_x)
    cyg, cxg = torch.meshgrid(cy, cx, indexing="ij")          # (H, W)
    pairs = [(s, ratios[0]) for s in sizes] + \
        [(sizes[0], r) for r in ratios[1:]]
    ws = torch.stack([c(s) * torch.sqrt(c(r)) for s, r in pairs])  # (A,)
    hs = torch.stack([c(s) / torch.sqrt(c(r)) for s, r in pairs])
    A = ws.shape[0]
    cxg = cxg[..., None].expand(H, W, A)
    cyg = cyg[..., None].expand(H, W, A)
    anchors = torch.stack([cxg - ws / 2, cyg - hs / 2, cxg + ws / 2,
                           cyg + hs / 2], dim=-1).reshape(1, H * W * A, 4)
    if clip:
        anchors = anchors.clamp(0.0, 1.0)
    return anchors.to(device)


def multibox_prior(data, sizes=(1.0,), ratios=(1.0,), clip=False,
                   steps=(-1.0, -1.0), offsets=(0.5, 0.5)):
    """Parity: multibox_prior.cc, SSD anchor generation. data (B, C, H, W)
    -> (1, H*W*(S+R-1), 4) float32 corner anchors in [0, 1] coordinates,
    whatever data's dtype: (s_i, r_0) for every size, then (s_0, r_j)
    for every extra ratio, per cell. Sizes, ratios, steps and offsets
    are cast to float32 before any arithmetic, as JAX casts them, so the
    anchors are the reference's bytes. They depend only on (H, W) and
    the arguments and are cached per shape and device: treat the result
    as read-only."""
    return _prior(int(data.shape[2]), int(data.shape[3]),
                  tuple(float(s) for s in sizes),
                  tuple(float(r) for r in ratios), bool(clip),
                  tuple(float(s) for s in steps),
                  tuple(float(o) for o in offsets), data.device)


def _center(b):
    return ((b[..., 0] + b[..., 2]) / 2, (b[..., 1] + b[..., 3]) / 2,
            b[..., 2] - b[..., 0], b[..., 3] - b[..., 1])


def _const(v, like):
    """v as a float32 tensor on like's device (a true divisor there)."""
    return torch.tensor(np.float32(v), dtype=torch.float32,
                        device=like.device)


def multibox_target(anchor, label, cls_pred, overlap_threshold=0.5,
                    ignore_label=-1.0, negative_mining_ratio=-1.0,
                    negative_mining_thresh=0.5, minimum_negative_samples=0,
                    variances=(0.1, 0.1, 0.2, 0.2)):
    """Parity: multibox_target.cc, SSD anchor-to-gt matching and target
    encoding. anchor (1, N, 4) corner; label (B, M, 5) rows
    [cls_id, x1, y1, x2, y2] padded with -1; cls_pred (B, C+1, N) (for
    the reference's signature only). Returns (box_target (B, N*4),
    box_mask (B, N*4), cls_target (B, N)): cls_target 0 is background,
    gt class ids shifted by +1.

    An anchor is positive when its best IoU reaches the threshold (its
    gt the first best) or when a valid gt claims it as its own best
    anchor (the first best); where two valid gts claim one anchor, the
    later gt wins, as the reference's scatter resolves it. Padding gts
    claim nothing."""
    N = anchor.shape[1]
    B, M = label.shape[0], label.shape[1]
    anc = anchor[0]                                       # (N, 4)
    gt_valid = label[..., 0] >= 0                         # (B, M)
    gt_boxes = label[..., 1:5]
    iou = _iou_corner(anc, gt_boxes)                      # (B, N, M)
    iou = torch.where(gt_valid[:, None, :], iou, -1.0)
    best_gt = iou.argmax(dim=2)                           # (B, N)
    best_iou = iou.amax(dim=2)
    matched = best_iou >= overlap_threshold
    best_anchor = iou.argmax(dim=1)                       # (B, M)
    gt_index = torch.arange(M, device=label.device).expand(B, M)
    # each valid gt claims its best anchor; column N takes the padding's
    claim = torch.full((B, N + 1), -1, dtype=torch.int64,
                       device=label.device).scatter_reduce_(
        1, torch.where(gt_valid, best_anchor, N), gt_index, "amax")[:, :N]
    forced = claim >= 0
    gt_of = torch.where(forced, claim, best_gt)
    pos = matched | forced
    g = torch.gather(gt_boxes, 1, gt_of[..., None].expand(B, N, 4))
    acx, acy, aw, ah = _center(anc)
    gcx, gcy, gw, gh = _center(g)
    eps = 1e-8
    aw_, ah_ = aw.clamp(min=eps), ah.clamp(min=eps)
    tx = (gcx - acx) / aw_ / _const(variances[0], g)
    ty = (gcy - acy) / ah_ / _const(variances[1], g)
    tw = torch.log(gw.clamp(min=eps) / aw_) / _const(variances[2], g)
    th = torch.log(gh.clamp(min=eps) / ah_) / _const(variances[3], g)
    bt = torch.stack([tx, ty, tw, th], dim=-1)            # (B, N, 4)
    bt = torch.where(pos[..., None], bt, 0.0)
    bm = pos[..., None].to(bt.dtype).expand(B, N, 4)
    ct = torch.where(pos, torch.gather(label[..., 0], 1, gt_of) + 1.0, 0.0)
    return bt.reshape(B, -1), bm.reshape(B, -1), ct


def multibox_detection(cls_prob, loc_pred, anchor, clip=True,
                       threshold=0.01, background_id=0, nms_threshold=0.5,
                       force_suppress=False,
                       variances=(0.1, 0.1, 0.2, 0.2), nms_topk=-1,
                       impl="auto"):
    """Parity: multibox_detection.cc: decode the loc predictions against
    the anchors and run NMS over each anchor's best class. cls_prob
    (B, C+1, N) (class 0 background), loc_pred (B, N*4), anchor
    (1, N, 4). Returns (B, N, 6) rows [class_id, score, x1, y1, x2, y2],
    invalid rows -1, in float32 (the scores keep cls_prob's dtype until
    the rows are joined, as the reference promotes them)."""
    rows = _decode_rows(cls_prob, loc_pred, anchor, clip, threshold,
                        variances)
    return box_nms(rows, overlap_thresh=nms_threshold,
                   valid_thresh=threshold, topk=nms_topk, coord_start=2,
                   score_index=1, id_index=0, background_id=-1,
                   force_suppress=force_suppress, impl=impl)


def _decode_rows(cls_prob, loc_pred, anchor, clip, threshold, variances):
    """multibox_detection's rows before NMS: (B, N, 6) float32 [class_id,
    score, x1, y1, x2, y2], class_id and score -1 below the threshold."""
    B = cls_prob.shape[0]
    N = anchor.shape[1]
    acx, acy, aw, ah = _center(anchor[0])
    loc = loc_pred.reshape(B, N, 4)
    cx = loc[..., 0] * variances[0] * aw + acx
    cy = loc[..., 1] * variances[1] * ah + acy
    w = torch.exp(loc[..., 2] * variances[2]) * aw
    h = torch.exp(loc[..., 3] * variances[3]) * ah
    boxes = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2],
                        dim=-1)                           # (B, N, 4)
    if clip:
        boxes = boxes.clamp(0.0, 1.0)
    fg = cls_prob[:, 1:, :]                               # (B, C, N)
    cls_id = fg.argmax(dim=1).to(torch.float32)           # (B, N)
    score = fg.amax(dim=1)
    valid = score > threshold
    cls_id = torch.where(valid, cls_id, -1.0)
    score = torch.where(valid, score, -1.0)
    return torch.cat([cls_id[..., None], score[..., None], boxes], dim=-1)


def roi_align(data, rois, pooled_size=(7, 7), spatial_scale=1.0,
              sample_ratio=2, aligned=False):
    """contrib/roi_align.cc (Mask R-CNN ROIAlign): not ported yet."""
    raise not_ported("roi_align")


# the registered ops (mx.nd.*), the reference's names over the functions
# above; roi_align raises not_ported as its function does
for _name in ("box_iou", "box_nms", "multibox_prior", "multibox_target",
              "multibox_detection", "roi_align"):
    _registry.op(_name)(globals()[_name])
del _name
