"""The port's detection ops and VOC mAP against the JAX package.

Each case hands the same seeded numpy inputs to mxnet_tpu.ops.detection
(the raw functions behind the ops) and to mxnet_tpu_torch.ops.detection
on the CPU, where the NMS wrapper takes its plain version. The anchors
are held byte-equal, `box_iou` and `box_nms` (outputs and keep masks)
exactly equal; `multibox_target`'s class targets, masks and center
offsets exactly equal and its log-size targets within two units in the
last place (XLA's float32 log is not correctly rounded: up to 1.12 ulp
from the true value where torch's stays within 0.52, so the two logs
differ by one ulp on about 8% of inputs, and the division by the
variance that follows rounds that into at most two);
`multibox_detection`'s class ids and scores equal and its boxes within
1e-6 (its exp is another library's); `VOCMApMetric` equal to the
reference's. The NMS kernel itself runs only on a card: chip_smoke.py
holds it to the plain version there.
"""
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from mxnet_tpu import metric as jmetric  # noqa: E402
from mxnet_tpu.ops import detection as jdet  # noqa: E402
from mxnet_tpu_torch import MXNetError, metric  # noqa: E402
from mxnet_tpu_torch.ops import _build  # noqa: E402
from mxnet_tpu_torch.ops import detection as det  # noqa: E402


def _j(fn, *args, **kw):
    out = getattr(jdet, fn).raw_fn(*[jnp.asarray(a) for a in args], **kw)
    if isinstance(out, tuple):
        return tuple(np.asarray(o) for o in out)
    return np.asarray(out)


def _t(fn, *args, **kw):
    out = getattr(det, fn)(*[torch.from_numpy(np.array(a)) for a in args],
                           **kw)
    if isinstance(out, tuple):
        return tuple(o.numpy() for o in out)
    return out.numpy()


def _corner_boxes(r, n, lo=0.0, hi=1.0):
    xy = r.uniform(lo, hi, (n, 2, 2))
    xy.sort(axis=1)                                   # x1 <= x2, y1 <= y2
    return xy.transpose(0, 2, 1).reshape(n, 4)[:, [0, 2, 1, 3]].astype(
        np.float32)


def _bits_equal(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


# ---------------------------------------------------------------------------
# multibox_prior and box_iou
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("H,W,sizes,ratios,clip,steps,offsets", [
    (4, 4, (0.1, 0.2), (1.0, 2.0, 0.5), False, (-1.0, -1.0), (0.5, 0.5)),
    (8, 5, (np.float64(0.38), 0.4936598), (1.0, 2.0, 0.5, 3.0, 1.0 / 3),
     True, (-1.0, -1.0), (0.5, 0.5)),
    (3, 7, (0.3,), (1.0,), True, (0.25, 0.1), (0.0, 0.3)),
    (32, 32, tuple(np.linspace(0.1, 0.95, 6)[:2]), (1.0, 2.0, 0.5), True,
     (-1.0, -1.0), (0.5, 0.5)),
    (1, 1, (0.95, 1.2), (1.0, 2.0, 0.5, 3.0, 1.0 / 3), False, (-1.0, -1.0),
     (0.5, 0.5))],
    ids=["plain", "ssd_scale3", "steps_offsets", "ssd_scale0_32", "1x1"])
def test_multibox_prior_byte_equal(H, W, sizes, ratios, clip, steps,
                                   offsets):
    data = np.zeros((1, 2, H, W), np.float32)
    kw = dict(sizes=sizes, ratios=ratios, clip=clip, steps=steps,
              offsets=offsets)
    want = _j("multibox_prior", data, **kw)
    got = _t("multibox_prior", data, **kw)
    _bits_equal(got, want)
    # float32 whatever the feature dtype; cached, the same bytes again
    again = det.multibox_prior(torch.zeros(1, 2, H, W, dtype=torch.bfloat16),
                               **kw)
    _bits_equal(again.numpy(), want)


@pytest.mark.parametrize("fmt", ["corner", "center"])
def test_box_iou_equal(fmt):
    r = np.random.default_rng(1)
    a = r.uniform(0, 1, (2, 7, 4)).astype(np.float32)
    b = r.uniform(0, 1, (2, 5, 4)).astype(np.float32)
    if fmt == "corner":
        a[..., 2:] += a[..., :2]
        b[..., 2:] += b[..., :2]
    a[0, 0] = [0, 0, 1, 1] if fmt == "corner" else [0.5, 0.5, 1, 1]
    b[0, 0] = [0, 0, 1, 0.5] if fmt == "corner" else [0.5, 0.25, 1, 0.5]
    b[1, 1] = a[1, 2]                                  # identical pair
    b[1, 2, 2:] = b[1, 2, :2] if fmt == "corner" else 0.0   # zero area
    want = _j("box_iou", a, b, format=fmt)
    got = _t("box_iou", a, b, format=fmt)
    _bits_equal(got, want)
    assert got[0, 0, 0] == np.float32(0.5)
    with pytest.raises(MXNetError, match="unknown box format"):
        det.box_iou(torch.zeros(1, 4), torch.zeros(1, 4), format="xywh")


# ---------------------------------------------------------------------------
# box_nms
# ---------------------------------------------------------------------------

def _nms_rows(seed, B, N, n_ids=3, tie_scores=False):
    """(B, N, 6) rows [id, score, x1, y1, x2, y2]: clustered boxes, so
    that many pairs overlap near the thresholds."""
    r = np.random.default_rng(seed)
    rows = np.zeros((B, N, 6), np.float32)
    for b in range(B):
        centers = r.uniform(0.2, 0.8, (max(N // 6, 1), 2))
        c = centers[r.integers(0, len(centers), N)] + r.normal(0, 0.03,
                                                               (N, 2))
        wh = r.uniform(0.1, 0.3, (N, 2))
        rows[b, :, 2:4] = c - wh / 2
        rows[b, :, 4:6] = c + wh / 2
    rows[..., 0] = r.integers(0, n_ids, (B, N))
    scores = r.uniform(0, 1, (B, N))
    rows[..., 1] = np.round(scores, 1) if tie_scores else scores
    return rows


def _keep_jax(rows, overlap_thresh, valid_thresh, topk, id_index,
              background_id, force_suppress):
    """The reference's keep mask: `_nms_single` on box_nms's inputs."""
    data = jnp.asarray(rows)
    scores = data[..., 1]
    boxes = data[..., 2:6]
    if id_index >= 0:
        ids = data[..., id_index]
        valid = (scores > valid_thresh) & (ids != background_id)
    else:
        ids = jnp.zeros_like(scores)
        valid = scores > valid_thresh
    if topk > 0:
        kth = -jnp.sort(-jnp.where(valid, scores, -jnp.inf), axis=-1)[
            :, min(topk, rows.shape[1]) - 1]
        valid = valid & (scores >= kth[:, None])
    return np.stack([np.asarray(jdet._nms_single(
        boxes[b], scores[b], ids[b], valid[b], overlap_thresh,
        force_suppress)) for b in range(rows.shape[0])])


def _keep_port(rows, overlap_thresh, valid_thresh, topk, id_index,
               background_id, force_suppress):
    """The port's keep mask (box_nms's walk order, the public nms_keep,
    the unsort) and its box_nms output."""
    data = torch.from_numpy(rows)
    out = det.box_nms(data, overlap_thresh, valid_thresh, topk, 2, 1,
                      id_index, background_id, force_suppress)
    order, args = det._nms_inputs(data, data[..., 2:6], valid_thresh, topk,
                                  1, id_index, background_id)
    ks = det.nms_keep(*args, overlap_thresh, force_suppress)
    keep = torch.zeros_like(ks).scatter_(1, order, ks)
    return keep.numpy(), out.numpy()


# (overlap_thresh, topk, force_suppress, id_index, background_id, seed,
#  B, N, tie_scores, class ids). The last four sit where the CUDA kernel's
# paths switch: every row of N = 1,300 valid (over its 1,216 on-chip
# rows), 80 class ids with and without force, a negative threshold (a
# pair that does not overlap has IoU 0, which is above it)
_NMS_CASES = {
    "t03": (0.3, -1, False, 0, -1, 0, 2, 40, False, 3),
    "t05": (0.5, -1, False, 0, -1, 1, 2, 40, False, 3),
    "t07": (0.7, -1, False, 0, -1, 2, 2, 40, False, 3),
    "topk5_ties": (0.5, 5, False, 0, -1, 3, 2, 40, True, 3),
    "topkN": (0.5, 40, False, 0, -1, 4, 2, 40, False, 3),
    "equal_scores": (0.5, -1, False, 0, -1, 5, 2, 40, True, 3),
    "force": (0.5, -1, True, 0, -1, 6, 2, 40, False, 3),
    "no_ids": (0.5, -1, False, -1, -1, 7, 2, 40, False, 3),
    "background1": (0.5, -1, False, 0, 1, 8, 2, 40, False, 3),
    "background1_topk5": (0.3, 5, False, 0, 1, 9, 2, 40, True, 3),
    "n1": (0.5, -1, False, 0, -1, 10, 2, 1, False, 3),
    "n63": (0.5, -1, False, 0, -1, 11, 1, 63, False, 3),
    "n64": (0.45, 20, False, 0, -1, 12, 1, 64, False, 3),
    "n65": (0.5, -1, True, 0, -1, 13, 1, 65, False, 3),
    "n200": (0.45, -1, False, 0, -1, 14, 2, 200, True, 3),
    "n1300_all_valid": (0.45, -1, False, 0, -1, 15, 1, 1300, False, 3),
    "ids80": (0.5, -1, False, 0, -1, 16, 2, 300, False, 80),
    "ids80_force": (0.5, -1, True, 0, -1, 17, 2, 300, False, 80),
    "negative_thresh": (-0.1, -1, False, 0, -1, 18, 2, 200, False, 3),
}


@pytest.mark.parametrize("case", list(_NMS_CASES), ids=list(_NMS_CASES))
def test_box_nms_equal(case):
    thresh, topk, force, id_index, bg, seed, B, N, ties, n_ids = \
        _NMS_CASES[case]
    rows = _nms_rows(seed, B, N, n_ids=n_ids, tie_scores=ties)
    kw = dict(overlap_thresh=thresh, valid_thresh=0.0, topk=topk,
              coord_start=2, score_index=1, id_index=id_index,
              background_id=bg, force_suppress=force)
    want = _j("box_nms", rows, **kw)
    keep, got = _keep_port(rows, thresh, 0.0, topk, id_index, bg, force)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        keep, _keep_jax(rows, thresh, 0.0, topk, id_index, bg, force))
    assert keep.sum() >= min(1, N)


def test_box_nms_edges():
    """Formats, a 2-D input, every row invalid, an IoU exactly at the
    threshold, zero-area boxes, NaN coordinates and NaN scores."""
    r = np.random.default_rng(20)
    rows = _nms_rows(21, 2, 24)
    kw = dict(coord_start=2, score_index=1, id_index=0)
    # center in, center and corner out
    center = rows.copy()
    center[..., 2:4] = (rows[..., 2:4] + rows[..., 4:6]) / 2
    center[..., 4:6] = rows[..., 4:6] - rows[..., 2:4]
    for fmt_out in ("center", "corner"):
        np.testing.assert_array_equal(
            _t("box_nms", center, in_format="center", out_format=fmt_out,
               **kw),
            _j("box_nms", center, in_format="center", out_format=fmt_out,
               **kw))
    np.testing.assert_array_equal(
        _t("box_nms", rows, out_format="center", **kw),
        _j("box_nms", rows, out_format="center", **kw))
    with pytest.raises(MXNetError, match="unknown box format"):
        det.box_nms(torch.from_numpy(rows), out_format="xywh")
    # one image as a 2-D array
    np.testing.assert_array_equal(_t("box_nms", rows[0], **kw),
                                  _j("box_nms", rows[0], **kw))
    # every row invalid: all -1
    dead = rows.copy()
    dead[..., 1] = -r.uniform(0, 1, dead.shape[:2])
    got = _t("box_nms", dead, **kw)
    assert (got == -1).all()
    np.testing.assert_array_equal(got, _j("box_nms", dead, **kw))
    # IoU exactly 0.5 is not above 0.5: both kept; above it is suppressed
    at = np.float32([[[0, 0.9, 0, 0, 1, 1], [0, 0.8, 0, 0, 1, 0.5],
                      [0, 0.7, 0, 0, 1, 0.51]]])
    got = _t("box_nms", at, overlap_thresh=0.5, **kw)
    np.testing.assert_array_equal(got, _j("box_nms", at, overlap_thresh=0.5,
                                          **kw))
    np.testing.assert_array_equal(got[0, :, 0], [0, 0, -1])
    # zero-area boxes (a point, a line) and NaN coordinates and scores
    odd = rows.copy()
    odd[0, 0, 4:6] = odd[0, 0, 2:4]
    odd[0, 1, 4] = odd[0, 1, 2]
    odd[0, 2:4, 1] = odd[0, 4:6, 1]                   # equal scores
    odd[1, 0, 3] = np.nan
    odd[1, 1, 2:6] = np.nan
    odd[1, 2, 1] = np.nan
    odd[0, 5, 0] = np.nan                             # a NaN class id
    for force in (False, True):
        for topk in (-1, 6):
            got = _t("box_nms", odd, topk=topk, force_suppress=force, **kw)
            want = _j("box_nms", odd, topk=topk, force_suppress=force, **kw)
            np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(
                _keep_port(odd, 0.5, 0.0, topk, 0, -1, force)[0],
                _keep_jax(odd, 0.5, 0.0, topk, 0, -1, force))


def test_nms_wrapper_on_the_cpu():
    """The kernel wrapper imports without CUDA; impl="auto" on a CPU
    tensor takes the plain version (no launch counted), as impl="torch"
    does; an unknown impl raises. The wrapper's mirrors of the kernel's
    constants match csrc/nms.cu."""
    rows = torch.from_numpy(_nms_rows(30, 2, 70))
    det.reset_launches()
    auto = det.box_nms(rows, id_index=0)
    plain = det.box_nms(rows, id_index=0, impl="torch")
    assert torch.equal(auto, plain)
    assert det.LAUNCHES == {"nms": 0}
    with pytest.raises(ValueError, match="unknown nms impl"):
        det.box_nms(rows, id_index=0, impl="cuda")
    src = _build.SOURCES["nms"]
    assert src.name == "nms.cu" and src.is_file()
    consts = {m[0]: int(m[1]) for m in re.findall(
        r"constexpr int (\w+) = (\d+);", src.read_text())}
    assert consts["kTile"] == det._NMS_TILE == 64
    assert consts["kMaxWords"] == det._NMS_MAX_WORDS
    assert consts["kOnChipRows"] == det._NMS_ON_CHIP_ROWS
    assert consts["kThreads"] == 1024
    # the on-chip block's shared memory at the limit (boxes, ids and areas
    # of the valid rows, their rows x words mask words; 33 ints and 32
    # words static) fits the 227 KB a block can have; the walk's lane w
    # holds word w; the global path reuses that memory for its 32 warps'
    # column tiles of 64 boxes, ids and areas, then for the walk's
    # bitmask and its 2 x 64 diagonal words
    rows = det._NMS_ON_CHIP_ROWS
    words = -(-rows // det._NMS_TILE)
    limit = rows * (16 + 4 + 4) + rows * words * 8
    assert limit + 33 * 4 + 32 * 8 <= 232448
    assert words <= 32
    assert 32 * 64 * (16 + 4 + 4) <= limit
    assert 8 * (det._NMS_MAX_WORDS + 2 * 64) <= limit


def _above_by_rule(inter, union, thresh):
    """csrc/nms.cu iou_above's threshold test in numpy float64: whether
    RN(inter / union) > thresh, decided without dividing. mid is halfway
    from thresh to the next float32 up; union * mid is exact in float64;
    a quotient equal to mid rounds up where thresh's last bit is odd.
    Where inter is 0 or the union not above 0 the IoU is 0."""
    t = np.float32(thresh)
    mid = 0.5 * (np.float64(t) + np.float64(np.nextafter(t, np.float32(
        np.inf))))
    tie_up = bool(t.view(np.uint32) & 1)
    with np.errstate(invalid="ignore", over="ignore"):
        x = union.astype(np.float64) * mid
        y = inter.astype(np.float64)
        by_rule = (y > x) | ((y == x) & tie_up)
        return np.where((inter != 0) & (union > 0), by_rule,
                        np.float32(0) > t), int(((y == x) & (inter != 0)
                                                 & (union > 0)).sum())


def _above_by_division(inter, union, thresh):
    """_iou_corner's quotient (float32, round to nearest) against the
    threshold."""
    with np.errstate(divide="ignore", invalid="ignore"):
        iou = np.where(union > 0, inter / union, np.float32(0))
    return iou.astype(np.float32) > np.float32(thresh)


_TINY = float(np.float32(2.0 ** -149))
_RULE_THRESHOLDS = [-0.1, 0.0, -0.0, 0.5, 0.45, 0.7, 1.0,
                    float(np.nextafter(np.float32(0.5), np.float32(1))),
                    _TINY, 3 * _TINY, 1000 * _TINY, -_TINY,
                    float(np.finfo(np.float32).tiny), float("nan")]


@pytest.mark.parametrize("thresh", _RULE_THRESHOLDS,
                         ids=[repr(t) for t in _RULE_THRESHOLDS])
def test_nms_threshold_rule_equals_division(thresh):
    """The kernel's division-free threshold test decides as float32
    division does: quotients within a few ulps of the threshold over
    unions at many scales, exact ties at the midpoint (they exist only
    for a zero or subnormal threshold), subnormal quotients, a zero
    intersection, a union at or below zero, NaN and infinite parts."""
    src = _build.SOURCES["nms"].read_text()
    assert "0.5 * ((double)t + (double)nextafterf(t, INFINITY))" in src
    assert "y > x || (y == x && th.tie_up)" in src
    assert ": 0.f > th.t;" in src
    r = np.random.default_rng(0)
    f32 = np.float32
    t = f32(thresh)
    unions = np.concatenate([
        r.uniform(1e-3, 10, 4000), 2.0 ** r.integers(-60, 60, 1000),
        r.uniform(1e-38, 1e-36, 500), r.uniform(1e20, 1e30, 500)]).astype(
        f32)
    q = np.abs(t) if np.isfinite(t) else f32(0.5)
    ulps = np.arange(-4, 5)
    near = (q.view(np.int32) + ulps).view(f32)       # quotients by t
    near = near[np.isfinite(near) & (near >= 0)]
    u = np.repeat(unions, near.size)
    inter = (u.astype(np.float64) * np.tile(near, unions.size)).astype(f32)
    inter = np.concatenate([(inter.view(np.int32) + d).view(f32)
                            for d in (-1, 0, 1)])
    union = np.tile(u, 3)
    # exact ties: a subnormal threshold k 2^-149 has mid (2k + 1) 2^-150,
    # so inter = (2k + 1) 2^(j - 150) over union = 2^j is a tie
    k = int(abs(t) / _TINY) if np.isfinite(t) and abs(t) < 1e-37 else 0
    j = np.arange(1, 40)
    tie_u = (2.0 ** j).astype(f32)
    tie_i = ((2 * k + 1) * 2.0 ** (j - 150)).astype(f32)
    # subnormal quotients; zero and non-positive unions; NaN and inf (an
    # infinite intersection comes with a union of -inf or NaN: the union
    # is the areas' sum less the intersection)
    sub_i = r.uniform(1e-30, 1e-28, 2000).astype(f32)
    sub_u = r.uniform(1e8, 1e10, 2000).astype(f32)
    odd_i = np.array([0, 0, 0.5, 0.5, np.nan, 0.25, 1e30, 0.5, np.inf,
                      np.inf], f32)
    odd_u = np.array([1, 0, 0, -1, 1, np.nan, np.inf, np.inf, -np.inf,
                      np.nan], f32)
    inter = np.concatenate([inter, tie_i, sub_i, odd_i])
    union = np.concatenate([union, tie_u, sub_u, odd_u])
    got, ties = _above_by_rule(inter, union, t)
    np.testing.assert_array_equal(got, _above_by_division(inter, union, t))
    if 0 <= t < 1e-37 and k < 2 ** 23:
        assert ties >= 20        # the ties above were met as ties


# ---------------------------------------------------------------------------
# multibox_target and multibox_detection
# ---------------------------------------------------------------------------

def _targets_equal(got, want):
    """Class targets, masks and the (tx, ty) targets bit-equal; the log
    targets (tw, th) within two ulps (the module docstring says why)."""
    (bt, bm, ct), (wbt, wbm, wct) = got, want
    _bits_equal(ct, wct)
    _bits_equal(bm, wbm)
    g, w = bt.reshape(*ct.shape, 4), wbt.reshape(*ct.shape, 4)
    _bits_equal(np.ascontiguousarray(g[..., :2]),
                np.ascontiguousarray(w[..., :2]))
    assert g.dtype == w.dtype == np.float32
    assert (np.sign(g) == np.sign(w)).all()
    ulps = np.abs(g[..., 2:].view(np.int32).astype(np.int64)
                  - w[..., 2:].view(np.int32).astype(np.int64))
    assert ulps.max() <= 2


def _anchors():
    return _j("multibox_prior", np.zeros((1, 1, 4, 4), np.float32),
              sizes=(0.2, 0.35), ratios=(1.0, 2.0, 0.5), clip=True)


def test_multibox_target_equal():
    """Two valid gts that share a best anchor (the later one wins),
    padding rows, an image with no gt, and a gt matched only by force
    (no anchor reaches 0.5 IoU with it)."""
    anchors = _anchors()                              # (1, 64, 4)
    N = anchors.shape[1]
    r = np.random.default_rng(3)
    label = np.full((4, 4, 5), -1.0, np.float32)
    label[0, :2, 0] = [3, 7]
    label[0, :2, 1:] = _corner_boxes(r, 2, 0.05, 0.95)
    label[1, 0] = [2, 0.3, 0.3, 0.55, 0.6]
    label[1, 1] = [5, 0.3, 0.3, 0.55, 0.6]            # same box, later id
    label[1, 2] = [1, 0.6, 0.1, 0.9, 0.4]
    label[2, 0] = [4, 0.45, 0.45, 0.47, 0.48]         # tiny: forced only
    # image 3: no gt at all
    cls_pred = np.zeros((4, 3, N), np.float32)
    got = _t("multibox_target", anchors, label, cls_pred)
    _targets_equal(got, _j("multibox_target", anchors, label, cls_pred))
    bt, bm, ct = got
    iou = _j("box_iou", anchors[0], label[1, :2, 1:])
    shared = int(np.argmax(iou[:, 0]))
    assert int(np.argmax(iou[:, 1])) == shared
    assert ct[1, shared] == 6.0                       # gt 1 (class 5) won
    assert (ct[3] == 0).all() and (bm[3] == 0).all()
    assert _j("box_iou", anchors[0], label[2, :1, 1:]).max() < 0.5
    assert (ct[2] == 5.0).sum() == 1
    # other thresholds and variances
    kw = dict(overlap_threshold=0.3, variances=(0.2, 0.2, 0.1, 0.3))
    _targets_equal(_t("multibox_target", anchors, label, cls_pred, **kw),
                   _j("multibox_target", anchors, label, cls_pred, **kw))


@pytest.mark.parametrize("topk,force", [(-1, False), (400, False),
                                        (10, True)])
def test_multibox_detection_equal(topk, force):
    anchors = _anchors()
    N = anchors.shape[1]
    r = np.random.default_rng(4)
    logits = r.normal(0, 2, (2, 6, N)).astype(np.float32)
    cls_prob = np.exp(logits) / np.exp(logits).sum(axis=1, keepdims=True)
    loc = r.normal(0, 0.5, (2, N * 4)).astype(np.float32)
    kw = dict(threshold=0.05, nms_threshold=0.45, nms_topk=topk,
              force_suppress=force)
    want = _j("multibox_detection", cls_prob, loc, anchors, **kw)
    got = _t("multibox_detection", cls_prob, loc, anchors, **kw)
    assert got.dtype == np.float32 and got.shape == (2, N, 6)
    np.testing.assert_array_equal(got[..., :2], want[..., :2])
    np.testing.assert_allclose(got[..., 2:], want[..., 2:], rtol=0,
                               atol=1e-6)
    assert 0 < (got[..., 0] >= 0).sum() < 2 * N


# ---------------------------------------------------------------------------
# VOCMApMetric
# ---------------------------------------------------------------------------

def _voc_batch(seed, B=3, M=5, N=12, classes=4, difficult=False):
    r = np.random.default_rng(seed)
    labels = np.full((B, M, 6 if difficult else 5), -1.0, np.float32)
    dets = np.full((B, N, 6), -1.0, np.float32)
    for b in range(B):
        m = r.integers(1, M + 1)
        labels[b, :m, 0] = r.integers(0, classes, m)
        labels[b, :m, 1:5] = _corner_boxes(r, m)
        if difficult:
            labels[b, :m, 5] = r.random(m) < 0.3
        n = r.integers(1, N + 1)
        dets[b, :n, 0] = r.integers(0, classes, n)
        dets[b, :n, 1] = r.random(n)
        # half the detections near a gt box, the rest anywhere
        near = labels[b, r.integers(0, m, n), 1:5] + r.normal(0, 0.03,
                                                              (n, 4))
        dets[b, :n, 2:6] = np.where(r.random((n, 1)) < 0.5, near,
                                    _corner_boxes(r, n))
    return labels, dets


@pytest.mark.parametrize("kw,difficult", [
    (dict(), False), (dict(), True), (dict(use_voc07=True), True),
    (dict(class_names=["a", "b", "c"], iou_thresh=0.3), True)],
    ids=["plain", "difficult", "voc07", "class_names"])
def test_voc_map_equal(kw, difficult):
    want_m = jmetric.VOCMApMetric(**kw)
    got_m = metric.VOCMApMetric(**kw)
    for seed in (0, 1):
        labels, dets = _voc_batch(seed, difficult=difficult)
        want_m.update(labels, dets)
        # the port takes tensors too
        got_m.update(torch.from_numpy(labels),
                     [torch.from_numpy(d) for d in dets])
    np.testing.assert_equal(got_m.get(), want_m.get())
    np.testing.assert_equal(got_m.get_name_value(),
                            want_m.get_name_value())
    assert got_m.num_inst == want_m.num_inst == 6
    got_m.reset()
    assert got_m.num_inst == 0 and not got_m._records
    with pytest.raises(MXNetError, match="label images"):
        got_m.update(np.zeros((2, 1, 5)), np.zeros((3, 1, 6)))
