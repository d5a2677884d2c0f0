"""The port's SSD-512 detector against the JAX package.

One JAX `ssd_512_resnet50_v1_voc` (Xavier, seed 0) is built per module
and its 315 arrays are carried into the port's net by name
(models/convert.load_jax_params). Held on the CPU: the parameter names;
a 128x128 eval forward (356 anchors: byte-equal; class and box
predictions within 1e-5 of their largest magnitude, float32 sums in
another order); SSDMultiBoxLoss within 1e-5 and its gradients on the
predictions within 1e-5 of their largest, ties among the background
losses included; `detect` (the same rows kept, class ids equal, scores
and boxes within 1e-5); and three TrainStep + SGD(5e-4, momentum 0.9)
steps at 64x64 (98 anchors), B = 8, held to the reference's own float32
spread (see TrainStep's gates below). The JAX net is released at the
module's end.
"""
import gc

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import mxnet_tpu as mx  # noqa: E402
from mxnet_tpu import optimizer as jopt  # noqa: E402
from mxnet_tpu import parallel as jpar  # noqa: E402
from mxnet_tpu.models.vision import ssd as jssd  # noqa: E402
from mxnet_tpu.ops import detection as jdet  # noqa: E402
from mxnet_tpu_torch import MXNetError  # noqa: E402
from mxnet_tpu_torch.models import load_jax_params, vision  # noqa: E402
from mxnet_tpu_torch.models.vision.ssd import SSDMultiBoxLoss  # noqa: E402
from mxnet_tpu_torch.ops import detection as det  # noqa: E402
from mxnet_tpu_torch.optimizer import SGD  # noqa: E402
from mxnet_tpu_torch.parallel import TrainStep  # noqa: E402


def _arrays(jnet):
    return {n: np.array(p.data().asnumpy())
            for n, p in jnet.collect_params().items()}


def _restore(jnet, arrays):
    for n, p in jnet.collect_params().items():
        p.set_data(mx.nd.array(arrays[n]))


def _rel_to_max(got, want):
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _images(seed, B, S):
    return np.random.default_rng(seed).standard_normal(
        (B, 3, S, S)).astype(np.float32)


def _labels():
    """examples/train_ssd.py's labels: two images, up to two boxes."""
    labels = np.full((2, 2, 5), -1.0, np.float32)
    labels[0, 0] = [5, 0.2, 0.3, 0.6, 0.8]
    labels[1, 0] = [2, 0.5, 0.5, 0.9, 0.85]
    labels[1, 1] = [7, 0.05, 0.05, 0.3, 0.3]
    return labels


@pytest.fixture(scope="module")
def ssd():
    """The JAX net (shapes resolved by one forward at the forward test's
    shape, so that its eager ops are compiled once) and its arrays;
    deleted and collected at the module's end."""
    gc.collect()
    jnet = jssd.ssd_512_resnet50_v1_voc()
    mx.rng.seed(0)
    jnet.initialize(mx.init.Xavier())
    jnet(mx.nd.array(np.zeros((2, 3, 128, 128), np.float32)))
    held = {"net": jnet, "arrays": _arrays(jnet)}
    yield held
    held.clear()
    del jnet
    gc.collect()


def _port(arrays):
    return load_jax_params(vision.ssd_512_resnet50_v1_voc(device="cpu"),
                           arrays)


def test_parameter_names_and_defaults(ssd):
    net = vision.ssd_512_resnet50_v1_voc(device="cpu")
    got = {n: tuple(p.shape) for n, p in net.named_parameters()}
    want = {n: a.shape for n, a in ssd["arrays"].items()}
    assert got == want and len(got) == 315
    assert sum(int(np.prod(s)) for s in got.values()) == sum(
        a.size for a in ssd["arrays"].values())
    assert not net.training and net.num_classes == 20
    assert all(p.dtype == torch.float32 and p.device.type == "cpu"
               for p in net.parameters())
    # seeded Xavier: the same weights from the same seed
    again = vision.ssd_512_resnet50_v1_voc(device="cpu")
    for (n, p), q in zip(net.named_parameters(), again.parameters()):
        assert torch.equal(p, q), n
    assert float(dict(net.named_parameters())[
        "extras.0.body.1.running_var"].min()) == 1.0


def test_get_model_builds_both_names():
    for name, classes in (("ssd_512_resnet50_v1", 20),
                          ("ssd_512_resnet50_v1_voc", 20)):
        net = vision.get_model(name, device="cpu")
        assert isinstance(net, vision.SSD) and net.num_classes == classes
    net = vision.get_model("ssd_512_resnet50_v1", classes=3, num_extras=2,
                           device="cpu")
    assert net.cls_heads[0].weight.shape[0] == 4 * 4
    assert len(net.extras) == 2
    with pytest.raises(MXNetError, match="pretrained"):
        vision.get_model("ssd_512_resnet50_v1_voc", pretrained=True)
    with pytest.raises(MXNetError, match="sizes/ratios"):
        vision.SSD(classes=2, sizes=[(0.1, 0.2)], device="cpu")
    with pytest.raises(MXNetError, match="not ported"):
        vision.get_model("mobilenet1_0")
    with pytest.raises(MXNetError, match="not ported"):
        det.roi_align(torch.zeros(1, 1, 4, 4), torch.zeros(1, 5))


def test_forward_matches_jax(ssd):
    """Eval mode at 128x128, B = 2: 356 anchors byte-equal; predictions
    within 1e-5 of their largest magnitude."""
    jnet, arrays = ssd["net"], ssd["arrays"]
    x = _images(0, 2, 128)
    jc, jb, ja = (np.asarray(v.asnumpy()) for v in jnet(mx.nd.array(x)))
    net = _port(arrays)
    with torch.no_grad():
        c, b, a = net(torch.from_numpy(x))
    assert c.shape == (2, 356, 21) and b.shape == (2, 356 * 4)
    assert a.shape == (1, 356, 4) and a.dtype == torch.float32
    assert a.numpy().tobytes() == ja.tobytes()
    assert _rel_to_max(c.numpy(), jc) <= 1e-5
    assert _rel_to_max(b.numpy(), jb) <= 1e-5


def _loss_inputs(seed, ties):
    """Predictions and targets at 256 anchors, 21 classes: targets from
    multibox_target on the example's labels; with `ties`, half of the
    anchors share one class row, so their background losses tie."""
    r = np.random.default_rng(seed)
    anchors = np.asarray(jdet.multibox_prior.raw_fn(
        np.zeros((1, 1, 8, 8), np.float32), sizes=(0.1, 0.3),
        ratios=(1.0, 2.0, 0.5)))
    N = anchors.shape[1]
    cp = r.normal(0, 1, (2, N, 21)).astype(np.float32)
    if ties:
        cp[:, ::2] = cp[:, :1]
    bp = r.normal(0, 1, (2, N * 4)).astype(np.float32)
    bt, bm, ct = (np.asarray(o) for o in jdet.multibox_target.raw_fn(
        anchors, _labels(), np.transpose(cp, (0, 2, 1)),
        overlap_threshold=0.3))
    return cp, bp, ct, bt, bm


@pytest.mark.parametrize("ties", [False, True], ids=["distinct", "ties"])
def test_multibox_loss_and_gradients_match_jax(ties):
    cp, bp, ct, bt, bm = _loss_inputs(1, ties)
    assert (ct > 0).sum() >= 3
    jcp, jbp = mx.nd.array(cp), mx.nd.array(bp)
    jcp.attach_grad()
    jbp.attach_grad()
    with mx.autograd.record():
        jl = jssd.SSDMultiBoxLoss()(jcp, jbp, mx.nd.array(ct),
                                    mx.nd.array(bt), mx.nd.array(bm))
    jl.backward()
    tcp = torch.from_numpy(cp).requires_grad_()
    tbp = torch.from_numpy(bp).requires_grad_()
    tl = SSDMultiBoxLoss()(tcp, tbp, *(torch.from_numpy(a)
                                       for a in (ct, bt, bm)))
    assert tl.shape == (2,) and tl.dtype == torch.float32
    tl.sum().backward()
    np.testing.assert_allclose(tl.detach().numpy(), jl.asnumpy(), rtol=1e-5)
    assert _rel_to_max(tcp.grad.numpy(), jcp.grad.asnumpy()) <= 1e-5
    assert _rel_to_max(tbp.grad.numpy(), jbp.grad.asnumpy()) <= 1e-5
    # the mined negatives are the reference's: the gradient's zero rows
    np.testing.assert_array_equal(
        (tcp.grad.numpy() == 0).all(axis=-1),
        (jcp.grad.asnumpy() == 0).all(axis=-1))


def test_detect_matches_jax(ssd):
    """detect at 128x128, B = 2, the defaults (nms 0.45, threshold 0.01,
    topk 400): the same rows kept, class ids equal, scores and boxes
    within 1e-5."""
    jnet, arrays = ssd["net"], ssd["arrays"]
    x = _images(0, 2, 128)
    want = np.asarray(jnet.detect(mx.nd.array(x)).asnumpy())
    got = _port(arrays).detect(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 356, 6)
    kept = want[..., 0] >= 0
    np.testing.assert_array_equal(got[..., 0] >= 0, kept)
    np.testing.assert_array_equal(got[..., 0], want[..., 0])
    np.testing.assert_allclose(got[..., 1:], want[..., 1:], rtol=0, atol=1e-5)
    assert 0 < kept.sum() < kept.size


class _JLoss(jssd.SSDMultiBoxLoss):
    def forward(self, cls_p, box_p, anchors, ct, bt, bm):
        return super().forward(cls_p, box_p, ct, bt, bm)


class _Loss(SSDMultiBoxLoss):
    def forward(self, cls_p, box_p, anchors, ct, bt, bm):
        return super().forward(cls_p, box_p, ct, bt, bm)


# TrainStep's gates. A quantity computed in train() mode through the whole
# net is determined in float32 only as far as the reference's own
# spread: its largest distance from the reference's runs on the images
# one ulp up and half an ulp down (x * (1 + 2**-23), x * (1 - 2**-24)).
#   * At 64x64 the extra blocks' BatchNorms see 1x1 maps, B values a
#     channel: their batch statistics cancel, and the betas of the
#     squeeze BatchNorms and the running means after the 3x3
#     convolutions are mathematically zero (each is a batch mean of a
#     normalised input), so they hold rounding alone.
#   * At B = 2 the reference's own spread reaches 2e-5 of the first loss
#     and, after three steps at lr 5e-4, 80% of a median tensor's largest
#     value. At B = 8 the first step is determined (median spread 4e-6)
#     and the third spreads 2%. So B = 8.
#   * A ReLU input that rounding moves across zero routes one term of a
#     gradient elsewhere, and which inputs flip depends on the
#     perturbation: after the first step stage4.2.body.7.beta moved
#     4.2e-5 of its largest under the first, 1.9e-3 under the second and
#     9.5e-3 in the port. A flip moves the gradients of the layers just
#     before that ReLU: after the first step the port's
#     stage4.2.body.3.weight and stage4.2.body.4.beta stood 30 and 36
#     times the spread from the reference, every other tensor within 8.
# (Readings from the JAX package and the port on a CPU.) So: the first
# loss within 1e-5 relative; every loss within SPREAD_FACTOR times the
# spread; after the first and the third step, every parameter and
# running statistic within SPREAD_FACTOR times the spread (never below
# FLOOR of the largest value) except at most FLIPPED_TENSORS, which stay
# within FLIP_FACTOR times, and the median ratio over the tensors at
# most 2.
SPREAD_FACTOR = 8
FLOOR = 1e-6
FLIPPED_TENSORS = 2
FLIP_FACTOR = 64
ULPS = (np.float32(1 + 2 ** -23), np.float32(1 - 2 ** -24))
TRAIN_B = 8


def _jax_steps(jnet, arrays, x, batch):
    """Three reference steps from `arrays`: the losses and every
    parameter after the first and the third; the net is restored."""
    try:
        jstep = jpar.TrainStep(jnet, _JLoss(),
                               jopt.SGD(learning_rate=5e-4, momentum=0.9),
                               mesh=None, n_net_inputs=1)
        losses, states = [], []
        for t in range(3):
            losses.append(float(jstep(mx.nd.array(x), *(
                mx.nd.array(a) for a in batch)).asnumpy()))
            if t in (0, 2):
                jstep.sync_params()
                states.append(_arrays(jnet))
        return np.array(losses), states
    finally:
        _restore(jnet, arrays)


def _within_spread(got, want, want_ulps):
    """|got - want| over the reference's spread, the largest
    |want_ulp - want|, each relative to want's largest magnitude (the
    spread never below FLOOR): the ratio, gated at SPREAD_FACTOR."""
    spread = max(_rel_to_max(w, want) for w in want_ulps)
    return _rel_to_max(got, want) / max(spread, FLOOR)


def test_train_steps_match_jax(ssd):
    """Three steps of TrainStep + SGD(5e-4, momentum 0.9) at 64x64 (98
    anchors), B = 8, on the example's labels (the two images repeated),
    from the same weights as the reference."""
    jnet, arrays = ssd["net"], ssd["arrays"]
    x = _images(2, TRAIN_B, 64)
    labels = np.concatenate([_labels()] * (TRAIN_B // 2))
    net = _port(arrays)
    with torch.no_grad():       # the port's anchors: the reference's bytes
        anchors = mx.nd.array(net(torch.from_numpy(x[:1]))[2].numpy())
    batch = tuple(np.asarray(o.asnumpy()) for o in mx.nd.multibox_target(
        anchors, mx.nd.array(labels), mx.nd.zeros((TRAIN_B, 21, 98))))
    bt, bm, ct = batch
    assert anchors.shape == (1, 98, 4) and (ct > 0).sum() >= 3 * TRAIN_B / 2
    batch = (ct, bt, bm)
    want, jstates = _jax_steps(jnet, arrays, x, batch)
    ulp_runs = [_jax_steps(jnet, arrays, x * u, batch) for u in ULPS]
    step = TrainStep(net, _Loss(), SGD(learning_rate=5e-4, momentum=0.9),
                     n_net_inputs=1)
    tb = tuple(torch.from_numpy(a) for a in (x,) + batch)
    got = [step(*tb)]
    states = [{n: p.detach().numpy().copy()
               for n, p in net.named_parameters()}]
    got += list(step.run_steps(*tb, steps=2))
    states.append({n: p.detach().numpy() for n, p in net.named_parameters()})
    got = np.array([float(g) for g in got])
    assert not net.training and step.step_count == 3
    assert abs(got[0] - want[0]) <= 1e-5 * abs(want[0])
    for i in range(3):
        r = _within_spread(got[i:i + 1], want[i:i + 1],
                           [u[0][i:i + 1] for u in ulp_runs])
        assert r <= SPREAD_FACTOR, (i, got, want, ulp_runs[0][0])
    n_stats = 0
    for k, (state, jstate) in enumerate(zip(states, jstates)):
        ratios = {}
        for name, w in jstate.items():
            ratios[name] = _within_spread(state[name], w,
                                          [u[1][k][name] for u in ulp_runs])
            n_stats += name.endswith(("running_mean", "running_var"))
        over = sorted(n for n, r in ratios.items() if r > SPREAD_FACTOR)
        assert len(over) <= FLIPPED_TENSORS, (k, over)
        assert all(ratios[n] <= FLIP_FACTOR for n in over), (
            k, {n: ratios[n] for n in over})
        assert np.median(list(ratios.values())) <= 2.0
        assert len(ratios) == 315
    # 59 BatchNorms: 53 in the trunk's stem and stages 1-4, 2 an extra block
    assert n_stats == 2 * 2 * 59
    assert not np.array_equal(states[1]["cls_heads.0.weight"],
                              arrays["cls_heads.0.weight"])
