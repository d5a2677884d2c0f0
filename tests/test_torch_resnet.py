"""The port's ResNet training slice against the JAX package.

The ops (2-D convolution, pooling, BatchNorm, relu) are held to
mxnet_tpu.ops.nn on the same numpy inputs; the ResNet zoo to
mxnet_tpu.models.vision by parameter names and by forward outputs with
the JAX net's weights carried over (models/convert.load_jax_params);
SGD's functional update to the reference's; Xavier to the reference's
formula; and three TrainStep steps of resnet50_v1b, running statistics
included, to mxnet_tpu.parallel.TrainStep. Each test states its
tolerance. JAX nets are built once per module, after a collection.

The step runs at lr 0.01 with B = 4: at lr 0.1 and B = 2 the reference
itself diverges (batch statistics over two samples at 1x1 spatial size
in the last stage), and values near 1e7 make a relative tolerance
meaningless.

Anything computed in train() mode through the whole net (its logits,
the running statistics after a training forward, the steps' losses and
weights) is held to the reference's own float32 spread: the distance
between the reference on x and on x * (1 + 2**-23), one unit in the
last place of every input. In train() mode a ResNet's float32 result
is determined only that far: a ReLU input that rounding moves across
zero routes a gradient term elsewhere, and 53 layers of batch
statistics, over 2-32 values a channel in the last stage at these
sizes, amplify each rounding. The port sits about as far from the
reference as the reference sits from itself; the gate is SPREAD_FACTOR
times that spread, never below FLOOR of the largest value, and the
median ratio over a step's tensors at most 2. Eval-mode forwards and
the ops are held to fixed tolerances.
"""
import gc

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import mxnet_tpu as mx  # noqa: E402
from mxnet_tpu import initializer as jinit  # noqa: E402
from mxnet_tpu import optimizer as jopt  # noqa: E402
from mxnet_tpu import parallel as jpar  # noqa: E402
from mxnet_tpu.gluon import loss as jloss  # noqa: E402
from mxnet_tpu.gluon import nn as jgnn  # noqa: E402
from mxnet_tpu.models import vision as jvision  # noqa: E402
from mxnet_tpu.ops import nn as jax_nn  # noqa: E402
from mxnet_tpu_torch import MXNetError  # noqa: E402
from mxnet_tpu_torch.initializer import Xavier, _fan_in_out, initialize  # noqa: E402
from mxnet_tpu_torch.loss import SoftmaxCrossEntropyLoss  # noqa: E402
from mxnet_tpu_torch.models import init_params, load_jax_params  # noqa: E402
from mxnet_tpu_torch.models import vision  # noqa: E402
from mxnet_tpu_torch.nn import (AvgPool2D, BatchNorm, Conv2D,  # noqa: E402
                                GlobalAvgPool2D, HybridSequential, MaxPool2D)
from mxnet_tpu_torch.ops import nn as port_nn  # noqa: E402
from mxnet_tpu_torch.optimizer import SGD, create  # noqa: E402
from mxnet_tpu_torch.parallel import TrainStep  # noqa: E402


# train()-mode results: the port's distance from the reference over the
# reference's distance from itself under a one-ulp change of the input
SPREAD_FACTOR = 8
FLOOR = 1e-6
ONE_ULP = np.float32(1 + 2 ** -23)


def _within_spread(got, want, want_ulp, label):
    """got (the port) against want (the reference), gated by the
    reference's own spread want_ulp - want: each relative to want's
    largest magnitude. Returns the ratio."""
    d, spread = _rel_to_max(got, want), _rel_to_max(want_ulp, want)
    assert d <= SPREAD_FACTOR * max(spread, FLOOR), (label, d, spread)
    return d / max(spread, FLOOR)


def _jax_net(ctor, x_shape, seed, **kw):
    """A JAX zoo net with Xavier weights, shapes resolved by one forward,
    and its parameters as numpy."""
    gc.collect()
    net = ctor(**kw)
    mx.rng.seed(seed)
    net.initialize(mx.init.Xavier())
    net(mx.nd.array(np.zeros(x_shape, np.float32)))
    return net, _arrays(net)


def _arrays(jnet):
    return {n: np.array(p.data().asnumpy())
            for n, p in jnet.collect_params().items()}


def _restore(jnet, arrays):
    for n, p in jnet.collect_params().items():
        p.set_data(mx.nd.array(arrays[n]))


def _port(ctor, arrays, **kw):
    return load_jax_params(ctor(device="cpu", **kw), arrays)


def _images(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _rel_to_max(got, want):
    """max |got - want| over the largest |want|."""
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.fixture(scope="module")
def r50():
    return _jax_net(jvision.resnet50_v1b, (1, 3, 32, 32), 5, classes=10)


# ---------------------------------------------------------------------------
# ops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("stride,pad,dilate,groups,bias", [
    (1, 0, 1, 1, False), (2, 3, 1, 1, True), (2, 1, 1, 4, False),
    (1, 2, 2, 2, True)], ids=["1x1", "stride2_pad3_bias", "groups4",
                              "dilate2_groups2"])
def test_convolution_matches_jax(stride, pad, dilate, groups, bias):
    """Tolerance 1e-5 of the largest output (float32 sums of 72-288
    products in another order)."""
    r = np.random.default_rng(1)
    k = 1 if (stride, pad) == (1, 0) else 3
    x = r.standard_normal((2, 8, 11, 9)).astype(np.float32)
    w = r.standard_normal((16, 8 // groups, k, k)).astype(np.float32)
    b = r.standard_normal(16).astype(np.float32) if bias else None
    want = np.asarray(jax_nn.Convolution(
        jnp.asarray(x), jnp.asarray(w), None if b is None else jnp.asarray(b),
        kernel=(k, k), stride=(stride, stride), dilate=(dilate, dilate),
        pad=(pad, pad), num_filter=16, num_group=groups, no_bias=not bias))
    got = port_nn.convolution(
        torch.from_numpy(x), torch.from_numpy(w),
        None if b is None else torch.from_numpy(b), (stride, stride),
        (pad, pad), (dilate, dilate), groups).numpy()
    assert got.shape == want.shape
    assert _rel_to_max(got, want) <= 1e-5
    with pytest.raises(MXNetError, match="not ported"):
        port_nn.convolution(torch.zeros(1, 2, 5), torch.zeros(3, 2, 3))


@pytest.mark.parametrize("kw", [
    dict(kernel=(3, 3), pool_type="max", stride=(2, 2), pad=(1, 1)),
    dict(kernel=(3, 3), pool_type="avg", stride=(2, 2), pad=(1, 1)),
    dict(kernel=(3, 3), pool_type="avg", stride=(2, 2), pad=(1, 1),
         count_include_pad=False),
    dict(kernel=(2, 2), pool_type="max", stride=(2, 2),
         pooling_convention="full"),
    dict(kernel=(3, 3), pool_type="avg", stride=(2, 2), pad=(1, 1),
         pooling_convention="full", count_include_pad=False),
    dict(kernel=(2, 3), pool_type="avg", stride=(1, 2), pad=(1, 0),
         count_include_pad=False),
    dict(kernel=(3, 3), pool_type="max", pad=(2, 2)),
    dict(global_pool=True, pool_type="avg"),
    dict(global_pool=True, pool_type="max")],
    ids=["max_pad1", "avg_pad1", "avg_pad1_exclude", "max_full",
         "avg_full_exclude", "avg_2x3_exclude", "max_pad_past_half",
         "global_avg", "global_max"])
def test_pooling_matches_jax(kw):
    """Tolerance 1e-6 of the largest output."""
    x = _images(2, (2, 3, 11, 10))
    want = np.asarray(jax_nn.Pooling(jnp.asarray(x), **kw))
    got = port_nn.pooling(torch.from_numpy(x), **kw).numpy()
    assert got.shape == want.shape
    assert _rel_to_max(got, want) <= 1e-6


def test_global_pool_bfloat16_accumulates_in_float32():
    """jnp.mean of bfloat16 sums in float32 and rounds once: bit-equal."""
    x = _images(3, (2, 4, 7, 7)) * 4 + 100
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    want = np.asarray(jax_nn.Pooling(jx, global_pool=True, pool_type="avg")
                      .astype(jnp.float32))
    got = port_nn.pooling(torch.from_numpy(x).bfloat16(), global_pool=True,
                          pool_type="avg")
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_relu_matches_jax():
    x = _images(4, (3, 5))
    x[0, :2] = 0.0
    np.testing.assert_array_equal(
        port_nn.activation(torch.from_numpy(x), "relu").numpy(),
        np.asarray(jax_nn.Activation(jnp.asarray(x), act_type="relu")))
    with pytest.raises(MXNetError, match="unknown act_type"):
        port_nn.activation(torch.from_numpy(x), "nope")


def _bf16_ulp(v):
    """One bfloat16 unit in the last place of each |v| (8 significant
    bits)."""
    a = np.maximum(np.abs(v), np.float32(2.0 ** -126))
    return np.exp2(np.floor(np.log2(a)) - 7)


def _bn_inputs(dtype, offset=0.0, spread=1.0):
    r = np.random.default_rng(6)
    x = (r.standard_normal((4, 6, 5, 5)) * spread + offset).astype(np.float32)
    gamma = r.standard_normal(6).astype(np.float32)
    beta = r.standard_normal(6).astype(np.float32)
    mm = r.standard_normal(6).astype(np.float32)
    mv = r.random(6).astype(np.float32) + 0.5
    jarr = [jnp.asarray(a).astype(dtype) for a in (x, gamma, beta, mm, mv)]
    tdt = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    tarr = [torch.from_numpy(a).to(tdt) for a in (x, gamma, beta, mm, mv)]
    return jarr, tarr


@pytest.mark.parametrize("training", [True, False], ids=["train", "infer"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fix_gamma", [False, True], ids=["gamma", "fixed"])
def test_batch_norm_matches_jax(training, dtype, fix_gamma):
    """float32: y, mean and var within 1e-6 of the largest; bfloat16
    (one-pass variance, the folded a/b cast, y = x * a + b in bfloat16):
    y within one bfloat16 ulp of the reference's, mean and var (rounded
    to bfloat16) likewise."""
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jarr, tarr = _bn_inputs(jdt)
    kw = dict(eps=1e-5, momentum=0.9, fix_gamma=fix_gamma)
    with mx.autograd.train_mode() if training else mx.autograd.predict_mode():
        want = jax_nn.BatchNorm(*jarr, **kw)
    got = port_nn.batch_norm(*tarr, training=training, **kw)
    want = want if training else (want,)
    got = got if training else (got,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w.astype(jnp.float32))
        g = g.float().numpy()
        assert g.shape == w.shape
        if dtype == "float32":
            assert _rel_to_max(g, w) <= 1e-6
        else:
            assert (np.abs(g - w) <= _bf16_ulp(w)).all()


def test_batch_norm_float32_is_two_pass():
    """|mean| / std = 1e4: E[x^2] - E[x]^2 in float32 loses every bit of
    the variance here, the two-pass form keeps it: both packages'
    variance within 1e-3 of the float64 one, the means within 1e-6 of
    each other, y within four float32 units of the largest |x * a|."""
    jarr, tarr = _bn_inputs(jnp.float32, offset=100.0, spread=0.01)
    with mx.autograd.train_mode():
        jy, jmean, jvar = jax_nn.BatchNorm(*jarr, fix_gamma=False)
    y, mean, var = port_nn.batch_norm(*tarr, fix_gamma=False, training=True)
    x64 = tarr[0].double().numpy()
    var64 = x64.var(axis=(0, 2, 3))
    np.testing.assert_allclose(var.numpy(), var64, rtol=1e-3)
    np.testing.assert_allclose(np.asarray(jvar), var64, rtol=1e-3)
    x32 = tarr[0]
    one_pass = ((x32 * x32).mean(dim=(0, 2, 3)) - mean * mean).numpy()
    assert np.abs(one_pass - var64).max() > var64.max()
    # y = x * a + b cancels |x * a| ~ 1e4 down to ~1: both packages hold
    # y to a few float32 units of |x * a|
    xa = np.abs(x64).max() * np.abs(tarr[1].numpy()).max() \
        / np.sqrt(var64.min() + 1e-5)
    assert np.abs(y.numpy() - np.asarray(jy)).max() <= 4 * np.spacing(
        np.float32(xa))
    assert _rel_to_max(mean.numpy(), np.asarray(jmean)) <= 1e-6


def test_batch_norm_gradients_match_jax():
    """Training-mode BatchNorm's gradients through the batch statistics
    (dx, dgamma, dbeta for a random dy) against jax.vjp of the
    reference op: within 1e-5 of each gradient's largest element."""
    jarr, tarr = _bn_inputs(jnp.float32)
    dy = _images(13, (4, 6, 5, 5))

    def ref(x, g, b):
        with mx.autograd.train_mode():
            y = jax_nn.BatchNorm(x, g, b, jarr[3], jarr[4],
                                 fix_gamma=False)[0]
        return getattr(y, "_data", y)
    _, vjp = jax.vjp(ref, *jarr[:3])
    want = vjp(jnp.asarray(dy))
    x, g, b = (t.clone().requires_grad_() for t in tarr[:3])
    y, _, _ = port_nn.batch_norm(x, g, b, tarr[3], tarr[4], fix_gamma=False,
                                 training=True)
    y.backward(torch.from_numpy(dy))
    for name, got, w in zip("x gamma beta".split(), (x.grad, g.grad, b.grad),
                            want):
        assert _rel_to_max(got.numpy(), np.asarray(w)) <= 1e-5, name


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batch_norm_layer_running_update_matches_jax(dtype):
    """The layer's running statistics after one training forward (new =
    old * 0.9 + batch * 0.1, the scalars rounded to the statistics'
    dtype as the reference's weak typing does): float32 within 1e-6 of
    the largest, bfloat16 bit-equal. y within 1e-6 / one bfloat16 ulp."""
    jdt = "bfloat16" if dtype == "bfloat16" else "float32"
    jarr, tarr = _bn_inputs(jnp.bfloat16 if dtype == "bfloat16"
                            else jnp.float32)
    ref = jgnn.BatchNorm(in_channels=6)
    ref.initialize()
    ref.cast(jdt)
    layer = BatchNorm(in_channels=6, device="cpu", dtype=tarr[0].dtype)
    for jname, a, t in zip(("gamma", "beta", "running_mean", "running_var"),
                           jarr[1:], tarr[1:]):
        getattr(ref, jname).set_data(mx.nd.array(np.asarray(a.astype(
            jnp.float32)), dtype=jdt))
        with torch.no_grad():
            getattr(layer, jname).copy_(t)
    with mx.autograd.train_mode():
        want = np.asarray(ref(mx.nd.array(np.asarray(jarr[0].astype(
            jnp.float32)), dtype=jdt))._data.astype(jnp.float32))
    layer.train()
    got = layer(tarr[0]).float().detach().numpy()
    exact = dtype == "bfloat16"
    if exact:
        assert (np.abs(got - want) <= _bf16_ulp(want)).all()
    else:
        assert _rel_to_max(got, want) <= 1e-6
    for name in ("running_mean", "running_var"):
        w = np.asarray(getattr(ref, name).data()._data.astype(jnp.float32))
        g = getattr(layer, name).float().detach().numpy()
        if exact:
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            assert _rel_to_max(g, w) <= 1e-6, name
    assert not layer.running_mean.requires_grad
    layer.eval()                          # eval: the running statistics
    before = layer.running_mean.detach().clone()
    layer(tarr[0])
    assert torch.equal(layer.running_mean, before)


# ---------------------------------------------------------------------------
# layers, zoo and weights
# ---------------------------------------------------------------------------

def test_layers_validate_and_name_children():
    with pytest.raises(TypeError):
        Conv2D(8, 3)                            # in_channels is required
    with pytest.raises(MXNetError, match="divisible"):
        Conv2D(8, 3, groups=2, in_channels=3, device="cpu")
    with pytest.raises(MXNetError, match="channel-first"):
        MaxPool2D(layout="NHWC")
    for pool_type in ("sum", "lp"):
        with pytest.raises(MXNetError, match="not ported"):
            port_nn.pooling(torch.ones(1, 1, 4, 4), (2, 2), pool_type)
    with pytest.raises(MXNetError, match="unknown pool_type"):
        port_nn.pooling(torch.ones(1, 1, 4, 4), (2, 2), "median")
    seq = HybridSequential(Conv2D(4, 3, padding=1, in_channels=2,
                                  device="cpu"))
    seq.add(BatchNorm(in_channels=4, device="cpu"), AvgPool2D(),
            GlobalAvgPool2D())
    assert [n for n, _ in seq.named_parameters()] == [
        "0.weight", "0.bias", "1.gamma", "1.beta", "1.running_mean",
        "1.running_var"]
    initialize(seq, Xavier(), seed=1)
    seq.eval()
    assert seq(torch.ones(2, 2, 8, 8)).shape == (2, 4, 1, 1)


def test_parameter_names_match_jax(r50):
    """267 names, 23,581,642 values, the same shapes; the running
    statistics (and only they) do not require grad."""
    _, arrays = r50
    net = vision.resnet50_v1b(classes=10, device="cpu")
    shapes = {n: tuple(p.shape) for n, p in net.named_parameters()}
    assert shapes == {n: a.shape for n, a in arrays.items()}
    assert len(shapes) == 267
    assert sum(int(np.prod(s)) for s in shapes.values()) == 23_581_642
    frozen = sorted(n for n, p in net.named_parameters()
                    if not p.requires_grad)
    assert len(frozen) == 106
    assert all(n.endswith(("running_mean", "running_var")) for n in frozen)
    assert "features.4.0.body.7.gamma" in shapes
    assert "features.4.0.downsample.1.running_var" in shapes
    assert not net.training                     # starts in eval() mode


def test_get_model_and_get_resnet():
    net = vision.get_model("ResNet18_V1", classes=3, thumbnail=True,
                           device="cpu")
    assert isinstance(net, vision.ResNetV1) and net.output.weight.shape == \
        (3, 512)
    for name in ("alexnet", "vgg16", "densenet121"):
        with pytest.raises(MXNetError, match="not ported"):
            vision.get_model(name)
    with pytest.raises(MXNetError, match="invalid resnet depth"):
        vision.get_resnet(1, 77)
    with pytest.raises(MXNetError, match="pretrained"):
        vision.resnet50_v1(pretrained=True, device="cpu")
    # v1 strides the first 1x1 of a bottleneck, v1b its 3x3
    v1 = vision.resnet50_v1(classes=2, device="cpu")
    v1b = vision.resnet50_v1b(classes=2, device="cpu")
    assert v1.features[5][0].body[0]._strides == (2, 2)
    assert v1.features[5][0].body[3]._strides == (1, 1)
    assert v1b.features[5][0].body[0]._strides == (1, 1)
    assert v1b.features[5][0].body[3]._strides == (2, 2)


def _jax_train_forward(jnet, arrays, x):
    """The reference's train()-mode logits on x and the running
    statistics it leaves; the net's parameters are restored after."""
    try:
        with mx.autograd.train_mode():
            logits = jnet(mx.nd.array(x)).asnumpy()
        stats = {n: a for n, a in _arrays(jnet).items()
                 if n.endswith(("running_mean", "running_var"))}
    finally:
        _restore(jnet, arrays)
    return logits, stats


def _train_forward_matches(jnet, arrays, net, x):
    """The port's train()-mode logits and running statistics against the
    reference's, gated by its spread (x against x one ulp up)."""
    want, stats = _jax_train_forward(jnet, arrays, x)
    want_ulp, stats_ulp = _jax_train_forward(jnet, arrays, x * ONE_ULP)
    net.train()
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
    _within_spread(got, want, want_ulp, "logits")
    p = dict(net.named_parameters())
    for n, w in stats.items():
        assert not np.array_equal(w, arrays[n]), n
        _within_spread(p[n].detach().numpy(), w, stats_ulp[n], n)


def test_forward_matches_jax_and_carries_running_stats(r50):
    """resnet50_v1b at B = 2, 32x32: eval-mode logits within 1e-5
    (relative and absolute); load_jax_params carried the running
    statistics in; train-mode logits and the running statistics after
    one training forward within the reference's spread."""
    jnet, arrays = r50
    net = _port(vision.resnet50_v1b, arrays, classes=10)
    p = dict(net.named_parameters())
    np.testing.assert_array_equal(
        p["features.4.0.downsample.1.running_var"].detach().numpy(),
        arrays["features.4.0.downsample.1.running_var"])
    x = _images(7, (2, 3, 32, 32))
    want = jnet(mx.nd.array(x)).asnumpy()
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    _train_forward_matches(jnet, arrays, net, x)


@pytest.mark.parametrize("ctor,kw", [
    ("resnet18_v1", dict(thumbnail=True)), ("resnet18_v2", {})],
    ids=["resnet18_v1_thumbnail", "resnet18_v2"])
def test_small_resnets_match_jax(ctor, kw):
    """Eval-mode logits at B = 2, 32x32 within 1e-5; train-mode logits
    and running statistics within the reference's spread. v2's first
    BatchNorm (scale and center off) has no trainable parameter."""
    jnet, arrays = _jax_net(getattr(jvision, ctor), (1, 3, 32, 32), 8,
                            classes=10, **kw)
    net = _port(getattr(vision, ctor), arrays, classes=10, **kw)
    x = _images(9, (2, 3, 32, 32))
    want = jnet(mx.nd.array(x)).asnumpy()
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    _train_forward_matches(jnet, arrays, net, x)
    if ctor.endswith("v2"):
        bn0 = net.features[0]
        assert not bn0.gamma.requires_grad and not bn0.beta.requires_grad


def test_xavier_follows_the_reference_formula():
    """Bounds and variance of U(-s, s) with s = sqrt(3 / ((fan_in +
    fan_out) / 2)), the reference's _fan_in_out; N(0, s) for gaussian;
    variance within 5% (about six standard errors); the same seed gives
    the same weights."""
    for shape in ((64, 3, 7, 7), (10, 2048), (256, 64, 1, 1)):
        assert _fan_in_out(shape) == jinit._fan_in_out(shape)
        fi, fo = jinit._fan_in_out(shape)
        s = np.sqrt(3.0 / ((fi + fo) / 2.0))
        assert Xavier().scale(shape) == pytest.approx(s, rel=1e-12)
        w = torch.empty(shape)
        Xavier()("w", w, torch.Generator().manual_seed(0))
        w = w.numpy()
        assert np.abs(w).max() <= s
        assert np.abs(w).max() > 0.99 * s
        assert w.var() == pytest.approx(s * s / 3, rel=0.05)
        Xavier("gaussian", "in", 2)("w", torch.from_numpy(w),
                                    torch.Generator().manual_seed(0))
        assert w.std() == pytest.approx(np.sqrt(2.0 / fi), rel=0.05)
    a = vision.resnet18_v1(classes=4, thumbnail=True, device="cpu")
    b = vision.resnet18_v1(classes=4, thumbnail=True, device="cpu")
    pa, pb = dict(a.named_parameters()), dict(b.named_parameters())
    assert all(torch.equal(pa[n], pb[n]) for n in pa)
    initialize(b, Xavier(), seed=1)
    assert not torch.equal(pa["features.0.weight"], pb["features.0.weight"])
    bn = "features.1.0.body.1."
    assert bool((pb[bn + "gamma"] == 1).all()) and bool(
        (pb[bn + "running_var"] == 1).all())
    assert bool((pb[bn + "beta"] == 0).all()) and bool(
        (pb[bn + "running_mean"] == 0).all())
    assert bool((pb["output.bias"] == 0).all())
    with pytest.raises(MXNetError, match="rnd_type"):
        Xavier(rnd_type="cauchy")


def test_init_params_gives_running_stats_their_defaults():
    net = init_params(vision.resnet18_v1(classes=4, thumbnail=True,
                                         device="cpu"), seed=3, std=0.5)
    p = dict(net.named_parameters())
    assert bool((p["features.1.0.body.1.running_mean"] == 0).all())
    assert bool((p["features.1.0.body.1.running_var"] == 1).all())
    assert abs(float(p["features.0.weight"].detach().std()) - 0.5) < 0.1


# ---------------------------------------------------------------------------
# SGD
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("momentum", [0.0, 0.9], ids=["plain", "momentum"])
def test_sgd_apply_arrays_matches_jax(momentum):
    """Three updates, float32 and the bfloat16-weight / float32-master
    layout, within 1e-6; the bfloat16 weight is the master rounded, equal
    to the reference's."""
    r = np.random.default_rng(10)
    w = r.standard_normal((5, 7)).astype(np.float32)
    kw = dict(learning_rate=0.1, momentum=momentum, wd=1e-4,
              rescale_grad=0.5, clip_gradient=1.0)
    ref, port = jopt.SGD(**kw), SGD(**kw)
    jw, pw = jnp.asarray(w), torch.from_numpy(w.copy())
    js, ps = ref.init_state_arrays(jw), port.init_state_arrays(pw)
    assert len(ps) == len(js) == (1 if momentum else 0)
    jbw = jnp.asarray(w).astype(jnp.bfloat16)
    pbw = torch.from_numpy(w.copy()).bfloat16()
    jbs, pbs = ref.init_state_arrays_mp(jbw), port.init_state_arrays_mp(pbw)
    assert len(pbs) == len(jbs) and pbs[0].dtype == torch.float32
    for t in (1, 2, 3):
        g = r.standard_normal((5, 7)).astype(np.float32) * 2
        jw, js = ref.apply_arrays(jw, jnp.asarray(g), js, 0.1, 1e-4,
                                  jnp.asarray(t, jnp.int32))
        pw, ps = port.apply_arrays(pw, torch.from_numpy(g), ps, 0.1, 1e-4, t)
        np.testing.assert_allclose(pw.numpy(), np.asarray(jw), rtol=1e-6,
                                   atol=1e-6)
        for a, b in zip(ps, js):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-6)
        jbw, jbs = ref.apply_arrays_mp(jbw, jnp.asarray(g, jnp.bfloat16),
                                       jbs, 0.1, 1e-4,
                                       jnp.asarray(t, jnp.int32))
        pbw, pbs = port.apply_arrays_mp(
            pbw, torch.from_numpy(g).bfloat16(), pbs, 0.1, 1e-4, t)
        assert pbw.dtype == torch.bfloat16
        np.testing.assert_array_equal(pbw.float().numpy(),
                                      np.asarray(jbw.astype(jnp.float32)))
        for a, b in zip(pbs, jbs):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-6)


def test_create_sgd():
    opt = create("SGD", learning_rate=0.1, momentum=0.9, wd=1e-4)
    assert isinstance(opt, SGD) and opt.fused_supported
    assert (opt.learning_rate, opt.momentum, opt.wd) == (0.1, 0.9, 1e-4)


# ---------------------------------------------------------------------------
# the slice: TrainStep on resnet50_v1b
# ---------------------------------------------------------------------------

def _jax_steps(jnet, arrays, xs, ys):
    """Three reference TrainStep steps from `arrays`: the losses and every
    parameter after them; the net's parameters are restored after."""
    try:
        jstep = jpar.TrainStep(jnet, jloss.SoftmaxCrossEntropyLoss(),
                               jopt.SGD(learning_rate=0.01, momentum=0.9,
                                        wd=1e-4),
                               mesh=None, n_net_inputs=1)
        losses = [float(jstep(mx.nd.array(x), mx.nd.array(y, dtype="int32"))
                        .asnumpy()) for x, y in zip(xs, ys)]
        jstep.sync_params()
        return np.array(losses), _arrays(jnet)
    finally:
        _restore(jnet, arrays)


def test_train_step_matches_jax(r50):
    """Three steps of resnet50_v1b(classes=10), B = 4, 32x32,
    SGD(0.01, momentum 0.9, wd 1e-4), int32 labels, against
    mxnet_tpu.parallel.TrainStep from the same weights: each loss, and
    every parameter and running statistic after the steps, within the
    reference's spread (its own steps on the images one ulp up), and the
    median of those ratios over the tensors at most 2."""
    jnet, arrays = r50
    net = _port(vision.resnet50_v1b, arrays, classes=10)
    r = np.random.default_rng(11)
    xs = r.standard_normal((3, 4, 3, 32, 32)).astype(np.float32)
    ys = r.integers(0, 10, (3, 4)).astype(np.int32)
    want, jfinal = _jax_steps(jnet, arrays, xs, ys)
    want_ulp, jfinal_ulp = _jax_steps(jnet, arrays, xs * ONE_ULP, ys)
    step = TrainStep(net, SoftmaxCrossEntropyLoss(),
                     SGD(learning_rate=0.01, momentum=0.9, wd=1e-4),
                     n_net_inputs=1)
    assert len(step._params) == 161
    got = step.run_steps(torch.from_numpy(xs), torch.from_numpy(ys))
    assert got.shape == (3,) and got.dtype == torch.float32
    assert not net.training and step.step_count == 3
    for i in range(3):
        _within_spread(got.numpy()[i:i + 1], want[i:i + 1],
                       want_ulp[i:i + 1], f"loss {i}")
    port = dict(net.named_parameters())
    ratios = []
    for name, w in jfinal.items():
        assert not np.array_equal(w, arrays[name]), name
        ratios.append(_within_spread(port[name].detach().numpy(), w,
                                     jfinal_ulp[name], name))
    assert len(ratios) == 267 and np.median(ratios) <= 2.0


def test_train_step_bfloat16_updates_stats_in_bfloat16(r50):
    """net.cast("bfloat16")'s counterpart: every parameter and running
    statistic in bfloat16, the step keeps float32 masters for the
    trainable ones; two steps leave finite losses and statistics."""
    _, arrays = r50
    net = _port(vision.resnet50_v1b, arrays, classes=10).to(torch.bfloat16)
    assert all(p.dtype == torch.bfloat16 for p in net.parameters())
    step = TrainStep(net, SoftmaxCrossEntropyLoss(),
                     SGD(learning_rate=0.01, momentum=0.9, wd=1e-4))
    assert all(s[0].dtype == torch.float32 and len(s) == 2
               for s in step._states)
    x = torch.from_numpy(_images(12, (4, 3, 32, 32))).bfloat16()
    y = torch.tensor([1, 2, 3, 4], dtype=torch.int32)
    rm = net.features[1].running_mean
    before = rm.detach().clone()
    losses = step.run_steps(x, y, steps=2)
    assert bool(torch.isfinite(losses).all())
    assert rm.dtype == torch.bfloat16 and not torch.equal(rm, before)
    assert all(bool(torch.isfinite(p).all()) for p in net.parameters())
