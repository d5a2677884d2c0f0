"""ResNet v1, v2 (pre-activation) and v1b (stride in the 3x3).

Counterparts of mxnet_tpu/models/vision/resnet.py `BasicBlockV1`,
`BottleneckV1` (with `stride_in_1x1`), `BasicBlockV2`, `BottleneckV2`,
`ResNetV1` (with `thumbnail`), `ResNetV2`, `get_resnet` and the
`resnet{18,34,50,101,152}_v1/_v2/_v1b` entry points; the reference's
`_Activation` block is nn.Activation here. Module indices follow the
reference's structure paths (the activation blocks take their index in
the sequentials), so a name such as
`features.4.0.body.7.gamma` or `output.weight` names the same tensor in
both packages and models/convert.load_jax_params copies by name. Input
channels are computed here, where the reference defers them to the
first forward.

A model lives on `device` (default: the CUDA card; raises without one)
in float32, starts in eval() mode (BatchNorm reads its running
statistics; the reference normalises by batch only under autograd
training) and holds seeded Xavier weights (initializer.initialize, seed
0). `model.to(torch.bfloat16)` plays the part of the reference's
`net.cast("bfloat16")`: it casts every parameter, the running statistics
included. parallel.TrainStep runs the forward in train() mode, which
updates the running statistics once a step.
"""
from __future__ import annotations


from ...base import MXNetError, resolve_device
from ...nn.layers import TensorBlock
from ...initializer import Xavier, initialize
from ...nn import (Activation, BatchNorm, Conv2D, Dense, Flatten,
                   GlobalAvgPool2D, HybridSequential, MaxPool2D)
from ...ops import nn as _ops

__all__ = ["ResNetV1", "ResNetV2",
           "BasicBlockV1", "BasicBlockV2", "BottleneckV1", "BottleneckV2",
           "resnet18_v1", "resnet34_v1", "resnet50_v1", "resnet101_v1",
           "resnet152_v1",
           "resnet18_v2", "resnet34_v2", "resnet50_v2", "resnet101_v2",
           "resnet152_v2",
           "resnet18_v1b", "resnet34_v1b", "resnet50_v1b", "resnet101_v1b",
           "resnet152_v1b",
           "get_resnet"]


def _conv3x3(channels, stride, in_channels, **kw):
    return Conv2D(channels, kernel_size=3, strides=stride, padding=1,
                  use_bias=False, in_channels=in_channels, **kw)


class BasicBlockV1(TensorBlock):
    """conv3x3-BN-relu-conv3x3-BN + shortcut."""

    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 **kw):
        super().__init__()
        self.body = HybridSequential(
            _conv3x3(channels, stride, in_channels, **kw),
            BatchNorm(in_channels=channels, **kw),
            Activation("relu"),
            _conv3x3(channels, 1, channels, **kw),
            BatchNorm(in_channels=channels, **kw))
        self.downsample = HybridSequential(
            Conv2D(channels, kernel_size=1, strides=stride, use_bias=False,
                   in_channels=in_channels, **kw),
            BatchNorm(in_channels=channels, **kw)) if downsample else None

    def forward(self, x):
        residual = x if self.downsample is None else self.downsample(x)
        return _ops.activation(self.body(x) + residual, "relu")


class BottleneckV1(TensorBlock):
    """1x1-3x3-1x1 bottleneck. stride_in_1x1=True is the classic v1
    (stride on the first 1x1); False is v1b (stride on the 3x3)."""

    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 stride_in_1x1=True, **kw):
        super().__init__()
        s1, s3 = (stride, 1) if stride_in_1x1 else (1, stride)
        mid = channels // 4
        self.body = HybridSequential(
            Conv2D(mid, kernel_size=1, strides=s1, use_bias=False,
                   in_channels=in_channels, **kw),
            BatchNorm(in_channels=mid, **kw),
            Activation("relu"),
            _conv3x3(mid, s3, mid, **kw),
            BatchNorm(in_channels=mid, **kw),
            Activation("relu"),
            Conv2D(channels, kernel_size=1, strides=1, use_bias=False,
                   in_channels=mid, **kw),
            BatchNorm(in_channels=channels, **kw))
        self.downsample = HybridSequential(
            Conv2D(channels, kernel_size=1, strides=stride, use_bias=False,
                   in_channels=in_channels, **kw),
            BatchNorm(in_channels=channels, **kw)) if downsample else None

    def forward(self, x):
        residual = x if self.downsample is None else self.downsample(x)
        return _ops.activation(self.body(x) + residual, "relu")


class BasicBlockV2(TensorBlock):
    """Pre-activation basic block."""

    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 **kw):
        super().__init__()
        self.bn1 = BatchNorm(in_channels=in_channels, **kw)
        self.conv1 = _conv3x3(channels, stride, in_channels, **kw)
        self.bn2 = BatchNorm(in_channels=channels, **kw)
        self.conv2 = _conv3x3(channels, 1, channels, **kw)
        self.downsample = Conv2D(channels, 1, strides=stride, use_bias=False,
                                 in_channels=in_channels, **kw) \
            if downsample else None

    def forward(self, x):
        residual = x
        x = _ops.activation(self.bn1(x), "relu")
        if self.downsample is not None:
            residual = self.downsample(x)
        x = self.conv1(x)
        x = _ops.activation(self.bn2(x), "relu")
        return self.conv2(x) + residual


class BottleneckV2(TensorBlock):
    """Pre-activation bottleneck."""

    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 **kw):
        super().__init__()
        mid = channels // 4
        self.bn1 = BatchNorm(in_channels=in_channels, **kw)
        self.conv1 = Conv2D(mid, kernel_size=1, strides=1, use_bias=False,
                            in_channels=in_channels, **kw)
        self.bn2 = BatchNorm(in_channels=mid, **kw)
        self.conv2 = _conv3x3(mid, stride, mid, **kw)
        self.bn3 = BatchNorm(in_channels=mid, **kw)
        self.conv3 = Conv2D(channels, kernel_size=1, strides=1,
                            use_bias=False, in_channels=mid, **kw)
        self.downsample = Conv2D(channels, 1, strides=stride, use_bias=False,
                                 in_channels=in_channels, **kw) \
            if downsample else None

    def forward(self, x):
        residual = x
        x = _ops.activation(self.bn1(x), "relu")
        if self.downsample is not None:
            residual = self.downsample(x)
        x = self.conv1(x)
        x = _ops.activation(self.bn2(x), "relu")
        x = self.conv2(x)
        x = _ops.activation(self.bn3(x), "relu")
        return self.conv3(x) + residual


def _make_layer(block, layers, channels, stride, in_channels, **kw):
    layer = HybridSequential(block(channels, stride, channels != in_channels,
                                   in_channels=in_channels, **kw))
    for _ in range(layers - 1):
        layer.add(block(channels, 1, False, in_channels=channels, **kw))
    return layer


class _ResNet(TensorBlock):
    def _finish(self):
        initialize(self, Xavier(), seed=0)
        self.eval()

    @property
    def device(self):
        return self.output.weight.device

    def forward(self, x):
        return self.output(self.features(x))


class ResNetV1(_ResNet):
    """ResNet v1 trunk. thumbnail=True swaps the 7x7/2 stem and its max
    pool for one 3x3/1 convolution (CIFAR-size inputs)."""

    def __init__(self, block, layers, channels, classes=1000,
                 thumbnail=False, stride_in_1x1=True, device=None):
        super().__init__()
        if len(layers) != len(channels) - 1:
            raise MXNetError("ResNetV1: len(layers) must be len(channels) "
                             "- 1")
        kw = dict(device=resolve_device(device))
        self.features = HybridSequential()
        if thumbnail:
            self.features.add(_conv3x3(channels[0], 1, 3, **kw))
        else:
            self.features.add(
                Conv2D(channels[0], 7, 2, 3, use_bias=False, in_channels=3,
                       **kw),
                BatchNorm(in_channels=channels[0], **kw),
                Activation("relu"),
                MaxPool2D(3, 2, 1))
        if block is BottleneckV1:
            kw["stride_in_1x1"] = stride_in_1x1
        for i, num_layer in enumerate(layers):
            self.features.add(_make_layer(
                block, num_layer, channels[i + 1], 1 if i == 0 else 2,
                channels[i], **kw))
        kw.pop("stride_in_1x1", None)
        self.features.add(GlobalAvgPool2D(), Flatten())
        self.output = Dense(channels[-1], classes, **kw)
        self._finish()


class ResNetV2(_ResNet):
    """Pre-activation ResNet v2 trunk."""

    def __init__(self, block, layers, channels, classes=1000,
                 thumbnail=False, device=None):
        super().__init__()
        if len(layers) != len(channels) - 1:
            raise MXNetError("ResNetV2: len(layers) must be len(channels) "
                             "- 1")
        kw = dict(device=resolve_device(device))
        self.features = HybridSequential(
            BatchNorm(scale=False, center=False, in_channels=3, **kw))
        if thumbnail:
            self.features.add(_conv3x3(channels[0], 1, 3, **kw))
        else:
            self.features.add(
                Conv2D(channels[0], 7, 2, 3, use_bias=False, in_channels=3,
                       **kw),
                BatchNorm(in_channels=channels[0], **kw),
                Activation("relu"),
                MaxPool2D(3, 2, 1))
        in_channels = channels[0]
        for i, num_layer in enumerate(layers):
            self.features.add(_make_layer(
                block, num_layer, channels[i + 1], 1 if i == 0 else 2,
                in_channels, **kw))
            in_channels = channels[i + 1]
        self.features.add(BatchNorm(in_channels=in_channels, **kw),
                          Activation("relu"), GlobalAvgPool2D(), Flatten())
        self.output = Dense(in_channels, classes, **kw)
        self._finish()


# num_layers -> (block-type key, per-stage layer counts, channel schedule)
resnet_spec = {
    18: ("basic_block", [2, 2, 2, 2], [64, 64, 128, 256, 512]),
    34: ("basic_block", [3, 4, 6, 3], [64, 64, 128, 256, 512]),
    50: ("bottle_neck", [3, 4, 6, 3], [64, 256, 512, 1024, 2048]),
    101: ("bottle_neck", [3, 4, 23, 3], [64, 256, 512, 1024, 2048]),
    152: ("bottle_neck", [3, 8, 36, 3], [64, 256, 512, 1024, 2048]),
}
resnet_net_versions = [ResNetV1, ResNetV2]
resnet_block_versions = [
    {"basic_block": BasicBlockV1, "bottle_neck": BottleneckV1},
    {"basic_block": BasicBlockV2, "bottle_neck": BottleneckV2},
]


def get_resnet(version, num_layers, pretrained=False, stride_in_1x1=None,
               **kwargs):
    """version 1 or 2, num_layers 18/34/50/101/152. stride_in_1x1
    defaults to True for v1 bottlenecks; the v1b entries pass False.
    kwargs: classes, thumbnail, device."""
    if num_layers not in resnet_spec:
        raise MXNetError(f"invalid resnet depth {num_layers}; options: "
                         f"{sorted(resnet_spec)}")
    if pretrained:
        raise MXNetError("pretrained weights are not bundled; carry them "
                         "with models.load_jax_params")
    if version not in (1, 2):
        raise MXNetError(f"invalid resnet version {version}; options: 1, 2")
    block_type, layers, channels = resnet_spec[num_layers]
    net_cls = resnet_net_versions[version - 1]
    block_cls = resnet_block_versions[version - 1][block_type]
    if version == 1 and block_type == "bottle_neck":
        kwargs["stride_in_1x1"] = (True if stride_in_1x1 is None
                                   else stride_in_1x1)
    return net_cls(block_cls, layers, channels, **kwargs)


def _entry(version, depth, **fixed):
    def f(**kwargs):
        kwargs.update(fixed)
        return get_resnet(version, depth, **kwargs)
    f.__name__ = f"resnet{depth}_v{version}" \
        + ("b" if "stride_in_1x1" in fixed else "")
    return f


resnet18_v1 = _entry(1, 18)
resnet34_v1 = _entry(1, 34)
resnet50_v1 = _entry(1, 50)
resnet101_v1 = _entry(1, 101)
resnet152_v1 = _entry(1, 152)
resnet18_v2 = _entry(2, 18)
resnet34_v2 = _entry(2, 34)
resnet50_v2 = _entry(2, 50)
resnet101_v2 = _entry(2, 101)
resnet152_v2 = _entry(2, 152)
# v1b (GluonCV): the bottleneck's stride moves to the 3x3 convolution
resnet18_v1b = _entry(1, 18)
resnet34_v1b = _entry(1, 34)
resnet50_v1b = _entry(1, 50, stride_in_1x1=False)
resnet101_v1b = _entry(1, 101, stride_in_1x1=False)
resnet152_v1b = _entry(1, 152, stride_in_1x1=False)
