"""Vision model zoo (counterpart of mxnet_tpu/models/vision: `get_model`,
the ResNet entry points and the SSD-512 detector). The reference's
other families (AlexNet, DenseNet, Inception, MobileNet, SqueezeNet,
VGG) are not ported yet: `get_model` raises for their names."""
from ...base import not_ported
from . import resnet as _resnet
from . import ssd as _ssd
from .resnet import *  # noqa: F401,F403
from .ssd import *  # noqa: F401,F403

_models = {name: getattr(_resnet, name) for name in _resnet.__all__
           if name.startswith("resnet")}
_models.update({name: getattr(_ssd, name) for name in _ssd.__all__
                if name.startswith("ssd_")})


def get_model(name, **kwargs):
    """A zoo model by name (parity: model_zoo.vision.get_model), e.g.
    get_model("resnet50_v1b", classes=10, device="cpu") or
    get_model("ssd_512_resnet50_v1_voc")."""
    name = name.lower()
    if name not in _models:
        raise not_ported(f"vision model {name!r}")
    return _models[name](**kwargs)


__all__ = list(_resnet.__all__) + list(_ssd.__all__) + ["get_model"]
