"""Vision models of the PyTorch port (counterpart of
incubator_mxnet_tpu/gluon/model_zoo/vision/): ResNet v1 and v1b, and the
`get_model` registry.  The other families of the JAX package are not yet
ported."""
from . import resnet as _resnet
from .resnet import *        # noqa: F401,F403

_models = {name: getattr(_resnet, name) for name in _resnet.__all__
           if name[0].islower() and not name.startswith("get_")}


def get_model(name, **kwargs):
    """The model `name` (e.g. "resnet50_v1b") built with `kwargs`
    (ref: model_zoo.vision.get_model)."""
    name = name.lower()
    if name not in _models:
        raise ValueError("model %r not in registry (%s)"
                         % (name, sorted(_models)))
    return _models[name](**kwargs)
