"""Vision models of the PyTorch port (counterpart of
incubator_mxnet_tpu/gluon/model_zoo/vision/): ResNet v1, v1b and v2,
AlexNet, VGG (with and without BatchNorm), MobileNet v1, v2 and v3,
DenseNet, SqueezeNet and Inception v3, and the `get_model` registry over
the JAX registry's names.  The weights are random (`pretrained=True`
raises)."""
from . import resnet as _m1
from . import alexnet as _m2
from . import vgg as _m3
from . import mobilenet as _m4
from . import densenet as _m5
from . import squeezenet as _m6
from . import inception as _m7

# after the module references: the `alexnet` and `vgg` factories shadow
# the submodules' names here, as in the JAX package
from .resnet import *        # noqa: F401,F403,E402
from .alexnet import *       # noqa: F401,F403,E402
from .vgg import *           # noqa: F401,F403,E402
from .mobilenet import *     # noqa: F401,F403,E402
from .densenet import *      # noqa: F401,F403,E402
from .squeezenet import *    # noqa: F401,F403,E402
from .inception import *     # noqa: F401,F403,E402

_models = {name: getattr(mod, name)
           for mod in (_m1, _m2, _m3, _m4, _m5, _m6, _m7)
           for name in mod.__all__
           if name[0].islower() and not name.startswith("get_")}


def get_model(name, **kwargs):
    """The model `name` (e.g. "mobilenet_v2_1_0") built with `kwargs`
    (ref: model_zoo.vision.get_model)."""
    name = name.lower()
    if name not in _models:
        raise ValueError("model %r not in registry (%s)"
                         % (name, sorted(_models)))
    return _models[name](**kwargs)
