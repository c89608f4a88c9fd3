"""mx.image of the PyTorch port (ref: python/mxnet/image/): host image
functions, augmenters and `ImageIter`, and the detection augmenters.
They run on the host and return NDArrays on the CPU."""
from .image import *     # noqa: F401,F403
from . import detection  # noqa: F401
from .detection import *  # noqa: F401,F403
