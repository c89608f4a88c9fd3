"""mx.gluon.data of the PyTorch port (ref: python/mxnet/gluon/data/):
datasets, samplers, the DataLoader and `vision`."""
from .dataset import *       # noqa: F401,F403
from .sampler import *       # noqa: F401,F403
from .dataloader import *    # noqa: F401,F403
from . import vision         # noqa: F401
