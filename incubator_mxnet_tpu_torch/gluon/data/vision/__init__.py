"""mx.gluon.data.vision of the PyTorch port: datasets and transforms."""
from .datasets import *      # noqa: F401,F403
from . import transforms     # noqa: F401
