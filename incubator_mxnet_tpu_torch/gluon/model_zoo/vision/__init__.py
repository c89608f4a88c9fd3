"""Vision models of the PyTorch port: ResNet v1 and v1b."""
from .resnet import *        # noqa: F401,F403
