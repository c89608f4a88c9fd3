"""Gluon front-end of the PyTorch port."""
from .block import Block, HybridBlock
from . import nn
from . import loss
from . import model_zoo
from .trainer import Trainer
