"""Gluon front-end of the PyTorch port."""
from .block import Block, HybridBlock
from . import nn
from . import loss
from .trainer import Trainer
