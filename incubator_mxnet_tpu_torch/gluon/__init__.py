"""Gluon front-end of the PyTorch port."""
from .parameter import (Parameter, Constant, ParameterDict,
                        DeferredInitializationError)
from .block import Block, HybridBlock
from . import nn
from . import loss
from . import model_zoo
from . import utils
from .trainer import Trainer
