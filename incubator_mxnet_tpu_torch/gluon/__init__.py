"""Gluon front-end of the PyTorch port (the JAX package's `mx.gluon` less
`SymbolBlock` and contrib's `estimator`, which are not yet ported)."""
from .parameter import (Parameter, Constant, ParameterDict,
                        DeferredInitializationError)
from .block import Block, HybridBlock
from . import nn
from . import rnn
from . import loss
from . import data
from . import model_zoo
from . import contrib
from . import utils
from .trainer import Trainer
from .utils import split_and_load, split_data, clip_global_norm

__all__ = ["Parameter", "Constant", "ParameterDict", "Block", "HybridBlock",
           "Trainer", "nn", "rnn", "loss", "data", "utils", "model_zoo", "contrib",
           "split_and_load", "split_data", "clip_global_norm",
           "DeferredInitializationError"]
