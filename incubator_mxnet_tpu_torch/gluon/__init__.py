"""Gluon front-end of the PyTorch port (the JAX package's `mx.gluon` less
`SymbolBlock`, `rnn`, `data` and contrib's `rnn` and `estimator`, which
are not yet ported)."""
from .parameter import (Parameter, Constant, ParameterDict,
                        DeferredInitializationError)
from .block import Block, HybridBlock
from . import nn
from . import loss
from . import model_zoo
from . import contrib
from . import utils
from .trainer import Trainer
from .utils import split_and_load, split_data, clip_global_norm

__all__ = ["Parameter", "Constant", "ParameterDict", "Block", "HybridBlock",
           "Trainer", "nn", "loss", "utils", "model_zoo", "contrib",
           "split_and_load", "split_data", "clip_global_norm",
           "DeferredInitializationError"]
