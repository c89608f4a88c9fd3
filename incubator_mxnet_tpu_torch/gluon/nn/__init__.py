"""Gluon layers of the PyTorch port."""
from .basic_layers import (HybridSequential, Dense, Dropout, Embedding,
                           LayerNorm, BatchNorm, Flatten)
from .conv_layers import (Conv2D, MaxPool2D, AvgPool2D, GlobalMaxPool2D,
                          GlobalAvgPool2D)
from .activations import Activation
