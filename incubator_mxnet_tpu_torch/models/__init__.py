"""Model definitions of the PyTorch port."""
from .transformer import (MultiHeadAttention, PositionwiseFFN,
                          TransformerEncoderLayer, TransformerEncoder,
                          BERTModel, FusedMLMCELoss, bert_base,
                          bert_small)
