"""Model definitions of the PyTorch port."""
from .transformer import (MultiHeadAttention, CrossAttention,
                          PositionwiseFFN, TransformerEncoderLayer,
                          TransformerEncoder, TransformerDecoderLayer,
                          TransformerDecoder, TransformerNMT,
                          transformer_nmt_base, transformer_nmt_small,
                          BERTModel, FusedMLMCELoss, bert_base, bert_small)
