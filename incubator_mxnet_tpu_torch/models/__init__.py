"""Model definitions of the PyTorch port."""
from .transformer import (MultiHeadAttention, CrossAttention,
                          PositionwiseFFN, TransformerEncoderLayer,
                          TransformerEncoder, TransformerDecoderLayer,
                          TransformerDecoder, TransformerNMT,
                          transformer_nmt_base, transformer_nmt_small,
                          BERTModel, FusedMLMCELoss, bert_base, bert_small)
from .ssd import (SSD, ssd_300, ssd_512, ssd_512_vgg16, ssd_toy,
                  VGG16ReducedFeatures, ssd_training_targets, SSDTrainLoss)
from .faster_rcnn import (FasterRCNN, faster_rcnn_toy,
                          faster_rcnn_resnet50_v1b, rcnn_training_targets,
                          RCNNTrainLoss)
from .seq2seq import Seq2Seq, GNMT, gnmt_large
from .wide_deep import WideDeep, wide_deep, csr_to_fields
