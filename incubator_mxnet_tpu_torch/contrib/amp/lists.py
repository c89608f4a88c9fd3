"""AMP op lists of the PyTorch port: the port's own copy of the JAX
package's `contrib/amp/lists.py` (ref: python/mxnet/contrib/amp/lists/
symbol_fp16.py), by the reference's op names.

TARGET ops are the matrix products and run in the target dtype; FP32 ops
are numerically sensitive and run in float32 whatever their inputs.  Ops
in neither list run in whatever dtype reaches them.  `amp.init` maps the
names to the port functions that implement them and skips the others.
The reference's third list, WIDEST_TYPE_CASTS, serves only the symbol
pass (`convert_symbol`), which is not yet ported.
"""

# matmul/conv-heavy: cast float32 inputs DOWN to the target dtype
# (ref list: FP16_FUNCS)
TARGET_DTYPE_OPS = [
    "Convolution", "Deconvolution", "FullyConnected", "RNN",
    "dot", "batch_dot",
    "_contrib_interleaved_matmul_selfatt_qk",
    "_contrib_interleaved_matmul_selfatt_valatt",
    "_contrib_interleaved_matmul_encdec_qk",
    "_contrib_interleaved_matmul_encdec_valatt",
]

# numerically sensitive: cast low-precision float inputs UP to float32
# (ref list: FP32_FUNCS — norms, softmaxes, exponentials, losses)
FP32_OPS = [
    "softmax", "log_softmax", "SoftmaxActivation", "SoftmaxOutput",
    "BatchNorm", "LayerNorm", "InstanceNorm", "GroupNorm", "L2Normalization",
    "exp", "log", "log2", "log10", "log1p", "expm1", "power",
    "mean", "sum", "nansum", "prod", "nanprod", "norm",
    "smooth_l1", "MakeLoss", "CTCLoss", "ctc_loss",
    "linalg_gemm", "linalg_gemm2", "linalg_potrf", "linalg_trsm",
]
