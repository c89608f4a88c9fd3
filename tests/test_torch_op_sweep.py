"""PyTorch port: every operator of the port's registry against the JAX
package's, through both packages' `invoke`.

The inputs are those of the JAX package's own sweep
(`tests/python/unittest/test_op_sweep.py`, its `CASES` and
`RANDOM_CHECKS`, read by path), plus cases written here for the port's
ops that sweep does not cover (aliases take their op's case).  Each
output is held to the JAX output's dtype and shape, and its values:

* exactly, for the outputs of selection, shape, index, comparison and
  creation ops and any non-float output (`EXACT`; their gradients, which
  sum, take the elementwise rule);
* within 2e-5 of the output's scale (max |ref|, at least 1) for
  reductions, products and normalizations (`SCALED`);
* within rtol 1e-5 (atol 1e-6) elementwise for the rest.

Gradients are held against `jax.vjp` of the JAX op with a seeded
cotangent on the first output, at the same tolerances; the forward of
such a case is held to that program's outputs, the others to the JAX
`invoke`.  Sampling ops are
held to the JAX sweep's moment checks, never to shared seeds.
`_contrib_flash_attention` is held against the JAX Pallas kernels run in
interpret mode.  Two coverage tests pin the registry: every port op is
swept here, and the JAX ops the port lacks are exactly `NOT_YET_PORTED`
(listed in ROADMAP.md, Queue 1).
"""
import functools
import importlib.util
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu import nd as jnd
from incubator_mxnet_tpu.ndarray.ndarray import invoke as jinvoke
from incubator_mxnet_tpu.ops import registry as jreg

import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch import nd as tnd
from incubator_mxnet_tpu_torch import autograd as tag
from incubator_mxnet_tpu_torch.ndarray.ndarray import invoke as tinvoke
from incubator_mxnet_tpu_torch.ops import registry as treg

pytestmark = pytest.mark.torch_port

_HERE = os.path.dirname(os.path.abspath(__file__))
_spec = importlib.util.spec_from_file_location(
    "_jax_op_sweep",
    os.path.join(_HERE, "python", "unittest", "test_op_sweep.py"))
_jsweep = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_jsweep)

#: JAX ops the port does not register yet (ROADMAP.md, Queue 1)
NOT_YET_PORTED = {
    # ops/control_flow.py
    "cond", "foreach", "while_loop",
    # ops/quantization.py
    "_contrib_dequantize", "_contrib_quantize", "_contrib_quantize_v2",
    "_contrib_quantized_act", "_contrib_quantized_conv",
    "_contrib_quantized_elemwise_add", "_contrib_quantized_flatten",
    "_contrib_quantized_fully_connected", "_contrib_quantized_pooling",
    "_contrib_requantize",
}

# ---------------------------------------------------------------------------
# cases: the JAX sweep's, plus the port ops it does not sweep
# ---------------------------------------------------------------------------

RS = np.random.RandomState(7)


def U(lo, hi, *shape):
    return RS.uniform(lo, hi, size=shape).astype(np.float32)


def I(hi, *shape):
    return RS.randint(0, hi, size=shape).astype(np.float32)


CASES = {op: [dict(args=c["args"], kw=c["kw"], grad=c["grad"],
                   grad_argnums=c["grad_argnums"]) for c in cases]
         for op, cases in _jsweep.CASES.items() if op in treg._REGISTRY}


def case(op, args, kw, grad=True, grad_argnums=None):
    CASES.setdefault(op, []).append(dict(args=args, kw=kw, grad=grad,
                                         grad_argnums=grad_argnums))


#: alias -> an op of the same OpDef that the JAX sweep has a case for
ALIASES = {"Cast": "cast", "Pad": "pad", "Reshape": "reshape",
           "SliceChannel": "split", "SwapAxis": "swapaxes",
           "_add": "elemwise_add", "_plus": "elemwise_add",
           "_sub": "elemwise_sub", "_minus": "elemwise_sub",
           "_mul": "elemwise_mul", "_div": "elemwise_div",
           "_copy": "identity", "stop_gradient": "BlockGrad",
           "broadcast_axes": "broadcast_axis", "flatten": "Flatten",
           "max_axis": "max", "min_axis": "min", "sum_axis": "sum",
           "pow": "_power", "reverse": "flip"}
for _alias, _op in ALIASES.items():
    assert treg.get(_alias) is treg.get(_op), _alias
    CASES[_alias] = CASES[_op]

_X4 = U(-1, 1, 2, 3, 6, 6)
case("Convolution", [_X4, U(-1, 1, 4, 3, 3, 3), U(-1, 1, 4)],
     {"kernel": (3, 3), "num_filter": 4, "pad": (1, 1)})
case("Convolution", [_X4, U(-1, 1, 6, 1, 3, 3)],
     {"kernel": (3, 3), "num_filter": 6, "num_group": 3, "stride": (2, 2),
      "no_bias": True})
for _kw in ({"kernel": (2, 2), "stride": (2, 2), "pool_type": "max"},
            {"kernel": (3, 3), "stride": (2, 2), "pad": (1, 1),
             "pool_type": "avg"},
            {"kernel": (3, 3), "stride": (2, 2), "pad": (1, 1),
             "pool_type": "avg", "count_include_pad": False},
            {"kernel": (3, 3), "stride": (2, 2), "pool_type": "sum",
             "pooling_convention": "full"},
            {"kernel": (2, 2), "stride": (2, 2), "pool_type": "lp"},
            {"global_pool": True, "pool_type": "avg"}):
    case("Pooling", [_X4], _kw)
_BN = [U(-1, 1, 4, 3, 2, 2), U(0.5, 1.5, 3), U(-0.5, 0.5, 3),
       U(-0.5, 0.5, 3), U(0.5, 1.5, 3)]
case("BatchNorm", _BN, {"fix_gamma": False}, grad_argnums=(0, 1, 2))
case("BatchNorm", _BN, {"fix_gamma": False, "_training": True},
     grad_argnums=(0, 1, 2))
case("BatchNorm", _BN, {"_training": True}, grad_argnums=(0, 2))
case("LayerNorm", [U(-1, 1, 3, 4, 5), U(0.5, 1.5, 5), U(-0.5, 0.5, 5)], {})
case("LayerNorm", [U(-1, 1, 3, 4, 5), U(0.5, 1.5, 4), U(-0.5, 0.5, 4)],
     {"axis": 1})
case("Dropout", [U(-1, 1, 4, 5)], {"p": 0.5})
case("_fused_softmax_ce", [U(-2, 2, 6, 7), I(7, 6)], {})
case("_fused_linear_softmax_ce",
     [U(-1, 1, 8, 5), U(-1, 1, 9, 5), U(-0.5, 0.5, 9), I(9, 8)],
     {"num_chunks": 2})
case("amp_cast", [U(-1, 1, 3, 4)], {"dtype": "float16"}, grad=False)
case("amp_cast", [I(5, 3, 4).astype(np.int32)], {"dtype": "float16"},
     grad=False)
case("amp_multicast", [U(-1, 1, 3, 4).astype(np.float16), U(-1, 1, 3, 4)],
     {"num_outputs": 2}, grad=False)
case("amp_multicast", [U(-1, 1, 3, 4).astype(np.float16), U(-1, 1, 3, 4)],
     {"num_outputs": 2, "cast_narrow": True}, grad=False)
case("LeakyReLU", [U(-1, 1, 2, 3, 4), U(0.1, 0.3, 3)],
     {"act_type": "prelu"})
for _act in ("selu", "gelu", "rrelu"):
    case("LeakyReLU", [U(-2, 2, 3, 4) + 0.05], {"act_type": _act})
case("Activation", [U(-2, 2, 3, 4)], {"act_type": "tanh"})
case("Activation", [U(-2, 2, 3, 4)], {"act_type": "softsign"})
case("SoftmaxOutput", [U(-1, 1, 4, 5), I(5, 4)],
     {"normalization": "batch", "grad_scale": 2.0}, grad_argnums=(0,))
case("reshape", [U(-1, 1, 2, 3, 4)], {"shape": (0, -3)})
case("reshape", [U(-1, 1, 2, 3, 4)], {"shape": (-4, 1, 2, -2)})
case("reshape", [U(-1, 1, 2, 3, 4)], {"shape": (-1, 0), "reverse": True})
case("slice", [U(-1, 1, 4, 5)], {"begin": (3, None), "end": (0, None),
                                 "step": (-1, 2)})
case("pad", [U(-1, 1, 2, 3, 4, 5)],
     {"mode": "reflect", "pad_width": (0, 0, 0, 0, 2, 1, 1, 2)})
case("sum", [I(3, 2, 3, 4).astype(np.int32)], {"axis": 1}, grad=False)
case("mean", [I(3, 2, 3, 4).astype(np.int32)], {}, grad=False)
case("topk", [RS.permutation(24).reshape(4, 6).astype(np.float32)],
     {"axis": 1, "k": 3, "ret_typ": "both", "is_ascend": True}, grad=False)
case("topk", [RS.permutation(24).reshape(4, 6).astype(np.float32)],
     {"axis": 0, "k": 2, "ret_typ": "mask"}, grad=False)
case("argsort", [RS.permutation(24).reshape(4, 6).astype(np.float32)],
     {"axis": 0, "is_ascend": False, "dtype": "int32"}, grad=False)
case("take", [U(-1, 1, 5, 3), np.array([[0, 7], [-2, 4]], np.float32)],
     {"axis": 0, "mode": "wrap"}, grad_argnums=(0,))
case("one_hot", [I(5, 6)], {"depth": 5, "dtype": "int32"}, grad=False)
case("SequenceMask", [U(-1, 1, 3, 5, 2), np.array([1, 3, 5], np.float32)],
     {"use_sequence_length": True, "value": 0.5, "axis": 1},
     grad_argnums=(0,))
case("_arange", [], {"start": 2, "stop": 11, "step": 3, "dtype": "int32"},
     grad=False)
case("_arange", [], {"start": 0.0, "stop": 3.0, "repeat": 2}, grad=False)

# ops/nn.py beyond the JAX sweep's cases: 1-D and 3-D convolution and
# pooling, the transposed convolution's options, the norms, both
# GridGenerator transforms, bilinear and multi-input UpSampling, CTC and
# SyncBatchNorm on one device
_X3, _X5 = U(-1, 1, 2, 4, 9), U(-1, 1, 2, 3, 5, 6, 4)
case("Convolution", [_X3, U(-1, 1, 6, 2, 3), U(-1, 1, 6)],
     {"kernel": (3,), "num_filter": 6, "num_group": 2, "stride": (2,),
      "pad": (1,), "dilate": (2,)})
case("Convolution", [_X5, U(-1, 1, 4, 3, 3, 2, 3)],
     {"kernel": (3, 2, 3), "num_filter": 4, "pad": (1, 0, 1),
      "no_bias": True})
for _kw in ({"kernel": (3,), "stride": (2,), "pad": (1,),
             "pool_type": "max"},
            {"kernel": (2,), "stride": (2,), "pool_type": "avg",
             "pooling_convention": "full"},
            {"global_pool": True, "pool_type": "max"}):
    case("Pooling", [_X3], _kw)
for _kw in ({"kernel": (2, 2, 2), "stride": (2, 2, 2), "pool_type": "max"},
            {"kernel": (3, 3, 3), "stride": (2, 2, 2), "pad": (1, 1, 1),
             "pool_type": "avg", "count_include_pad": False},
            {"global_pool": True, "pool_type": "avg"}):
    case("Pooling", [_X5], _kw)
case("Deconvolution", [_X4, U(-1, 1, 3, 2, 3, 3), U(-1, 1, 6)],
     {"kernel": (3, 3), "stride": (2, 2), "pad": (1, 1), "adj": (1, 1),
      "num_filter": 6, "num_group": 3, "no_bias": False})
case("Deconvolution", [_X4, U(-1, 1, 3, 4, 2, 3)],
     {"kernel": (2, 3), "stride": (1, 2), "dilate": (2, 1), "adj": (3, 0),
      "num_filter": 4})
case("Deconvolution", [_X3, U(-1, 1, 4, 3, 4)],
     {"kernel": (4,), "stride": (3,), "pad": (2,), "num_filter": 3})
case("Deconvolution", [U(-1, 1, 1, 2, 3, 4, 3), U(-1, 1, 2, 3, 2, 2, 2)],
     {"kernel": (2, 2, 2), "stride": (2, 1, 2), "num_filter": 3})
case("InstanceNorm", [_X4 + 0.5, U(0.5, 1.5, 3), U(-0.5, 0.5, 3)], {})
case("InstanceNorm", [_X3, U(0.5, 1.5, 4), U(-0.5, 0.5, 4)],
     {"eps": 1e-5})
case("GroupNorm", [U(-1, 1, 2, 6, 3, 4) + 0.5, U(0.5, 1.5, 6),
                   U(-0.5, 0.5, 6)], {"num_groups": 3})
case("GroupNorm", [_X3, U(0.5, 1.5, 4), U(-0.5, 0.5, 4)],
     {"num_groups": 1, "eps": 1e-3})
case("LRN", [U(-1, 1, 2, 6, 3, 3)], {"nsize": 3, "alpha": 0.1,
                                     "beta": 0.5, "knorm": 1.0})
case("UpSampling", [U(-1, 1, 2, 3, 4, 5)],
     {"scale": 2, "sample_type": "bilinear", "num_args": 1})
case("UpSampling", [U(-1, 1, 1, 2, 3, 3)],
     {"scale": 3, "sample_type": "bilinear", "num_args": 1})
case("UpSampling", [U(-1, 1, 2, 3, 4, 4), U(-1, 1, 2, 2, 2, 2)],
     {"scale": 2, "num_args": 2})
case("GridGenerator", [U(-1, 1, 2, 2, 3, 4)],
     {"transform_type": "warp"})
_CTC = U(-1, 1, 6, 3, 5)
case("CTCLoss", [_CTC, np.array([[1, 2, 2], [3, 0, 0], [4, 4, 1]],
                                np.float32)], {}, grad_argnums=(0,))
case("CTCLoss", [_CTC, np.array([[0, 1, 1], [2, -1, -1], [3, 2, 1]],
                                np.float32),
                 np.array([6, 4, 5], np.float32),
                 np.array([3, 1, 2], np.float32)],
     {"use_data_lengths": True, "use_label_lengths": True,
      "blank_label": "last"}, grad_argnums=(0,))
# the third example needs 5 steps (1, 1 and a blank between, 2, 2 and a
# blank between) and has 3: no alignment, a loss of about 1e30
case("CTCLoss", [_CTC, np.array([[1, 2, 2], [3, 0, 0], [1, 1, 2]],
                                np.float32),
                 np.array([6, 6, 3], np.float32)],
     {"use_data_lengths": True}, grad_argnums=(0,))
ALIASES["ctc_loss"] = "CTCLoss"
assert treg.get("ctc_loss") is treg.get("CTCLoss")
CASES["ctc_loss"] = CASES["CTCLoss"]
case("_contrib_SyncBatchNorm", _BN, {"fix_gamma": False, "_training": True},
     grad_argnums=(0, 1, 2))
case("_contrib_SyncBatchNorm", _BN, {"fix_gamma": False, "_training": False,
                                     "ndev": 1}, grad_argnums=(0, 1, 2))
case("softmax", [U(-2, 2, 3, 5)], {"length": np.array([2, 5, 3], np.float32),
                                   "use_length": True, "axis": -1})

# the fused RNN ops (ops/rnn.py): (T, B, I) data, the flat vector, the
# states; the length vector of RNN_varlen takes no gradient
_RNN_X = U(-1, 1, 4, 2, 3)


def _rnn_args(mode, layers, bi, hidden=5, lengths=None):
    from incubator_mxnet_tpu_torch.ops.rnn import rnn_param_size
    d = 2 if bi else 1
    args = [_RNN_X, U(-0.5, 0.5, rnn_param_size(mode, layers, 3, hidden,
                                                bi)),
            U(-0.5, 0.5, layers * d, 2, hidden)]
    if mode == "lstm":
        args.append(U(-0.5, 0.5, layers * d, 2, hidden))
    return args + ([] if lengths is None else [np.array(lengths,
                                                        np.float32)])


case("RNN", _rnn_args("lstm", 2, True),
     {"state_size": 5, "num_layers": 2, "bidirectional": True,
      "mode": "lstm"})
case("RNN", _rnn_args("gru", 1, False), {"state_size": 5, "mode": "gru"})
case("RNN", _rnn_args("rnn_relu", 2, False),
     {"state_size": 5, "num_layers": 2, "mode": "rnn_relu",
      "state_outputs": False})
case("RNN", _rnn_args("rnn_tanh", 1, True),
     {"state_size": 5, "bidirectional": True, "mode": "rnn_tanh"})
case("RNN_varlen", _rnn_args("lstm", 2, True, lengths=[4, 2]),
     {"state_size": 5, "num_layers": 2, "bidirectional": True,
      "mode": "lstm"}, grad_argnums=(0, 1, 2, 3))


# the detection ops (ops/contrib.py, ops/rcnn.py), which the JAX sweep
# leaves to its own files (test_contrib_ops.py, test_rcnn.py)


def _corner_boxes(n, lead=(), scale=1.0):
    ctr = RS.rand(*(lead + (n, 2))) * scale
    wh = RS.rand(*(lead + (n, 2))) * 0.4 * scale + 0.05 * scale
    return np.concatenate([ctr - wh / 2, ctr + wh / 2], -1).astype(
        np.float32)


def _anchors(H, W, size):
    cy, cx = np.meshgrid((np.arange(H) + 0.5) / H, (np.arange(W) + 0.5) / W,
                         indexing="ij")
    c = np.stack([cx, cy], -1).reshape(1, -1, 2)
    return np.concatenate([c - size / 2, c + size / 2], -1).astype(
        np.float32)


def _probs(*shape, axis=1):
    e = np.exp(RS.randn(*shape))
    return (e / e.sum(axis, keepdims=True)).astype(np.float32)


def _rois(R, B, H, W):
    ctr = RS.rand(R, 2) * [W, H]
    wh = RS.rand(R, 2) * [W / 2.0, H / 2.0] + 1
    return np.concatenate([RS.randint(0, B, (R, 1)), ctr - wh / 2,
                           ctr + wh / 2], 1).astype(np.float32)


_DET = np.concatenate([RS.randint(0, 3, (2, 24, 1)), U(0, 1, 2, 24, 1),
                       _corner_boxes(24, (2,))], -1).astype(np.float32)
_LAB = np.concatenate([RS.randint(0, 2, (2, 2, 1)),
                       _corner_boxes(2, (2,))], -1).astype(np.float32)
case("box_iou", [_corner_boxes(4), _corner_boxes(5)], {})
case("box_iou", [_corner_boxes(3, (2,)), _corner_boxes(4)],
     {"format": "center"})
case("box_nms", [_DET], {"overlap_thresh": 0.3, "id_index": 0}, grad=False)
case("box_nms", [_DET], {"overlap_thresh": 0.2, "topk": 10,
                         "valid_thresh": 0.3, "force_suppress": True},
     grad=False)
case("box_decode", [U(-1, 1, 2, 5, 4), _corner_boxes(5, (2,))],
     {"std2": 0.2, "std3": 0.2})
case("MultiBoxPrior", [U(-1, 1, 1, 2, 3, 4)],
     {"sizes": (0.3, 0.6), "ratios": (1, 2, 0.5)}, grad=False)
case("MultiBoxPrior", [U(-1, 1, 1, 2, 2, 2)],
     {"sizes": (0.8,), "clip": True}, grad=False)
case("MultiBoxTarget", [_anchors(4, 4, 0.3), _LAB, U(-1, 1, 2, 3, 16)],
     {"overlap_threshold": 0.3}, grad=False)
case("MultiBoxDetection", [_probs(2, 3, 16), U(-1, 1, 2, 64),
                           _anchors(4, 4, 0.3)], {"nms_threshold": 0.3},
     grad=False)
case("ROIAlign", [U(-1, 1, 2, 3, 8, 9), _rois(5, 2, 8, 9)],
     {"pooled_size": (2, 3), "sample_ratio": 2})
case("ROIAlign", [U(-1, 1, 1, 2, 8, 8), _rois(4, 1, 16, 16)],
     {"pooled_size": (2, 2), "spatial_scale": 0.5, "aligned": True})
case("ROIPooling", [U(-1, 1, 2, 2, 8, 8), _rois(4, 2, 8, 8)],
     {"pooled_size": (2, 2)})
case("BilinearResize2D", [U(-1, 1, 1, 2, 4, 5)], {"height": 7, "width": 3})
case("AdaptiveAvgPooling2D", [U(-1, 1, 2, 2, 7, 6)], {"output_size": (3, 2)})
case("AdaptiveAvgPooling2D", [U(-1, 1, 2, 2, 8, 4)], {"output_size": 2})
case("interleaved_matmul_selfatt_qk", [U(-1, 1, 3, 2, 24)], {"heads": 2})
case("interleaved_matmul_selfatt_valatt",
     [U(-1, 1, 3, 2, 24), U(0, 1, 4, 3, 3)], {"heads": 2})
case("_contrib_Proposal",
     [_probs(1, 2, 3, 4, 4).reshape(1, 6, 4, 4), U(-0.2, 0.2, 1, 12, 4, 4),
      np.array([[32, 32, 1.0]], np.float32)],
     {"rpn_pre_nms_top_n": 30, "rpn_post_nms_top_n": 8, "threshold": 0.5,
      "rpn_min_size": 2, "scales": (4,), "ratios": (0.5, 1, 2),
      "feature_stride": 8}, grad=False)
case("_contrib_ProposalTarget",
     [np.concatenate([np.zeros((6, 1)), _corner_boxes(6, scale=30.0)],
                     1).astype(np.float32),
      np.concatenate([_corner_boxes(2, (1,), scale=30.0),
                      np.array([[[0], [1]]])], -1).astype(np.float32)],
     {"num_classes": 3, "batch_rois": 6, "fg_fraction": 0.5,
      "fg_overlap": 0.3}, grad=False)
assert treg.get("_contrib_MultiProposal") is treg.get("_contrib_Proposal")
CASES["_contrib_MultiProposal"] = CASES["_contrib_Proposal"]

#: (op, index) pairs to run; an alias's cases run under the alias' name
_ALL = [(op, i) for op in treg.list_ops() for i in range(len(CASES.get(op,
                                                                      ())))]

SCALED = {"sum", "sum_axis", "mean", "prod", "nansum", "nanprod", "norm",
          "dot", "batch_dot", "khatri_rao", "L2Normalization",
          "FullyConnected", "Convolution", "Pooling", "softmax",
          "log_softmax", "softmin", "LayerNorm", "BatchNorm",
          "SoftmaxOutput", "_fused_softmax_ce", "_fused_linear_softmax_ce",
          "ROIAlign", "BilinearResize2D", "AdaptiveAvgPooling2D",
          "Deconvolution", "InstanceNorm", "GroupNorm", "LRN", "UpSampling",
          "GridGenerator", "CTCLoss", "ctc_loss", "_contrib_SyncBatchNorm",
          "interleaved_matmul_selfatt_qk",
          "interleaved_matmul_selfatt_valatt", "RNN", "RNN_varlen"}
EXACT = {"argmax", "argmin", "argmax_channel", "argsort", "topk", "sort",
         "shape_array", "size_array", "one_hot", "boolean_mask", "where",
         "take", "pick", "gather_nd", "scatter_nd", "_scatter_set_nd",
         "reshape", "Reshape", "reshape_like", "Flatten", "flatten",
         "expand_dims", "squeeze", "transpose", "swapaxes", "SwapAxis",
         "flip", "reverse", "tile", "repeat", "broadcast_to",
         "broadcast_like", "broadcast_axis", "broadcast_axes", "concat",
         "Concat", "stack", "split", "SliceChannel", "slice", "slice_axis",
         "slice_like", "pad", "Pad", "depth_to_space", "space_to_depth",
         "diag", "cast", "Cast", "amp_cast", "amp_multicast", "identity",
         "_copy", "BlockGrad", "stop_gradient", "zeros_like", "ones_like",
         "_zeros", "_ones", "_full", "_eye", "arange_like", "Embedding",
         "SequenceMask", "SequenceLast", "SequenceReverse", "MakeLoss",
         "max", "max_axis", "min", "min_axis", "relu", "abs", "sign",
         "negative", "clip", "round", "rint", "ceil", "floor", "trunc",
         "fix", "_maximum_scalar", "_minimum_scalar", "Dropout",
         "box_nms", "bipartite_matching", "ROIPooling", "count_sketch",
         "index_copy", "getnnz"}


def _name(dt):
    return str(dt).replace("torch.", "")


def _assert_close(op, got, ref, what):
    """`got` (port) against `ref` (JAX), numpy arrays of one dtype."""
    assert got.shape == ref.shape, (op, what, got.shape, ref.shape)
    g, r = got.astype(np.float64), ref.astype(np.float64)
    if (op in EXACT and what == "output") or not np.issubdtype(
            ref.dtype, np.floating):
        assert np.array_equal(g, r, equal_nan=True), (op, what, g, r)
        return
    if op in SCALED:
        scale = max(1.0, float(np.abs(r).max())) if r.size else 1.0
        err = float(np.abs(g - r).max()) if r.size else 0.0
        assert err <= 2e-5 * scale, (op, what, err, scale)
        return
    assert np.allclose(g, r, rtol=1e-5, atol=1e-6, equal_nan=True), \
        (op, what, float(np.abs(g - r).max()))


def _outs(x):
    return tuple(x) if isinstance(x, (tuple, list)) else (x,)


def _grad_argnums(op, c):
    if c["grad_argnums"] is not None:
        return tuple(c["grad_argnums"])
    return tuple(i for i in range(len(c["args"]))
                 if i not in jreg.get(op).nograd_argnums)


# an alias shares its op's OpDef (asserted above): its gradient is its
# op's, which runs
_GRAD = [(op, i) for op, i in _ALL
         if CASES[op][i]["grad"] and treg.get(op).differentiable
         and op != "Dropout" and op not in ALIASES]


@functools.lru_cache(maxsize=None)
def _jax_vjp(op, idx):
    """(outputs, cotangent, gradients) of the JAX op on case `idx`, the
    gradients of the first output against a seeded cotangent: one
    compiled program (the vjp op by op compiles each primitive's forward
    and transpose on its own, which is most of this file's time)."""
    c = CASES[op][idx]
    argnums = _grad_argnums(op, c)
    kw = dict(c["kw"])
    jfn = jreg.get(op).fn
    jargs = [jnp.asarray(a) for a in c["args"]]

    def f(*xs):
        full = list(jargs)
        for i, x in zip(argnums, xs):
            full[i] = x
        outs = _outs(jfn(*full, **kw))
        return outs[0], outs[1:]

    xs = [jargs[i] for i in argnums]
    first = jax.eval_shape(f, *xs)[0]
    cot = np.random.RandomState(idx + 1).uniform(
        -1, 1, size=first.shape).astype(np.float32)

    def run(xs, ct):
        out, vjp, rest = jax.vjp(f, *xs, has_aux=True)
        return (out,) + tuple(rest), vjp(ct)

    outs, grads = jax.jit(run)(xs, jnp.asarray(cot, dtype=first.dtype))
    return outs, cot, grads


class _Out:
    """A JAX array as a JAX NDArray shows it: its dtype and asnumpy."""

    def __init__(self, a):
        self.dtype, self._a = np.dtype(a.dtype), a

    def asnumpy(self):
        return np.asarray(self._a)


@pytest.mark.parametrize("op,idx", _ALL, ids=["%s-%d" % c for c in _ALL])
def test_op_forward_matches_jax(op, idx):
    """The JAX side is its `invoke`, or for a case whose gradient is
    checked, the same registry function in the gradient's program (but
    for an op that reads the training flag, which the gradient's program
    takes as `record()` sets it)."""
    c = CASES[op][idx]
    if (op, idx) in _GRAD and not treg.get(op).needs_training:
        jout = tuple(_Out(o) for o in _jax_vjp(op, idx)[0])
    else:
        jout = _outs(jinvoke(op, *[jnd.array(a) for a in c["args"]],
                             **c["kw"]))
    tout = _outs(tinvoke(op, *[tnd.array(a, ctx="cpu") for a in c["args"]],
                         ctx="cpu", **c["kw"]))
    assert len(tout) == len(jout), (op, len(tout), len(jout))
    for k, (t, j) in enumerate(zip(tout, jout)):
        assert isinstance(t, tnd.NDArray)
        assert _name(t.dtype) == str(j.dtype), (op, k, t.dtype, j.dtype)
        _assert_close(op, t.asnumpy(), j.asnumpy(), "output")


@pytest.mark.parametrize("op,idx", _GRAD, ids=["%s-%d" % c for c in _GRAD])
def test_op_gradient_matches_jax_vjp(op, idx):
    c = CASES[op][idx]
    argnums = _grad_argnums(op, c)
    _, cot, jgrads = _jax_vjp(op, idx)
    targs = [tnd.array(a, ctx="cpu") for a in c["args"]]
    for i in argnums:
        targs[i].attach_grad()
    with tag.record():
        tout = _outs(tinvoke(op, *targs, **c["kw"]))[0]
    tgrads = tag.grad(tout, [targs[i] for i in argnums],
                      head_grads=tnd.array(cot, ctx="cpu"))
    for i, tg, jg in zip(argnums, tgrads, jgrads):
        assert _name(tg.dtype) == str(jg.dtype), (op, i)
        _assert_close(op, tg.asnumpy(), np.asarray(jg), "grad of input %d"
                      % i)


@pytest.mark.parametrize("op", sorted(_jsweep.RANDOM_CHECKS))
def test_random_op_statistics(op):
    """The JAX sweep's moment checks, on the port's samples."""
    args, kw, check = _jsweep.RANDOM_CHECKS[op]
    tmx.random.seed(1234)
    out = tinvoke(op, *[tnd.array(a, ctx="cpu") for a in args], ctx="cpu",
                  **kw)
    try:        # the JAX output's dtype and shape, without compiling
        jout = _outs(jax.eval_shape(lambda: jreg.get(op).fn(
            *[jnp.asarray(a) for a in args], _rng_key=jax.random.PRNGKey(0),
            **kw)))[0]
    except jax.errors.ConcretizationTypeError:
        jout = _outs(jinvoke(op, *[jnd.array(a) for a in args], **kw))[0]
    out = _outs(out)[0]
    assert _name(out.dtype) == str(jout.dtype) and out.shape == jout.shape
    x = out.asnumpy()
    assert check(x.astype(np.float64)), (op, x.mean())


def test_dropout_training_statistics():
    """Training dropout (mode 'always' outside record, and under
    record()) zeroes about p of the elements and scales the rest by
    1/(1-p), in both packages; `axes` shares the mask along them."""
    x = np.ones((200, 100), np.float32)
    for out in (tinvoke("Dropout", tnd.array(x, ctx="cpu"), p=0.3,
                        mode="always"),
                jinvoke("Dropout", jnd.array(x), p=0.3, mode="always")):
        a = out.asnumpy()
        assert set(np.unique(a)) <= {0.0, np.float32(1 / 0.7)}
        assert abs((a == 0).mean() - 0.3) < 0.02
    with tag.record():
        a = tnd.Dropout(tnd.array(x, ctx="cpu"), p=0.5, axes=(1,)).asnumpy()
    assert (a == a[:, :1]).all() and abs((a[:, 0] == 0).mean() - 0.5) < 0.15
    assert (tnd.Dropout(tnd.array(x, ctx="cpu"), p=0.5).asnumpy() == x).all()


@pytest.fixture
def pallas_interpret(monkeypatch):
    monkeypatch.setenv("MXNET_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("MXNET_FLASH_BLOCK_Q", "128")
    monkeypatch.setenv("MXNET_FLASH_BLOCK_K", "128")


@pytest.mark.parametrize("causal", [False, True])
def test_contrib_flash_attention_matches_pallas(pallas_interpret, causal):
    """`nd.contrib.flash_attention` (the kernels' plain versions on the
    CPU) against the JAX registry op on the Pallas kernels in interpret
    mode: output and the three gradients, within 2e-5 of their scale."""
    rs = np.random.RandomState(3)
    B, T, C, H = 2, 128, 64, 2
    qkv = [(rs.randn(B, T, C) * 0.5).astype(np.float32) for _ in range(3)]
    cot = rs.uniform(-1, 1, (B, T, C)).astype(np.float32)
    kw = dict(num_heads=H, causal=causal)
    jfn = jreg.get("_contrib_flash_attention").fn
    jout, vjp = jax.vjp(lambda q, k, v: jfn(q, k, v, **kw),
                        *[jnp.asarray(a) for a in qkv])
    jgrads = vjp(jnp.asarray(cot))
    targs = [tnd.array(a, ctx="cpu") for a in qkv]
    for a in targs:
        a.attach_grad()
    with tag.record():
        tout = tnd.contrib.flash_attention(*targs, **kw)
    tout.backward(tnd.array(cot, ctx="cpu"))
    _assert_close("_contrib_flash_attention", tout.asnumpy(),
                  np.asarray(jout), "output")
    for i, (a, jg) in enumerate(zip(targs, jgrads)):
        g, r = a.grad.asnumpy(), np.asarray(jg)
        assert np.abs(g - r).max() <= 2e-5 * max(1.0, np.abs(r).max()), i


def test_flash_attention_second_order_raises(pallas_interpret):
    """create_graph through the flash kernels: the JAX package raises (it
    cannot differentiate its Pallas kernels), and the port raises
    MXNetError, never a silent zero."""
    rs = np.random.RandomState(4)
    qkv = [rs.randn(1, 128, 32).astype(np.float32) for _ in range(3)]
    jq = [jnd.array(a) for a in qkv]
    for a in jq:
        a.attach_grad()
    with pytest.raises(Exception):
        with jmx.autograd.record():
            s = (jinvoke("_contrib_flash_attention", *jq, num_heads=2)
                 ** 2).sum()
            jmx.autograd.grad(s, [jq[0]], create_graph=True)
    tq = [tnd.array(a, ctx="cpu") for a in qkv]
    for a in tq:
        a.attach_grad()
    with pytest.raises(tmx.MXNetError, match="differentiable once"):
        with tag.record():
            s = (tnd.contrib.flash_attention(*tq, num_heads=2) ** 2).sum()
            tag.grad(s, [tq[0]], create_graph=True)


def test_every_port_op_is_swept():
    """Every op of the port's registry has a case here (an alias takes
    its op's), a moment check, or a test of its own in this file."""
    own = {"_contrib_flash_attention": "test_contrib_flash_attention_"
           "matches_pallas"}
    covered = set(CASES) | set(_jsweep.RANDOM_CHECKS) | set(own)
    missing = [op for op in treg.list_ops() if op not in covered]
    assert not missing, missing
    src = open(os.path.abspath(__file__)).read()
    assert all(name in src for name in own.values())


def test_jax_ops_not_in_port_are_the_listed_ones():
    """The JAX registry minus the port's is NOT_YET_PORTED, which
    ROADMAP.md lists too; the port registers nothing the JAX package
    lacks."""
    jops, tops = set(jreg.list_ops()), set(treg.list_ops())
    assert jops - tops == NOT_YET_PORTED
    assert tops <= jops
    roadmap = open(os.path.join(_HERE, os.pardir, "ROADMAP.md")).read()
    assert [op for op in sorted(NOT_YET_PORTED) if op not in roadmap] == []


def test_registry_metadata_matches_jax():
    """Tensor inputs, differentiability, outputs, rng and training flags
    and gradient-free inputs are the JAX entries'."""
    for op in treg.list_ops():
        t, j = treg.get(op), jreg.get(op)
        for attr in ("ndarray_inputs", "differentiable", "num_outputs",
                     "visible_outputs", "needs_rng", "needs_training",
                     "nograd_argnums"):
            assert getattr(t, attr) == getattr(j, attr), (op, attr)
