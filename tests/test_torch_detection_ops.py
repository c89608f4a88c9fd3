"""PyTorch port: the detection operators (`ops/contrib.py`, `ops/rcnn.py`
and the greedy NMS of `ops/nms.py`) against the JAX package on the CPU.

Every op runs on the same numpy inputs through the JAX `invoke` and the
port's: selections, indices and labels equal exactly, values within 2e-5
of their scale.  Gradients of ROIAlign, ROIPooling, BilinearResize2D,
AdaptiveAvgPooling2D, box_encode, box_decode and the interleaved matmuls
are held against `jax.vjp`.  The cases of the JAX package's
test_contrib_ops.py and test_rcnn.py run on the port, the greedy NMS at
n in {40, 256, 391, 700} against the per-box loop, with tied scores
too (and the JAX blocked fixpoint on tied scores).  On the CPU the NMS wrapper runs its
plain version; the kernel's C source is held against it in
test_torch_kernels_emulated.py, and on the card in test_torch_cuda.py.

One case is pinned to the reference rather than to the JAX package:
MultiBoxTarget with a padding label row, where the JAX scatter lets the
padding row's write undo the forced match (ROADMAP.md, Queue 3).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from incubator_mxnet_tpu import nd as jnd
from incubator_mxnet_tpu.ndarray.ndarray import invoke as jinvoke
from incubator_mxnet_tpu.ops import registry as jreg
from incubator_mxnet_tpu.ops import rcnn as jrcnn

from incubator_mxnet_tpu_torch import nd as tnd, autograd as tag
from incubator_mxnet_tpu_torch.ndarray.ndarray import invoke as tinvoke
from incubator_mxnet_tpu_torch.ops import nms as tnms
from incubator_mxnet_tpu_torch.ops import rcnn as trcnn
from incubator_mxnet_tpu_torch.ops import registry as treg

pytestmark = pytest.mark.torch_port

CPU = "cpu"


def _outs(x):
    return tuple(x) if isinstance(x, (tuple, list)) else (x,)


def _close(got, ref, exact=False, what=""):
    """`got` (port) against `ref` (JAX), numpy: exact for integers and
    `exact`, else within 2e-5 of the reference's scale."""
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    g, r = got.astype(np.float64), ref.astype(np.float64)
    if exact or not np.issubdtype(ref.dtype, np.floating):
        assert np.array_equal(g, r, equal_nan=True), (what, g, r)
        return
    scale = max(1.0, float(np.abs(r[np.isfinite(r)]).max())) \
        if np.isfinite(r).any() else 1.0
    assert np.array_equal(np.isfinite(g), np.isfinite(r)), what
    fin = np.isfinite(r)
    assert np.array_equal(g[~fin], r[~fin]), what
    err = float(np.abs(g[fin] - r[fin]).max()) if fin.any() else 0.0
    assert err <= 2e-5 * scale, (what, err, scale)


def _run_both(op, args, kw):
    jout = _outs(jinvoke(op, *[jnd.array(a) for a in args], **kw))
    tout = _outs(tinvoke(op, *[tnd.array(a, ctx=CPU) for a in args],
                         ctx=CPU, **kw))
    assert len(tout) == len(jout), op
    for t, j in zip(tout, jout):
        assert str(t.dtype).replace("torch.", "") == str(j.dtype), \
            (op, t.dtype, j.dtype)
    return [t.asnumpy() for t in tout], [j.asnumpy() for j in jout]


RS = np.random.RandomState(11)


def _boxes(n, scale=1.0, lead=()):
    ctr = RS.rand(*(lead + (n, 2))) * scale
    wh = RS.rand(*(lead + (n, 2))) * scale * 0.4 + 0.02 * scale
    return np.concatenate([ctr - wh / 2, ctr + wh / 2], -1).astype(
        np.float32)


def _det(B, N, C, ties=False):
    """(B, N, 6) [cls, score, x1, y1, x2, y2] rows; with `ties`, the
    scores take four values."""
    d = np.zeros((B, N, 6), np.float32)
    d[..., 0] = RS.randint(0, C, (B, N))
    d[..., 1] = (RS.randint(0, 4, (B, N)) / 4.0 + 0.1) if ties \
        else RS.rand(B, N)
    d[..., 2:] = _boxes(N, lead=(B,))
    return d


def _labels(B, M, pad=0):
    lab = np.full((B, M + pad, 5), -1.0, np.float32)
    lab[:, :M, 0] = RS.randint(0, 3, (B, M))
    lab[:, :M, 1:] = _boxes(M, lead=(B,))
    return lab


def _rois(R, B, H, W, stride):
    ctr = RS.rand(R, 2) * [W * stride, H * stride]
    wh = RS.rand(R, 2) * [W * stride / 2, H * stride / 2] + 2
    r = np.concatenate([RS.randint(0, B, (R, 1)), ctr - wh / 2,
                        ctr + wh / 2], 1)
    return r.astype(np.float32)


# (op, args, kwargs, exact output positions)
FORWARD = [
    ("box_iou", [_boxes(5), _boxes(7)], {}, ()),
    ("box_iou", [_boxes(6, lead=(2,)), _boxes(3)], {"format": "center"},
     ()),
    ("box_nms", [_det(2, 40, 3)], {"overlap_thresh": 0.3, "id_index": 0},
     (0,)),
    ("box_nms", [_det(2, 40, 3)], {"overlap_thresh": 0.3, "id_index": 0,
                                   "force_suppress": True, "topk": 12},
     (0,)),
    ("box_nms", [_det(3, 50, 4)], {"overlap_thresh": 0.2,
                                   "valid_thresh": 0.4, "id_index": 0,
                                   "background_id": 1}, (0,)),
    ("box_nms", [_det(2, 64, 2, ties=True)], {"overlap_thresh": 0.25,
                                              "id_index": 0}, (0,)),
    ("box_nms", [_det(1, 30, 1)], {"overlap_thresh": 0.4,
                                   "in_format": "center"}, (0,)),
    ("box_encode", [(RS.rand(2, 6) > 0.4).astype(np.float32),
                    RS.randint(0, 3, (2, 6)).astype(np.float32),
                    _boxes(6, lead=(2,)), _boxes(3, lead=(2,))], {}, ()),
    ("box_decode", [RS.randn(2, 6, 4).astype(np.float32) * 0.5,
                    _boxes(6, lead=(2,))], {"std0": 0.1, "std1": 0.1,
                                            "std2": 0.2, "std3": 0.2}, ()),
    ("box_decode", [RS.randn(1, 5, 4).astype(np.float32) * 3,
                    _boxes(5, lead=(1,))], {"clip": 1.5}, ()),
    ("bipartite_matching", [RS.rand(2, 5, 4).astype(np.float32)],
     {"threshold": 0.3}, (0, 1)),
    ("bipartite_matching", [RS.rand(2, 4, 6).astype(np.float32)],
     {"threshold": 0.6, "is_ascend": True, "topk": 3}, (0, 1)),
    ("MultiBoxPrior", [np.zeros((1, 3, 4, 5), np.float32)],
     {"sizes": (0.3, 0.5), "ratios": (1, 2, 0.5)}, ()),
    ("MultiBoxPrior", [np.zeros((1, 3, 3, 3), np.float32)],
     {"sizes": (0.9,), "ratios": (1, 3), "clip": True,
      "steps": (0.25, 0.3), "offsets": (0.4, 0.6)}, ()),
    ("MultiBoxTarget", [None, _labels(3, 2), np.zeros((3, 4, 48),
                                                       np.float32)],
     {"overlap_threshold": 0.3}, (1, 2)),
    ("MultiBoxDetection", [None, RS.randn(2, 48 * 4).astype(np.float32),
                           None], {"nms_threshold": 0.3}, ()),
    ("MultiBoxDetection", [None, RS.randn(2, 48 * 4).astype(np.float32),
                           None], {"force_suppress": True,
                                   "threshold": 0.3, "nms_topk": 20,
                                   "clip": False}, ()),
    ("ROIAlign", [RS.randn(2, 3, 10, 12).astype(np.float32),
                  _rois(7, 2, 10, 12, 4)],
     {"pooled_size": (3, 4), "spatial_scale": 0.25}, ()),
    ("ROIAlign", [RS.randn(1, 2, 9, 9).astype(np.float32),
                  _rois(40, 1, 9, 9, 1)],
     {"pooled_size": (2, 2), "sample_ratio": 3, "aligned": True}, ()),
    ("ROIPooling", [RS.randn(2, 3, 8, 8).astype(np.float32),
                    _rois(5, 2, 8, 8, 2)],
     {"pooled_size": (2, 3), "spatial_scale": 0.5}, ()),
    ("BilinearResize2D", [RS.randn(2, 2, 4, 5).astype(np.float32)],
     {"height": 8, "width": 7}, ()),
    ("BilinearResize2D", [RS.randn(1, 3, 9, 8).astype(np.float32)],
     {"height": 4, "width": 3}, ()),
    ("BilinearResize2D", [RS.randn(1, 1, 6, 6).astype(np.float32)],
     {"scale_height": 1.5, "scale_width": 0.5, "mode": "scale"}, ()),
    ("AdaptiveAvgPooling2D", [RS.randn(2, 3, 8, 8).astype(np.float32)],
     {"output_size": (2, 4)}, ()),
    ("AdaptiveAvgPooling2D", [RS.randn(2, 3, 7, 5).astype(np.float32)],
     {"output_size": 3}, ()),
    ("count_sketch", [RS.randn(3, 6).astype(np.float32),
                      np.array([0, 3, 1, 3, 2, 0], np.float32),
                      np.array([1, -1, 1, 1, -1, 1], np.float32)],
     {"out_dim": 4}, ()),
    ("index_copy", [RS.randn(5, 3).astype(np.float32),
                    np.array([4, 0], np.float32),
                    RS.randn(2, 3).astype(np.float32)], {}, (0,)),
    ("getnnz", [np.array([[0, 1, 0], [2, 0, 3]], np.float32)], {}, (0,)),
    ("getnnz", [np.array([[0, 1, 0], [2, 0, 3]], np.float32)], {"axis": 0},
     (0,)),
    ("interleaved_matmul_selfatt_qk", [RS.randn(4, 2, 48).astype(
        np.float32)], {"heads": 2}, ()),
    ("interleaved_matmul_selfatt_valatt",
     [RS.randn(4, 2, 48).astype(np.float32),
      RS.rand(4, 4, 4).astype(np.float32)], {"heads": 2}, ()),
]


def _fill(op, args):
    """MultiBox cases take the anchors of a 4x4 map (48 of them) and
    softmaxed class scores."""
    args = list(args)
    anchors = jinvoke("MultiBoxPrior", jnd.array(np.zeros((1, 3, 4, 4),
                                                          np.float32)),
                      sizes=(0.3, 0.45), ratios=(1, 2)).asnumpy()
    if op == "MultiBoxTarget":
        args[0] = anchors
    if op == "MultiBoxDetection":
        logits = np.random.RandomState(5).randn(2, 3, 48)
        p = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
        args[0], args[2] = p.astype(np.float32), anchors
    return args


@pytest.mark.parametrize("i", range(len(FORWARD)),
                         ids=["%s-%d" % (c[0], i)
                              for i, c in enumerate(FORWARD)])
def test_op_matches_jax(i):
    op, args, kw, exact = FORWARD[i]
    got, ref = _run_both(op, _fill(op, args), kw)
    for k, (g, r) in enumerate(zip(got, ref)):
        _close(g, r, exact=k in exact, what="%s output %d" % (op, k))


def test_box_nms_keeps_exactly_the_jax_boxes():
    """Which rows box_nms keeps, class-aware and forced, equals the JAX
    op's row for row (a flipped IoU decision changes a whole row)."""
    for kw in ({"overlap_thresh": 0.3, "id_index": 0},
               {"overlap_thresh": 0.1, "id_index": 0,
                "force_suppress": True}):
        for ties in (False, True):
            got, ref = _run_both("box_nms", [_det(4, 80, 3, ties=ties)], kw)
            assert (got[0][..., 1] >= 0).sum() > 4
            np.testing.assert_array_equal(got[0][..., 1] >= 0,
                                          ref[0][..., 1] >= 0)


def _proposal_inputs(N, A, H, W, seed):
    rs = np.random.RandomState(seed)
    logits = rs.randn(N, 2, A, H, W)
    p = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    cls = p.reshape(N, 2 * A, H, W).astype(np.float32)
    box = (rs.randn(N, 4 * A, H, W) * 0.2).astype(np.float32)
    im_info = np.tile([H * 4.0, W * 4.0, 1.0], (N, 1)).astype(np.float32)
    return cls, box, im_info


PROPOSAL_KW = dict(rpn_pre_nms_top_n=60, rpn_post_nms_top_n=16,
                   threshold=0.6, rpn_min_size=3, scales=(2, 4),
                   ratios=(0.5, 1, 2), feature_stride=4)


@pytest.mark.parametrize("op,extra", [
    ("_contrib_Proposal", {}), ("_contrib_MultiProposal", {}),
    ("_contrib_Proposal", {"output_score": True}),
    ("_contrib_Proposal", {"rpn_min_size": 12, "threshold": 0.3})])
def test_proposal_matches_jax(op, extra):
    args = _proposal_inputs(2, 6, 5, 6, seed=3)
    kw = dict(PROPOSAL_KW, **extra)
    got, ref = _run_both(op, args, kw)
    # rois: which are padding exactly, the boxes within 2e-5 of scale
    np.testing.assert_array_equal(got[0][:, 1] < 0, ref[0][:, 1] < 0)
    _close(got[0][:, 0], ref[0][:, 0], exact=True)
    for g, r in zip(got, ref):
        _close(g, r)


def test_proposal_target_matches_jax():
    rs = np.random.RandomState(4)
    rois = _rois(24, 2, 8, 8, 4)
    rois[-3:, 1:] = -1.0                       # padded proposals
    gt = np.full((2, 3, 5), -1.0, np.float32)
    gt[:, :2, :4] = _rois(4, 1, 8, 8, 4)[:, 1:].reshape(2, 2, 4)
    gt[:, :2, 4] = rs.randint(0, 3, (2, 2))
    kw = dict(num_classes=4, batch_images=2, batch_rois=16,
              fg_fraction=0.25, fg_overlap=0.3)
    got, ref = _run_both("_contrib_ProposalTarget", [rois, gt], kw)
    for k in (0, 1, 3):
        _close(got[k], ref[k], exact=True, what=k)
    _close(got[2], ref[2])
    assert (got[1] > 0).any() and (got[1] == 0).any()


# --- gradients against jax.vjp ---------------------------------------------

GRADS = [
    ("ROIAlign", [RS.randn(2, 3, 10, 12).astype(np.float32),
                  _rois(9, 2, 10, 12, 4)],
     {"pooled_size": (3, 3), "spatial_scale": 0.25}, (0,)),
    ("ROIAlign", [RS.randn(1, 2, 9, 9).astype(np.float32),
                  _rois(35, 1, 9, 9, 1)],
     {"pooled_size": (2, 2), "aligned": True}, (0,)),
    ("ROIPooling", [RS.randn(2, 3, 8, 8).astype(np.float32),
                    _rois(5, 2, 8, 8, 2)],
     {"pooled_size": (2, 2), "spatial_scale": 0.5}, (0,)),
    ("BilinearResize2D", [RS.randn(2, 2, 4, 5).astype(np.float32)],
     {"height": 7, "width": 9}, (0,)),
    ("BilinearResize2D", [RS.randn(1, 2, 9, 8).astype(np.float32)],
     {"height": 4, "width": 3}, (0,)),
    ("AdaptiveAvgPooling2D", [RS.randn(2, 3, 7, 5).astype(np.float32)],
     {"output_size": (3, 2)}, (0,)),
    ("box_decode", [RS.randn(2, 6, 4).astype(np.float32) * 0.5,
                    _boxes(6, lead=(2,))], {"std2": 0.2, "clip": 0.3},
     (0, 1)),
    ("box_encode", [(RS.rand(2, 6) > 0.4).astype(np.float32),
                    RS.randint(0, 3, (2, 6)).astype(np.float32),
                    _boxes(6, lead=(2,)), _boxes(3, lead=(2,))], {}, (2, 3)),
    ("interleaved_matmul_selfatt_qk",
     [RS.randn(4, 2, 48).astype(np.float32)], {"heads": 2}, (0,)),
    ("interleaved_matmul_selfatt_valatt",
     [RS.randn(4, 2, 48).astype(np.float32),
      RS.rand(4, 4, 4).astype(np.float32)], {"heads": 2}, (0, 1)),
]


@pytest.mark.parametrize("i", range(len(GRADS)),
                         ids=["%s-%d" % (c[0], i)
                              for i, c in enumerate(GRADS)])
def test_gradient_matches_jax_vjp(i):
    """The gradient of the first output against one seeded cotangent; the
    registry functions are called directly (box_encode is registered
    non-differentiable in both, its arithmetic is not)."""
    op, args, kw, argnums = GRADS[i]
    jfn, tfn = jreg.get(op).fn, treg.get(op).fn

    def jf(*xs):
        full = [jnp.asarray(a) for a in args]
        for k, x in zip(argnums, xs):
            full[k] = x
        return _outs(jfn(*full, **kw))[0]
    jout, vjp = jax.vjp(jf, *[jnp.asarray(args[k]) for k in argnums])
    cot = np.random.RandomState(i).uniform(-1, 1, jout.shape).astype(
        np.float32)
    jgrads = vjp(jnp.asarray(cot))
    targs = [torch.from_numpy(a.copy()) for a in args]
    for k in argnums:
        targs[k].requires_grad_(True)
    tout = _outs(tfn(*targs, **kw))[0]
    _close(tout.detach().numpy(), np.asarray(jout), what="output")
    tgrads = torch.autograd.grad(tout, [targs[k] for k in argnums],
                                 torch.from_numpy(cot))
    for k, tg, jg in zip(argnums, tgrads, jgrads):
        _close(tg.numpy(), np.asarray(jg), what="grad of input %d" % k)


def test_roialign_bf16_matches_jax_bf16():
    """bf16 features: bf16 matrices, f32 accumulation, each product
    rounded to bf16, as the JAX op casts; within two bf16 ulps of the
    scale."""
    data = RS.randn(2, 4, 10, 12).astype(np.float32)
    rois = _rois(9, 2, 10, 12, 4)
    kw = dict(pooled_size=(3, 3), spatial_scale=0.25)
    j = jinvoke("ROIAlign", jnd.array(data, dtype="bfloat16"),
                jnd.array(rois), **kw)
    t = tinvoke("ROIAlign", tnd.array(data, ctx=CPU, dtype="bfloat16"),
                tnd.array(rois, ctx=CPU), **kw)
    assert t.dtype == torch.bfloat16 and str(j.dtype) == "bfloat16"
    g, r = t.asnumpy().astype(np.float64), j.asnumpy().astype(np.float64)
    assert np.abs(g - r).max() <= 2 * 2 ** -8 * np.abs(r).max()


def test_roialign_and_softmax_ce_take_float64_arithmetic():
    """float64 features and logits keep float64 arithmetic (the JAX
    package has no float64; the port's rule, which a float64 check of a
    whole training step needs).  ROIAlign is linear in its data: a
    1e-10 change of features near 1, lost entirely in f32, pools to the
    change's own pooling within 1e-5 of its scale; and its sample
    coordinates are float64: rois moved by 1e-9 pixel, lost in f32,
    move the pooled values by at most 1e-8 of scale, but move them.  The
    fused softmax
    cross-entropy and its gradient equal torch's float64 cross-entropy
    within 1e-13 of scale."""
    from incubator_mxnet_tpu_torch.ops import contrib as tcontrib
    from incubator_mxnet_tpu_torch.ops import nn as tnn
    rs = np.random.RandomState(23)
    base = torch.tensor(1.0 + rs.rand(2, 4, 10, 12))
    step = torch.tensor(rs.randn(2, 4, 10, 12))
    rois = torch.from_numpy(_rois(9, 2, 10, 12, 4))
    kw = dict(pooled_size=(3, 3), spatial_scale=0.25)
    out = tcontrib.roi_align(base + 1e-10 * step, rois, **kw)
    assert out.dtype == torch.float64
    moved = (out - tcontrib.roi_align(base, rois, **kw)) / 1e-10
    want = tcontrib.roi_align(step, rois, **kw)
    assert (moved - want).abs().max().item() \
        <= 1e-5 * want.abs().max().item()
    shifted = rois.double()
    shifted[:, 1:] += 1e-9
    diff = (tcontrib.roi_align(base, shifted, **kw)
            - tcontrib.roi_align(base, rois.double(), **kw)).abs().max()
    assert 0 < diff.item() <= 1e-8 * out.abs().max().item()
    pred = torch.tensor(rs.randn(6, 5) * 3, requires_grad=True)
    label = torch.from_numpy(rs.randint(0, 5, 6).astype(np.float32))
    loss = tnn.fused_softmax_ce(pred, label)
    ref = torch.nn.functional.cross_entropy(pred, label.long(),
                                            reduction="none")
    assert loss.dtype == torch.float64
    assert (loss - ref).abs().max().item() <= 1e-13 * ref.abs().max().item()
    dy = torch.tensor(rs.randn(6))
    got, = torch.autograd.grad(loss, pred, dy)
    want, = torch.autograd.grad(ref, pred, dy)
    assert got.dtype == torch.float64
    assert (got - want).abs().max().item() <= 1e-13 * want.abs().max().item()


# --- the JAX package's op tests, on the port --------------------------------


def _t(a, **kw):
    return tnd.array(np.asarray(a, np.float32), ctx=CPU, **kw)


def test_box_iou_known_values():
    iou = tnd.contrib.box_iou(_t([[0, 0, 2, 2]]),
                              _t([[1, 1, 3, 3], [0, 0, 2, 2],
                                  [5, 5, 6, 6]])).asnumpy()
    assert iou[0, 0] == pytest.approx(1.0 / 7.0, rel=1e-6)
    assert iou[0, 1] == 1.0 and iou[0, 2] == 0.0


def test_box_nms_suppression_force_and_topk():
    det = _t([[[0, 0.9, 0, 0, 1, 1], [0, 0.8, 0.05, 0.05, 1, 1],
               [1, 0.7, 0.8, 0.8, 1.5, 1.5], [0, 0.05, 0, 0, 0.1, 0.1]]])
    s = tnd.contrib.box_nms(det, overlap_thresh=0.5, valid_thresh=0.1,
                            id_index=0).asnumpy()[0, :, 1]
    assert s[0] == pytest.approx(0.9) and s[1] == -1
    assert s[2] == pytest.approx(0.7) and s[3] == -1
    s2 = tnd.contrib.box_nms(det, overlap_thresh=0.01, valid_thresh=0.1,
                             id_index=0, force_suppress=True).asnumpy()
    assert (s2[0, 1:, 1] <= 0.7).all()
    n = 8
    far = np.zeros((1, n, 6), np.float32)
    far[0, :, 1] = np.linspace(0.9, 0.2, n)
    for i in range(n):
        far[0, i, 2:] = [i * 10, 0, i * 10 + 1, 1]
    out = tnd.contrib.box_nms(_t(far), topk=3, id_index=0).asnumpy()
    assert (out[0, :3, 1] > 0).all() and (out[0, 3:, 1] == -1).all()


def test_multibox_prior_first_anchor():
    a = tnd.contrib.MultiBoxPrior(tnd.zeros((1, 3, 2, 2), ctx=CPU),
                                  sizes=(0.5,), ratios=(1.0,)).asnumpy()
    assert a.shape == (1, 4, 4)
    np.testing.assert_allclose(a[0, 0], [0.0, 0.0, 0.5, 0.5], atol=1e-6)


def _padding_case():
    anchors = tnd.contrib.MultiBoxPrior(tnd.zeros((1, 3, 4, 4), ctx=CPU),
                                        sizes=(0.3,), ratios=(1.0,))
    label = np.array([[[0, 0, 0, 0.2, 0.2], [-1, 0, 0, 0, 0]]], np.float32)
    return anchors, label


def test_multibox_target_padding_row_keeps_the_forced_match():
    """On a 4x4 map of size-0.3 priors, gt [0, 0, .2, .2] overlaps anchor
    0 below the threshold, so only its forced match makes a positive.
    With a padding row after it, the JAX package's scatter writes the
    padding row's False over anchor 0 (its column is all -1, so its
    argmax is anchor 0) and no anchor is positive; the reference forces a
    match for every valid gt (multibox_target.cc), as the port does.
    Without the padding row both agree."""
    anchors, label = _padding_case()
    cls_pred = np.zeros((1, 2, anchors.shape[1]), np.float32)
    _, _, ct = tnd.contrib.MultiBoxTarget(anchors, _t(label), _t(cls_pred))
    ct = ct.asnumpy()
    assert ct[0, 0] == 1 and (ct == 1).sum() == 1
    jct = jinvoke("MultiBoxTarget", jnd.array(anchors.asnumpy()),
                  jnd.array(label), jnd.array(cls_pred))[2].asnumpy()
    assert (jct == 1).sum() == 0               # the reference's fault
    got, ref = _run_both("MultiBoxTarget",
                         [anchors.asnumpy(), label[:, :1], cls_pred], {})
    for g, r in zip(got, ref):
        _close(g, r)
    assert got[2][0, 0] == 1


def test_multibox_target_and_detection_shapes():
    anchors = tnd.contrib.MultiBoxPrior(tnd.zeros((1, 3, 4, 4), ctx=CPU),
                                        sizes=(0.3,), ratios=(1.0,))
    N = anchors.shape[1]
    label = _t([[[0, 0.1, 0.1, 0.4, 0.4], [-1, 0, 0, 0, 0]]])
    loc_t, loc_m, cls_t = tnd.contrib.MultiBoxTarget(
        anchors, label, tnd.zeros((1, 2, N), ctx=CPU))
    assert loc_t.shape == (1, N * 4) and cls_t.shape == (1, N)
    ct = cls_t.asnumpy()
    assert (ct == 1).sum() >= 1 and (ct == 0).sum() > 0
    det = tnd.contrib.MultiBoxDetection(
        _t(np.random.RandomState(0).rand(1, 2, N)), tnd.zeros((1, N * 4),
                                                              ctx=CPU),
        anchors)
    assert det.shape == (1, N, 6)


def test_roialign_constant_image_and_gradient():
    out = tnd.contrib.ROIAlign(tnd.ones((1, 1, 8, 8), ctx=CPU) * 3.0,
                               _t([[0, 1, 1, 5, 5]]), pooled_size=(2, 2),
                               spatial_scale=1.0).asnumpy()
    np.testing.assert_allclose(out, np.full((1, 1, 2, 2), 3.0), rtol=1e-6)
    x = _t(np.random.RandomState(0).randn(1, 2, 8, 8))
    x.attach_grad()
    with tag.record():
        tnd.contrib.ROIAlign(x, _t([[0, 0, 0, 4, 4]]),
                             pooled_size=(2, 2)).sum().backward()
    assert float(x.grad.norm().asscalar()) > 0
    # a padded roi (batch index -1) pools to zeros
    pad = tnd.contrib.ROIAlign(x, _t([[-1, 0, 0, 4, 4]]), pooled_size=(2, 2))
    assert (pad.asnumpy() == 0).all()


def test_roi_pooling_max_and_adaptive_pooling():
    img = _t(np.arange(16).reshape(1, 1, 4, 4))
    out = tnd.ROIPooling(img, _t([[0, 0, 0, 3, 3]]), pooled_size=(2, 2),
                         spatial_scale=1.0).asnumpy()
    assert out[0, 0, 1, 1] == 15.0
    x = np.random.RandomState(1).randn(2, 3, 8, 8).astype(np.float32)
    out = tnd.contrib.AdaptiveAvgPooling2D(_t(x), output_size=(2, 2))
    np.testing.assert_allclose(
        out.asnumpy(), x.reshape(2, 3, 2, 4, 2, 4).mean(axis=(3, 5)),
        rtol=1e-5, atol=1e-6)
    assert tnd.contrib.AdaptiveAvgPooling2D(
        _t(x), output_size=(3, 3)).shape == (2, 3, 3, 3)
    assert tnd.contrib.BilinearResize2D(
        _t(x[:1, :1, :4, :4]), height=8, width=8).shape == (1, 1, 8, 8)


def test_box_decode_of_zero_deltas_is_the_anchor():
    anchors = _t([[[0.2, 0.2, 0.6, 0.6]]])
    dec = tnd.contrib.box_decode(tnd.zeros((1, 1, 4), ctx=CPU), anchors)
    np.testing.assert_allclose(dec.asnumpy(), anchors.asnumpy(), atol=1e-7)


def test_interleaved_attention_shapes():
    T, B, H, d = 4, 2, 2, 8
    qkv = _t(np.random.RandomState(2).randn(T, B, 3 * H * d))
    att = tnd.interleaved_matmul_selfatt_qk(qkv, heads=H)
    assert att.shape == (B * H, T, T)
    out = tnd.interleaved_matmul_selfatt_valatt(
        qkv, tnd.softmax(att, axis=-1), heads=H)
    assert out.shape == (T, B, H * d)


# --- test_rcnn.py, on the port ---------------------------------------------


def test_make_anchors_and_bbox_transform_inv_match_jax():
    a = trcnn._make_anchors(16, scales=(8, 16), ratios=(0.5, 1, 2))
    np.testing.assert_array_equal(a, jrcnn._make_anchors(16, (8, 16),
                                                         (0.5, 1, 2)))
    cx = (a[:, 0] + a[:, 2]) / 2
    assert np.allclose(cx, cx[0])
    boxes = np.array([[0.0, 0.0, 15.0, 15.0], [10.0, 10.0, 29.0, 19.0]],
                     np.float32)
    deltas = RS.randn(2, 4).astype(np.float32)
    _close(trcnn._bbox_transform_inv(torch.from_numpy(boxes),
                                     torch.from_numpy(deltas)).numpy(),
           np.asarray(jrcnn._bbox_transform_inv(jnp.asarray(boxes),
                                                jnp.asarray(deltas))))
    out = trcnn._bbox_transform_inv(torch.from_numpy(boxes),
                                    torch.zeros(2, 4))
    np.testing.assert_allclose(out.numpy(), boxes, atol=1e-5)


def test_proposal_zero_deltas_returns_clipped_anchors():
    A, H, W, stride = 6, 4, 4, 16
    cls = np.zeros((1, 2 * A, H, W), np.float32)
    cls[0, A + 2, 1, 2] = 10.0
    box = np.zeros((1, 4 * A, H, W), np.float32)
    rois = tinvoke("_contrib_Proposal", _t(cls), _t(box),
                   _t([[64, 64, 1.0]]), rpn_pre_nms_top_n=32,
                   rpn_post_nms_top_n=8, rpn_min_size=0, scales=(4, 8),
                   ratios=(0.5, 1, 2), feature_stride=stride).asnumpy()
    assert rois.shape == (8, 5)
    want = trcnn._make_anchors(stride, (4, 8), (0.5, 1, 2))[2] + np.array(
        [2 * stride, stride, 2 * stride, stride])
    np.testing.assert_allclose(rois[0, 1:], np.clip(want, 0, 63), atol=1e-5)


def test_proposal_nms_suppresses_duplicates():
    cls = np.zeros((1, 2, 2, 2), np.float32)
    cls[0, 1, 0, 0] = cls[0, 1, 0, 1] = 5.0
    rois = tinvoke("_contrib_Proposal", _t(cls), _t(np.zeros((1, 4, 2, 2))),
                   _t([[32, 32, 1.0]]), rpn_pre_nms_top_n=4,
                   rpn_post_nms_top_n=4, rpn_min_size=0, scales=(4,),
                   ratios=(1,), threshold=0.3, feature_stride=4).asnumpy()
    kept = rois[rois[:, 1] >= 0][:, 1:]
    assert 1 <= len(kept) < 4
    assert len({tuple(r) for r in kept.tolist()}) == len(kept)


def test_proposal_target_labels_targets_and_gt_append():
    rois = _t([[0, 5, 5, 30, 30], [0, 6, 6, 31, 31], [0, 50, 50, 60, 60],
               [0, 0, 0, 3, 3]])
    gt = _t([[[5, 5, 30, 30, 0]]])
    r, labels, targets, weights = tinvoke(
        "_contrib_ProposalTarget", rois, gt, num_classes=4, batch_images=1,
        batch_rois=4, fg_fraction=0.5, fg_overlap=0.5)
    assert labels.asnumpy().tolist() == [1, 1, 0, 0]
    w = weights.asnumpy()
    assert w[0].sum() == 4 and w[1].sum() == 4 and w[2:].sum() == 0
    t = targets.asnumpy()
    assert np.isfinite(t).all() and np.abs(t[0]).max() < 1e-6
    # no roi overlaps the gt: the appended gt is the foreground
    r, labels, _, _ = tinvoke(
        "_contrib_ProposalTarget", _t([[0, 50, 50, 60, 60], [0, 0, 0, 3, 3]]),
        _t([[[5, 5, 30, 30, 2]]]), num_classes=4, batch_images=1,
        batch_rois=4, fg_fraction=0.25, fg_overlap=0.5)
    ln = labels.asnumpy()
    assert (ln == 3).sum() == 1
    assert r.asnumpy()[int(np.argmax(ln == 3)), 1:].tolist() == [5, 5, 30, 30]


def _greedy_np(boxes, scores, thresh, topk):
    """The per-box greedy loop (test_rcnn.py's), numpy f32."""
    order = np.argsort(-scores, kind="stable")
    b = boxes[order]
    n = len(b)
    area = np.maximum(b[:, 2] - b[:, 0] + 1, 0) * \
        np.maximum(b[:, 3] - b[:, 1] + 1, 0)
    keep = np.ones(n, bool)
    for i in range(n):
        if not keep[i]:
            continue
        tl = np.maximum(b[i, :2], b[:, :2])
        br = np.minimum(b[i, 2:4], b[:, 2:4])
        wh = np.maximum(br - tl + 1, 0)
        inter = wh[:, 0] * wh[:, 1]
        iou = inter / np.maximum(area[i] + area - inter, np.float32(1e-12))
        keep &= ~((iou > np.float32(thresh)) & (np.arange(n) > i))
    idx = np.where(keep)[0][:topk]
    return order, np.pad(idx, (0, topk - len(idx)), constant_values=-1)


@pytest.mark.parametrize("n", [40, 256, 391, 700])
@pytest.mark.parametrize("ties", [False, True])
def test_nms_keep_matches_greedy_loop(n, ties):
    """The port's `_nms_keep` (the kernel's plain version on the CPU)
    equals the per-box greedy loop: order and kept positions, at n
    below, at and above the JAX block of 256.  With tied scores (8
    values) the stable order decides, as argsort's does; at n 391 (a
    full block and a ragged one) the JAX blocked fixpoint is held to the
    same loop on them too (test_rcnn.py holds it on distinct scores)."""
    rs = np.random.RandomState(7 + n + ties)
    ctr = rs.rand(n, 2) * 200
    wh = rs.rand(n, 2) * 80 + 5
    boxes = np.concatenate([ctr - wh / 2, ctr + wh / 2], 1).astype(np.float32)
    scores = (rs.randint(0, 8, n) / 8.0 if ties else rs.rand(n)).astype(
        np.float32)
    for thresh in (0.3, 0.7):
        o_ref, k_ref = _greedy_np(boxes, scores, thresh, 64)
        o_got, k_got = trcnn._nms_keep(torch.from_numpy(boxes)[None],
                                       torch.from_numpy(scores)[None],
                                       thresh, 64)
        np.testing.assert_array_equal(o_got[0].numpy(), o_ref)
        np.testing.assert_array_equal(k_got[0].numpy(), k_ref)
        if not (ties and n == 391):
            continue
        o_j, k_j = jrcnn._nms_keep(jnp.asarray(boxes), jnp.asarray(scores),
                                   thresh, 64)
        np.testing.assert_array_equal(np.asarray(o_j), o_ref)
        np.testing.assert_array_equal(np.asarray(k_j), k_ref)


def test_nms_sorted_plain_conventions_and_first_kept():
    """Corner and +1 IoU, class-aware, `valid`, and the topk positions of
    the plain version against a direct loop over pairs."""
    rs = np.random.RandomState(3)
    B, N = 3, 50
    boxes = torch.from_numpy(_boxes(N, scale=20.0, lead=(B,)))
    cls = torch.from_numpy(rs.randint(0, 3, (B, N)).astype(np.float32))
    valid = torch.from_numpy(rs.rand(B, N) > 0.2)
    for plus_one in (False, True):
        iou_fn = tnms.iou_plus_one if plus_one else tnms.iou_corner
        keep, idx = tnms.nms_sorted(boxes, valid, 0.2, cls=cls,
                                    plus_one=plus_one, topk=10)
        for b in range(B):
            iou = iou_fn(boxes[b], boxes[b]).numpy()
            want = np.zeros(N, bool)
            for i in range(N):
                if valid[b, i] and not any(
                        want[j] and iou[j, i] > np.float32(0.2)
                        and cls[b, j] == cls[b, i] for j in range(i)):
                    want[i] = True
            np.testing.assert_array_equal(keep[b].numpy(), want)
            pos = np.where(want)[0][:10]
            np.testing.assert_array_equal(
                idx[b].numpy(), np.pad(pos, (0, 10 - len(pos)),
                                       constant_values=-1))


def test_nms_positions_only_mode():
    """`positions_only` returns just the first `topk` kept positions, as
    the full pass gives them (reached and not), and needs `topk` > 0."""
    rs = np.random.RandomState(4)
    boxes = torch.from_numpy(_boxes(60, scale=20.0, lead=(2,)))
    valid = torch.from_numpy(rs.rand(2, 60) > 0.3)
    for topk in (3, 60):
        for plus_one in (False, True):
            idx = tnms.nms_sorted(boxes, valid, 0.3, plus_one=plus_one,
                                  topk=topk, positions_only=True)
            _, want = tnms.nms_sorted(boxes, valid, 0.3, plus_one=plus_one,
                                      topk=topk)
            assert torch.equal(idx, want)
    with pytest.raises(ValueError, match="topk"):
        tnms.nms_sorted(boxes, None, 0.3, positions_only=True)


def test_nms_is_captured_by_the_cpu_recorder():
    """The plain NMS reads no device value on the host: a capture records
    it and a replay on new boxes gives the new greedy result."""
    from incubator_mxnet_tpu_torch import graph_capture
    boxes = torch.from_numpy(_boxes(30, scale=10.0, lead=(2,)))
    prog, (keep, idx) = graph_capture.capture(
        lambda: tnms.nms_sorted(boxes, None, 0.3, plus_one=True, topk=8),
        "cpu")
    new = torch.from_numpy(_boxes(30, scale=10.0, lead=(2,)))
    boxes.copy_(new)
    prog.replay()
    want_keep, want_idx = tnms.nms_sorted(new, None, 0.3, plus_one=True,
                                          topk=8)
    assert torch.equal(keep, want_keep) and torch.equal(idx, want_idx)


def test_nms_wrapper_refuses_other_devices():
    with pytest.raises(ValueError, match="CUDA or CPU"):
        tnms.nms_sorted(torch.zeros(1, 2, 4, device="meta"), None, 0.5)
