"""PyTorch port: the detection models (`models/ssd.py`,
`models/faster_rcnn.py`) against the JAX package on the CPU.

`ssd_toy` (2 classes, 2 x 3 x 32 x 32 images, two gt boxes each) and
`faster_rcnn_toy` (3 classes, 2 x 3 x 64 x 64 images, im_info [64, 64,
1], two gt boxes each, 8 sampled rois) are built in JAX, their weights
carried into the port by structural name: an inference forward, then
two SGD steps (lr 0.01, momentum 0.9) of `SSDTrainLoss` and of the
Faster R-CNN training forward + `RCNNTrainLoss`, the JAX side op by op
(not hybridized), as the port runs.  Loss, every gradient and every
parameter after each step are held to 2e-5 of their scale; sampled rois,
labels and the NMS selections exactly.  The RCNN test prints its
smallest score gap among the pre-NMS anchors and its smallest
|IoU - threshold| among their pairs, so that a flipped selection can be
explained.  Hybridized (the CPU recorder of `graph_capture`), both
nets and losses run three steps bit for bit as the eager port.  The
full-width `ssd_512_vgg16` and `faster_rcnn_resnet50_v1b` are held by
their parameters' names and shapes only (JAX's abstract `infer_shape`,
no forward).
"""
import numpy as np
import pytest
import torch

from incubator_mxnet_tpu import autograd as jag, gluon as jgluon, nd as jnd
from incubator_mxnet_tpu import random as jrandom
from incubator_mxnet_tpu import models as jmodels
from incubator_mxnet_tpu.gluon.block import nameless_scope

import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch import models as tmodels
from incubator_mxnet_tpu_torch.ops import nms as tnms
from incubator_mxnet_tpu_torch.ops import rcnn as trcnn

pytestmark = pytest.mark.torch_port

SGD = {"learning_rate": 0.01, "momentum": 0.9}
STEPS = 2
TOL = 2e-5


def _scaled(got, ref, what, tol=TOL):
    err = float(np.abs(np.asarray(got, np.float64) - ref).max())
    scale = max(1.0, float(np.abs(ref).max()))
    assert err <= tol * scale, (what, err, scale)


def _params_np(net):
    return {n: p.data().asnumpy()
            for n, p in net._collect_params_with_prefix().items()}


# --- SSD -------------------------------------------------------------------

def _ssd_data():
    rs = np.random.RandomState(0)
    x = rs.randn(2, 3, 32, 32).astype(np.float32)
    y = np.zeros((2, 2, 5), np.float32)
    y[:, 0] = [0, 0.1, 0.15, 0.55, 0.6]
    y[:, 1] = [1, 0.4, 0.3, 0.9, 0.85]
    return x, y


def _jax_ssd_run(net, loss_b, x, y):
    params = net._collect_params_with_prefix()
    trainer = jgluon.Trainer(net.collect_params(), "sgd", dict(SGD))
    steps = []
    for _ in range(STEPS):
        with jag.record():
            anchors, cls_preds, box_preds = net(jnd.array(x))
            loss = loss_b(anchors, cls_preds, box_preds, jnd.array(y))
            loss.backward()
        grads = {n: p.grad().asnumpy() for n, p in params.items()
                 if p.grad_req != "null"}
        trainer.step(x.shape[0])
        steps.append(dict(loss=loss.asnumpy(), grads=grads,
                          after=_params_np(net)))
    return steps


def _port_step_fn(net, loss_b, trainer, make_loss):
    params = net.collect_params()

    def step():
        with tmx.autograd.record():
            loss = make_loss()
        tmx.autograd.backward(loss)
        grads = {n: p.grad.detach().numpy().copy()
                 for n, p in params.items()
                 if p.requires_grad and p.grad is not None}
        trainer.step(2)
        return dict(loss=loss.detach().numpy(), grads=grads,
                    after={n: p.detach().numpy().copy()
                           for n, p in params.items()})
    return step


@pytest.fixture(scope="module")
def ssd_runs():
    x, y = _ssd_data()
    jrandom.seed(0)
    with nameless_scope():
        jnet = jmodels.ssd_toy(classes=2)
        jnet.initialize()
        jloss = jmodels.SSDTrainLoss()
    pred = [o.asnumpy() for o in jnet(jnd.array(x))]
    init = _params_np(jnet)
    steps = _jax_ssd_run(jnet, jloss, x, y)
    return x, y, init, pred, steps


def _port_ssd(init, hybrid=False):
    net = tmodels.ssd_toy(classes=2)
    tmx.weights.load_reference_params(net, init, device="cpu")
    loss_b = tmodels.SSDTrainLoss()
    if hybrid:
        net.hybridize()
        loss_b.hybridize()
    trainer = tmx.gluon.Trainer(net.collect_params(), "sgd", dict(SGD))
    return net, loss_b, trainer


def _ssd_steps(init, x, y, hybrid=False, steps=STEPS):
    net, loss_b, trainer = _port_ssd(init, hybrid)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    step = _port_step_fn(net, loss_b, trainer,
                         lambda: loss_b(*net(tx), ty))
    return [step() for _ in range(steps)], net, loss_b, trainer


def test_ssd_toy_forward_matches_jax(ssd_runs):
    x, _, init, pred, _ = ssd_runs
    net, _, _ = _port_ssd(init)
    with torch.no_grad():
        out = net(torch.from_numpy(x))
    assert [tuple(o.shape) for o in out] == [p.shape for p in pred]
    for o, p, what in zip(out, pred, ("anchors", "cls", "box")):
        _scaled(o.numpy(), p, what)


def _hold_steps(got_steps, ref_steps):
    for k, (got, ref) in enumerate(zip(got_steps, ref_steps)):
        _scaled(got["loss"], ref["loss"], ("loss", k))
        # a parameter the loss does not reach has no torch gradient in the
        # port (ROADMAP.md, Queue 1 item 2) and a zero one in JAX
        for n, g in ref["grads"].items():
            if n in got["grads"]:
                _scaled(got["grads"][n], g, ("grad", k, n))
            else:
                assert not g.any(), ("grad", k, n)
        for n, a in ref["after"].items():
            _scaled(got["after"][n], a, ("param", k, n))


def test_ssd_toy_sgd_steps_match_jax(ssd_runs):
    x, y, init, _, ref_steps = ssd_runs
    steps = _ssd_steps(init, x, y)[0]
    assert len(steps[0]["grads"]) == len(ref_steps[0]["grads"])
    _hold_steps(steps, ref_steps)


def test_ssd_toy_hybridized_is_bit_for_bit_eager(ssd_runs):
    """Three steps: eager, capture, replay; the hybridized net and loss
    replay what the eager port computes, bit for bit."""
    x, y, init, _, _ = ssd_runs
    eager = _ssd_steps(init, x, y, steps=3)[0]
    hyb, net, loss_b, _ = _ssd_steps(init, x, y, hybrid=True, steps=3)
    cg = net.__dict__["_cached_graph"]
    assert (cg.eager_calls, cg.captures, cg.replays) == (1, 2, 2)
    assert loss_b.__dict__["_cached_graph"].replays == 2
    for e, h in zip(eager, hyb):
        assert np.array_equal(e["loss"], h["loss"])
        for n in e["after"]:
            assert np.array_equal(e["after"][n], h["after"][n]), n


def test_ssd_training_targets_and_detection():
    """The MultiBoxTarget front on NDArrays, and MultiBoxDetection of the
    toy net's softmaxed scores: fixed shapes, -1 rows past the kept."""
    x, y = _ssd_data()
    net = tmodels.ssd_toy(classes=2, device="cpu")
    with torch.no_grad():
        anchors, cls_preds, box_preds = net(torch.from_numpy(x))
    loc_t, loc_m, cls_t = tmodels.ssd_training_targets(
        tmx.nd.array(anchors, ctx="cpu"), tmx.nd.array(cls_preds, ctx="cpu"),
        tmx.nd.array(y, ctx="cpu"))
    N = anchors.shape[1]
    assert isinstance(cls_t, tmx.nd.NDArray) and cls_t.shape == (2, N)
    assert (cls_t.asnumpy() > 0).any() and loc_m.shape == (2, 4 * N)
    det = tmx.nd.contrib.MultiBoxDetection(
        tmx.nd.array(torch.softmax(cls_preds, -1).transpose(1, 2),
                     ctx="cpu"),
        tmx.nd.array(box_preds, ctx="cpu"),
        tmx.nd.array(anchors, ctx="cpu"), nms_threshold=0.45)
    d = det.asnumpy()
    assert d.shape == (2, N, 6) and (d[..., 1] >= 0).any()
    assert ((d[..., 1] < 0) == (d[..., 1] == -1)).all()


# --- Faster R-CNN ----------------------------------------------------------

def _rcnn_data():
    rs = np.random.RandomState(1)
    x = rs.randn(2, 3, 64, 64).astype(np.float32)
    im_info = np.tile([64.0, 64.0, 1.0], (2, 1)).astype(np.float32)
    gt = np.zeros((2, 2, 5), np.float32)
    gt[:, 0] = [6, 6, 30, 30, 1]
    gt[:, 1] = [24, 20, 56, 60, 2]
    return x, im_info, gt


BATCH_ROIS = 8


def _margins(net_fwd_rpn, pre, scales, ratios, stride, thresh, im_info):
    """The smallest gap between distinct pre-NMS scores and the smallest
    |IoU - thresh| among the top `pre` proposals' pairs of each image."""
    rpn_cls, rpn_box = net_fwd_rpn
    B, twoA = rpn_cls.shape[:2]
    prob = torch.softmax(rpn_cls.reshape(B, 2, -1), dim=1).reshape(
        rpn_cls.shape)
    rois, scores = trcnn.proposal(
        prob, rpn_box, torch.from_numpy(im_info), rpn_pre_nms_top_n=pre,
        rpn_post_nms_top_n=pre, threshold=1.1, rpn_min_size=2,
        scales=scales, ratios=ratios, feature_stride=stride,
        output_score=True)
    gap, margin = np.inf, np.inf
    for b in range(B):
        s = np.sort(scores.reshape(B, pre)[b].numpy().astype(np.float64))
        d = np.diff(s)
        if (d > 0).any():
            gap = min(gap, d[d > 0].min())
        boxes = rois.reshape(B, pre, 5)[b, :, 1:]
        iou = tnms.iou_plus_one(boxes, boxes).numpy()
        margin = min(margin, np.abs(iou[np.triu_indices(pre, 1)]
                                    - thresh).min())
    return gap, margin


@pytest.fixture(scope="module")
def rcnn_runs():
    x, im_info, gt = _rcnn_data()
    jrandom.seed(0)
    with nameless_scope():
        jnet = jmodels.faster_rcnn_toy(classes=3)
        jnet.initialize()
        jloss = jmodels.RCNNTrainLoss()
    pred = [o.asnumpy() for o in jnet(jnd.array(x), jnd.array(im_info))]
    init = _params_np(jnet)
    params = jnet._collect_params_with_prefix()
    trainer = jgluon.Trainer(jnet.collect_params(), "sgd", dict(SGD))
    steps = []
    for _ in range(STEPS):
        with jag.record():
            out = jnet(jnd.array(x), jnd.array(im_info),
                       gt_boxes=jnd.array(gt), batch_rois=BATCH_ROIS)
            loss = jloss(*out[:2], *out[3:6])
            loss.backward()
        grads = {n: p.grad().asnumpy() for n, p in params.items()
                 if p.grad_req != "null"}
        trainer.step(2)
        steps.append(dict(loss=loss.asnumpy(), grads=grads,
                          after=_params_np(jnet),
                          sel=[o.asnumpy() for o in out[2:6]]))
    return x, im_info, gt, init, pred, steps


def _port_rcnn(init, hybrid=False):
    net = tmodels.faster_rcnn_toy(classes=3)
    tmx.weights.load_reference_params(net, init, device="cpu")
    loss_b = tmodels.RCNNTrainLoss()
    if hybrid:
        net.hybridize()
        loss_b.hybridize()
    trainer = tmx.gluon.Trainer(net.collect_params(), "sgd", dict(SGD))
    return net, loss_b, trainer


def _rcnn_steps(init, x, im_info, gt, hybrid=False, steps=STEPS):
    net, loss_b, trainer = _port_rcnn(init, hybrid)
    tx, ti, tg = (torch.from_numpy(a) for a in (x, im_info, gt))
    sels = []

    def make_loss():
        out = net(tx, ti, gt_boxes=tg, batch_rois=BATCH_ROIS)
        sels.append([o.detach().numpy() for o in out[2:6]])
        return loss_b(*out[:2], *out[3:6])
    # the head loss does not reach the RPN: both Trainers update its
    # parameters with zero gradients
    step = _port_step_fn(net, loss_b, trainer, make_loss)
    runs = [step() for _ in range(steps)]
    for r, s in zip(runs, sels):
        r["sel"] = s
    return runs, net, loss_b, trainer


def test_faster_rcnn_toy_forward_matches_jax(rcnn_runs):
    x, im_info, _, init, pred, _ = rcnn_runs
    net, _, _ = _port_rcnn(init)
    with torch.no_grad():
        out = net(torch.from_numpy(x), torch.from_numpy(im_info))
        gap, margin = _margins(net.rpn(net.features(torch.from_numpy(x))),
                               64, (2, 4), (0.5, 1, 2), 4, 0.7, im_info)
    print("faster_rcnn_toy inference: smallest score gap %.3g, smallest "
          "|IoU - 0.7| %.3g" % (gap, margin))
    assert [tuple(o.shape) for o in out] == [p.shape for p in pred]
    # the rois (the NMS selection) exactly in which rows are padding
    np.testing.assert_array_equal(out[2][:, 1].numpy() < 0, pred[2][:, 1] < 0)
    for o, p, what in zip(out, pred, ("cls", "box", "rois", "rpn_cls",
                                      "rpn_box")):
        _scaled(o.numpy(), p, what)


def test_faster_rcnn_toy_sgd_steps_match_jax(rcnn_runs):
    x, im_info, gt, init, _, ref_steps = rcnn_runs
    steps = _rcnn_steps(init, x, im_info, gt)[0]
    for k, (got, ref) in enumerate(zip(steps, ref_steps)):
        rois, labels, targets, weights = got["sel"]
        jrois, jlabels, jtargets, jweights = ref["sel"]
        # the sampled rows: which proposals, their labels and weights
        np.testing.assert_array_equal(labels, jlabels)
        np.testing.assert_array_equal(weights, jweights)
        _scaled(rois, jrois, ("rois", k))
        _scaled(targets, jtargets, ("targets", k))
        assert (labels > 0).any()
    _hold_steps(steps, ref_steps)


def test_faster_rcnn_toy_hybridized_is_bit_for_bit_eager(rcnn_runs):
    """Three steps, eager then captured then replayed: the program holds
    Proposal's NMS loop and ProposalTarget, and replays them on the new
    weights' RPN outputs bit for bit as the eager port."""
    x, im_info, gt, init, _, _ = rcnn_runs
    eager = _rcnn_steps(init, x, im_info, gt, steps=3)[0]
    hyb, net, loss_b, trainer = _rcnn_steps(init, x, im_info, gt,
                                            hybrid=True, steps=3)
    cg = net.__dict__["_cached_graph"]
    assert (cg.eager_calls, cg.captures, cg.replays) == (1, 2, 2)
    # the RPN's zero gradients keep the update's live set: captured in
    # step 2, replayed in step 3
    assert (trainer.eager_updates, trainer.captures,
            trainer.replays) == (1, 1, 1)
    for e, h in zip(eager, hyb):
        assert np.array_equal(e["loss"], h["loss"])
        for a, b in zip(e["sel"], h["sel"]):
            assert np.array_equal(a, b)
        for n in e["after"]:
            assert np.array_equal(e["after"][n], h["after"][n]), n


def test_rcnn_training_targets_on_ndarrays():
    rois = tmx.nd.array(np.array([[0, 5, 5, 30, 30], [0, 50, 50, 60, 60]],
                                 np.float32), ctx="cpu")
    gt = tmx.nd.array(np.array([[[5, 5, 30, 30, 0]]], np.float32),
                      ctx="cpu")
    r, labels, targets, weights = tmodels.rcnn_training_targets(
        rois, gt, num_classes=3, batch_rois=4, fg_fraction=0.5)
    assert isinstance(labels, tmx.nd.NDArray)
    assert labels.asnumpy().tolist() == [1, 1, 0, -1]
    assert targets.shape == (4, 16) and weights.asnumpy()[:2].sum() == 8


# --- full widths: names and shapes -----------------------------------------

@pytest.mark.parametrize("name,inputs", [
    ("ssd_512_vgg16", lambda: (jnd.zeros((1, 3, 512, 512)),)),
    ("faster_rcnn_resnet50_v1b", lambda: (
        jnd.zeros((1, 3, 64, 64)), jnd.array([[64.0, 64.0, 1.0]])))])
def test_full_width_parameters_match_jax(name, inputs):
    """Every parameter name of the JAX net, with its shape after JAX's
    abstract shape pass; the port's widths that it knows at build time
    equal them, and its deferred ones (0) take them on loading."""
    with nameless_scope():
        jnet = getattr(jmodels, name)(classes=20)
        jnet.initialize()
    jnet.infer_shape(*inputs())
    jshapes = {n: tuple(p.shape) for n, p in
               jnet._collect_params_with_prefix().items()}
    net = getattr(tmodels, name)(classes=20)
    own = net.collect_params()
    assert sorted(own) == sorted(jshapes)
    for n, p in own.items():
        shp = tuple(p.shape or ())
        assert len(shp) == len(jshapes[n]) and all(
            s in (0, j) for s, j in zip(shp, jshapes[n])), (n, shp)
    known = sum(all(s) for s in (tuple(p.shape) for p in own.values()))
    assert known >= len(own) // 2
    tmx.weights.load_reference_params(
        net, {n: np.zeros(s, np.float32) for n, s in jshapes.items()},
        device="cpu")
    assert {n: tuple(p.shape) for n, p in net.collect_params().items()} \
        == jshapes
    if name == "ssd_512_vgg16":
        assert (net.features.norm_scale.detach() == 0).all()
