"""PyTorch port: the rest of the Gluon surface against the JAX package.

* A user block written as `hybrid_forward(self, F, x, weight, tied)`
  under `name_scope()`, with a child `Dense`, a `params.get` weight whose
  width is filled by its own `infer_shape`, and a tied weight: one class
  body run in both packages.  Forward, input and parameter gradients and
  3 Trainer steps are held against the JAX package, eager and
  hybridized; parameters are paired by `Parameter.name`, which equals
  the JAX name.
* Prefixes, names and `params` of a nested construction equal the JAX
  ones; the default `infer_shape` (a forward on meta tensors) fills the
  widths the JAX `infer_shape` fills, and refuses an op without a meta
  path by name.
* `summary` gives the JAX table.
* The ten losses the JAX package adds to SoftmaxCrossEntropyLoss, with
  every option, `sample_weight` and `batch_axis`: values and input
  gradients within 1e-6 of scale, eager and hybridized.
* The `Caffe` and `Torch` metrics, and `gluon.utils.download` against a
  `file://` URL and an HTTP server on 127.0.0.1.
"""
import functools
import hashlib
import http.server
import os
import threading

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu import autograd as jag
from incubator_mxnet_tpu import metric as jmetric
from incubator_mxnet_tpu import nd
from incubator_mxnet_tpu import random as jrandom
from incubator_mxnet_tpu.base import MXNetError as JMXNetError
from incubator_mxnet_tpu.gluon import utils as jutils
from incubator_mxnet_tpu.gluon.block import nameless_scope as jnameless
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch.base import MXNetError
from incubator_mxnet_tpu_torch.gluon.block import nameless_scope

pytestmark = pytest.mark.torch_port

TOL = 1e-6


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _own_names():
    """Both packages count block names from 0 inside each test."""
    with jnameless(), nameless_scope():
        yield


# -- hybrid_forward ------------------------------------------------------------

def user_block(mx):
    """One class body for both packages (`mx` is either one)."""
    class UserMLP(mx.gluon.HybridBlock):
        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            with self.name_scope():
                self.dense = mx.gluon.nn.Dense(16, in_units=8)
                self.weight = self.params.get(
                    "weight", shape=(6, 0), allow_deferred_init=True)
                self.tied = self.dense.weight

        def infer_shape(self, x, *args):
            self.weight.shape = (6, 16)

        def hybrid_forward(self, F, x, weight, tied):
            h = F.relu(self.dense(x))
            y = F.FullyConnected(h, weight, no_bias=True, num_hidden=6)
            z = F.FullyConnected(x, tied, no_bias=True, num_hidden=16)
            return F.tanh(y) + F.mean(z * z, axis=1, keepdims=True)
    return UserMLP


B = 4


def _data():
    rs = np.random.RandomState(3)
    return rs.randn(B, 8).astype(np.float32), \
        rs.randn(B, 6).astype(np.float32)


@pytest.fixture(scope="module")
def jax_user():
    """The JAX run: initial values by name, and per step the output, the
    loss, the gradients of the input and of every parameter, and the
    parameters after the Adam update."""
    with jnameless():
        jrandom.seed(0)
        net = user_block(jmx)()
        net.initialize()
        x, y = _data()
        net(nd.array(x))
        init = {p.name: p.data().asnumpy()
                for p in net.collect_params().values()}
        loss = jmx.gluon.loss.L2Loss()
        trainer = jmx.gluon.Trainer(net.collect_params(), "adam",
                                    {"learning_rate": 0.01})
        out = []
        for _ in range(3):
            xa = nd.array(x)
            xa.attach_grad()
            with jag.record():
                o = net(xa)
                lv = loss(o, nd.array(y))
            lv.backward()
            out.append(dict(
                out=o.asnumpy(), loss=lv.asnumpy(), xgrad=xa.grad.asnumpy(),
                grads={p.name: p.grad().asnumpy()
                       for p in net.collect_params().values()}))
            trainer.step(B)
            out[-1]["after"] = {p.name: p.data().asnumpy()
                                for p in net.collect_params().values()}
        names = {k: p.name for k, p in
                 net._collect_params_with_prefix().items()}
    return init, out, names


def _port_user_run(init, hybrid):
    with nameless_scope():
        net = user_block(tmx)()
    net.initialize(ctx="cpu")
    x, y = (torch.from_numpy(a) for a in _data())
    with torch.no_grad():
        net(x)              # the deferred width, filled by infer_shape
    by_name = {p.name: p for p in net.collect_params().values()}
    assert set(by_name) == set(init)
    for n, p in by_name.items():
        p.set_data(init[n])
    if hybrid:
        net.hybridize()
    loss = tmx.gluon.loss.L2Loss()
    trainer = tmx.gluon.Trainer(net.collect_params(), "adam",
                                {"learning_rate": 0.01})
    out = []
    for _ in range(3):
        xa = x.clone().requires_grad_()
        with tmx.autograd.record():
            o = net(xa)
            lv = loss(o, y)
        tmx.autograd.backward(lv)
        out.append(dict(out=o.detach().clone(), loss=lv.detach().clone(),
                        xgrad=xa.grad.clone(),
                        grads={n: p.grad.clone()
                               for n, p in by_name.items()}))
        trainer.step(B)
        out[-1]["after"] = {n: p.detach().clone()
                            for n, p in by_name.items()}
    return out, net, trainer


def _close(got, want, what, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    scale = max(np.abs(want).max(), 1.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale,
                               err_msg=str(what))


@pytest.mark.parametrize("hybrid", [False, True], ids=["eager", "hybrid"])
def test_hybrid_forward_block_matches_jax(jax_user, hybrid):
    init, ref, _ = jax_user
    got, net, trainer = _port_user_run(init, hybrid)
    for step, (g, r) in enumerate(zip(got, ref)):
        _close(g["out"], r["out"], ("out", step), 2e-6)
        _close(g["loss"], r["loss"], ("loss", step), 2e-6)
        _close(g["xgrad"], r["xgrad"], ("xgrad", step), 2e-6)
        for n in r["grads"]:
            _close(g["grads"][n], r["grads"][n], (n, step), 2e-6)
        for n in r["after"]:
            _close(g["after"][n], r["after"][n], (n, "after", step), 2e-5)
    if hybrid:
        graph = net._cached_graph
        assert (graph.eager_calls, graph.captures) == (1, 2)
        assert (trainer.eager_updates, trainer.captures,
                trainer.replays) == (1, 1, 1)


def test_hybrid_forward_hybridized_equals_eager(jax_user):
    init, _, _ = jax_user
    eager, _, _ = _port_user_run(init, False)
    hyb, _, _ = _port_user_run(init, True)
    for a, b in zip(eager, hyb):
        for k in ("out", "loss", "xgrad"):
            assert torch.equal(a[k], b[k]), k
        for n in a["after"]:
            assert torch.equal(a["after"][n], b["after"][n]), n


def test_hybrid_forward_takes_ndarrays_and_gives_ndarrays(jax_user):
    init, ref, _ = jax_user
    net = user_block(tmx)()
    net.initialize(ctx="cpu")
    x, _ = _data()
    out = net(tmx.nd.array(x, ctx="cpu"))
    assert isinstance(out, tmx.nd.NDArray)
    assert isinstance(net(torch.from_numpy(x)), torch.Tensor)
    assert tuple(net.weight.shape) == (6, 16)


def test_names_follow_jax(jax_user):
    """The user block's parameters by structural name carry the JAX
    names; the tied weight is one parameter with one structural key."""
    _, _, jax_names = jax_user
    net = user_block(tmx)()
    names = {k: p.name for k, p in net.collect_params().items()}
    assert names == {"weight": "usermlp0_weight", "tied": "dense0_weight",
                     "dense.bias": "dense0_bias"}
    assert {jax_names[k] for k in names} == set(names.values())
    assert list(net.params) == ["usermlp0_weight", "dense0_weight"]
    assert (net.prefix, net.name) == ("usermlp0_", "usermlp0")


def _nested(mx):
    net = mx.gluon.nn.HybridSequential()
    with net.name_scope():
        net.add(mx.gluon.nn.Dense(16, activation="relu"),
                mx.gluon.nn.LayerNorm())
        inner = mx.gluon.nn.HybridSequential()
        inner.add(mx.gluon.nn.Dense(8), mx.gluon.nn.Dropout(0.1))
        net.add(inner, mx.gluon.nn.Dense(4, in_units=8))
    return net


def test_prefixes_and_parameter_names_equal_jax():
    jnet, tnet = _nested(jmx), _nested(tmx)
    jnames = {k: p.name for k, p in jnet._collect_params_with_prefix().items()}
    tnames = {k: p.name for k, p in tnet.collect_params().items()}
    assert tnames == jnames
    assert [c.prefix for c in tnet] == [c.prefix for c in jnet._children
                                        .values()]
    assert (tnet.prefix, tnet.name) == (jnet.prefix, jnet.name)
    for tc, jc in zip(tnet, jnet._children.values()):
        assert list(tc.params) == list(jc.params.keys())
    block = tmx.gluon.HybridBlock(prefix="mine_")
    w = block.params.get("w", shape=(2, 3))
    assert w.name == "mine_w" and block.params.get("w") is w
    shared = tmx.gluon.HybridBlock(prefix="mine_", params=block.params)
    assert shared.params.get("w") is w


def test_default_infer_shape_runs_on_meta_tensors():
    """HybridSequential has no shape rule of its own: its infer_shape
    runs the forward on meta tensors, filling each Dense width as the
    JAX package's jax.eval_shape pass does, and computing nothing."""
    jnet, tnet = _nested(jmx), _nested(tmx)
    x = np.random.RandomState(0).randn(3, 5).astype(np.float32)
    jnet.initialize()
    jnet.infer_shape(nd.array(x))
    tnet.initialize(ctx="cpu")
    tnet.infer_shape(torch.from_numpy(x))
    jshapes = {k: tuple(p.shape)
               for k, p in jnet._collect_params_with_prefix().items()}
    tshapes = {k: tuple(p.shape) for k, p in tnet.collect_params().items()}
    assert tshapes == jshapes
    # the widths are known, the data not yet made
    assert tmx.gluon.parameter.is_deferred(tnet[0].weight)
    assert tmx.gluon.parameter.is_deferred(tnet[2][0].weight)
    out = tnet(torch.from_numpy(x))
    assert out.shape == (3, 4) and out.device.type == "cpu"


def test_default_infer_shape_names_an_op_without_meta_path():
    class HostRead(tmx.gluon.HybridBlock):
        def __init__(self):
            super().__init__()
            self.weight = self.params.get("weight", shape=(0, 3),
                                          allow_deferred_init=True)

        def hybrid_forward(self, F, x, weight):
            if float(F.sum(x).asscalar()) > 0:
                return x
            return x * 2

    blk = HostRead()
    blk.initialize(ctx="cpu")
    with pytest.raises(MXNetError, match="infer_shape of HostRead: its "
                       "forward failed on meta tensors at aten\\._to_copy"):
        blk(torch.ones(2, 3))


def test_summary_gives_the_jax_table(capsys):
    jnet, tnet = _nested(jmx), _nested(tmx)
    x = np.random.RandomState(1).randn(2, 5).astype(np.float32)
    jnet.initialize()
    tnet.initialize(ctx="cpu")
    tnet.hybridize()
    want = jnet.summary(nd.array(x))
    got = tnet.summary(torch.from_numpy(x))
    assert got == want
    assert "Total params: %d" % sum(
        p.numel() for p in tnet.collect_params().values()) in got
    # the programs were set aside and are back
    assert tnet._cached_graph is not None
    tnet(torch.from_numpy(x))
    capsys.readouterr()


def test_summary_of_the_user_block(jax_user):
    with jnameless():
        jnet = user_block(jmx)()
        jnet.initialize()
        x, _ = _data()
        want = jnet.summary(nd.array(x))
    net = user_block(tmx)()
    net.initialize(ctx="cpu")
    assert net.summary(torch.from_numpy(x)) == want


# -- losses ----------------------------------------------------------------

N, K = 4, 5
LOSSES = {
    # id: (class name, kwargs, inputs, takes sample_weight)
    "l2": ("L2Loss", {}, "reg"),
    "l2_weight_axis1": ("L2Loss", dict(weight=0.7, batch_axis=1), "reg"),
    "l1": ("L1Loss", {}, "reg"),
    "l1_weight": ("L1Loss", dict(weight=2.0), "reg"),
    "sbce": ("SigmoidBinaryCrossEntropyLoss", {}, "binary"),
    "sbce_pos_weight": ("SigmoidBinaryCrossEntropyLoss", {}, "binary_pw"),
    "sbce_from_sigmoid": ("SigmoidBinaryCrossEntropyLoss",
                          dict(from_sigmoid=True), "prob"),
    "sbce_from_sigmoid_pw": ("SigmoidBinaryCrossEntropyLoss",
                             dict(from_sigmoid=True), "prob_pw"),
    "sbce_alias": ("SigmoidBCELoss", dict(weight=0.5), "binary"),
    "kldiv": ("KLDivLoss", {}, "dist"),
    "kldiv_logits": ("KLDivLoss", dict(from_logits=False, axis=1), "dist"),
    "huber": ("HuberLoss", {}, "reg"),
    "huber_rho": ("HuberLoss", dict(rho=0.3, weight=1.5), "reg"),
    "hinge": ("HingeLoss", {}, "signed"),
    "hinge_margin": ("HingeLoss", dict(margin=0.5, batch_axis=1), "signed"),
    "sq_hinge": ("SquaredHingeLoss", {}, "signed"),
    "sq_hinge_margin": ("SquaredHingeLoss", dict(margin=2.0), "signed"),
    "logistic": ("LogisticLoss", {}, "signed"),
    "logistic_binary": ("LogisticLoss", dict(label_format="binary"),
                        "binary"),
    "triplet": ("TripletLoss", {}, "triplet"),
    "triplet_margin": ("TripletLoss", dict(margin=0.2, weight=0.5),
                       "triplet"),
    "cosine": ("CosineEmbeddingLoss", {}, "cosine"),
    "cosine_margin": ("CosineEmbeddingLoss", dict(margin=0.3, weight=2.0),
                      "cosine"),
}


def _loss_inputs(kind, seed):
    """(differentiable inputs, other inputs, keyword inputs) as numpy."""
    rs = np.random.RandomState(seed)
    f = np.float32
    pred = rs.randn(N, K).astype(f)
    if kind == "reg":
        return [pred], [rs.randn(N, K).astype(f)], {}
    if kind == "binary":
        return [pred], [rs.randint(0, 2, (N, K)).astype(f)], {}
    if kind == "binary_pw":
        return [pred], [rs.randint(0, 2, (N, K)).astype(f)], dict(
            pos_weight=rs.rand(K).astype(f) * 2)
    if kind == "prob":
        return [rs.rand(N, K).astype(f) * 0.9 + 0.05], \
            [rs.randint(0, 2, (N, K)).astype(f)], {}
    if kind == "prob_pw":
        return [rs.rand(N, K).astype(f) * 0.9 + 0.05], \
            [rs.randint(0, 2, (N, K)).astype(f)], dict(
                pos_weight=rs.rand(K).astype(f) * 2)
    if kind == "dist":
        lab = rs.rand(N, K).astype(f)
        lab /= lab.sum(axis=1, keepdims=True)
        logp = pred - np.log(np.exp(pred).sum(axis=1, keepdims=True))
        return [logp.astype(f)], [lab], {}
    if kind == "signed":
        return [pred], [rs.choice([-1.0, 1.0], (N, K)).astype(f)], {}
    if kind == "triplet":
        return [pred, rs.randn(N, K).astype(f), rs.randn(N, K).astype(f)], \
            [], {}
    if kind == "cosine":
        return [rs.randn(N, 2, 3).astype(f), rs.randn(N, 6).astype(f)], \
            [rs.choice([-1.0, 1.0], (N,)).astype(f)], {}
    raise ValueError(kind)


def _sample_weight(cls, kw, rs):
    axis = kw.get("batch_axis", 0)
    if cls in ("TripletLoss", "CosineEmbeddingLoss"):
        return rs.rand(N).astype(np.float32)
    shape = [1, 1]
    shape[axis] = N if axis == 0 else K
    return rs.rand(*shape).astype(np.float32)


def _jax_loss(cls, kw, diff, other, kwin, sw):
    loss = getattr(jmx.gluon.loss, cls)(**kw)
    xs = [nd.array(a) for a in diff]
    for x in xs:
        x.attach_grad()
    # the JAX HybridBlock.forward takes positional arguments only
    tail = [None if sw is None else nd.array(sw)]
    if "pos_weight" in kwin:
        tail.append(nd.array(kwin["pos_weight"]))
    with jag.record():
        out = loss(*xs, *[nd.array(a) for a in other], *tail)
    out.backward()
    return out.asnumpy(), [x.grad.asnumpy() for x in xs]


def _port_loss(cls, kw, diff, other, kwin, sw, hybrid):
    loss = getattr(tmx.gluon.loss, cls)(**kw)
    if hybrid:
        loss.hybridize()
    extra = {k: torch.from_numpy(v) for k, v in kwin.items()}
    if sw is not None:
        extra["sample_weight"] = torch.from_numpy(sw)
    res = None
    # a hybridized call runs eagerly, then captures, then replays
    for _ in range(3 if hybrid else 1):
        xs = [torch.from_numpy(a).requires_grad_() for a in diff]
        with tmx.autograd.record():
            out = loss(*xs, *[torch.from_numpy(a) for a in other], **extra)
        tmx.autograd.backward(out)
        got = (out.detach().numpy(), [x.grad.numpy() for x in xs])
        if res is not None:
            for a, b in zip([res[0]] + res[1], [got[0]] + got[1]):
                assert np.array_equal(a, b)
        res = got
    if hybrid:
        g = loss._cached_graph
        assert (g.eager_calls, g.captures, g.replays) == (1, 2, 2)
    return res


@pytest.mark.parametrize("hybrid", [False, True], ids=["eager", "hybrid"])
@pytest.mark.parametrize("weighted", [False, True], ids=["", "sw"])
@pytest.mark.parametrize("case", sorted(LOSSES))
def test_loss_matches_jax(case, weighted, hybrid):
    cls, kw, kind = LOSSES[case]
    seed = sorted(LOSSES).index(case)
    diff, other, kwin = _loss_inputs(kind, seed)
    sw = _sample_weight(cls, kw, np.random.RandomState(100 + seed)) \
        if weighted else None
    want, want_grads = _jax_loss(cls, kw, diff, other, kwin, sw)
    got, got_grads = _port_loss(cls, kw, diff, other, kwin, sw, hybrid)
    assert got.shape == want.shape
    _close(got, want, (case, "value"))
    for i, (g, w) in enumerate(zip(got_grads, want_grads)):
        _close(g, w, (case, "grad", i))


def test_loss_aliases_and_reprs():
    assert tmx.gluon.loss.SigmoidBCELoss is \
        tmx.gluon.loss.SigmoidBinaryCrossEntropyLoss
    assert repr(tmx.gluon.loss.L1Loss(weight=2.0)) == \
        repr(jmx.gluon.loss.L1Loss(weight=2.0))
    assert set(jmx.gluon.loss.__all__) == set(tmx.gluon.loss.__all__)


# -- metrics and download --------------------------------------------------

@pytest.mark.parametrize("name", ["Caffe", "Torch"])
def test_caffe_and_torch_metrics_equal_jax(name):
    rs = np.random.RandomState(5)
    batches = [rs.rand(3, 2).astype(np.float32) for _ in range(3)]
    t, j = getattr(tmx.metric, name)(), getattr(jmetric, name)()
    for b in batches:
        t.update(None, [torch.from_numpy(b)])
        j.update(None, [nd.array(b)])
    assert t.get()[0] == j.get()[0] == "loss"
    # the port sums in f64, the JAX metric each batch's f32 sum
    assert t.get()[1] == pytest.approx(j.get()[1], rel=1e-6)
    assert isinstance(t, tmx.metric.Loss)
    assert name.lower() not in tmx.metric._REGISTRY


@pytest.fixture
def served(tmp_path):
    """A directory with one file, served over HTTP on 127.0.0.1."""
    root = tmp_path / "served"
    root.mkdir()
    (root / "weights.bin").write_bytes(b"0123456789" * 100)
    handler = functools.partial(_QuietHandler, directory=str(root))
    server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), handler)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield root, "http://127.0.0.1:%d" % server.server_address[1]
    server.shutdown()
    server.server_close()
    thread.join()


class _QuietHandler(http.server.SimpleHTTPRequestHandler):
    def log_message(self, *args):
        pass


def _sha1(data):
    return hashlib.sha1(data).hexdigest()


@pytest.mark.parametrize("scheme", ["file", "http"])
def test_download_follows_jax(served, tmp_path, scheme):
    root, base = served
    url = ("file://" + str(root) if scheme == "file" else base) \
        + "/weights.bin"
    data = (root / "weights.bin").read_bytes()
    for pkg, utils in (("port", tmx.gluon.utils), ("jax", jutils)):
        out = tmp_path / pkg
        out.mkdir()
        # into a directory: the URL's last part
        got = utils.download(url, path=str(out))
        assert got == os.path.join(str(out), "weights.bin")
        assert open(got, "rb").read() == data
        # an existing file is kept ...
        open(got, "wb").write(b"local")
        assert utils.download(url, path=str(out)) == got
        assert open(got, "rb").read() == b"local"
        # ... unless its sha1 differs or overwrite is asked for
        utils.download(url, path=str(out), sha1_hash=_sha1(data))
        assert open(got, "rb").read() == data
        open(got, "wb").write(b"local")
        utils.download(url, path=str(out), sha1_hash=_sha1(b"local"))
        assert open(got, "rb").read() == b"local"
        utils.download(url, path=str(out), overwrite=True)
        assert open(got, "rb").read() == data
        # a file path is used as it is
        named = str(out / "renamed.bin")
        assert utils.download(url, path=named) == named
        assert open(named, "rb").read() == data
    missing = url.replace("weights.bin", "missing.bin")
    target = str(tmp_path / "port" / "missing.bin")
    with pytest.raises(MXNetError, match="download of %s failed .* place "
                       "the file at %s" % (missing, target)):
        tmx.gluon.utils.download(missing, path=str(tmp_path / "port"))
    with pytest.raises(JMXNetError, match="download of"):
        jutils.download(missing, path=str(tmp_path / "jax"))
    assert not os.path.exists(target)
