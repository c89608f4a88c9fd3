"""PyTorch port: `HybridBlock.hybridize` as captured programs, and the
Trainer's captured update, on the CPU.

On the CPU a captured program is the list of aten ops its capture
issued, replayed on the same tensors (`graph_capture`): it keeps a CUDA
graph's rules, so these tests catch what a graph gets wrong -- Python
values frozen at capture, storage read after it was replaced, outputs
that a later replay overwrites.  A hybridized Dense/LayerNorm stack,
`bert_small` and a small ResNet v1b train 3 steps (step 1 eager, step 2
captured, step 3 replayed) with Adam and with NAG under a warmup-cosine
scheduler: bit for bit the eager port's losses, parameters, optimizer
states and update counts, and within the existing tolerances of the JAX
package's hybridized Trainer run on the same numpy inputs and copied
parameters.  The ResNet is held to the eager port only: the JAX
package's hybridized ResNet step differs from its own eager step
(test_torch_resnet.py holds the eager port against eager JAX).

Every test runs torch on one thread: the CPU's bf16 GEMMs may sum in
another order when threads are contended, which eager runs show too.
"""
import numpy as np
import pytest
import torch

from incubator_mxnet_tpu import autograd as jag
from incubator_mxnet_tpu import gluon as jgluon
from incubator_mxnet_tpu import lr_scheduler as jsched
from incubator_mxnet_tpu import nd
from incubator_mxnet_tpu import random as jrandom
from incubator_mxnet_tpu.gluon.block import nameless_scope
from incubator_mxnet_tpu.models import transformer as jtr
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch import graph_capture
from incubator_mxnet_tpu_torch.base import MXNetError
from incubator_mxnet_tpu_torch.gluon.model_zoo.vision import resnet as tres
from test_torch_train import (LR, _assert_adam_params_close,
                              _assert_grads_close)

pytestmark = pytest.mark.torch_port

B, STEPS = 2, 3
# f32 forward, backward and updates of the same small nets in another
# order of sums, as test_torch_gluon_core.py holds them: within 2e-5
TOL = 2e-5
OPTS = {
    "adam": lambda m: ("adam", {"learning_rate": LR}),
    "nag": lambda m: ("nag", dict(
        learning_rate=0.05, momentum=0.9, wd=1e-4,
        lr_scheduler=m.CosineScheduler(max_update=8, base_lr=0.05,
                                       final_lr=0.0, warmup_steps=1,
                                       warmup_begin_lr=0.01))),
}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def _own_jax_block_names():
    with nameless_scope():
        yield


# -- the models, in either package -------------------------------------------

def _mlp(nn, dropout=0.0):
    net = nn.HybridSequential()
    net.add(nn.Dense(16, in_units=8, activation="relu"),
            nn.LayerNorm(in_channels=16))
    if dropout:
        net.add(nn.Dropout(dropout))
    net.add(nn.Dense(4, in_units=16))
    return net


def _mlp_data():
    rs = np.random.RandomState(1)
    return ((rs.randn(B, 8).astype(np.float32),),
            rs.randint(0, 4, B).astype(np.float32))


V, T = 50, 8
BERT = dict(vocab_size=V, units=32, hidden_size=64, num_layers=1,
            num_heads=2, max_length=16, dropout=0.0, output_hidden=True)


def _bert_data():
    rs = np.random.RandomState(2)
    return ((rs.randint(0, V, (B, T)).astype(np.int32),),
            rs.randint(0, V, (B, T)).astype(np.float32))


def _resnet_data():
    rs = np.random.RandomState(3)
    return ((rs.randn(B, 3, 16, 16).astype(np.float32),),
            rs.randint(0, 4, B).astype(np.float32))


def _jax_model(model):
    """A JAX net and loss block, initialized, and their parameters as
    numpy by structural name (the loss block's under "loss.")."""
    jrandom.seed(0)
    if model == "mlp":
        net, loss = _mlp(jgluon.nn), jgluon.loss.SoftmaxCrossEntropyLoss()
        net.initialize()
    else:
        net = jtr.bert_small(**BERT)
        net.initialize()
        loss = jtr.FusedMLMCELoss(V, 32)
        loss.initialize()
    x, y = DATA[model]()
    loss(net(*[nd.array(a, dtype=a.dtype) for a in x]), nd.array(y))
    params = dict(net._collect_params_with_prefix())
    params.update({"loss." + n: p
                   for n, p in loss._collect_params_with_prefix().items()})
    return net, loss, params


def _port_model(model, init):
    if model == "mlp_dropout":
        tmx.random.seed(0)
        net = _mlp(tmx.gluon.nn, dropout=0.3)
        net.initialize(ctx="cpu")
        return net, tmx.gluon.loss.SoftmaxCrossEntropyLoss()
    if model == "resnet":
        tmx.random.seed(0)
        net = tres.ResNetV1(tres.BottleneckV1, [1, 1, 1, 1],
                            [8, 16, 32, 64, 128], classes=4,
                            thumbnail=True, stride_on_3x3=True,
                            device="cpu")
        return net, tmx.gluon.loss.SoftmaxCrossEntropyLoss()
    if model == "mlp":
        net, loss = _mlp(tmx.gluon.nn), \
            tmx.gluon.loss.SoftmaxCrossEntropyLoss()
    else:
        net = tmx.models.bert_small(device="cpu", **BERT)
        loss = tmx.models.FusedMLMCELoss(V, 32, device="cpu")
    tmx.weights.load_reference_params(
        net, {n: a for n, a in init.items() if not n.startswith("loss.")},
        device="cpu")
    if model == "bert":
        tmx.weights.load_reference_params(
            loss, {n[5:]: a for n, a in init.items()
                   if n.startswith("loss.")})
    return net, loss


DATA = {"mlp": _mlp_data, "mlp_dropout": _mlp_data, "bert": _bert_data,
        "resnet": _resnet_data}


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX package's hybridized runs by (model, optimizer), made on
    first use: initial parameters, and per step the loss, the gradients
    and the parameters after the update."""
    cache = {}

    def get(model, opt):
        if (model, opt) not in cache:
            net, loss, params = _jax_model(model)
            init = {n: p.data().asnumpy() for n, p in params.items()}
            net.hybridize(static_alloc=True, static_shape=True)
            loss.hybridize()
            name, kw = OPTS[opt](jsched)
            trainer = jgluon.Trainer({**net.collect_params(),
                                      **loss.collect_params()}, name, kw)
            x, y = DATA[model]()
            steps = []
            for _ in range(STEPS):
                with jag.record():
                    lv = loss(net(*[nd.array(a, dtype=a.dtype) for a in x]),
                              nd.array(y))
                    lv.backward()
                trainer.step(B)
                steps.append(dict(
                    loss=lv.asnumpy(),
                    grads={n: p.grad().asnumpy() for n, p in params.items()},
                    after={n: p.data().asnumpy()
                           for n, p in params.items()}))
            cache[model, opt] = init, steps
        return cache[model, opt]
    return get


def _bits(t):
    t = t.detach().contiguous()
    return t.view({1: torch.uint8, 2: torch.int16, 4: torch.int32,
                   8: torch.int64}[t.element_size()])


def _same_bits(a, b):
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(map(_same_bits, a, b))
    if a is None or b is None:
        return a is b
    return a.dtype == b.dtype and torch.equal(_bits(a), _bits(b))


def _train(model, opt, init, hybrid, steps=STEPS, net_loss=None):
    """`steps` steps of the port; per step the loss, the gradients and
    the parameters after the update, and the objects."""
    net, loss = net_loss or _port_model(model, init)
    if hybrid:
        net.hybridize(static_alloc=True, static_shape=True)
        loss.hybridize()
    params = dict(net.collect_params())
    params.update({"loss." + n: p for n, p in loss.collect_params().items()})
    name, kw = OPTS[opt](tmx.lr_scheduler)
    trainer = tmx.gluon.Trainer(params, name, kw)
    x, y = DATA[model]()
    x, y = [torch.from_numpy(a) for a in x], torch.from_numpy(y)
    out = []
    for _ in range(steps):
        with tmx.autograd.record():
            lv = loss(net(*x), y)
        tmx.autograd.backward(lv)
        grads = {n: p.grad.clone() for n, p in params.items()
                 if p.grad is not None}
        trainer.step(B)
        out.append(dict(loss=lv.detach(), grads=grads,
                        after={n: p.detach().clone()
                               for n, p in params.items()}))
    return out, dict(net=net, loss=loss, trainer=trainer, params=params)


MODELS = [("mlp", "adam"), ("mlp", "nag"), ("bert", "adam"),
          ("bert", "nag"), ("resnet", "adam"), ("resnet", "nag"),
          ("mlp_dropout", "adam")]


@pytest.mark.parametrize("model,opt", MODELS)
def test_hybridized_training_equals_eager_bit_for_bit(jax_runs, model, opt):
    """Dropout 0.3 included: a replay draws from the port's generator as
    the eager step does."""
    init = jax_runs(model, opt)[0] if model in ("mlp", "bert") else None
    eager, e = _train(model, opt, init, hybrid=False)
    hyb, h = _train(model, opt, init, hybrid=True)
    for a, b in zip(eager, hyb):
        assert _same_bits(a["loss"], b["loss"])
        assert a["grads"].keys() == b["grads"].keys()
        for n in a["grads"]:
            assert _same_bits(a["grads"][n], b["grads"][n]), n
        for n in a["after"]:
            assert _same_bits(a["after"][n], b["after"][n]), n
    eo, ho = e["trainer"].optimizer, h["trainer"].optimizer
    es, hs = e["trainer"]._updater.states, h["trainer"]._updater.states
    assert es.keys() == hs.keys()
    assert all(_same_bits(es[i], hs[i]) for i in es)
    assert eo._index_update_count == ho._index_update_count
    assert eo.num_update == ho.num_update == STEPS
    # step 1 eager, step 2 captured (forward and backward), step 3
    # replayed; the update captured at step 2, replayed at step 3
    for blk in (h["net"], h["loss"]):
        g = blk._cached_graph
        assert (g.eager_calls, g.captures, g.replays) == (1, 2, 2)
    tr = h["trainer"]
    assert (tr.eager_updates, tr.captures, tr.replays) == (1, 1, 1)
    assert e["trainer"].captures == 0


@pytest.mark.parametrize("model,opt", MODELS[:4])
def test_hybridized_training_matches_jax(jax_runs, model, opt):
    init, ref = jax_runs(model, opt)
    got, _ = _train(model, opt, init, hybrid=True)
    for step, (g, r) in enumerate(zip(got, ref)):
        np.testing.assert_allclose(g["loss"].numpy(), r["loss"], rtol=0,
                                   atol=TOL, err_msg="step %d" % step)
        _assert_grads_close({n: t.numpy() for n, t in g["grads"].items()},
                            r["grads"])
    after = {n: t.numpy() for n, t in got[-1]["after"].items()}
    if opt == "adam":
        _assert_adam_params_close(after, ref[-1]["after"],
                                  [r["grads"] for r in ref])
    else:
        for n, r in ref[-1]["after"].items():
            np.testing.assert_allclose(after[n], r, rtol=0, atol=TOL,
                                       err_msg=n)


# -- the update --------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_adam_aggregated_path_equals_per_tensor(dtype):
    """Adam is aggregatable, as in the JAX package; its aggregated
    update gives the per-tensor update's bits (F2: one rounding)."""
    assert tmx.optimizer.Adam.aggregatable
    rs = np.random.RandomState(5)
    shapes = [(7, 3), (16,), (4, 4, 2)]
    ws = [torch.from_numpy(rs.randn(*s).astype(np.float32)).to(dtype)
          for s in shapes]
    gs = [torch.from_numpy(rs.randn(*s).astype(np.float32)).to(dtype)
          for s in shapes]
    kw = dict(learning_rate=0.01, wd=1e-3, rescale_grad=0.5)
    multi, single = tmx.optimizer.Adam(**kw), tmx.optimizer.Adam(**kw)
    wm, ws1 = [w.clone() for w in ws], [w.clone() for w in ws]
    sm = [multi.create_state(i, w) for i, w in enumerate(wm)]
    ss = [single.create_state(i, w) for i, w in enumerate(ws1)]
    for _ in range(3):
        multi.update_multi(list(range(3)), wm, gs, sm)
        for i in range(3):
            single.update(i, ws1[i], gs[i], ss[i])
    assert all(_same_bits(a, b) for a, b in zip(wm, ws1))
    assert all(_same_bits(a, b) for a, b in zip(sm, ss))
    assert all(w.dtype == dtype for w in wm)
    assert multi._index_update_count == single._index_update_count
    assert not all(_same_bits(a, b) for a, b in zip(wm, ws))


@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_sgd_grouped_update_equals_per_tensor(momentum):
    """SGD's aggregated update runs the tensors that share an lr and a wd
    (one slot of `Hypers`) as one `_foreach_*` group: the per-tensor
    update's bits."""
    from incubator_mxnet_tpu_torch.optimizer.optimizer import Hypers
    rs = np.random.RandomState(6)
    shapes = [(5, 3), (7,), (2, 2, 2), (4,)]
    ws = [torch.from_numpy(rs.randn(*s).astype(np.float32)) for s in shapes]
    gs = [torch.from_numpy(rs.randn(*s).astype(np.float32)) for s in shapes]
    hypers = Hypers().write([0.1, 0.2, 0.1, 0.2], [1e-3, 0.0, 1e-3, 0.0],
                            0.25, "cpu")
    assert [pos for pos, _, _ in hypers.groups] == [[0, 2], [1, 3]]
    opt = tmx.optimizer.SGD(momentum=momentum)
    moms = [opt.create_state(i, w) for i, w in enumerate(ws)]
    grouped = [w.clone() for w in ws]
    single = [w.clone() for w in ws]
    smoms = None if moms[0] is None else [m.clone() for m in moms]
    for _ in range(3):
        opt._device_multi(range(4), grouped, gs, moms, hypers)
        for i in range(4):
            lr, wd, rescale = hypers.at(i)
            kw = dict(lr=lr, wd=wd, rescale_grad=rescale)
            if smoms is None:
                tmx.ops.optimizer.sgd_update(single[i], gs[i], **kw)
            else:
                tmx.ops.optimizer.sgd_mom_update(
                    single[i], gs[i], smoms[i], momentum=momentum, **kw)
    assert all(map(_same_bits, grouped, single))
    assert smoms is None or all(map(_same_bits, moms, smoms))


def _mlp_port(seed=0):
    tmx.random.seed(seed)
    net = _mlp(tmx.gluon.nn)
    net.initialize(ctx="cpu")
    return net


def _steps(net, trainer, n, x, y, lrs=None):
    loss_fn = tmx.gluon.loss.SoftmaxCrossEntropyLoss()
    losses = []
    for k in range(n):
        if lrs is not None:
            trainer.set_learning_rate(lrs[k])
        with tmx.autograd.record():
            lv = loss_fn(net(x), y)
        tmx.autograd.backward(lv)
        trainer.step(B)
        losses.append(lv.detach())
    return losses


@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_lr_change_reaches_replays_without_capture(opt):
    (x,), y = _mlp_data()
    x, y = torch.from_numpy(x), torch.from_numpy(y)
    lrs = [0.1, 0.1, 0.1, 0.02, 0.3, 0.05]
    runs = []
    for hybrid in (False, True):
        net = _mlp_port()
        if hybrid:
            net.hybridize()
        trainer = tmx.gluon.Trainer(net.collect_params(), opt,
                                    {"learning_rate": 0.1})
        losses = _steps(net, trainer, len(lrs), x, y, lrs)
        runs.append((losses, [p.detach().clone() for p in net.parameters()],
                     trainer))
    (el, ep, _), (hl, hp, tr) = runs
    assert all(map(_same_bits, el, hl)) and all(map(_same_bits, ep, hp))
    assert (tr.captures, tr.replays) == (1, len(lrs) - 2)


def test_trainer_stays_eager_under_the_amp_loss_scaler():
    (x,), y = _mlp_data()
    x, y = torch.from_numpy(x), torch.from_numpy(y)
    net = _mlp_port()
    net.hybridize()
    trainer = tmx.gluon.Trainer(net.collect_params(), "sgd",
                                {"learning_rate": 0.1})
    tmx.contrib.amp.init_trainer(trainer)
    _steps(net, trainer, 4, x, y)
    assert (trainer.captures, trainer.eager_updates) == (0, 4)
    assert net._cached_graph.replays > 0


# -- gradients and outputs ---------------------------------------------------

def test_write_and_add_gradients_across_replays():
    """'write' overwrites, 'add' sums until zero_grad, in the same
    persistent buffers from the first captured backward on."""
    (x,), y = _mlp_data()
    x, y = torch.from_numpy(x), torch.from_numpy(y)
    runs = []
    for hybrid in (False, True):
        net = _mlp_port()
        net.collect_params()["0.bias"].grad_req = "add"
        net.collect_params()["2.weight"].grad_req = "add"
        if hybrid:
            net.hybridize()
        loss_fn = tmx.gluon.loss.SoftmaxCrossEntropyLoss()
        grads, ptrs = [], []
        for k in range(5):
            if k == 3:
                net.zero_grad()
            with tmx.autograd.record():
                lv = loss_fn(net(x * (k + 1)), y)
            tmx.autograd.backward(lv)
            params = net.collect_params()
            grads.append({n: p.grad.clone() for n, p in params.items()})
            ptrs.append({n: p.grad.data_ptr() for n, p in params.items()})
        runs.append((grads, ptrs))
    (eg, _), (hg, hptr) = runs
    for a, b in zip(eg, hg):
        assert all(_same_bits(a[n], b[n]) for n in a)
    # from the capture (call 2) on, every gradient stays in its buffer
    assert hptr[1] == hptr[2] == hptr[3] == hptr[4]
    assert not torch.equal(hg[2]["0.bias"], hg[1]["0.bias"])


def test_outputs_of_a_step_keep_their_values():
    (x,), y = _mlp_data()
    x, y = torch.from_numpy(x), torch.from_numpy(y)
    net = _mlp_port()
    net.hybridize()
    loss_fn = tmx.gluon.loss.SoftmaxCrossEntropyLoss()
    loss_fn.hybridize()
    trainer = tmx.gluon.Trainer(net.collect_params(), "sgd",
                                {"learning_rate": 0.5})
    kept = []
    for k in range(4):
        with tmx.autograd.record():
            out = net(x)
            lv = loss_fn(out, y)
        tmx.autograd.backward(lv)
        trainer.step(B)
        kept.append((out, lv, out.detach().clone(), lv.detach().clone()))
    for out, lv, out0, lv0 in kept:
        assert torch.equal(out, out0) and torch.equal(lv, lv0)
    assert len({o.data_ptr() for o, _, _, _ in kept}) == 4
    assert not torch.equal(kept[-1][3], kept[-2][3])


def test_parameter_used_twice_and_outside_sums_as_eager():
    """A block called twice in one recorded step takes a second program
    (the first still waits for its backward), and a parameter also used
    outside it: the contributions sum, as eager torch sums them, within
    f32 rounding: the second call of step 1 is already captured, and
    three terms summed in another order may differ in the last bit."""
    (x,), y = _mlp_data()
    x = torch.from_numpy(x)
    runs = []
    for hybrid in (False, True):
        net = _mlp_port()
        if hybrid:
            net.hybridize()
        w = net.collect_params()["0.weight"]
        grads = []
        for k in range(4):
            with tmx.autograd.record():
                out = net(x) * net(x + 1.0) + (w * w).sum()
            tmx.autograd.backward(out)
            grads.append({n: p.grad.clone()
                          for n, p in net.collect_params().items()})
        runs.append(grads)
    for a, b in zip(*runs):
        for n in a:
            np.testing.assert_allclose(b[n].numpy(), a[n].numpy(),
                                       rtol=1e-6, atol=1e-7, err_msg=n)
    programs = next(iter(net._cached_graph._programs.values()))
    assert len(programs) == 2


def test_backward_after_a_later_call_or_twice_raises():
    (x,), _ = _mlp_data()
    x = torch.from_numpy(x)
    net = _mlp_port()
    net.hybridize()
    for _ in range(2):
        with tmx.autograd.record():
            first = net(x)
        tmx.autograd.backward(first)
    with tmx.autograd.record():
        first = net(x)
    tmx.autograd.backward(first, retain_graph=True)
    with pytest.raises(MXNetError, match="once per call"):
        tmx.autograd.backward(first, retain_graph=True)
    with tmx.autograd.record():
        net(x)                  # the program is free again: reused
    with pytest.raises(MXNetError, match="called again"):
        tmx.autograd.backward(first)


# -- invalidation ------------------------------------------------------------

def _act(action, net, trainer, tmp_path):
    if action == "cast":
        net.cast("bfloat16")
    elif action == "load_parameters":
        f = str(tmp_path / "p.params")
        _mlp_port(seed=7).save_parameters(f)
        net.load_parameters(f)
    elif action == "set_data":
        p = net.collect_params()["2.weight"]
        p.set_data(p.detach() * 0.5)
    else:
        f = str(tmp_path / "s.states")
        trainer.save_states(f)
        trainer.load_states(f)


@pytest.mark.parametrize("action", ["cast", "load_parameters", "set_data",
                                    "load_states"])
def test_replacing_captured_tensors_recaptures(action, tmp_path):
    (x,), y = _mlp_data()
    x, y = torch.from_numpy(x), torch.from_numpy(y)
    runs = []
    for hybrid in (False, True):
        net = _mlp_port()
        if hybrid:
            net.hybridize()
        trainer = tmx.gluon.Trainer(net.collect_params(), "nag",
                                    {"learning_rate": 0.1, "momentum": 0.9})
        losses = _steps(net, trainer, 3, x, y)
        before = (net._cached_graph.captures, trainer.captures) \
            if hybrid else None
        _act(action, net, trainer, tmp_path)
        xx = x.to(torch.bfloat16) if action == "cast" else x
        losses += _steps(net, trainer, 3, xx, y)
        runs.append((losses, [p.detach().clone() for p in net.parameters()],
                     before, net, trainer))
    (el, ep, *_), (hl, hp, before, net, trainer) = runs
    assert all(map(_same_bits, el, hl)) and all(map(_same_bits, ep, hp))
    after = (net._cached_graph.captures, trainer.captures)
    if action == "load_states":
        assert after[1] == before[1] + 1
    else:
        assert after[0] == before[0] + 2 and after[1] == before[1] + 1


# -- remat, hybridize(active=False), host reads -----------------------------

def _grads_of(net, x, steps=3):
    out = []
    for _ in range(steps):
        with tmx.autograd.record():
            o = net(x)
        tmx.autograd.backward(o)
        out.append({n: p.grad.clone()
                    for n, p in net.collect_params().items()})
    return out


@pytest.mark.parametrize("dropout", [0.0, 0.3])
def test_remat_gives_the_gradients_without_remat(dropout):
    (x,), _ = _mlp_data()
    x = torch.from_numpy(x)
    runs = []
    for remat in (False, True):
        tmx.random.seed(3)
        net = _mlp(tmx.gluon.nn, dropout)
        net.initialize(ctx="cpu")
        net.hybridize(remat=remat)
        runs.append(_grads_of(net, x))
    for a, b in zip(*runs):
        assert all(_same_bits(a[n], b[n]) for n in a)
    if dropout:                 # the masks change from step to step
        assert not torch.equal(runs[1][1]["0.weight"],
                               runs[1][2]["0.weight"])


def test_remat_matches_jax_remat_gradients():
    (x,), _ = _mlp_data()
    jrandom.seed(0)
    jnet = _mlp(jgluon.nn)
    jnet.initialize()
    jnet(nd.array(x))
    init = {n: p.data().asnumpy()
            for n, p in jnet._collect_params_with_prefix().items()}
    jnet.hybridize(remat=True)
    with jag.record():
        out = jnet(nd.array(x))
        out.backward()
    ref = {n: p.grad().asnumpy()
           for n, p in jnet._collect_params_with_prefix().items()}
    net = _mlp(tmx.gluon.nn)
    tmx.weights.load_reference_params(net, init, device="cpu")
    net.hybridize(remat=True)
    got = _grads_of(net, torch.from_numpy(x), steps=2)
    for step in got:
        for n, r in ref.items():
            np.testing.assert_allclose(step[n].numpy(), r, rtol=0,
                                       atol=TOL, err_msg=n)


def test_remat_policy_is_not_ported():
    with pytest.raises(NotImplementedError, match="jax.checkpoint_policies"):
        _mlp_port().hybridize(remat=True,
                              remat_policy="dots_with_no_batch_dims_saveable")


def test_hybridize_inactive_is_eager_again():
    (x,), _ = _mlp_data()
    x = torch.from_numpy(x)
    net = _mlp_port()
    want = _grads_of(net, x)
    net = _mlp_port()
    net.hybridize()
    assert all(m._cached_graph is not None for m in net.modules()
               if isinstance(m, tmx.gluon.HybridBlock))
    _grads_of(net, x)
    net = _mlp_port()
    net.hybridize()
    net.hybridize(active=False)
    assert all(m.__dict__.get("_cached_graph") is None
               for m in net.modules())
    got = _grads_of(net, x)
    for a, b in zip(want, got):
        assert all(_same_bits(a[n], b[n]) for n in a)


class _HostRead(tmx.gluon.HybridBlock):
    def forward(self, x):
        return x * x.sum().item()


def test_host_read_in_a_capture_raises():
    block = _HostRead()
    block.hybridize()
    x = torch.ones(3)
    block(x)                    # the eager first call may read
    with pytest.raises(graph_capture.CaptureError,
                       match="_local_scalar_dense"):
        block(x)


def test_hybridized_call_counts_no_kernel_on_the_cpu():
    """The launch counters move only where a kernel launches: never on
    the CPU, eager or replayed."""
    from incubator_mxnet_tpu_torch.ops import attention, conv_stats
    (x,), y = _bert_data()
    net = tmx.models.bert_small(device="cpu", **BERT)
    net.hybridize()
    names = ("flash_fwd_launches", "flash_bwd_dq_launches",
             "flash_bwd_dkv_launches", "flash_fwd_causal_launches",
             "flash_bwd_dq_causal_launches", "flash_bwd_dkv_causal_launches")
    before = [getattr(attention, n) for n in names]
    for _ in range(3):
        with tmx.autograd.record():
            h = net(torch.from_numpy(x))
        tmx.autograd.backward(h)
    assert [getattr(attention, n) for n in names] == before
    assert conv_stats.conv1x1_stats_launches == 0
