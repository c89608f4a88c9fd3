"""PyTorch port: `models.WideDeep`, `contrib.sparse_jit.
BucketedSparseTrainer`, `LibSVMIter` → `csr_to_fields` and `mx.rnn`
against the JAX package, on the CPU.

Small nets are built and initialized in JAX from a seed and their
`_collect_params_with_prefix()` arrays carried into the port
(`weights.load_reference_params`).  Both packages then run the same
numpy inputs: the forward, 3 hybridized dense Adam steps, the bucketed
trainer on `tests/python/unittest/test_sparse.py`'s four batches and its
overflow case, the static-size unique against `np.unique`, the LibSVM
convergence run's loss trajectory, and `BucketSentenceIter`'s batches.
The chip smoke run's eager-against-bucketed check (`chip_smoke.
_wd_sparse_parity`) is run here with the CPU as the card, and must refuse
its two planted faults.

The wide table's gradient is zero in exact arithmetic: its term adds one
value to both logits, which the softmax ignores.  So it is rounding noise
in both packages, and an Adam step, which divides it by its own root
mean square (or by eps), moves a touched wide row by up to lr in a
direction that noise sets; under Adam the wide table is held to that
bound, `steps x lr` of the JAX table, and its gradient to zero within
`TOL` of the model's largest gradient.  Torch runs on one thread.
"""
import numpy as np
import pytest
import torch

from incubator_mxnet_tpu import autograd as jag
from incubator_mxnet_tpu import gluon as jgluon
from incubator_mxnet_tpu import io as jio
from incubator_mxnet_tpu import nd as jnd
from incubator_mxnet_tpu import random as jrandom
from incubator_mxnet_tpu import rnn as jrnn
from incubator_mxnet_tpu.contrib.sparse_jit import \
    BucketedSparseTrainer as JaxBST
from incubator_mxnet_tpu.gluon.block import nameless_scope
from incubator_mxnet_tpu.models.wide_deep import WideDeep as JaxWideDeep
from incubator_mxnet_tpu.models.wide_deep import csr_to_fields as jcsr_to_fields
import chip_smoke
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch import autograd as tag
from incubator_mxnet_tpu_torch import nd as tnd
from incubator_mxnet_tpu_torch.contrib.sparse_jit import (
    BucketedSparseTrainer, static_unique)

pytestmark = pytest.mark.torch_port

# the forward: the same sums in another order
TOL = 1e-5
# 3 Adam steps of a small net (or the bucketed trainer's steps): the
# gradients' sums in another order, then each update's arithmetic
STEP_TOL = 2e-5
# the LibSVM run's 48 Adam steps, loss by loss
CONVERGENCE_TOL = 1e-4


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x.asnumpy() if hasattr(x, "asnumpy") else x)


def _err(got, ref):
    """(max-abs error, the reference's scale: its max-abs value, at least
    1)."""
    got, ref = _np(got).astype(np.float64), _np(ref).astype(np.float64)
    assert got.shape == ref.shape
    return float(np.abs(got - ref).max()), max(1.0, float(np.abs(ref).max()))


def _close(got, ref, tol, what=""):
    err, scale = _err(got, ref)
    assert err <= tol * scale, (what, err, scale)


def _jax_net(V, sparse_grad, **kw):
    """A JAX WideDeep initialized from seed 0, whatever ran before."""
    with nameless_scope():
        net = JaxWideDeep(V, sparse_grad=sparse_grad, **kw)
    jrandom.seed(0)
    net.initialize()
    return net


def _arrays(net):
    return {n: p.data().asnumpy()
            for n, p in net._collect_params_with_prefix().items()}


def _port_net(V, sparse_grad, params, **kw):
    net = tmx.models.WideDeep(V, sparse_grad=sparse_grad, **kw)
    return tmx.weights.load_reference_params(net, params, device="cpu")


def _batch(rs, V, B, F):
    return (rs.randint(0, V, (B, F)).astype(np.int32),
            rs.rand(B, F).astype(np.float32),
            rs.randint(0, 2, B).astype(np.float32))


def _t(a):
    return torch.from_numpy(np.array(a))


def _j(a):
    return jnd.array(a, dtype="int32" if a.dtype == np.int32 else None)


KW = dict(embed_dim=6, hidden=(12, 8), classes=3)


def test_forward_and_names_match_jax():
    rs = np.random.RandomState(0)
    idx, vals, _ = _batch(rs, 50, 7, 4)
    jnet = _jax_net(50, True, **KW)
    ref = jnet(_j(idx), _j(vals))
    params = _arrays(jnet)
    net = _port_net(50, True, params, **KW)
    assert sorted(net.collect_params()) == sorted(params)
    _close(net(_t(idx), _t(vals)), ref, TOL, "logits")
    out = net(tnd.array(idx, ctx="cpu", dtype="int32"),
              tnd.array(vals, ctx="cpu"))
    _close(out, ref, TOL, "NDArray logits")


def test_dense_hybridized_adam_steps_match_jax():
    """bench.py's headline path at a small size: sparse_grad off, net and
    loss hybridized, Adam, 3 steps; against the JAX package's hybridized
    run (losses and parameters within STEP_TOL of scale, the wide table
    by the bound of the module doc), and bit for bit the port's eager
    run."""
    rs = np.random.RandomState(1)
    V, B, F, lr, steps = 40, 8, 3, 1e-3, 3
    batches = [_batch(rs, V, B, F) for _ in range(steps)]
    jnet = _jax_net(V, False, **KW)
    jnet(_j(batches[0][0]), _j(batches[0][1]))
    params = _arrays(jnet)
    jnet.hybridize(static_alloc=True, static_shape=True)
    jl = jgluon.loss.SoftmaxCrossEntropyLoss()
    jl.hybridize()
    jt = jgluon.Trainer(jnet.collect_params(), "adam",
                        {"learning_rate": lr})
    jlosses = []
    for idx, vals, y in batches:
        with jag.record():
            loss = jl(jnet(_j(idx), _j(vals)), jnd.array(y))
        loss.backward()
        jt.step(B)
        jlosses.append(loss.asnumpy())
    jp = _arrays(jnet)
    runs = {}
    for hybrid in (False, True):
        net = _port_net(V, False, params, **KW)
        head = tmx.gluon.loss.SoftmaxCrossEntropyLoss()
        if hybrid:
            net.hybridize(static_alloc=True, static_shape=True)
            head.hybridize()
        tr = tmx.gluon.Trainer(net.collect_params(), "adam",
                               {"learning_rate": lr})
        losses = []
        for idx, vals, y in batches:
            with tag.record():
                loss = head(net(_t(idx), _t(vals)), _t(y))
            tag.backward(loss)
            tr.step(B)
            losses.append(loss.detach().clone())
        runs[hybrid] = (losses, {n: p.detach().clone() for n, p in
                                 net.collect_params().items()}, tr)
    losses, tp, tr = runs[True]
    assert tr.captures == 1 and tr.replays == 1
    for a, b in zip(losses, jlosses):
        _close(a, b, STEP_TOL, "loss")
    for n, p in tp.items():
        if n == "wide.weight":
            err, _ = _err(p, jp[n])
            assert err <= steps * lr, (n, err)
        else:
            _close(p, jp[n], STEP_TOL, n)
    for a, b in zip(runs[False][0], losses):
        assert torch.equal(a, b)
    for n, p in runs[False][1].items():
        assert torch.equal(p, tp[n]), n


def test_wide_gradient_is_noise_in_both_packages():
    rs = np.random.RandomState(2)
    idx, vals, y = _batch(rs, 30, 6, 3)
    jnet = _jax_net(30, False, **KW)
    jnet(_j(idx), _j(vals))
    net = _port_net(30, False, _arrays(jnet), **KW)
    with jag.record():
        loss = jgluon.loss.SoftmaxCrossEntropyLoss()(
            jnet(_j(idx), _j(vals)), jnd.array(y))
    loss.backward()
    with tag.record():
        tl = tmx.gluon.loss.SoftmaxCrossEntropyLoss()(
            net(_t(idx), _t(vals)), _t(y))
    tag.backward(tl)
    top = max(float(np.abs(_np(p.grad)).max())
              for p in net.collect_params().values())
    for g in (net.wide.weight.grad,
              jnet.wide.weight.grad().asnumpy()):
        assert float(np.abs(_np(g)).max()) <= TOL * top
    for name in ("deep_embed.weight", "mlp.0.weight", "out.bias"):
        jg = jnet._collect_params_with_prefix()[name].grad().asnumpy()
        _close(net.collect_params()[name].grad, jg, TOL, name)


@pytest.mark.parametrize("optimizer,lr", [("adam", 1e-2), ("sgd", 0.1)])
def test_bucketed_trainer_matches_jax(optimizer, lr):
    """test_sparse.py:280-353's batches (vocab 600, embed 8, batch 16 x 4
    fields, pools of 5, 40, 300 and 12 rows) through both packages'
    BucketedSparseTrainer: losses within STEP_TOL, the parameters after
    `sync_to_net` within STEP_TOL of scale (the wide table under Adam by
    the bound of the module doc), untouched rows bit for bit; the JAX
    state carried into a port net equals the port's."""
    vocab, E, B, F = 600, 8, 16, 4
    rs = np.random.RandomState(5)
    jnet = _jax_net(vocab, True, embed_dim=E, hidden=(16,), classes=2)
    i0, v0 = rs.randint(0, vocab, (B, F)), rs.rand(B, F).astype(np.float32)
    jnet(jnd.array(i0, dtype="int32"), jnd.array(v0))
    params = _arrays(jnet)
    net = _port_net(vocab, True, params, embed_dim=E, hidden=(16,),
                    classes=2)
    jt = JaxBST(jnet, optimizer=optimizer, lr=lr)
    tt = BucketedSparseTrainer(net, optimizer=optimizer, lr=lr)
    touched = set()
    for nuniq in (5, 40, 300, 12):
        pool = rs.choice(vocab, size=nuniq, replace=False)
        idx = rs.choice(pool, size=(B, F)).astype(np.int32)
        touched.update(idx.reshape(-1).tolist())
        vals = rs.rand(B, F).astype(np.float32)
        y = rs.randint(0, 2, B).astype(np.float32)
        a = float(jt.step(idx, vals, y).asnumpy())
        b = tt.step(idx, vals, y).item()
        assert abs(a - b) <= STEP_TOL, (nuniq, a, b)
    assert (tt.captures, tt.replays, tt.eager_steps) == (1, 2, 1)
    assert tt.bucket_keys == [(B * F, B, F)]
    jt.sync_to_net()
    tt.sync_to_net()
    jp = _arrays(jnet)
    untouched = sorted(set(range(vocab)) - touched)
    for n, p in net.collect_params().items():
        if n == "wide.weight" and optimizer == "adam":
            err, _ = _err(p, jp[n])
            assert err <= 4 * lr, (n, err)
        else:
            _close(p, jp[n], STEP_TOL, n)
        if n in ("wide.weight", "deep_embed.weight"):
            np.testing.assert_array_equal(_np(p)[untouched],
                                          params[n][untouched])
    carried = _port_net(vocab, True, jp, embed_dim=E, hidden=(16,),
                        classes=2)
    for n, p in carried.collect_params().items():
        np.testing.assert_array_equal(_np(p), jp[n])


def test_bucketed_trainer_overflow_matches_jax():
    """test_sparse.py:356-400: bucket_rows 8, SGD; a batch of 4 unique
    rows fits, one of more than 8 is skipped (the overflow counted, the
    state bit for bit, the previous loss returned), the next fits again;
    every step's loss and the tables as in the JAX package."""
    vocab, E, B, F = 300, 4, 8, 4
    rs = np.random.RandomState(11)
    jnet = _jax_net(vocab, True, embed_dim=E, hidden=(8,), classes=2)
    jnet(jnd.array(rs.randint(0, vocab, (B, F)), dtype="int32"),
         jnd.array(rs.rand(B, F).astype(np.float32)))
    net = _port_net(vocab, True, _arrays(jnet), embed_dim=E, hidden=(8,),
                    classes=2)
    jt = JaxBST(jnet, optimizer="sgd", lr=1e-2, bucket_rows=8)
    tt = BucketedSparseTrainer(net, optimizer="sgd", lr=1e-2,
                               bucket_rows=8)
    pool = rs.choice(vocab, size=4, replace=False)
    idx = rs.choice(pool, size=(B, F)).astype(np.int32)
    vals = rs.rand(B, F).astype(np.float32)
    y = rs.randint(0, 2, B).astype(np.float32)
    idx2 = rs.choice(vocab, size=(B, F), replace=False).astype(np.int32)
    assert len(np.unique(idx2)) > 8
    losses = []
    for k, step_idx in enumerate((idx, idx, idx2, idx)):
        before = {n: v.clone() for n, v in tt._state["tables"].items()}
        t_before = int(tt._state["t"])
        a = float(jt.step(step_idx, vals, y).asnumpy())
        b = tt.step(step_idx, vals, y).item()
        assert abs(a - b) <= STEP_TOL, (k, a, b)
        assert tt.overflow_steps == jt.overflow_steps == (k >= 2)
        losses.append(b)
        if k == 2:
            assert b == losses[1]
            assert int(tt._state["t"]) == t_before
            for n, v in tt._state["tables"].items():
                assert torch.equal(v, before[n]), n
    jt.sync_to_net()
    tt.sync_to_net()
    jp = _arrays(jnet)
    for n, p in net.collect_params().items():
        _close(p, jp[n], STEP_TOL, n)


@pytest.mark.parametrize("K", [16, 11, 9, 5, 1])
def test_static_unique_matches_np_unique(K):
    rs = np.random.RandomState(3)
    flat = rs.randint(0, 40, 16)
    true = np.unique(flat)
    uniq, inv, n = static_unique(torch.from_numpy(flat), K, 40)
    assert int(n) == len(true)
    want = np.full(K, 40)
    want[:min(K, len(true))] = true[:K]
    np.testing.assert_array_equal(uniq.numpy(), want)
    fits = np.searchsorted(true, flat) < K
    np.testing.assert_array_equal(uniq.numpy()[inv.numpy()][fits],
                                  flat[fits])
    assert int(inv.max()) <= K - 1


def _libsvm(tmp_path):
    rs = np.random.RandomState(0)
    vocab, fields, N = 100, 4, 64
    lines = []
    for _ in range(N):
        ids = sorted(rs.choice(vocab, fields, replace=False))
        label = 1 if min(ids) < vocab // 2 else 0
        lines.append("%d %s" % (label, " ".join("%d:%.3f" % (i, 1.0)
                                                for i in ids)))
    path = tmp_path / "train.libsvm"
    path.write_text("\n".join(lines))
    return str(path), vocab, fields


def test_libsvm_to_fields_training_matches_jax(tmp_path):
    """JAX test_wide_deep_libsvm_convergence (test_sparse.py:232-277) in
    both packages from the same weights: LibSVMIter's CSRNDArray batches
    → csr_to_fields (equal) → WideDeep with row_sparse gradients → Adam
    lr 0.02, 12 epochs of 4 batches; the loss trajectory within
    CONVERGENCE_TOL, and halved, as the JAX test asks."""
    path, vocab, fields = _libsvm(tmp_path)
    B = 16
    jnet = _jax_net(vocab, True, embed_dim=8, hidden=(16,), classes=2)
    jnet(jnd.array(np.zeros((1, fields)), dtype="int32"),
         jnd.array(np.zeros((1, fields), np.float32)))
    net = _port_net(vocab, True, _arrays(jnet), embed_dim=8, hidden=(16,),
                    classes=2)
    jit = jio.LibSVMIter(data_libsvm=path, data_shape=(vocab,),
                         batch_size=B)
    tit = tmx.io.LibSVMIter(data_libsvm=path, data_shape=(vocab,),
                            batch_size=B, ctx="cpu")
    jl, tl = jgluon.loss.SoftmaxCrossEntropyLoss(), \
        tmx.gluon.loss.SoftmaxCrossEntropyLoss()
    jt = jgluon.Trainer(jnet.collect_params(), "adam",
                        {"learning_rate": 0.02})
    tt = tmx.gluon.Trainer(net.collect_params(), "adam",
                           {"learning_rate": 0.02})
    jlosses, tlosses = [], []
    for _ in range(12):
        jit.reset()
        tit.reset()
        for jb, tb in zip(jit, tit):
            assert tb.data[0].stype == "csr"
            ji, jv = jcsr_to_fields(jb.data[0], fields)
            ti, tv = tmx.models.csr_to_fields(tb.data[0], fields)
            np.testing.assert_array_equal(ti.asnumpy(), ji.asnumpy())
            np.testing.assert_array_equal(tv.asnumpy(), jv.asnumpy())
            with jag.record():
                a = jl(jnet(ji, jv), jb.label[0])
                a.backward()
            jt.step(B)
            with tag.record():
                b = tl(net(ti, tv), tb.label[0])
            b.backward()
            tt.step(B)
            jlosses.append(float(a.asnumpy().mean()))
            tlosses.append(float(b.asnumpy().mean()))
    assert len(tlosses) == 48
    np.testing.assert_allclose(tlosses, jlosses, rtol=0,
                               atol=CONVERGENCE_TOL)
    assert tlosses[-1] < tlosses[0] * 0.5
    assert net.deep_embed.weight.list_grad()[0].stype == "row_sparse"


def test_bucket_sentence_iter_matches_jax():
    """mx.rnn.BucketSentenceIter: the same RandomState(seed) plan, so both
    packages give the same batches (data, label, bucket_key) over two
    epochs, with the legacy cell names resolving to gluon.rnn's."""
    rs = np.random.RandomState(4)
    sents = [rs.randint(1, 30, rs.randint(2, 14)).tolist()
             for _ in range(90)]
    for kw in (dict(buckets=[5, 10, 15]), dict(buckets=[4, 8],
                                                layout="TN"), dict()):
        j = jrnn.BucketSentenceIter(sents, 4, seed=3, **kw)
        t = tmx.rnn.BucketSentenceIter(sents, 4, seed=3, ctx="cpu", **kw)
        assert t.buckets == j.buckets and t.discarded == j.discarded
        assert t.provide_data == j.provide_data
        assert t.default_bucket_key == j.default_bucket_key
        for _ in range(2):
            j.reset()
            t.reset()
            jb, tb = list(j), list(t)
            assert len(tb) == len(jb) > 0
            for a, b in zip(tb, jb):
                assert a.bucket_key == b.bucket_key
                np.testing.assert_array_equal(a.data[0].asnumpy(),
                                              b.data[0].asnumpy())
                np.testing.assert_array_equal(a.label[0].asnumpy(),
                                              b.label[0].asnumpy())
                assert a.provide_data == b.provide_data
    assert tmx.rnn.LSTMCell is tmx.gluon.rnn.LSTMCell
    assert tmx.rnn.ZoneoutCell is tmx.gluon.rnn.ZoneoutCell


@pytest.fixture
def small_phase(monkeypatch):
    """chip_smoke's train_wide_deep constants at a CPU size, the CPU in
    the card's place."""
    for name, value in dict(WD_DEVICE="cpu", WD_FEATURES=3000,
                            WD_SPARSE_BATCH=64, WD_FIELDS=4, WD_EMBED=8,
                            WD_HIDDEN=(16,), WD_POOLS=(5, 40, 150, 12),
                            WD_OVERFLOW_BUCKET=32, WD_FIT_POOL=10).items():
        monkeypatch.setattr(chip_smoke, name, value)


def test_sparse_parity_check_refuses_planted_faults(small_phase):
    """chip_smoke's (c): the eager sparse path passes against the bucketed
    one (untouched rows bit for bit), and a dense Adam update or an
    off-by-one sentinel fails by more than 10x its limit."""
    batches = chip_smoke._wd_sparse_batches(torch)
    row, ok = chip_smoke._wd_sparse_parity(torch, tmx, batches)
    assert ok, row
    assert row["eager_net"] == dict(captures=0, eager_calls=4)
    assert row["trainer"]["sparse_updates"] == 4
    for fault in ("dense_adam", "sentinel"):
        row, ok = chip_smoke._wd_sparse_parity(torch, tmx, batches, fault)
        assert not ok, fault
        assert row["err_over_scale"]["deep_embed.weight"] \
            > 10 * chip_smoke.WD_SPARSE_TOL, (fault, row)
    assert tmx.nd.sparse.sparse_adam_update.__name__ == \
        "sparse_adam_update"


def test_overflow_check_holds_on_the_cpu(small_phase):
    row, ok = chip_smoke._wd_overflow(torch, tmx)
    assert ok, row
    assert row["unique_rows"] > chip_smoke.WD_OVERFLOW_BUCKET \
        >= row["fit_unique_rows"]
