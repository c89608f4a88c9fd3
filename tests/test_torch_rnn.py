"""PyTorch port: the fused `RNN`/`RNN_varlen` ops, `gluon.rnn` and
`gluon.contrib.rnn` against the JAX package, on the CPU.

The same numpy inputs (T <= 7, B <= 3, H <= 16) and the same parameters
go through both packages.  The fused layers are held to the JAX op (its
`jax.vjp` for the gradients of the data, the flat vector and the states)
for every mode, 1 and 2 layers, one and two directions and both layouts;
outputs and final states within 1e-5 of their scale, gradients within
1e-4.  The cells' `unroll` (both layouts, `valid_length`), the stacked,
residual and bidirectional cells, LSTMP and the convolutional cells are
held to their JAX counterparts within 1e-5.  Dropout cells are held to
the identity at rate 0 and to their mask moments otherwise (the two
packages' generators differ, so no seed is shared).  The flat vector is
named `parameters` in `collect_params()` as in the JAX package, and
torch's `parameters()` keeps working beside it.
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from incubator_mxnet_tpu import nd
from incubator_mxnet_tpu.gluon import rnn as jrnn
from incubator_mxnet_tpu.gluon.block import nameless_scope
from incubator_mxnet_tpu.gluon.contrib import rnn as jcrnn
from incubator_mxnet_tpu.ops import rnn as jops
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch.gluon import rnn as trnn
from incubator_mxnet_tpu_torch.gluon.contrib import rnn as tcrnn
from incubator_mxnet_tpu_torch.ops import rnn as tops

pytestmark = pytest.mark.torch_port

T, B, I, H = 5, 3, 4, 6
OUT_TOL, GRAD_TOL = 1e-5, 1e-4
MODES = ("lstm", "gru", "rnn_tanh", "rnn_relu")
LAYERS = {"lstm": trnn.LSTM, "gru": trnn.GRU,
          "rnn_tanh": lambda *a, **k: trnn.RNN(*a, activation="tanh", **k),
          "rnn_relu": lambda *a, **k: trnn.RNN(*a, activation="relu", **k)}


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


def _close(got, ref, tol, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    scale = max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(got.astype(np.float64) - ref).max())
    assert err <= tol * scale, (what, err, scale)


def _op_inputs(mode, layers, bi, seed=0):
    rs = np.random.RandomState(seed)
    d = 2 if bi else 1
    n = tops.rnn_param_size(mode, layers, I, H, bi)
    assert n == jops.rnn_param_size(mode, layers, I, H, bi)
    arrays = [rs.randn(T, B, I), rs.uniform(-0.5, 0.5, n),
              rs.randn(layers * d, B, H) * 0.5]
    if mode == "lstm":
        arrays.append(rs.randn(layers * d, B, H) * 0.5)
    return [a.astype(np.float32) for a in arrays]


def _jax_vjp(mode, layers, bi, inputs, seq_len=None):
    """The JAX op's outputs and the gradients of all its inputs for
    seeded cotangents on every output: one jitted program (op by op,
    the scans compile apart, 3-5x slower)."""
    kw = dict(state_size=H, num_layers=layers, bidirectional=bi, mode=mode)
    if seq_len is not None:
        kw.update(use_sequence_length=True,
                  sequence_length=jnp.asarray(seq_len))

    def f(*xs):
        return jops.rnn(*xs, **kw)
    xs = [jnp.asarray(a) for a in inputs]
    rs = np.random.RandomState(9)
    cots = tuple(rs.uniform(-1, 1, o.shape).astype(np.float32)
                 for o in jax.eval_shape(f, *xs))

    def run(xs, cts):
        outs, vjp = jax.vjp(f, *xs)
        return outs, vjp(cts)
    outs, grads = jax.jit(run)(xs, tuple(jnp.asarray(c) for c in cots))
    return [np.asarray(o) for o in outs], cots, [np.asarray(g)
                                                 for g in grads]


@functools.lru_cache(maxsize=None)
def _jax_case(mode, layers, bi):
    """Inputs and the JAX reference of one fused case (both layouts hold
    the port to it)."""
    inputs = _op_inputs(mode, layers, bi)
    return (inputs,) + _jax_vjp(mode, layers, bi, inputs)


def _layer(mode, layers, bi, layout, flat):
    net = LAYERS[mode](H, num_layers=layers, bidirectional=bi,
                       layout=layout, input_size=I, device="cpu")
    with torch.no_grad():
        net.flat_param.copy_(torch.from_numpy(flat))
    return net


CASES = [(m, n, bi, lay) for m in MODES for n in (1, 2)
         for bi in (False, True) for lay in ("TNC", "NTC")]


@pytest.mark.parametrize("mode,layers,bi,layout", CASES, ids=[
    "%s-%dl-%s-%s" % (m, n, "bi" if b else "uni", lay)
    for m, n, b, lay in CASES])
def test_fused_layer_matches_jax_op(mode, layers, bi, layout):
    """The Gluon layer with explicit states: y and the final states, and
    the gradients of the data, the flat vector and the states."""
    inputs, ref, cots, ref_grads = _jax_case(mode, layers, bi)
    net = _layer(mode, layers, bi, layout, inputs[1])
    x = torch.from_numpy(inputs[0])
    if layout == "NTC":
        x = x.transpose(0, 1).contiguous()
    x.requires_grad_()
    states = [torch.from_numpy(a).requires_grad_() for a in inputs[2:]]
    with tmx.autograd.record():
        y, new = net(x, states)
    outs = [y.transpose(0, 1) if layout == "NTC" else y] + list(new)
    assert len(outs) == len(ref)
    for k, (o, r) in enumerate(zip(outs, ref)):
        _close(o, r, OUT_TOL, "output %d" % k)
    grads = torch.autograd.grad(outs, [x, net.flat_param] + states,
                                [torch.from_numpy(c) for c in cots])
    gx = grads[0].transpose(0, 1) if layout == "NTC" else grads[0]
    for k, (g, r) in enumerate(zip([gx] + list(grads[1:]), ref_grads)):
        _close(g, r, GRAD_TOL, "gradient of input %d" % k)


@pytest.mark.parametrize("mode,bi", [("lstm", False), ("lstm", True),
                                     ("gru", True), ("rnn_relu", False)])
def test_varlen_op_matches_jax(mode, bi):
    """`RNN_varlen` (and `RNN(use_sequence_length=True)`) against the JAX
    op at two layers, rows of lengths 5, 3 and 1: outputs, final states
    and every gradient."""
    inputs = _op_inputs(mode, 2, bi, seed=1)
    seq_len = np.array([5, 3, 1], np.int32)
    ref, cots, ref_grads = _jax_vjp(mode, 2, bi, inputs, seq_len)
    ts = [torch.from_numpy(a).requires_grad_() for a in inputs]
    if mode != "lstm":
        ts.append(None)
    outs = tops.rnn_varlen(*ts, torch.from_numpy(seq_len), state_size=H,
                           num_layers=2, bidirectional=bi, mode=mode)
    for k, (o, r) in enumerate(zip(outs, ref)):
        _close(o, r, OUT_TOL, "output %d" % k)
    assert float(outs[0][1:, 2].detach().abs().max()) == 0.0  # length 1
    grads = torch.autograd.grad(outs, [t for t in ts if t is not None],
                                [torch.from_numpy(c) for c in cots])
    for k, (g, r) in enumerate(zip(grads, ref_grads)):
        _close(g, r, GRAD_TOL, "gradient of input %d" % k)


@pytest.mark.parametrize("bi", [False, True], ids=["uni", "bi"])
def test_varlen_equals_the_truncated_run(bi):
    """The prefill exactness contract (test_generation.py's
    test_rnn_varlen_matches_truncated_run) in the port: RNN_varlen over
    a right-padded batch equals each row run at its own length, outputs
    and final h and c, both directions; the padded tail emits 0."""
    rs = np.random.RandomState(3)
    x = torch.from_numpy(rs.randn(6, 2, 4).astype(np.float32))
    layers = 1 if bi else 2
    tmx.random.seed(0)
    lstm = trnn.LSTM(8, num_layers=layers, bidirectional=bi, layout="TNC",
                     device="cpu")
    with torch.no_grad():
        y_full = lstm(x)
        s0 = lstm.begin_state(batch_size=2)
        y, h, c = tmx.nd.RNN_varlen(
            tmx.nd.array(x), tmx.nd.array(lstm.flat_param.detach()),
            tmx.nd.array(s0[0]), tmx.nd.array(s0[1]),
            tmx.nd.array(np.array([4, 6], np.int32), ctx="cpu"),
            state_size=8, num_layers=layers, bidirectional=bi, mode="lstm")
        y, h, c = (a._data for a in (y, h, c))
        y4, (h4, c4) = lstm(x[:4, 0:1], lstm.begin_state(batch_size=1))
    np.testing.assert_allclose(y[:4, 0].numpy(), y4[:, 0].numpy(), atol=1e-6)
    np.testing.assert_allclose(h[:, 0].numpy(), h4[:, 0].numpy(), atol=1e-6)
    np.testing.assert_allclose(c[:, 0].numpy(), c4[:, 0].numpy(), atol=1e-6)
    np.testing.assert_allclose(y[:, 1].numpy(), y_full[:, 1].numpy(),
                               atol=1e-6)
    assert float(y[4:, 0].abs().max()) == 0.0


def test_layer_without_states_returns_output_only_and_state_info():
    net = trnn.GRU(H, num_layers=2, bidirectional=True, layout="NTC",
                   input_size=I, device="cpu")
    y = net(torch.zeros(B, T, I))
    assert isinstance(y, torch.Tensor) and y.shape == (B, T, 2 * H)
    assert net.state_info(B) == [{"shape": (4, B, H)}]
    lstm = trnn.LSTM(H, num_layers=3, device="cpu")
    s = lstm.begin_state(batch_size=B)
    assert [tuple(t.shape) for t in s] == [(3, B, H)] * 2
    # NDArrays in, the state list too: NDArrays out, as in the JAX package
    y, new = lstm(tmx.nd.zeros((T, B, H), ctx="cpu"),
                  [tmx.nd.array(t) for t in s])
    assert isinstance(y, tmx.nd.NDArray) and y.shape == (T, B, H)
    assert all(isinstance(t, tmx.nd.NDArray) for t in new)
    out, st = trnn.GRUCell(H, device="cpu").unroll(
        T, tmx.nd.zeros((B, T, I), ctx="cpu"))
    assert isinstance(out, tmx.nd.NDArray) and out.shape == (B, T, H)
    assert isinstance(st[0], tmx.nd.NDArray)
    with pytest.raises(Exception):
        trnn.LSTM(H, layout="NCT")


# -- the flat vector's name, deferred widths, cast ---------------------------

def _jax_layer_keys(cls, x):
    net = cls()
    net.initialize()
    net(nd.array(x))
    return {n: p.data().asnumpy()
            for n, p in net._collect_params_with_prefix().items()}


@pytest.mark.parametrize("name", ["LSTM", "GRU", "RNN"])
def test_flat_vector_keys_deferred_width_cast_and_loading(name):
    """A layer built without a width or a device: `initialize`, a forward
    takes the width, `Module.parameters()` works throughout, `cast`
    reaches the flat vector, and the JAX layer's parameter dict (key
    `parameters`) loads unchanged into a fresh deferred layer."""
    x = np.random.RandomState(0).randn(T, B, I).astype(np.float32)
    jparams = _jax_layer_keys(lambda: getattr(jrnn, name)(
        H, num_layers=2, bidirectional=True), x)
    net = getattr(trnn, name)(H, num_layers=2, bidirectional=True)
    assert net.flat_param.name == net.prefix + "parameters"
    assert list(net.collect_params()) == ["parameters"] == list(jparams)
    assert len(list(net.parameters())) == 1
    net.initialize(ctx="cpu")
    net(torch.from_numpy(x))
    assert tuple(net.flat_param.shape) == jparams["parameters"].shape
    assert net._own_params()["parameters"] is net.flat_param
    assert list(net.state_dict()) == ["parameters"]
    net.cast("bfloat16")
    assert net.flat_param.dtype == torch.bfloat16
    assert net(torch.from_numpy(x).bfloat16()).dtype == torch.bfloat16
    fresh = getattr(trnn, name)(H, num_layers=2, bidirectional=True)
    tmx.weights.load_reference_params(fresh, jparams, device="cpu")
    np.testing.assert_array_equal(fresh.flat_param.detach().numpy(),
                                  jparams["parameters"])


def test_hybridized_layer_is_the_eager_layer_bit_for_bit():
    """The flat vector reaches a captured program (the CPU's recorded
    ops): 3 calls (eager, capture, replay) of a hybridized LSTM and their
    gradients equal the eager layer's."""
    inputs = _op_inputs("lstm", 2, True, seed=4)
    grads = []
    for hybrid in (False, True):
        net = _layer("lstm", 2, True, "TNC", inputs[1])
        if hybrid:
            net.hybridize()
        got = []
        for _ in range(3):
            x = torch.from_numpy(inputs[0])
            with tmx.autograd.record():
                y = net(x)
            tmx.autograd.backward(y.sum())
            got.append((y.detach().clone(), net.flat_param.grad.clone()))
        grads.append(got)
        if hybrid:
            assert net._cached_graph.captures == 2     # forward, backward
            assert net._cached_graph.replays >= 1
    for (a, ga), (b, gb) in zip(*grads):
        assert torch.equal(a, b) and torch.equal(ga, gb)


def test_F_RNN_in_a_user_hybrid_forward():
    """`F.RNN` in a `hybrid_forward(F, ...)` block, and `nd.RNN` on
    NDArrays, run the port's op."""
    inputs = _op_inputs("gru", 1, False, seed=5)

    class Step(tmx.gluon.HybridBlock):
        def hybrid_forward(self, F, x, w, h0):
            return F.RNN(x, w, h0, state_size=H, mode="gru",
                         state_outputs=False)

    out = Step()(*[tmx.nd.array(a, ctx="cpu") for a in inputs])
    ref = tops.rnn(*[torch.from_numpy(a) for a in inputs], state_size=H,
                   mode="gru", state_outputs=False)
    assert isinstance(out, tmx.nd.NDArray)
    assert torch.equal(out._data, ref)
    y, h = tmx.nd.RNN(*[tmx.nd.array(a, ctx="cpu") for a in inputs],
                      state_size=H, mode="gru")
    assert torch.equal(y._data, ref) and h.shape == (1, B, H)


# -- cells -------------------------------------------------------------------

def _pair_cells(make_j, make_t, x, layout):
    """A JAX cell initialized and run once (its widths), and the port's
    cell carrying its parameters."""
    jcell = make_j()
    jcell.initialize()
    jcell.unroll(T, nd.array(x), layout=layout)
    params = {n: p.data().asnumpy()
              for n, p in jcell._collect_params_with_prefix().items()}
    tcell = make_t()
    assert sorted(tcell.collect_params()) == sorted(params)
    tmx.weights.load_reference_params(tcell, params)
    return jcell, tcell


def _cmp_unroll(jcell, tcell, x, layout, valid=None, **kw):
    jv = None if valid is None else nd.array(valid)
    tv = None if valid is None else torch.from_numpy(valid)
    jout, jst = jcell.unroll(T, nd.array(x), layout=layout,
                             valid_length=jv, **kw)
    with torch.no_grad():
        tout, tst = tcell.unroll(T, torch.from_numpy(x), layout=layout,
                                 valid_length=tv, **kw)
    _close(tout, jout.asnumpy(), OUT_TOL, "outputs")
    assert len(tst) == len(jst)
    for a, b in zip(tst, jst):
        _close(a, b.asnumpy(), OUT_TOL, "states")


def _x(layout, shape=(I,), seed=2):
    lead = (B, T) if layout == "NTC" else (T, B)
    return np.random.RandomState(seed).randn(*(lead + shape)).astype(
        np.float32)


def _device_cell(make, mod):
    cell = make(mod)
    cell.initialize(ctx="cpu")
    return cell


CELLS = {
    "RNNCell": lambda m: m.RNNCell(H, activation="relu"),
    "LSTMCell": lambda m: m.LSTMCell(H),
    "GRUCell": lambda m: m.GRUCell(H),
}


@pytest.mark.parametrize("layout", ["NTC", "TNC"])
@pytest.mark.parametrize("name", sorted(CELLS))
def test_cell_unroll_matches_jax(name, layout):
    make = CELLS[name]
    x = _x(layout)
    jcell, tcell = _pair_cells(lambda: make(jrnn),
                               lambda: _device_cell(make, trnn), x, layout)
    _cmp_unroll(jcell, tcell, x, layout)
    _cmp_unroll(jcell, tcell, x, layout,
                valid=np.array([5, 2, 3], np.float32))


def test_stacked_residual_and_bidirectional_cells_match_jax():
    x = _x("NTC")

    def seq(m):
        net = m.SequentialRNNCell()
        net.add(m.LSTMCell(H))
        net.add(m.ResidualCell(m.GRUCell(H, input_size=H)))
        return net
    jcell, tcell = _pair_cells(lambda: seq(jrnn),
                               lambda: _device_cell(seq, trnn), x, "NTC")
    assert len(tcell) == 2
    assert "1.base_cell.h2h_weight" in tcell.collect_params()
    _cmp_unroll(jcell, tcell, x, "NTC")

    def bi(m):
        return m.BidirectionalCell(m.LSTMCell(H), m.GRUCell(H))
    jcell, tcell = _pair_cells(lambda: bi(jrnn),
                               lambda: _device_cell(bi, trnn), x, "NTC")
    _cmp_unroll(jcell, tcell, x, "NTC")
    with pytest.raises(tmx.base.MXNetError):
        tcell(torch.zeros(B, I), tcell.begin_state(B, ctx="cpu"))


def test_lstmp_cell_matches_jax():
    x = _x("TNC")

    def make(m):
        return m.LSTMPCell(H, 3)
    jcell, tcell = _pair_cells(lambda: make(jcrnn),
                               lambda: _device_cell(make, tcrnn), x, "TNC")
    _cmp_unroll(jcell, tcell, x, "TNC")
    assert [tuple(s["shape"]) for s in tcell.state_info(B)] == \
        [(B, 3), (B, H)]


@pytest.mark.parametrize("name,spatial", [
    ("Conv1DLSTMCell", (7,)), ("Conv1DGRUCell", (7,)),
    ("Conv2DLSTMCell", (4, 5)), ("Conv2DGRUCell", (4, 5))])
def test_conv_cells_match_jax(name, spatial):
    shape = (2,) + spatial
    x = _x("NTC", shape)

    def make(m):
        return getattr(m, name)(shape, 3, i2h_kernel=3, h2h_kernel=3)
    jcell, tcell = _pair_cells(lambda: make(jcrnn),
                               lambda: _device_cell(make, tcrnn), x, "NTC")
    _cmp_unroll(jcell, tcell, x, "NTC")


def test_conv_cell_custom_pad_and_every_rank():
    for k, cls in ((1, tcrnn.Conv1DRNNCell), (2, tcrnn.Conv2DRNNCell),
                   (3, tcrnn.Conv3DRNNCell), (3, tcrnn.Conv3DLSTMCell),
                   (3, tcrnn.Conv3DGRUCell)):
        cell = cls((2,) + (5,) * k, 3, i2h_pad=0, device="cpu")
        out, st = cell.unroll(2, torch.zeros((B, 2, 2) + (5,) * k))
        assert out.shape == (B, 2, 3) + (3,) * k
        assert all(s.shape == (B, 3) + (3,) * k for s in st)


# -- dropout cells -----------------------------------------------------------

def _lstm_cell():
    return trnn.LSTMCell(H, input_size=I, device="cpu")


def test_dropout_cells_are_the_identity_at_rate_zero():
    x = torch.from_numpy(_x("NTC"))
    tmx.random.seed(1)
    base = _lstm_cell()
    ref, ref_st = base.unroll(T, x)
    for wrap in (lambda c: tcrnn.VariationalDropoutCell(c),
                 lambda c: trnn.ZoneoutCell(c)):
        with tmx.autograd.record():
            out, st = wrap(base).unroll(T, x)
        assert torch.equal(out, ref)
        assert all(torch.equal(a, b) for a, b in zip(st, ref_st))
    seq = trnn.SequentialRNNCell()
    seq.add(trnn.DropoutCell(0.0))
    seq.add(base)
    with tmx.autograd.record():
        out, _ = seq.unroll(T, x)
    assert torch.equal(out, ref)


def test_dropout_cell_moments():
    p = 0.3
    x = torch.ones(2000, 4, 50)
    cell = trnn.DropoutCell(p)
    with tmx.autograd.record():
        out, st = cell.unroll(4, x)
    a = out.numpy()
    assert st == [] and set(np.unique(a)) <= {0.0, np.float32(1 / 0.7)}
    assert abs((a == 0).mean() - p) < 0.01
    out, _ = cell.unroll(4, x)          # not training: the identity
    assert torch.equal(out, x)


def test_variational_dropout_keeps_one_mask_per_sequence():
    p = 0.4
    cell = tcrnn.VariationalDropoutCell(trnn.ResidualCell(
        _IdentityCell()), drop_inputs=p, drop_outputs=0.0)
    x = torch.ones(1000, 6, 40)
    with tmx.autograd.record():
        out, _ = cell.unroll(6, x)
    a = out.numpy()                 # the input through the mask
    assert (a == a[:, :1]).all()    # the same mask at every step
    assert abs((a[:, 0] == 0).mean() - p) < 0.02
    assert set(np.unique(a)) <= {0.0, np.float32(1 / 0.6)}
    with tmx.autograd.record():
        out2, _ = cell.unroll(6, x)     # a new sequence: a new mask
    assert not torch.equal(out, out2)


class _IdentityCell(trnn.RecurrentCell):
    """A stateless cell that emits 0, so that a ResidualCell around it
    emits its input."""

    def state_info(self, batch_size=0):
        return []

    def forward(self, x, states):
        return torch.zeros_like(x), states


def test_zoneout_moments():
    p = 0.25
    base = _IdentityResidual()
    cell = trnn.ZoneoutCell(base, zoneout_outputs=p)
    x = torch.ones(400, 2, 50)
    with tmx.autograd.record():
        out, _ = cell.unroll(2, x)
    a = out.numpy()
    # step 0 keeps the previous output (0) where zoned out
    assert abs((a[:, 0] == 0).mean() - p) < 0.02
    assert set(np.unique(a)) <= {0.0, 1.0}


class _IdentityResidual(trnn.ResidualCell):
    def __init__(self):
        super().__init__(_IdentityCell())
