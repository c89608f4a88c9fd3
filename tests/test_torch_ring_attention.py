"""PyTorch port: `parallel.shard_map`, its axis collectives and sequence
parallelism (`ring_attention`, `ulysses_attention`, `local_attention`,
`MultiHeadAttention(seq_parallel=...)`) against the JAX package.

The port's replicas are the CPU contexts `cpu(0..7)`; the JAX side runs
`jax.shard_map` on the 8-device virtual CPU mesh (tests/conftest.py).
Inputs come from `np.random.RandomState`.  Tolerances: f32 outputs
within 2e-5 (absolute, inputs of unit scale), gradients within 1e-4,
bf16 outputs within one bf16 ulp of scale of the JAX bf16 output, and
BERT's forward and weight gradients within 1e-4 of scale.  Every test
runs under a `signal.alarm`, as a deadlocked replica thread shows as a
hang, not a failure.
"""
import functools
import signal
import warnings

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch import parallel as tpar
from incubator_mxnet_tpu_torch.parallel import P

pytestmark = pytest.mark.torch_port

ALARM_S = 120
F32_TOL = 2e-5
GRAD_TOL = 1e-4
BF16_ULP = 2.0 ** -8


@pytest.fixture(autouse=True)
def _alarm():
    def on_alarm(signum, frame):
        raise TimeoutError("shard_map test exceeded %d s" % ALARM_S)
    prev = signal.signal(signal.SIGALRM, on_alarm)
    signal.alarm(ALARM_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, prev)


@pytest.fixture(scope="module")
def jx():
    import jax
    from jax.sharding import Mesh, PartitionSpec
    try:
        from jax import shard_map
    except ImportError:
        from jax.experimental.shard_map import shard_map
    from incubator_mxnet_tpu import parallel as jpar
    return dict(jax=jax, jnp=jax.numpy, Mesh=Mesh, P=PartitionSpec,
                shard_map=shard_map, par=jpar)


def _jmesh(jx, n=8, name="sp"):
    return jx["Mesh"](np.array(jx["jax"].devices()[:n]).reshape(n), (name,))


def _tmesh(n=8, name="sp"):
    return tpar.make_mesh(devices=[tmx.cpu(i) for i in range(n)],
                          axis_names=(name,))


def _qkv(B=2, T=64, H=8, D=16, seed=0):
    rs = np.random.RandomState(seed)
    return [rs.randn(B, T, H, D).astype(np.float32) for _ in range(3)]


def _err(got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-6))


def _jax_sp(jx, fn, causal, dtype=None):
    jfn = getattr(jx["par"], fn)
    spec = jx["P"](None, "sp")
    return jx["shard_map"](functools.partial(jfn, axis_name="sp",
                                             causal=causal),
                           mesh=_jmesh(jx), in_specs=(spec,) * 3,
                           out_specs=spec)


def _port_sp(fn, causal):
    spec = P(None, "sp")
    return tpar.shard_map(functools.partial(getattr(tpar, fn),
                                            axis_name="sp", causal=causal),
                          _tmesh(), in_specs=(spec,) * 3, out_specs=spec)


# -- local_attention ---------------------------------------------------------

@pytest.mark.parametrize("offsets", [(0, 0), (0, 100), (100, 0), (3, 1)])
def test_local_attention_offsets_match_jax(jx, offsets):
    q, k, v = _qkv(B=1, T=8, H=2, D=4)
    qo, ko = offsets
    want = jx["par"].local_attention(q, k, v, causal=True, q_offset=qo,
                                     k_offset=ko)
    got = tpar.local_attention(*map(torch.from_numpy, (q, k, v)),
                               causal=True, q_offset=qo, k_offset=ko)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=F32_TOL)
    if offsets == (0, 100):
        assert torch.all(got[2] == 0)       # a block wholly in the future
    if offsets == (100, 0):
        assert torch.all(got[2] > 0)


# -- ring and Ulysses against jax.shard_map ----------------------------------

@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("fn", ["ring_attention", "ulysses_attention"])
def test_sequence_parallel_matches_jax(jx, fn, causal):
    q, k, v = _qkv()
    want = np.asarray(jx["jax"].jit(_jax_sp(jx, fn, causal))(q, k, v))
    got = _port_sp(fn, causal)(*map(torch.from_numpy, (q, k, v)))
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=F32_TOL)


@pytest.mark.parametrize("fn", ["ring_attention", "ulysses_attention"])
def test_bf16_inputs_match_jax(jx, fn):
    q, k, v = _qkv(B=1, T=32, H=8, D=8)
    jnp = jx["jnp"]
    want = jx["jax"].jit(_jax_sp(jx, fn, False))(
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)))
    got = _port_sp(fn, False)(*(torch.from_numpy(a).to(torch.bfloat16)
                                for a in (q, k, v)))
    assert got.dtype == torch.bfloat16
    assert _err(got.float().numpy(), np.asarray(want, np.float32)) <= \
        BF16_ULP


@pytest.mark.parametrize("fn,causal", [("ring_attention", True),
                                       ("ring_attention", False),
                                       ("ulysses_attention", True)])
def test_gradients_match_jax(jx, fn, causal):
    q, k, v = _qkv(B=1, T=32, H=8, D=8)
    jf = _jax_sp(jx, fn, causal)
    want = jx["jax"].jit(jx["jax"].grad(lambda *a: (jf(*a) ** 2).sum(),
                                        argnums=(0, 1, 2)))(q, k, v)
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    (_port_sp(fn, causal)(*ts) ** 2).sum().backward()
    for t, w in zip(ts, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=0,
                                   atol=GRAD_TOL)


def test_a_dropped_rescale_fails_the_check():
    """The merge without the rescale of the running sum (a_prev = 1,
    chip_smoke's planted ring) is caught by the comparison the tests and
    the card make."""
    import chip_smoke
    q, k, v = _qkv(B=1, T=32, H=2, D=8)
    ts = [torch.from_numpy(a) for a in (q, k, v)]
    ref = _port_sp("ring_attention", False)(*ts)
    spec = P(None, "sp")
    planted = tpar.shard_map(functools.partial(
        chip_smoke.ring_without_rescale(), axis_name="sp"), _tmesh(),
        in_specs=(spec,) * 3, out_specs=spec)(*ts)
    assert _err(planted.numpy(), ref.numpy()) > 1e-2


# -- the collectives ---------------------------------------------------------

def test_collectives_match_lax(jx):
    """psum (and of a Python number), pmean, axis_index, a partial
    ppermute (zero-filled) and tiled/untiled all_to_all, forward and
    gradient, against jax.lax inside jax.shard_map."""
    lax = jx["jax"].lax
    rs = np.random.RandomState(9)
    x = rs.randn(8, 8, 6).astype(np.float32)
    perm = [(i, i + 1) for i in range(7)]

    def jbody(a):
        i = lax.axis_index("sp")
        s = lax.psum(a, "sp") + lax.pmean(a, "sp") * lax.psum(1, "sp")
        p = lax.ppermute(a * (i + 1.0), "sp", perm)
        t = lax.all_to_all(a, "sp", 1, 2, tiled=True)
        u = lax.all_to_all(a, "sp", 1, 0, tiled=False)
        return s, p, t, u

    def tbody(a):
        i = tpar.axis_index("sp")
        s = tpar.psum(a, "sp") + tpar.pmean(a, "sp") * tpar.psum(1, "sp")
        p = tpar.ppermute(a * (i + 1.0), "sp", perm)
        t = tpar.all_to_all(a, "sp", 1, 2, tiled=True)
        u = tpar.all_to_all(a, "sp", 1, 0, tiled=False)
        return s, p, t, u
    jspec, tspec = jx["P"]("sp"), P("sp")
    jf = jx["shard_map"](jbody, mesh=_jmesh(jx), in_specs=(jspec,),
                         out_specs=(jx["P"](), jspec, jspec, jspec))
    tf = tpar.shard_map(tbody, _tmesh(), in_specs=(tspec,),
                        out_specs=(P(), tspec, tspec, tspec))
    want = jx["jax"].jit(jf)(x)
    xt = torch.from_numpy(x).requires_grad_()
    got = tf(xt)
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   rtol=0, atol=1e-5)
    weights = [rs.randn(*w.shape).astype(np.float32) for w in want]
    jg = jx["jax"].jit(jx["jax"].grad(lambda a: sum(
        (o * w).sum() for o, w in zip(jf(a), weights))))(x)
    sum((o * torch.from_numpy(w)).sum() for o, w in
        zip(got, weights)).backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jg), rtol=0,
                               atol=1e-4)


def test_a_failing_replica_raises_instead_of_hanging():
    def body(a):
        if tpar.axis_index("sp") == 3:
            raise RuntimeError("replica 3 failed")
        return tpar.psum(a, "sp")
    f = tpar.shard_map(body, _tmesh(), in_specs=(P("sp"),), out_specs=P())
    with pytest.raises(RuntimeError, match="replica 3 failed"):
        f(torch.zeros(8, 2))
    with pytest.raises(RuntimeError, match="inside a shard_map"):
        tpar.axis_index("sp")


def test_grad_mode_and_training_reach_the_replicas():
    seen = []

    def body(a):
        seen.append((torch.is_grad_enabled(), tmx.autograd.is_training()))
        return a
    f = tpar.shard_map(body, _tmesh(2), in_specs=(P("sp"),),
                       out_specs=P("sp"))
    with torch.no_grad():
        f(torch.zeros(2))
    with tmx.autograd.record():
        f(torch.zeros(2))
    assert seen[:2] == [(False, False)] * 2 and seen[2:] == [(True, True)] * 2


def test_default_mesh_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("the default mesh has cards here")
    with pytest.raises(tmx.MXNetError):
        tpar.shard_map(lambda a: a, in_specs=(P(),), out_specs=P())
    with tmx.cpu():
        f = tpar.shard_map(lambda a: a * 2, in_specs=(P(),), out_specs=P())
    assert torch.equal(f(torch.ones(2)), torch.full((2,), 2.0))


# -- BERT with seq_parallel --------------------------------------------------

BERT_KW = dict(vocab_size=1000, max_length=64, dropout=0.0)


@pytest.fixture(scope="module")
def jax_bert_sp(jx):
    """The JAX bert_small(seq_parallel=...) forward and the gradients of
    layer 0's query and value weights on (2, 32) tokens, and its weights
    as numpy."""
    import incubator_mxnet_tpu as jmx
    from incubator_mxnet_tpu import autograd as jag
    from incubator_mxnet_tpu.models import transformer as jtr
    toks = np.random.RandomState(0).randint(0, 1000, (2, 32)).astype(
        np.int32)
    net = jtr.bert_small(seq_parallel=(_jmesh(jx), "sp"), **BERT_KW)
    net.initialize()
    t = jmx.nd.array(toks, dtype="int32")
    with jag.record():
        y = net(t)
        loss = (y ** 2).sum()
        loss.backward()
    out = y.asnumpy()
    layer = net.encoder.layers._children["0"].attn
    params = {n: p.data().asnumpy()
              for n, p in net._collect_params_with_prefix().items()}
    return dict(toks=toks, out=out, params=params,
                gq=layer.query.weight.grad().asnumpy(),
                gv=layer.value.weight.grad().asnumpy())


def _port_bert(params, **kw):
    net = tmx.models.bert_small(device="cpu", **dict(BERT_KW, **kw))
    tmx.weights.load_reference_params(net, params)
    return net


def test_bert_seq_parallel_matches_jax(jax_bert_sp):
    ref = jax_bert_sp
    net = _port_bert(ref["params"], seq_parallel=(_tmesh(), "sp"))
    toks = torch.from_numpy(ref["toks"])
    out = net(toks)
    assert _err(out.detach().numpy(), ref["out"]) <= 1e-4
    fused = _port_bert(ref["params"])(toks)
    assert _err(out.detach().numpy(), fused.detach().numpy()) <= 1e-4
    attn = net.encoder.layers[0].attn
    gq, gv = torch.autograd.grad((net(toks) ** 2).sum(),
                                 [attn.query.weight, attn.value.weight])
    assert _err(gq.numpy(), ref["gq"]) <= 1e-4
    assert _err(gv.numpy(), ref["gv"]) <= 1e-4
    with pytest.raises(ValueError, match="divide evenly"):
        net(torch.zeros(2, 28, dtype=torch.int32))


def test_seq_parallel_warnings():
    with pytest.warns(UserWarning, match="dropout is not applied"):
        tmx.models.MultiHeadAttention(16, 2, dropout=0.1, device="cpu",
                                      seq_parallel=(_tmesh(2), "sp"))
    mha = tmx.models.MultiHeadAttention(16, 2, device="cpu",
                                        seq_parallel=(_tmesh(2), "sp"))
    x = torch.randn(1, 4, 16)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        ring = mha(x)
    with pytest.warns(UserWarning, match="mask given"):
        masked = mha(x, torch.zeros(1, 1, 1, 4))
    assert _err(masked.detach().numpy(), ring.detach().numpy()) <= 1e-5


def test_seq_parallel_refuses_capture():
    """The ring runs one thread per replica, which a captured program
    does not record: inside a capture the block raises, and it neither
    falls back to the single-device path nor records a partial ring."""
    from incubator_mxnet_tpu_torch import graph_capture
    mha = tmx.models.MultiHeadAttention(16, 2, device="cpu",
                                        seq_parallel=(_tmesh(2), "sp"))
    x = torch.randn(1, 4, 16)
    with pytest.raises(graph_capture.CaptureError, match="captured program"):
        graph_capture.capture(lambda: mha(x), "cpu")
    assert mha(x).shape == (1, 4, 16)
