"""PyTorch port: the fused 1x1-conv + BatchNorm-statistics kernel's plain
version against the JAX package's Pallas kernel, and the fused
Conv2D → BatchNorm pair against the unfused one and against JAX.

The Pallas kernel lives in tools/conv_stats_pallas_experiment.py, which
runs a TPU benchmark when imported.  The tests take only its imports and
its two functions (`fused_conv1x1_stats`, `xla_ref`) from its syntax
tree and run the kernel in Pallas interpret mode on the CPU.
"""
import ast
import functools
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from incubator_mxnet_tpu import autograd as jag
from incubator_mxnet_tpu import nd
from incubator_mxnet_tpu.gluon import nn as jnn_layers
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch.gluon import nn as tnn_layers
from incubator_mxnet_tpu_torch.ops import conv_stats as tcs

pytestmark = pytest.mark.torch_port

TOOL = pathlib.Path(__file__).resolve().parents[1] / "tools" / \
    "conv_stats_pallas_experiment.py"


class _InterpretPallas:
    """`pl` with `pallas_call` in interpret mode (the CPU runs the
    kernel's body as jax ops)."""

    pallas_call = staticmethod(functools.partial(pl.pallas_call,
                                                 interpret=True))

    def __getattr__(self, name):
        return getattr(pl, name)


@pytest.fixture(scope="module")
def tool():
    """(fused_conv1x1_stats, xla_ref) of the tool, its kernel run in
    interpret mode."""
    tree = ast.parse(TOOL.read_text(), filename=str(TOOL))
    keep = [node for node in tree.body
            if isinstance(node, (ast.Import, ast.ImportFrom))
            or (isinstance(node, ast.FunctionDef)
                and node.name in ("fused_conv1x1_stats", "xla_ref"))]
    assert len([n for n in keep if isinstance(n, ast.FunctionDef)]) == 2
    ns = {}
    exec(compile(ast.Module(body=keep, type_ignores=[]), str(TOOL), "exec"),
         ns)
    ns["pl"] = _InterpretPallas()
    return ns["fused_conv1x1_stats"], ns["xla_ref"]


def _inputs(N, C, HW, O, seed=0):
    rs = np.random.RandomState(seed)
    return (rs.randn(N, C, HW).astype(np.float32),
            (rs.randn(O, C) * 0.05).astype(np.float32))


def _f32(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


# (N, C, HW, O, thw): O a multiple of min(256, O) and HW of thw, as the
# TPU kernel needs; HW > thw sums the statistics across the h grid axis
KERNEL_CASES = [(2, 8, 16, 32, 16), (2, 16, 64, 48, 32), (3, 24, 32, 64, 16),
                # MobileNetV2's channel counts off a multiple of 32, which
                # the card's CUDA-core instance takes: 16 -> 96, 24 -> 144,
                # 144 -> 24
                (2, 16, 32, 96, 16), (2, 24, 32, 144, 16),
                (2, 144, 32, 24, 16)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("N,C,HW,O,thw", KERNEL_CASES)
def test_plain_version_matches_pallas_kernel(tool, N, C, HW, O, thw, dtype):
    kernel, _ = tool
    x, w = _inputs(N, C, HW, O)
    jdt = getattr(jnp, dtype)
    y, s1, s2 = kernel(jnp.asarray(x, jdt), jnp.asarray(w, jdt), thw)
    tdt = getattr(torch, dtype)
    ty, ts1, ts2 = tcs.fused_conv1x1_stats(
        torch.from_numpy(x).to(tdt), torch.from_numpy(w).to(tdt))
    assert ty.dtype == tdt and ty.shape == (N, O, HW)
    assert ts1.dtype == ts2.dtype == torch.float32
    assert ts1.shape == ts2.shape == (1, O)
    ref = _f32(y)
    if dtype == "float32":
        # the same f32 sums over C in another order
        np.testing.assert_allclose(ty.numpy(), ref, rtol=0, atol=1e-5)
    else:
        # both round the f32 accumulator to the dtype; another summation
        # order can tip a rounding by one ulp (at most 2**-7 of |y| in
        # bf16, 2**-10 in f16, and 2**-24 among f16's subnormals)
        rel, low = {"bfloat16": (2.0 ** -7, 0.0),
                    "float16": (2.0 ** -10, 2.0 ** -24)}[dtype]
        err = np.abs(ty.float().numpy() - ref)
        assert (err <= rel * np.abs(ref) + low).all()
    # both sum the f32 accumulator, before its rounding: f32 sums of
    # N·HW terms in another order
    np.testing.assert_allclose(ts1.numpy(), _f32(s1), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ts2.numpy(), _f32(s2), rtol=1e-5, atol=1e-5)


def test_bf16_sums_are_taken_before_rounding(tool):
    # the tool's xla_ref sums the rounded bf16 y; the kernel (and the
    # port) sum the f32 accumulator: in bf16 the two differ, in f32 not
    kernel, xla_ref = tool
    x, w = _inputs(2, 8, 16, 32)
    xb, wb = jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16)
    _, s1k, _ = kernel(xb, wb, 16)
    _, s1r, _ = xla_ref(xb, wb)
    _, ts1, _ = tcs.fused_conv1x1_stats(torch.from_numpy(x).bfloat16(),
                                        torch.from_numpy(w).bfloat16())
    assert np.abs(_f32(s1k) - _f32(s1r)).max() > 1e-4
    np.testing.assert_allclose(ts1.numpy(), _f32(s1k), rtol=1e-5, atol=1e-5)


def test_conv1x1_stats_gradients_match_jax(tool):
    _, xla_ref = tool
    N, C, HW, O = 3, 12, 20, 10
    x, w = _inputs(N, C, HW, O, seed=1)
    dy = np.random.RandomState(2).randn(N, O, HW).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b: xla_ref(a, b)[0], jnp.asarray(x),
                     jnp.asarray(w))
    ref_dx, ref_dw = vjp(jnp.asarray(dy))
    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    y, s1, s2 = tcs.conv1x1_stats(tx, tw)
    assert not s1.requires_grad and not s2.requires_grad
    y.backward(torch.from_numpy(dy))
    # f32 sums in another order
    np.testing.assert_allclose(tx.grad.numpy(), _f32(ref_dx), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(tw.grad.numpy(), _f32(ref_dw), rtol=0,
                               atol=1e-5)


def test_kernel_wrapper_checks_and_cpu_route():
    x = torch.zeros(2, 4, 6)
    w = torch.zeros(3, 4)
    before = tcs.conv1x1_stats_launches
    tcs.fused_conv1x1_stats(x, w)           # CPU: the plain version
    assert tcs.conv1x1_stats_launches == before
    with pytest.raises(ValueError, match="CUDA or CPU"):
        tcs.fused_conv1x1_stats(x.to("meta"), w.to("meta"))
    check = tcs._check_operands
    with pytest.raises(ValueError, match="float32, bfloat16 or float16"):
        check(x.double(), w.double())
    with pytest.raises(ValueError, match="one dtype"):
        check(x, w.bfloat16())
    with pytest.raises(ValueError, match=r"\(N, C, HW\) and w \(O, C\)"):
        check(x, torch.zeros(3, 5))
    with pytest.raises(ValueError, match="contiguous"):
        check(torch.zeros(2, 6, 4).transpose(1, 2), w)
    check(x, w)


# --- the fused Conv2D → BatchNorm pair ------------------------------------

def _pair(conv_kw=None, bn_kw=None):
    seq = tnn_layers.HybridSequential()
    conv_kw = dict(dict(use_bias=False), **(conv_kw or {}))
    seq.add(tnn_layers.Conv2D(12, 1, in_channels=6, device="cpu", **conv_kw))
    seq.add(tnn_layers.BatchNorm(in_channels=12, device="cpu",
                                 **(bn_kw or {})))
    return seq


def _run_pair(seq, x, dy, fused_calls, record=True):
    """Forward (inside record() unless told otherwise) and backward of
    `seq`; returns output, grads (x, weight, gamma, beta), running
    statistics and the number of fused-kernel calls."""
    before = len(fused_calls)
    tx = torch.from_numpy(x).requires_grad_()
    if record:
        with tmx.autograd.record():
            out = seq(tx)
        tmx.autograd.backward(
            out, None if dy is None else torch.from_numpy(dy))
        grads = [t.grad.numpy().copy() for t in
                 (tx, seq[0].weight, seq[1].gamma, seq[1].beta)]
    else:
        with torch.no_grad():
            out = seq(tx)
        grads = None
    stats = [seq[1].running_mean.detach().numpy().copy(),
             seq[1].running_var.detach().numpy().copy()]
    return out.detach().numpy(), grads, stats, len(fused_calls) - before


@pytest.fixture
def fused_calls(monkeypatch):
    calls = []
    orig = tcs.fused_conv1x1_stats
    monkeypatch.setattr(tcs, "fused_conv1x1_stats",
                        lambda x, w: calls.append(1) or orig(x, w))
    return calls


@pytest.fixture(scope="module")
def pair_data():
    rs = np.random.RandomState(5)
    x = (rs.randn(3, 6, 5, 7) + 0.5).astype(np.float32)
    dy = rs.randn(3, 12, 5, 7).astype(np.float32)
    tmx.random.seed(4)
    params = {n: p.detach().numpy().copy()
              for n, p in _pair().collect_params().items()}
    params["1.gamma"] = rs.uniform(0.5, 1.5, 12).astype(np.float32)
    params["1.beta"] = rs.randn(12).astype(np.float32)
    return x, dy, params


def test_fused_pair_matches_unfused_pair(pair_data, fused_calls):
    x, dy, params = pair_data
    fused = tmx.weights.load_reference_params(_pair(), params)
    got = _run_pair(fused, x, dy, fused_calls)
    assert got[3] == 1                      # the pair ran fused

    class Unfused(tmx.gluon.HybridBlock):
        def __init__(self, seq):
            super().__init__()
            self.seq = seq

        def __getitem__(self, i):
            return self.seq[i]

        def forward(self, t):
            return self.seq[1](self.seq[0](t))   # each child on its own

    unfused = Unfused(tmx.weights.load_reference_params(_pair(), params))
    ref = _run_pair(unfused, x, dy, fused_calls)
    assert ref[3] == 0
    # the same function: f32 statistics from sums of the product against
    # statistics from a read of the conv output, another summation order
    np.testing.assert_allclose(got[0], ref[0], rtol=0, atol=1e-5)
    for g, r in zip(got[1] + got[2], ref[1] + ref[2]):
        np.testing.assert_allclose(g, r, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", ["stable_var", "outside_record",
                                  "global_stats", "strided", "bias"])
def test_fusion_only_where_the_sums_are_the_statistics(
        pair_data, fused_calls, monkeypatch, case):
    x, dy, params = pair_data
    conv_kw, bn_kw, record = {}, {}, True
    if case == "stable_var":
        monkeypatch.setenv("MXNET_BN_STABLE_VAR", "1")   # two-pass form
    elif case == "outside_record":
        record = False                      # running statistics normalize
    elif case == "global_stats":
        bn_kw = dict(use_global_stats=True)
    elif case == "strided":
        conv_kw = dict(strides=2)
    else:
        conv_kw = dict(use_bias=True)
    seq = _pair(conv_kw, bn_kw)
    if case == "bias":
        params = dict(params, **{"0.bias": np.zeros(12, np.float32)})
    tmx.weights.load_reference_params(seq, params)
    dy = None if case == "strided" else dy  # the output is smaller
    assert _run_pair(seq, x, dy, fused_calls, record=record)[3] == 0


@pytest.mark.parametrize("stable_var", [False, True], ids=["one_pass",
                                                           "two_pass"])
def test_conv_bn_pair_matches_jax(pair_data, fused_calls, monkeypatch,
                                  stable_var):
    # the port's pair (fused in one-pass mode, unfused in two-pass mode)
    # against the JAX package's Conv2D → BatchNorm, same weights
    x, dy, params = pair_data
    if stable_var:
        monkeypatch.setenv("MXNET_BN_STABLE_VAR", "1")
    jseq = jnn_layers.HybridSequential()
    jseq.add(jnn_layers.Conv2D(12, 1, use_bias=False, in_channels=6))
    jseq.add(jnn_layers.BatchNorm(in_channels=12))
    jseq.initialize()
    jparams = jseq._collect_params_with_prefix()
    assert set(jparams) == set(params)
    for n, p in jparams.items():
        p.set_data(nd.array(params[n]))
    jx = nd.array(x)
    jx.attach_grad()
    with jag.record():
        jout = jseq(jx)
    jout.backward(nd.array(dy))
    ref_grads = [jx.grad.asnumpy()] + [
        jparams[n].grad().asnumpy() for n in ("0.weight", "1.gamma",
                                             "1.beta")]
    ref_stats = [jparams[n].data().asnumpy()
                 for n in ("1.running_mean", "1.running_var")]
    seq = tmx.weights.load_reference_params(_pair(), params)
    out, grads, stats, calls = _run_pair(seq, x, dy, fused_calls)
    assert calls == (0 if stable_var else 1)
    # f32 sums in other orders (XLA's conv and reductions against
    # torch's): each tensor within 1e-5 of its largest value
    np.testing.assert_allclose(out, jout.asnumpy(), rtol=0, atol=1e-5)
    for g, r in zip(grads + stats, ref_grads + ref_stats):
        assert np.abs(g - r).max() <= 1e-5 * max(np.abs(r).max(), 1.0)
