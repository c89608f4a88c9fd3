"""PyTorch port: the default device under `with cpu():` (fault F5) against
the JAX package.

`with mx.cpu():` sets the default device of every entry point that takes
`ctx=None` / `device=None`, as the JAX package's `with mx.cpu():` does:
array creation, `current_context()`, `initialize()` and the iterators.
An explicit `ctx=` / `device=` still wins, and without a `with` the
default stays `cuda:0`, which raises on this host (no CUDA).  The port
reads torch's own `DeviceContext` (private API), which this file guards
with torch 2.13; a card test guards `with gpu(0):` with the card's torch.
"""
import threading

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu import nd as jnd
from incubator_mxnet_tpu.gluon import nn as jnn
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch import context as tctx
from incubator_mxnet_tpu_torch import nd as tnd
from incubator_mxnet_tpu_torch.base import MXNetError

pytestmark = pytest.mark.torch_port

def _jax_cpu(ctx):
    return ctx.device_type == "cpu"


def test_with_cpu_places_nd_creation_as_jax():
    with jmx.cpu():
        jout = [jnd.zeros((2,)), jnd.ones((2, 3)), jnd.array([1.0, 2.0]),
                jnd.arange(4), jnd.full((2,), 7.0)]
    with tmx.cpu():
        tout = [tnd.zeros((2,)), tnd.ones((2, 3)), tnd.array([1.0, 2.0]),
                tnd.arange(4), tnd.full((2,), 7.0)]
    for t, j in zip(tout, jout):
        assert _jax_cpu(j.context)
        assert t.context == torch.device("cpu")
        np.testing.assert_array_equal(t.asnumpy(), j.asnumpy())


def test_with_cpu_sets_current_context_as_jax():
    with jmx.cpu():
        assert _jax_cpu(jmx.current_context())
        with tmx.cpu():
            assert tmx.current_context() == torch.device("cpu")
            assert tmx.current_device() == torch.device("cpu")
            assert tctx.resolve_device(None) == torch.device("cpu")


def test_with_cpu_initializes_a_block_as_jax():
    with jmx.cpu():
        j = jnn.Dense(3, in_units=2)
        j.initialize()
    with tmx.cpu():
        t = tmx.gluon.nn.Dense(3, in_units=2)
        t.initialize()
    assert _jax_cpu(j.weight.list_ctx()[0])
    assert t.weight.device == torch.device("cpu")
    assert tuple(t.weight.shape) == j.weight.shape


def test_with_cpu_places_ndarray_iter_batches_as_jax():
    data = np.arange(20, dtype=np.float32).reshape(5, 4)
    label = np.arange(5, dtype=np.float32)
    with jmx.cpu():
        jb = list(jmx.io.NDArrayIter(data, label, batch_size=2))
    with tmx.cpu():
        tb = list(tmx.io.NDArrayIter(data, label, batch_size=2))
    assert len(tb) == len(jb)
    for a, b in zip(tb, jb):
        assert a.data[0].context == torch.device("cpu")
        assert _jax_cpu(b.data[0].context)
        np.testing.assert_array_equal(a.data[0].asnumpy(),
                                      b.data[0].asnumpy())
        np.testing.assert_array_equal(a.label[0].asnumpy(),
                                      b.label[0].asnumpy())


def test_explicit_device_wins_and_no_with_still_raises():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal without CUDA")
    with tmx.cpu():
        with pytest.raises(MXNetError, match="no CUDA"):
            tnd.zeros((2,), ctx="cuda:0")
        with pytest.raises(MXNetError, match="no CUDA"):
            tmx.gluon.nn.Dense(3, in_units=2).initialize(ctx="cuda:0")
    assert tnd.zeros((2,), ctx="cpu").context == torch.device("cpu")
    with pytest.raises(MXNetError, match="no CUDA"):
        tmx.current_context()
    with pytest.raises(MXNetError, match="no CUDA"):
        tnd.zeros((2,))
    with pytest.raises(MXNetError, match="no CUDA"):
        tmx.gluon.nn.Dense(3, in_units=2).initialize()


def test_the_with_ends_and_nests():
    assert tctx._entered_device() is None
    with tmx.cpu():
        assert tctx._entered_device() == torch.device("cpu")
        with torch.device("meta"):
            assert tmx.current_context() == torch.device("meta")
        assert tmx.current_context() == torch.device("cpu")
    assert tctx._entered_device() is None


def test_the_default_device_is_per_thread():
    """As the JAX package's context stack, the `with` holds for the thread
    that entered it only."""
    seen = []
    with tmx.cpu():
        th = threading.Thread(target=lambda: seen.append(
            tctx._entered_device()))
        th.start()
        th.join()
        assert tctx._entered_device() == torch.device("cpu")
    assert seen == [None]
