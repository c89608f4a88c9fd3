"""PyTorch port: metrics and callbacks against the JAX package.

Every ported metric reads the same sequence of numpy batches in both
packages (the port's as torch tensors) and gives the JAX metric's
`get()` within 1e-6.  The port keeps its sums as tensors, so `update`
reads nothing from the device; `get()` does.  `Speedometer`, with
`time.time` patched to a fixed sequence, logs the JAX package's lines
character for character.
"""
import collections
import logging
import time

import numpy as np
import pytest
import torch

from incubator_mxnet_tpu import callback as jcallback
from incubator_mxnet_tpu import metric as jmetric
import incubator_mxnet_tpu_torch as tmx

pytestmark = pytest.mark.torch_port

BatchEndParam = collections.namedtuple(
    "BatchEndParam", ["epoch", "nbatch", "eval_metric", "locals"])


def _softmax(z):
    e = np.exp(z - z.max(axis=-1, keepdims=True))
    return (e / e.sum(axis=-1, keepdims=True)).astype(np.float32)


def _batches(kind, seed=0, n=3):
    """n (labels, predictions) pairs of numpy arrays for a metric kind."""
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        if kind == "class":
            y = rs.randint(0, 7, 16).astype(np.float32)
            p = _softmax(rs.randn(16, 7).astype(np.float32) * 2)
        elif kind == "index":
            y = rs.randint(0, 5, 12).astype(np.float32)
            p = rs.randint(0, 5, 12).astype(np.float32)
        elif kind == "binary":
            y = rs.randint(0, 2, 20).astype(np.float32)
            p = _softmax(rs.randn(20, 2).astype(np.float32))
        elif kind == "binary_prob":
            y = rs.randint(0, 2, 20).astype(np.float32)
            p = rs.rand(20).astype(np.float32)
        elif kind == "sequence":
            y = rs.randint(0, 9, (4, 6)).astype(np.float32)
            p = _softmax(rs.randn(4, 6, 9).astype(np.float32))
        else:                                   # regression
            y = rs.randn(10).astype(np.float32)
            p = (y + 0.3 * rs.randn(10)).astype(np.float32).reshape(10, 1)
        out.append((y, p))
    return out


def _custom(label, pred):
    return float(np.abs(label.reshape(-1) - pred.argmax(-1)).sum()), 3


# name -> (factory over a metric module, batch kind)
METRICS = {
    "accuracy": (lambda m: m.Accuracy(), "class"),
    "accuracy_of_indices": (lambda m: m.Accuracy(), "index"),
    "top_k_3": (lambda m: m.TopKAccuracy(3), "class"),
    "f1": (lambda m: m.F1(), "binary"),
    "f1_of_probabilities": (lambda m: m.F1(), "binary_prob"),
    "mae": (lambda m: m.MAE(), "regression"),
    "mse": (lambda m: m.MSE(), "regression"),
    "rmse": (lambda m: m.RMSE(), "regression"),
    "cross_entropy": (lambda m: m.CrossEntropy(), "class"),
    "nll": (lambda m: m.NegativeLogLikelihood(), "class"),
    "perplexity": (lambda m: m.Perplexity(), "sequence"),
    "perplexity_ignore": (lambda m: m.Perplexity(ignore_label=0),
                          "sequence"),
    "pearsonr": (lambda m: m.PearsonCorrelation(), "regression"),
    "loss": (lambda m: m.Loss(), "regression"),
    "custom": (lambda m: m.CustomMetric(_custom, name="dist"), "class"),
    "np": (lambda m: m.np(lambda l, p: float((l == p.argmax(-1)).mean()),
                          name="hits"), "class"),
    "composite": (lambda m: m.CompositeEvalMetric(["acc", "ce"]), "class"),
    "create_list": (lambda m: m.create(["top_k_accuracy", "nll_loss"]),
                    "class"),
}


@pytest.mark.parametrize("case", sorted(METRICS))
def test_metric_matches_jax(case):
    build, kind = METRICS[case]
    jm, tm = build(jmetric), build(tmx.metric)
    assert type(tm).__name__ == type(jm).__name__
    for y, p in _batches(kind):
        jm.update([y], [p])
        tm.update([torch.from_numpy(y)], [torch.from_numpy(p)])
    ref, got = jm.get(), tm.get()
    assert got[0] == ref[0]
    np.testing.assert_allclose(got[1], ref[1], rtol=1e-6, atol=0)
    assert [n for n, _ in tm.get_name_value()] == \
        [n for n, _ in jm.get_name_value()]
    tm.reset()
    jm.reset()
    np.testing.assert_equal(tm.get()[1], jm.get()[1])


def test_metric_update_keeps_sums_as_tensors():
    acc, top = tmx.metric.Accuracy(), tmx.metric.TopKAccuracy(5)
    y, p = _batches("class")[0]
    pred = torch.from_numpy(p).bfloat16()
    for m in (acc, top):
        m.update(torch.from_numpy(y), pred)      # bare tensors, one batch
        assert isinstance(m.sum_metric, torch.Tensor)
        assert m.sum_metric.dtype == torch.float64
        assert m.num_inst == 16
    hits = (p.astype(np.float32).argmax(1) == y).sum()
    assert acc.get() == ("accuracy", hits / 16)


def test_speedometer_logs_the_jax_lines(monkeypatch, caplog):
    clock = iter(np.arange(100.0, 200.0, 0.25).tolist())
    monkeypatch.setattr(time, "time", lambda: next(clock))
    lines = {}
    for name, mod, metric in (("jax", jcallback, jmetric),
                              ("port", tmx.callback, tmx.metric)):
        caplog.clear()
        acc = metric.Accuracy()
        with caplog.at_level(logging.INFO):
            for auto_reset, m in ((True, acc), (False, None)):
                speed = mod.Speedometer(32, frequent=2,
                                        auto_reset=auto_reset)
                for nbatch, (y, p) in enumerate(_batches("class", n=6)):
                    if m is not None:
                        m.update([torch.from_numpy(y)
                                  if mod is tmx.callback else y],
                                 [torch.from_numpy(p)
                                  if mod is tmx.callback else p])
                    speed(BatchEndParam(1, nbatch, m, None))
        lines[name] = [r.getMessage() for r in caplog.records]
    assert len(lines["jax"]) == 4 and lines["port"] == lines["jax"]


def test_metric_callbacks_log_the_jax_lines(caplog):
    lines = {}
    for name, mod, metric in (("jax", jcallback, jmetric),
                              ("port", tmx.callback, tmx.metric)):
        caplog.clear()
        m = metric.MSE()
        y, p = _batches("regression")[0]
        m.update([y], [p])
        with caplog.at_level(logging.INFO):
            mod.log_train_metric(2)(BatchEndParam(3, 4, m, None))
            mod.LogValidationMetricsCallback()(BatchEndParam(3, 4, m, None))
            mod.ProgressBar(10, length=20)(BatchEndParam(3, 4, m, None))
        lines[name] = [r.getMessage() for r in caplog.records]
    assert len(lines["jax"]) == 3 and lines["port"] == lines["jax"]
