"""`autograd` of the PyTorch port (counterpart of
incubator_mxnet_tpu/autograd.py) on top of torch's own autograd.

* `record()` / `pause()` scope recording: inside `record()` torch grad
  mode is on, inside `pause()` it is off.  `train_mode()` /
  `predict_mode()` set only the training flag.  `is_recording()` and
  `is_training()` report the scope's flags.
* Training mode is `is_training()`, as in the JAX package: `record()`
  turns it on (`train_mode=True` by default), and the layers read it --
  dropout is live, attention leaves the fused path for attention
  dropout, and BatchNorm takes batch statistics and updates its running
  ones only while it is on.  `Module.train()` / `eval()` decide nothing.
* `backward(heads, head_grads=None)` seeds ones for a head without a
  gradient, whatever its shape, as MXNet does (a per-row loss vector is
  a valid head; `Tensor.backward()` refuses one).
* `grad_req='write'` (MXNet's default): a backward overwrites each
  parameter's gradient instead of adding to it, as torch would.  Before
  running torch's backward, `backward` clears `.grad` of every leaf that
  the heads reach.
"""
from __future__ import annotations

import threading

import torch

from .base import MXNetError

__all__ = ["record", "pause", "train_mode", "predict_mode", "is_recording",
           "is_training", "backward"]

_STATE = threading.local()


def is_recording() -> bool:
    return getattr(_STATE, "recording", False)


def is_training() -> bool:
    return getattr(_STATE, "training", False)


def set_recording(flag: bool) -> bool:
    prev = is_recording()
    _STATE.recording = bool(flag)
    return prev


def set_training(flag: bool) -> bool:
    prev = is_training()
    _STATE.training = bool(flag)
    return prev


class _RecordingStateScope:
    """Sets the flags that are not None for the scope; recording also sets
    torch grad mode."""

    def __init__(self, recording, training):
        self._rec, self._train = recording, training
        self._prev_rec = self._prev_train = self._grad = None

    def __enter__(self):
        if self._rec is not None:
            self._prev_rec = set_recording(self._rec)
            self._grad = torch.set_grad_enabled(self._rec)
            self._grad.__enter__()
        if self._train is not None:
            self._prev_train = set_training(self._train)
        return self

    def __exit__(self, *exc):
        if self._rec is not None:
            self._grad.__exit__(*exc)
            set_recording(self._prev_rec)
        if self._train is not None:
            set_training(self._prev_train)


def record(train_mode: bool = True):
    """`with autograd.record():` — recording (torch grad mode) and
    training mode on."""
    return _RecordingStateScope(True, train_mode)


def pause(train_mode: bool = False):
    """`with autograd.pause():` — recording (torch grad mode) off."""
    return _RecordingStateScope(False, train_mode)


def train_mode():
    """`with autograd.train_mode():` -- training mode on, recording as
    it was."""
    return _RecordingStateScope(None, True)


def predict_mode():
    """`with autograd.predict_mode():` -- training mode off, recording as
    it was."""
    return _RecordingStateScope(None, False)


def _reachable_leaves(heads):
    """The tensors of the AccumulateGrad nodes reachable from `heads`."""
    leaves, seen = [], set()
    stack = [h.grad_fn for h in heads if h.grad_fn is not None]
    while stack:
        fn = stack.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        var = getattr(fn, "variable", None)
        if var is not None:
            leaves.append(var)
        stack.extend(nxt for nxt, _ in fn.next_functions)
    return leaves


def backward(heads, head_grads=None, retain_graph=False):
    """Gradients of `heads` into the `.grad` of the leaves they reach,
    overwriting what was there (grad_req='write').  A head without a
    `head_grads` entry is seeded with ones of its own shape."""
    if isinstance(heads, torch.Tensor):
        heads = [heads]
    if head_grads is None:
        head_grads = [None] * len(heads)
    elif isinstance(head_grads, torch.Tensor):
        head_grads = [head_grads]
    if len(head_grads) != len(heads):
        raise MXNetError("backward: %d head gradients for %d heads"
                         % (len(head_grads), len(heads)))
    for h in heads:
        if not h.requires_grad:
            raise MXNetError(
                "cannot differentiate: output was not computed while "
                "recording (is autograd.record() active?)")
    grads = [torch.ones_like(h) if g is None else g
             for h, g in zip(heads, head_grads)]
    for leaf in _reachable_leaves(heads):
        leaf.grad = None
    torch.autograd.backward(heads, grads, retain_graph=retain_graph)
