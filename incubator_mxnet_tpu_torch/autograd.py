"""`autograd` of the PyTorch port (counterpart of
incubator_mxnet_tpu/autograd.py) on top of torch's own autograd.

* `record()` / `pause()` scope recording: inside `record()` torch grad
  mode is on, inside `pause()` it is off.  `is_recording()` and
  `is_training()` report the scope's flags.  The port's layers do not
  read `is_training()`: dropout follows `Module.train()` / `eval()`.
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

__all__ = ["record", "pause", "is_recording", "is_training", "backward"]

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
    def __init__(self, recording, training):
        self._rec, self._train = recording, training
        self._prev_rec = self._prev_train = self._grad = None

    def __enter__(self):
        self._prev_rec = set_recording(self._rec)
        self._prev_train = set_training(self._train)
        self._grad = torch.set_grad_enabled(self._rec)
        self._grad.__enter__()
        return self

    def __exit__(self, *exc):
        self._grad.__exit__(*exc)
        set_recording(self._prev_rec)
        set_training(self._prev_train)


def record(train_mode: bool = True):
    """`with autograd.record():` — recording (torch grad mode) and
    training mode on."""
    return _RecordingStateScope(True, train_mode)


def pause(train_mode: bool = False):
    """`with autograd.pause():` — recording (torch grad mode) off."""
    return _RecordingStateScope(False, train_mode)


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
