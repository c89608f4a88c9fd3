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
  the heads reach, except a `gluon.Parameter` with grad_req 'add', whose
  gradient sums over backwards until its `zero_grad()`.
* A hybridized block's backward is a captured program
  (`gluon.block`, `graph_capture`) that `GraphedCall`, a
  `torch.autograd.Function`, replays.  It writes its parameters'
  gradients into one buffer per parameter that persists across steps
  (`grad_buffer`), overwriting it for 'write' and adding to it for 'add',
  and that buffer is the parameter's `.grad`, so a captured update reads
  the same storage every step.  Several contributions to one parameter
  within one backward pass (from two calls of a block, or from a block
  and eager code) sum, as in eager torch: a contribution already made in
  this pass is kept aside and added back after the replay overwrites the
  buffer.
"""
from __future__ import annotations

import threading

import torch
from torch.utils.weak import WeakIdKeyDictionary

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
    overwriting what was there (grad_req='write'), or adding to it for a
    parameter with grad_req 'add'.  A head without a `head_grads` entry
    is seeded with ones of its own shape."""
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
        if getattr(leaf, "grad_req", "write") == "write":
            leaf.grad = None
    torch.autograd.backward(heads, grads, retain_graph=retain_graph)


# -- gradients of captured backwards ---------------------------------------

#: parameter -> its persistent gradient buffer
_GRAD_BUFFERS = WeakIdKeyDictionary()
#: parameter -> the id of the last backward pass that gave it a gradient
_GRAD_PASS = WeakIdKeyDictionary()


def _mark_pass(param):
    """Post-accumulate hook: an eager backward gave `param` a gradient."""
    _GRAD_PASS[param] = torch._C._current_graph_task_id()


def grad_buffer(param):
    """The gradient buffer of `param` that captured backwards write: made
    once (zeros) per shape, dtype and device, and kept across steps."""
    buf = _GRAD_BUFFERS.get(param)
    if (buf is None or buf.shape != param.shape
            or buf.dtype != param.dtype or buf.device != param.device):
        if param not in _GRAD_PASS:
            param.register_post_accumulate_grad_hook(_mark_pass)
            _GRAD_PASS[param] = None
        buf = torch.zeros_like(param, requires_grad=False)
        _GRAD_BUFFERS[param] = buf
    return buf


def has_stable_grad(param):
    """Whether `param.grad` is its persistent buffer."""
    grad = param.grad
    return grad is not None and grad is _GRAD_BUFFERS.get(param)


@torch.no_grad()
def _deliver_begin(deliveries, task):
    """Before a captured backward writes [(param, buffer, grad_req)]: an
    'add' parameter's gradient moves into its buffer; a 'write'
    parameter that already has a gradient from this pass keeps it aside
    (returned) to be added back."""
    kept = []
    for p, buf, req in deliveries:
        grad = p.grad
        if req == "add":
            if grad is not buf:
                buf.zero_() if grad is None else buf.copy_(grad)
                p.grad = buf
        elif grad is not None and _GRAD_PASS.get(p) == task:
            kept.append((buf, grad.clone() if grad is buf else grad))
    return kept


@torch.no_grad()
def _deliver_end(deliveries, kept, task):
    for buf, grad in kept:
        buf.add_(grad)
    for p, buf, _ in deliveries:
        if p.grad is not buf:
            p.grad = buf
        _GRAD_PASS[p] = task


def deliver(deliveries, grads):
    """Inside a captured backward: write each gradient into its buffer,
    overwriting ('write') or adding ('add')."""
    for (_, buf, req), g in zip(deliveries, grads):
        if req == "add":
            buf.add_(g)
        else:
            buf.copy_(g)


class _Release:
    """Frees a captured program for another forward once the autograd
    node of its forward is gone."""

    def __init__(self, program):
        self.program, self.generation = program, program.generation

    def __del__(self):
        if self.program.generation == self.generation:
            self.program.busy = False


class GraphedCall(torch.autograd.Function):
    """A hybridized block's call under `record()`: the forward replays
    `program` (which copies `inputs` into its static inputs and returns
    clones of its static outputs), the backward replays its captured
    backward.  `anchor` is a tensor that requires grad and gets none."""

    @staticmethod
    def forward(ctx, program, anchor, *inputs):
        outs = program.forward(inputs)
        ctx.program = program
        ctx.release = _Release(program)
        ctx.mark_non_differentiable(
            *(o for o, req in zip(outs, program.out_requires_grad)
              if not req))
        return tuple(outs)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, *grads):
        program = ctx.program
        if program.generation != ctx.release.generation:
            raise MXNetError(
                "a hybridized block was called again before the backward "
                "of an earlier call: its captured program keeps one "
                "call's activations; run backward first, or "
                "hybridize(active=False)")
        task = torch._C._current_graph_task_id()
        return (None, None) + tuple(program.backward(grads, task))
