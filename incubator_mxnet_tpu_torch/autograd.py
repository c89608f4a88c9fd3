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
* `mx.nd.NDArray`s take part as MXNet's do.  `backward` and `grad` take
  NDArray heads and head gradients.  An NDArray with `attach_grad()` (or
  `mark_variables`) wraps a leaf tensor that names the array as its owner
  (`_mx_owner`); `backward` writes that leaf's gradient into the array's
  `.grad` NDArray per its grad_req ('write' replaces, 'add' sums, 'null'
  leaves it) and leaves torch's `Tensor.grad` of the leaf empty.
* Sparse gradients: `Embedding` with `sparse_grad=True` on a leaf weight
  gives torch's COO gradient, which torch sums with another sparse one
  (the union of rows) and makes dense where it meets a dense one; only a
  leaf keeps it sparse (a weight with recorded history takes the dense
  gradient).  An NDArray whose gradient is row_sparse
  (`attach_grad(stype="row_sparse")`) gets it as a `RowSparseNDArray`
  (coalesced: sorted unique rows), replacing its rows for 'write' and
  taking the union (`sparse.add`) for 'add'; a `gluon.Parameter` keeps
  the COO tensor in `.grad`, and `list_grad()` reads it as a
  `RowSparseNDArray`.
* `grad(heads, variables, ..., create_graph)` returns NDArray gradients
  and writes no `.grad`; with `create_graph=True` the gradients are
  recorded, so a backward through them gives second-order gradients.
  A node whose backward is not differentiable again (the flash
  attention kernels, an `autograd.Function`) raises `MXNetError` there,
  as the JAX package refuses to differentiate its Pallas kernels.
* `Function` is MXNet's custom op: `forward` and `backward` run under
  `pause()` on NDArrays, and the call is one recorded node.
"""
from __future__ import annotations

import threading
import weakref

import torch
from torch.utils.weak import WeakIdKeyDictionary

from .base import MXNetError

__all__ = ["record", "pause", "train_mode", "predict_mode", "is_recording",
           "is_training", "backward", "grad", "mark_variables", "Function",
           "set_recording", "set_training"]

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


def _tensors(xs):
    """The tensors of a list of tensors and NDArrays."""
    return [x._data if hasattr(x, "_grad_req") else x for x in xs]


def _heads(heads, head_grads, api):
    """(head tensors, gradient tensors): a head without a gradient is
    seeded with ones of its own shape."""
    if not isinstance(heads, (list, tuple)):
        heads = [heads]
    if head_grads is None:
        head_grads = [None] * len(heads)
    elif not isinstance(head_grads, (list, tuple)):
        head_grads = [head_grads]
    if len(head_grads) != len(heads):
        raise MXNetError("%s: %d head gradients for %d heads"
                         % (api, len(head_grads), len(heads)))
    heads = _tensors(heads)
    for h in heads:
        if not h.requires_grad:
            raise MXNetError(
                "cannot differentiate: output was not computed while "
                "recording (is autograd.record() active?)")
    grads = [torch.ones_like(h) if g is None else _tensors([g])[0]
             for h, g in zip(heads, head_grads)]
    return heads, grads


def _owner(leaf):
    """The NDArray that `leaf` is the attached tensor of, or None."""
    ref = getattr(leaf, "_mx_owner", None)
    return None if ref is None else ref()


def backward(heads, head_grads=None, retain_graph=False, train_mode=True):
    """Gradients of `heads` into the `.grad` of the leaves they reach,
    overwriting what was there (grad_req='write'), or adding to it for a
    parameter with grad_req 'add'.  A head without a `head_grads` entry
    is seeded with ones of its own shape.  An NDArray leaf's gradient
    goes to the array's `.grad` (module doc)."""
    heads, grads = _heads(heads, head_grads, "backward")
    owned = []
    for leaf in _reachable_leaves(heads):
        nd = _owner(leaf)
        if nd is not None:
            owned.append((leaf, nd))
            leaf.grad = None
        elif getattr(leaf, "grad_req", "write") == "write":
            leaf.grad = None
    torch.autograd.backward(heads, grads, retain_graph=retain_graph)
    for leaf, nd in owned:
        g, leaf.grad = leaf.grad, None
        if g is None or nd._grad is None or nd._grad_req == "null":
            continue
        if getattr(nd._grad, "stype", "default") == "row_sparse":
            _deliver_row_sparse(nd, g)
            continue
        if g.is_sparse:
            g = g.to_dense()
        if nd._grad_req == "add":
            nd._grad._data = nd._grad._data + g
        else:
            nd._grad._data = g


def _deliver_row_sparse(nd, g):
    """Give `nd` (whose gradient is a `RowSparseNDArray`) the gradient
    `g`: torch's COO gradient coalesced, or a dense one's nonzero rows;
    'write' replaces the stored rows, 'add' takes the union with them
    (`sparse.add`)."""
    from .ndarray import sparse
    from .ndarray.ndarray import _wrap
    rsp = sparse.from_torch_sparse(g) if g.is_sparse else \
        sparse.cast_storage(_wrap(g), "row_sparse")
    if nd._grad_req == "add" and nd._grad.indices.shape[0] > 0:
        rsp = sparse.add(nd._grad, rsp)
    nd._grad = rsp


def grad(heads, variables, head_grads=None, retain_graph=None,
         create_graph=False, train_mode=True):
    """The gradients of `heads` with respect to `variables` (NDArrays),
    as NDArrays, without writing any `.grad`.  With `create_graph` they
    are recorded (in `train_mode`), so a backward through them gives
    higher-order gradients; `retain_graph` defaults to `create_graph`."""
    from .ndarray.ndarray import _wrap
    if retain_graph is None:
        retain_graph = create_graph
    single = not isinstance(variables, (list, tuple))
    variables = [variables] if single else list(variables)
    heads, grads = _heads(heads, head_grads, "grad")
    xs = _tensors(variables)
    live = [i for i, x in enumerate(xs) if x.requires_grad]
    scope = _RecordingStateScope(True, train_mode) if create_graph \
        else _RecordingStateScope(None, None)
    with scope:
        got = torch.autograd.grad(heads, [xs[i] for i in live], grads,
                                  retain_graph=retain_graph,
                                  create_graph=create_graph,
                                  allow_unused=True)
    out = [None] * len(xs)
    for i, g in zip(live, got):
        out[i] = g
    from .ndarray.sparse import from_torch_sparse
    return [_wrap(torch.zeros_like(x)) if g is None else
            from_torch_sparse(g) if g.is_sparse else _wrap(g)
            for x, g in zip(xs, out)]


def mark_variables(variables, gradients, grad_reqs="write"):
    """Make each NDArray of `variables` a leaf whose gradient goes into
    the NDArray of `gradients` at its place, per `grad_reqs` (ref:
    autograd.mark_variables)."""
    if isinstance(grad_reqs, str):
        grad_reqs = [grad_reqs] * len(variables)
    for v, g, req in zip(variables, gradients, grad_reqs):
        t = v._data.detach()
        if req != "null" and t.dtype.is_floating_point:
            t.requires_grad_(True)
            t._mx_owner = weakref.ref(v)
        v._data = t
        v._grad = g
        v._grad_req = req


class _FunctionNode(torch.autograd.Function):
    """One recorded `Function` call: the forward runs the user's
    `forward` on NDArrays over the inputs, the backward its `backward`."""

    @staticmethod
    def forward(ctx, func, slots, *tensors):
        from .ndarray.ndarray import _wrap
        it = iter(tensors)
        inputs = [_wrap(next(it)) if s is None else s for s in slots]
        with pause():
            outputs = func.forward(*inputs)
        ctx.func, ctx.n_in = func, len(tensors)
        func._multi = isinstance(outputs, (list, tuple))
        outs = tuple(outputs) if func._multi else (outputs,)
        return tuple(o._data for o in outs)

    @staticmethod
    def backward(ctx, *grads):
        from .ndarray.ndarray import _wrap
        if torch.is_grad_enabled():
            raise MXNetError(
                "%s: a custom autograd.Function is differentiable once; "
                "autograd.grad(create_graph=True) cannot pass through it"
                % type(ctx.func).__name__)
        with pause():
            igrads = ctx.func.backward(*[_wrap(g) for g in grads])
        if not isinstance(igrads, (list, tuple)):
            igrads = [igrads]
        if len(igrads) != ctx.n_in:
            raise MXNetError("%s.backward returned %d gradients for %d "
                             "array inputs" % (type(ctx.func).__name__,
                                               len(igrads), ctx.n_in))
        return (None, None) + tuple(
            None if g is None else _tensors([g])[0] for g in igrads)


class Function:
    """User-defined differentiable operation (ref: autograd.Function).

    Subclass, implement `forward(*inputs)` and `backward(*output_grads)`
    over NDArrays, then call the instance like a function::

        class sigmoid(autograd.Function):
            def forward(self, x):
                y = 1 / (1 + nd.exp(-x))
                self.save_for_backward(y)
                return y
            def backward(self, dy):
                y, = self.saved_tensors
                return dy * y * (1 - y)

    Both run with autograd paused; while recording, the call is one node
    whose gradient is `backward`, which returns one gradient per NDArray
    input (None for one that takes none)."""

    def __init__(self):
        self.saved_tensors = ()

    def save_for_backward(self, *args):
        self.saved_tensors = args

    def forward(self, *inputs):
        raise NotImplementedError

    def backward(self, *output_grads):
        raise NotImplementedError

    def __call__(self, *inputs):
        from .ndarray.ndarray import NDArray, _wrap
        nd_inputs = [a for a in inputs if isinstance(a, NDArray)]
        if not (is_recording()
                and any(a._data.requires_grad for a in nd_inputs)):
            with pause():
                return self.forward(*inputs)
        slots = [None if isinstance(a, NDArray) else a for a in inputs]
        outs = _FunctionNode.apply(self, slots,
                                   *[a._data for a in nd_inputs])
        wrapped = [_wrap(o) for o in outs]
        return wrapped if self._multi else wrapped[0]


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
