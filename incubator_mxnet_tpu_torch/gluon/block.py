"""`Block` and `HybridBlock` of the PyTorch port (counterpart of
incubator_mxnet_tpu/gluon/block.py) as `torch.nn.Module` subclasses.

Parameters are the port's `gluon.Parameter`s (`nn.Parameter`s with the
JAX package's attributes).  A layer built without `device=` has
parameters without data until `initialize(init, ctx)`; a layer built
with `device=` is initialized there at construction with the default
initializer, as the JAX package's `get_resnet(ctx=...)` does.  An input
width a layer is not given (`Dense(in_units=0)`, `Conv2D(in_channels=0)`,
`BatchNorm`, `LayerNorm`) is taken from the first forward's input, which
then materialises and fills the parameter on its `initialize` device.
`collect_params()` returns a `ParameterDict` keyed by structural names,
as the JAX package's `_collect_params_with_prefix()` names them
(`encoder.layers.0.attn.query.weight`), which are also their
`named_parameters()` names and the keys of `save_parameters` files.

`cast(dtype)` converts every parameter of the tree in place, keeping
each parameter object (one not yet materialised records the dtype), so
a `Trainer` built before or after the cast updates the cast tensors.

`HybridBlock.hybridize()` makes the block run as a cached program per
call signature (`_CachedGraph`, the counterpart of the JAX package's
`_CachedGraph`; `static_alloc` and `static_shape` are taken for the
reference's API and change nothing, as there).  The signature is the
training mode, whether the call records, the inputs' structure, shapes,
dtypes and devices and its other arguments; the parameters' storage,
dtypes and grad_req are checked at each call, and any change drops the
block's programs.  The first call of a signature runs eagerly (it loads
every kernel and lazy library state that a capture must not meet); the
next captures the forward with `graph_capture.capture` (a CUDA graph on
the card, the recorded aten ops on the CPU), and later calls copy their
inputs into the program's static inputs and replay it.  Under
`autograd.record()` the call is an `autograd.GraphedCall`, whose
backward replays a backward captured at the first backward
(`torch.autograd.grad` over the capture's own graph), which writes the
parameters' gradients into their persistent buffers
(`autograd.grad_buffer`).  Every output, and every input gradient, is a
clone of its static tensor, so a later replay changes no tensor already
handed out.  A program keeps one forward's activations: a call while
its last forward still waits for a backward captures another program for
the same signature (as MXNet's CachedOp takes another state); its
backward runs once per call, as the captured backward reuses the
forward's saved activations for its own temporaries.  Inside a
hybridized call, hybridized children run as plain code.  `remat=True`
runs the forward under `torch.utils.checkpoint` (non-reentrant), its
dropout masks kept for the recompute (`random.remat_contexts`), as the
JAX package wraps it in `jax.checkpoint`; `remat_policy` names a JAX
policy and raises.  `hybridize(active=False)` makes the block eager
again.  A parameter that `cast`, `initialize`, `load_parameters` or
`set_data` replaced or rewrote is marked (`parameter.touch`), which
changes the parameters' key and drops the block's programs.
"""
from __future__ import annotations

import re
import threading

import torch
from torch import nn
from torch.utils._pytree import tree_flatten, tree_unflatten

from .parameter import (Parameter, ParameterDict, cast_parameter,
                        is_deferred)
from .. import autograd as _ag
from .. import graph_capture as _capture
from .. import random as _rnd
from ..base import MXNetError
from ..context import resolve_device
from ..ndarray.ndarray import NDArray, _wrap, unwrap

__all__ = ["Block", "HybridBlock", "new_parameter", "cast_parameter",
           "materialize"]


def new_parameter(name, shape, init, device, dtype, grad_req="write"):
    """A `Parameter` of `shape` (0 for a width the first input gives);
    `init` is an Initializer, one of its names, or None for the default
    `Uniform()`.  With a `device` it is initialized there at once (or
    when its shape becomes known); without one it waits for
    `initialize`."""
    p = Parameter(name, grad_req=grad_req, shape=shape, dtype=dtype,
                  init=init, allow_deferred_init=True)
    if device is not None:
        p.initialize(ctx=device)
    return p


def materialize(param, shape):
    """Give a deferred `param` its full `shape` and complete its
    initialization; a parameter that has data is left as it is."""
    if is_deferred(param):
        param._set_shape(shape)
        param._finish_deferred_init()


def _nd_call(call, args, kwargs):
    """`call(*args, **kwargs)` with the NDArray arguments unwrapped to
    their tensors, and the tensor results wrapped as NDArrays; None when
    no argument is an NDArray."""
    if not any(isinstance(a, NDArray) for a in args) and not any(
            isinstance(a, NDArray) for a in kwargs.values()):
        return None
    args = tuple(unwrap(a) for a in args)
    kwargs = {k: unwrap(v) for k, v in kwargs.items()}
    out, ospec = tree_flatten(call(*args, **kwargs))
    return tree_unflatten([_wrap(o) if isinstance(o, torch.Tensor) else o
                           for o in out], ospec)


class Block(nn.Module):
    """ref: gluon.Block — a composable layer; the PyTorch module protocol
    (`forward`, `train()`/`eval()`, `state_dict`) applies as is.  Called
    with `mx.nd` NDArrays, a block runs on their tensors and returns
    NDArrays, as the JAX package's blocks do; called with tensors, it
    returns tensors."""

    def __call__(self, *args, **kwargs):
        out = _nd_call(super().__call__, args, kwargs)
        return super().__call__(*args, **kwargs) if out is None else out

    def collect_params(self, select=None):
        """`ParameterDict` of structural parameter names → parameters,
        for the names matching the regular expression `select` if
        given."""
        pattern = re.compile(select) if select is not None else None
        ret = ParameterDict()
        ret.update({name: p for name, p in self.named_parameters()
                    if pattern is None or pattern.match(name)})
        return ret

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False):
        """Initialize every parameter on `ctx` (default `cuda:0`), with
        `init` as the default initializer (ref: Block.initialize)."""
        self.collect_params().initialize(init, ctx, verbose, force_reinit)

    def zero_grad(self):
        """Zero every parameter's gradient (ref: Block.zero_grad)."""
        self.collect_params().zero_grad()

    def save_parameters(self, filename, deduplicate=False):
        """Save the materialised parameters, keyed by structural name, in
        the JAX package's file format (`ndarray.save`)."""
        from .. import ndarray as nd
        nd.save(filename, {k: v for k, v in self.collect_params().items()
                           if not is_deferred(v)})

    def load_parameters(self, filename, ctx=None, allow_missing=False,
                        ignore_extra=False, cast_dtype=False,
                        dtype_source="current"):
        """Load a `save_parameters` file (the port's or the JAX
        package's).  Keys may carry the reference's `arg:`/`aux:`
        prefixes.  Each tensor is copied into its parameter in the
        parameter's dtype; a parameter without data takes the file's
        shape and is allocated on `ctx`, else on its `initialize` device,
        else on `cuda:0`.  A materialised parameter missing from the
        file raises unless `allow_missing`, a name the block lacks unless
        `ignore_extra`; nothing is written before these checks.
        `cast_dtype` and `dtype_source` are accepted and, as in the JAX
        package, change nothing."""
        from .. import ndarray as nd
        loaded = nd._load_tensors(filename, ctx="cpu")
        loaded = {(k.split(":", 1)[1] if k.startswith(("arg:", "aux:"))
                   else k): v for k, v in loaded.items()}
        params = self.collect_params()
        if not allow_missing:
            for name, p in params.items():
                if name not in loaded and not is_deferred(p):
                    raise MXNetError("parameter %s missing in file" % name)
        if not ignore_extra:
            for name in loaded:
                if name not in params:
                    raise MXNetError("parameter %s not in block" % name)
        for name, data in loaded.items():
            if name in params:
                params[name]._load_and_set(data, ctx)

    def hybridize(self, active=True, **kwargs):
        """Hybridize every child block (ref: Block.hybridize)."""
        for child in self.children():
            if isinstance(child, Block):
                child.hybridize(active, **kwargs)

    def cast(self, dtype):
        """Cast every parameter of the tree to `dtype` ("bfloat16",
        "float16", "float32" or a torch dtype), BatchNorm's running
        statistics included, as the JAX `Block.cast` does (only
        `contrib.amp.convert_hybrid_block` keeps norm parameters f32).
        Each parameter keeps its identity; its data is replaced and its
        gradient dropped.  Returns the block."""
        for p in self.parameters():
            cast_parameter(p, dtype)
        return self

    def to_device(self, device=None):
        """Move the parameters to `device` (default `cuda:0`)."""
        return self.to(resolve_device(device))


class HybridBlock(Block):
    """ref: gluon.HybridBlock."""

    def hybridize(self, active=True, static_alloc=False, static_shape=False,
                  inline_limit=2, forward_bulk_size=None,
                  backward_bulk_size=None, remat=False, remat_policy=None):
        """Run this block as a cached program per call signature (module
        doc); the children are hybridized too, with `static_alloc` and
        `static_shape`, as in the JAX package."""
        if remat_policy is not None:
            raise NotImplementedError(
                "remat_policy=%r names a jax.checkpoint_policies member, "
                "which has no torch counterpart; remat=True recomputes the "
                "whole forward" % (remat_policy,))
        old = self.__dict__.get("_cached_graph")
        if old is not None:
            old.clear()
        self.__dict__["_cached_graph"] = _CachedGraph(self, remat) \
            if active else None
        super().hybridize(active, static_alloc=static_alloc,
                          static_shape=static_shape)

    def __call__(self, *args, **kwargs):
        out = _nd_call(self.__call__, args, kwargs)
        if out is not None:
            return out
        cached = self.__dict__.get("_cached_graph")
        if cached is None or _in_program():
            return nn.Module.__call__(self, *args, **kwargs)
        return cached(args, kwargs)

    def inference_engine(self, **kwargs):
        """Build a `serving.InferenceEngine` over this block; keyword
        arguments go to `InferenceEngine` (device, buckets, max_batch,
        queue_cap, example_shape, wire_dtype, ...)."""
        from ..serving import InferenceEngine
        return InferenceEngine(self, **kwargs)


# -- cached programs ---------------------------------------------------------

_SCOPE = threading.local()
#: an input of every recorded GraphedCall that requires grad, so that its
#: outputs do when no other input does (the parameters the program reads
#: are not inputs of the autograd node)
_ANCHOR = torch.zeros((), requires_grad=True)


def _in_program():
    """Whether a hybridized block's call is running on this thread."""
    return getattr(_SCOPE, "depth", 0) > 0


class _ProgramScope:
    """A hybridized call's scope: children run as plain code, with the
    training and recording flags of the call (which a recompute on
    another thread, or in a backward, would not have)."""

    def __init__(self, training, recording):
        self._flags = training, recording

    def __enter__(self):
        _SCOPE.depth = getattr(_SCOPE, "depth", 0) + 1
        self._prev = (_ag.set_training(self._flags[0]),
                      _ag.set_recording(self._flags[1]))

    def __exit__(self, *exc):
        _ag.set_training(self._prev[0])
        _ag.set_recording(self._prev[1])
        _SCOPE.depth -= 1


def _meta(x):
    """A call argument's part of the signature."""
    if isinstance(x, torch.Tensor):
        return (tuple(x.shape), x.stride(), x.dtype, x.device,
                x.requires_grad)
    return x


def _param_key(p):
    if is_deferred(p):
        return ("deferred", id(p))
    return (p.data_ptr(), p.dtype, tuple(p.shape), p.requires_grad,
            getattr(p, "grad_req", "write"),
            p.__dict__.get("_graph_version", 0))


class _CachedGraph:
    """The CachedOp counterpart (ref: incubator_mxnet_tpu/gluon/block.py
    `_CachedGraph`): a block's captured programs by call signature.
    `captures`, `replays` and `eager_calls` count what its calls did."""

    #: eager calls of a signature before its capture
    WARMUP = 1

    def __init__(self, block, remat):
        self.block = block
        self.remat = remat
        self.params = None
        self._param_keys = None
        self._warm = {}
        self._programs = {}
        self.captures = self.replays = self.eager_calls = 0

    def clear(self):
        """Drop every program (and the parameters' list)."""
        self.params = None
        self._param_keys = None
        self._warm.clear()
        self._programs.clear()

    def forward(self, args, kwargs, training, recording, params=None):
        """The block's forward as a hybridized call runs it: in the
        call's scope, with the tensors `params` (name -> tensor) in place
        of its parameters where given, and under checkpointing with
        `remat` while recording."""
        def run(*a, **kw):
            with _ProgramScope(training, recording):
                if params is None:
                    return self.block.forward(*a, **kw)
                return torch.func.functional_call(self.block, params, a, kw)
        if self.remat and recording:
            return torch.utils.checkpoint.checkpoint(
                run, *args, use_reentrant=False, preserve_rng_state=False,
                context_fn=_rnd.remat_contexts, **kwargs)
        return run(*args, **kwargs)

    def _check_params(self):
        if self.params is None:
            self.named = list(self.block.named_parameters())
            self.params = [p for _, p in self.named]
        keys = [_param_key(p) for p in self.params]
        if keys != self._param_keys:
            self._warm.clear()
            self._programs.clear()
            self._param_keys = keys

    def __call__(self, args, kwargs):
        self._check_params()
        training = _ag.is_training()
        flat, spec = tree_flatten((args, kwargs))
        recording = torch.is_grad_enabled() and (
            any(p.requires_grad for p in self.params)
            or any(isinstance(x, torch.Tensor) and x.requires_grad
                   for x in flat))
        sig = (training, recording, spec, tuple(_meta(x) for x in flat))
        try:
            warm = self._warm.get(sig, 0)
        except TypeError as exc:
            raise MXNetError("a hybridized call's arguments other than "
                             "tensors must be hashable: %s" % exc) from exc
        if warm < self.WARMUP:
            self._warm[sig] = warm + 1
            self.eager_calls += 1
            out = self.forward(args, kwargs, training, recording)
            # the parameters it materialised are part of the warm-up
            self._param_keys = [_param_key(p) for p in self.params]
            return out
        programs = self._programs.setdefault(sig, [])
        program = next((p for p in programs if not p.busy), None)
        if program is None:
            program = _Program(self, flat, spec, training, recording)
            programs.append(program)
        inputs = [flat[i] for i in program.tensor_pos]
        if recording:
            outs = _ag.GraphedCall.apply(program, _ANCHOR, *inputs)
        else:
            outs = program.forward(inputs)
        return program.result(outs)


def _device(cached, flat):
    for p in cached.params:
        if not is_deferred(p):
            return p.device
    for x in flat:
        if isinstance(x, torch.Tensor):
            return x.device
    return torch.device("cpu")


class _Program:
    """One captured forward of a block for one signature, with its static
    inputs and outputs, and under `record()` its captured backward.

    The capture runs the forward on leaf aliases of the parameters
    (`functional_call`), so that its autograd graph has accumulators of
    its own on the capture's stream, whatever graph of an eager step is
    still alive.  On a card the backward is captured right after the
    forward, over that graph (`torch.autograd.grad` with the static
    output gradients), as `torch.cuda.make_graphed_callables` does; on
    the CPU, where a capture runs what it records, at the first backward,
    with that backward's output gradients."""

    def __init__(self, cached, flat, spec, training, recording):
        self.cached = cached
        self.spec = spec
        self.training, self.recording = training, recording
        self.device = _device(cached, flat)
        self.tensor_pos = [i for i, x in enumerate(flat)
                           if isinstance(x, torch.Tensor)]
        for i in self.tensor_pos:
            if flat[i].device != self.device:
                raise _capture.CaptureError(
                    "a hybridized call's input is on %s, its program on %s"
                    % (flat[i].device, self.device))
        self.leaves = [None if isinstance(x, torch.Tensor) else x
                       for x in flat]
        self.static_in = [torch.empty_like(flat[i]) for i in self.tensor_pos]
        self.fwd = self.bwd = None
        self.busy = False
        self.generation = 0
        self.done = 0               # the generation whose backward ran
        self.bwd_runs = 0

    @torch.no_grad()
    def _load(self, inputs):
        for s, x in zip(self.static_in, inputs):
            s.copy_(x)

    def _capture_forward(self, inputs):
        for s, x in zip(self.static_in, inputs):
            s.requires_grad_(self.recording and x.requires_grad)
        leaves = list(self.leaves)
        for i, s in zip(self.tensor_pos, self.static_in):
            leaves[i] = s
        args, kwargs = tree_unflatten(leaves, self.spec)
        aliases = {n: p.detach().requires_grad_(p.requires_grad)
                   for n, p in self.cached.named if not is_deferred(p)}

        def fn():
            with torch.set_grad_enabled(self.recording):
                return self.cached.forward(args, kwargs, self.training,
                                           self.recording, aliases)
        self.fwd, out = _capture.capture(fn, self.device)
        self.cached.captures += 1
        flat, self.out_spec = tree_flatten(out)
        self.out_pos = [i for i, x in enumerate(flat)
                        if isinstance(x, torch.Tensor)]
        self.out_leaves = [None if isinstance(x, torch.Tensor) else x
                           for x in flat]
        outs = [flat[i] for i in self.out_pos]
        self.static_out = [o.detach() for o in outs]
        self.out_requires_grad = [o.requires_grad for o in outs]
        if self.recording:
            self._prepare_backward(outs, aliases)
            if self.fwd.ran:
                self._bwd_graph = outs
            else:
                self._capture_backward(outs)
        if not self.fwd.ran:
            self.fwd.replay()

    def _prepare_backward(self, outs, aliases):
        """The static output gradients, and the parameters the outputs
        reach with their gradient buffers and grad_req."""
        params = dict(self.cached.named)
        reached = {id(t) for t in _ag._reachable_leaves(
            [o for o in outs if o.requires_grad])}
        names = [n for n, a in aliases.items() if id(a) in reached]
        self.grad_aliases = [aliases[n] for n in names]
        self.deliveries = [(params[n], _ag.grad_buffer(params[n]),
                            getattr(params[n], "grad_req", "write"))
                           for n in names]
        self.gout = [torch.zeros_like(o) for o, req in
                     zip(self.static_out, self.out_requires_grad) if req]

    def _capture_backward(self, outs):
        outs = [o for o in outs if o.requires_grad]
        ins = [s for s in self.static_in if s.requires_grad]

        def fn():
            grads = torch.autograd.grad(outs, ins + self.grad_aliases,
                                        self.gout, allow_unused=True)
            _ag.deliver(self.deliveries, grads[len(ins):])
            return grads[:len(ins)]
        self.bwd, in_grads = _capture.capture(fn, self.device,
                                              pool=self.fwd.pool())
        self.cached.captures += 1
        self.in_grads = list(in_grads)
        # the capture freed the forward's saved tensors as it went, so
        # that the backward's temporaries reuse their memory in the pool
        # (as an eager backward does): a replayed backward reads them
        # once after each forward
        self._bwd_graph = None

    def forward(self, inputs):
        """Copy `inputs` in, capture or replay; clones of the outputs."""
        self._load(inputs)
        if self.fwd is None:
            self._capture_forward(inputs)
        else:
            self.fwd.replay()
            self.cached.replays += 1
        self.generation += 1
        self.busy = self.recording
        with torch.no_grad():
            return [o.clone() for o in self.static_out]

    def result(self, outs):
        leaves = list(self.out_leaves)
        for i, o in zip(self.out_pos, outs):
            leaves[i] = o
        return tree_unflatten(leaves, self.out_spec)

    def backward(self, grads, task):
        """Replay the backward (on the CPU, capture it at the first) for
        the output gradients `grads`; the inputs' gradients."""
        if self.done == self.generation:
            raise MXNetError(
                "a hybridized block's backward runs once per call: its "
                "captured backward overwrites the saved activations "
                "(retain_graph is not kept); call the block again")
        self.done = self.generation
        grads = [g for g, req in zip(grads, self.out_requires_grad) if req]
        with torch.no_grad():
            for buf, g in zip(self.gout, grads):
                buf.zero_() if g is None else buf.copy_(g)
        kept = _ag._deliver_begin(self.deliveries, task)
        if self.bwd is None:
            self._capture_backward(self._bwd_graph)
        if self.bwd_runs or not self.bwd.ran:
            self.bwd.replay()
        # the run that completes a capture is not a replay
        self.cached.replays += self.bwd_runs > 0
        self.bwd_runs += 1
        _ag._deliver_end(self.deliveries, kept, task)
        self.busy = False
        in_grads = iter(self.in_grads)
        with torch.no_grad():
            out = [next(in_grads) if s.requires_grad else None
                   for s in self.static_in]
            return [None if g is None else g.clone() for g in out]
