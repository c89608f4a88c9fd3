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
`named_parameters()` names and the keys of `save_parameters` files (a
parameter tied to two attributes has one key, its first name in module
order).  These keys stay structural: the JAX package's parameter files
and `weights.load_reference_params` use them.  Besides, as in the JAX
package, every block has a `prefix` (the class name in lower case and a
per-thread counter: "dense0_", "hybridsequential1_"; `name_scope()`
leaves it as it is), a `name` (the prefix without its "_"), and
`params`, a `ParameterDict` of its own parameters keyed by
`Parameter.name`, the prefixed name ("dense0_weight"), which
`params.get(name, **kwargs)` creates or shares (`params=`).  A block
written as `hybrid_forward(self, F, x, *args, **params)` with no
`forward` runs with `F` the port's `mx.nd` and its own parameters passed
by attribute name (`HybridBlock.forward`); a parameter of it whose shape
has a 0 is filled by `infer_shape`, its own or the default one that runs
the forward on meta tensors.  `summary(*inputs)` prints the JAX table.

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
again.  A block with a parameter whose gradient is row_sparse
(`Embedding(sparse_grad=True)`) runs its recorded calls eagerly (the
`eager_calls` counter counts them), as the JAX block leaves its fused
backward for such a parameter: the gradient's row count depends on the
data, which a captured program cannot hold; its calls without recording
are captured as any other.  `set_input_transform(fn)` installs a
function of the first input (a uint8 batch to its normalized bf16, say)
that runs inside the forward the block captures, and before `forward` in
an eager call.  A parameter that `cast`, `initialize`, `load_parameters`
or `set_data` replaced or rewrote is marked (`parameter.touch`), which
changes the parameters' key and drops the block's programs.

Parameters on several contexts (`initialize(ctx=[...])`): a call whose
first tensor input belongs to another context than the parameters'
first one (its device, or on the CPU the replica mark that
`gluon.utils.split_and_load` puts on its slices, `context.replica_of`)
runs on that context's copies (`Parameter.replica`), through
`torch.func.functional_call`; a hybridized block keeps one set of
programs per such context, each capturing over its context's copies and
writing their gradients.
"""
from __future__ import annotations

import contextlib
import itertools
import math
import re
import threading
from collections import OrderedDict

import torch
from torch import nn
from torch.utils._pytree import tree_flatten, tree_map, tree_unflatten

from .parameter import (DeferredInitializationError, Parameter,
                        ParameterDict, cast_parameter, in_shape_pass,
                        is_deferred, shape_pass)
from .. import autograd as _ag
from .. import graph_capture as _capture
from .. import random as _rnd
from ..base import MXNetError
from ..context import replica_of, resolve_device
from ..ndarray.ndarray import NDArray, _wrap, unwrap

__all__ = ["Block", "HybridBlock", "new_parameter", "cast_parameter",
           "materialize", "nameless_scope", "call_on_ndarrays"]


# -- names (ref: the JAX package's _gen_prefix and name_scope) ---------------

class _NameCounter(threading.local):
    def __init__(self):
        self.counts = {}


_NAMES = _NameCounter()


def _gen_prefix(hint):
    """`hint` and its count so far, "dense0_", "dense1_", ...: one
    counter per class name and thread, as in the JAX package."""
    n = _NAMES.counts.get(hint, 0)
    _NAMES.counts[hint] = n + 1
    return "%s%d_" % (hint, n)


@contextlib.contextmanager
def nameless_scope():
    """Name counters of their own inside, the outer ones restored after."""
    counts = _NAMES.counts
    _NAMES.counts = {}
    try:
        yield
    finally:
        _NAMES.counts = counts


def new_parameter(name, shape, init, device, dtype, grad_req="write",
                  grad_stype="default"):
    """A `Parameter` of `shape` (0 for a width the first input gives);
    `init` is an Initializer, one of its names, or None for the default
    `Uniform()`.  With a `device` it is initialized there at once (or
    when its shape becomes known); without one it waits for
    `initialize`."""
    p = Parameter(name, grad_req=grad_req, shape=shape, dtype=dtype,
                  init=init, allow_deferred_init=True,
                  grad_stype=grad_stype)
    # the block it is assigned to prefixes its name (`Block.__setattr__`)
    p.__dict__["_unscoped"] = True
    if device is not None:
        p.initialize(ctx=device)
    return p


def materialize(param, shape):
    """Give a deferred `param` its full `shape` and complete its
    initialization (inside a shape pass only the shape); a parameter
    that has data is left as it is."""
    if is_deferred(param):
        param._set_shape(shape)
        if not in_shape_pass():
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


def call_on_ndarrays(fn, *args, **kwargs):
    """`fn` over NDArrays: the tensor arguments come in wrapped, the
    NDArrays it returns go out as their tensors, and its `nd` ops record
    for autograd when torch's grad mode is on, as the port's other
    layers do."""
    def wrap(t):
        return _wrap(t) if isinstance(t, torch.Tensor) else t
    prev = _ag.set_recording(torch.is_grad_enabled())
    try:
        out = fn(*map(wrap, args), **{k: wrap(v) for k, v in kwargs.items()})
    finally:
        _ag.set_recording(prev)
    return tree_map(unwrap, out)


class Block(nn.Module):
    """ref: gluon.Block — a composable layer; the PyTorch module protocol
    (`forward`, `train()`/`eval()`, `state_dict`) applies as is.  Called
    with `mx.nd` NDArrays, a block runs on their tensors and returns
    NDArrays, as the JAX package's blocks do; called with tensors, it
    returns tensors.

    `Block(prefix=None, params=None)`: the prefix defaults to the class
    name in lower case and its count ("dense0_"), `params` is a
    `ParameterDict` whose parameters `self.params.get` shares.  A
    `Parameter` assigned to an attribute is registered under that name
    (`_reg_params`) and in `self.params` by its `name`; one made by
    `new_parameter` ("weight") takes the block's prefix ("dense0_weight")
    as the JAX `params.get("weight")` gives it."""

    def __init__(self, prefix=None, params=None):
        super().__init__()
        self._prefix = prefix if prefix is not None \
            else _gen_prefix(type(self).__name__.lower())
        self._params = ParameterDict(self._prefix, shared=params)
        self._reg_params = OrderedDict()

    def __setattr__(self, name, value):
        if isinstance(value, Parameter) and "_reg_params" in self.__dict__:
            self._scope_param(name, value)
        super().__setattr__(name, value)

    def _scope_param(self, name, value):
        if value.__dict__.pop("_unscoped", False):
            value.name = self._prefix + value.name
        self._reg_params[name] = value
        if value.name not in self._params:
            OrderedDict.__setitem__(self._params, value.name, value)

    def _register_shadowed(self, name, value):
        """Register the `Parameter` `value` under `name` as an attribute
        assignment would, where `name` is an attribute of `nn.Module`
        itself (the JAX RNN layers' flat vector is `parameters`, torch's
        method): it is this block's `name` in `named_parameters()`,
        `collect_params()`, `state_dict()` and `hybrid_forward`'s
        arguments, while `getattr(self, name)` stays torch's."""
        self._scope_param(name, value)
        self._parameters[name] = value

    def register_child(self, block, name=None):
        """Add `block` as a child named `name`, by default its index among
        the children ("0", "1", ...), as the JAX package names them."""
        self.add_module(name or str(len(self._modules)), block)

    def name_scope(self):
        """`with self.name_scope():` around the children's construction;
        as in the JAX package, the children's prefixes do not nest in
        it."""
        return contextlib.nullcontext()

    @property
    def prefix(self):
        return self._prefix

    @property
    def name(self):
        return self._prefix.rstrip("_")

    @property
    def params(self):
        """This block's own parameters (not its children's), keyed by
        name, with its prefix (`params.get("weight")`)."""
        return self._params

    def _own_params(self):
        """{attribute name: parameter} of the parameters assigned to this
        block's attributes, in order (what `hybrid_forward` receives)."""
        out = OrderedDict()
        own = self._parameters
        for n in self.__dict__.get("_reg_params", ()):
            p = own[n] if n in own else getattr(self, n, None)
            if p is not None:
                out[n] = p
        return out

    def __call__(self, *args, **kwargs):
        out = _nd_call(self._call, args, kwargs)
        return self._call(*args, **kwargs) if out is None else out

    def _call(self, *args, **kwargs):
        rep = _replica_params(self, args, kwargs)
        if rep is not None:
            return _replica_call(self, rep[1], args, kwargs)
        return nn.Module.__call__(self, *args, **kwargs)

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

    def summary(self, *inputs):
        """Print and return a per-layer table, as the JAX `Block.summary`
        gives it: per block that runs, in the order they finish, its
        structural name (the class name for this block), type, first
        output's shape and the size of its own parameters, then the
        total over `collect_params()`.  The forward runs eagerly under
        `autograd.pause()`, with every hybridized block's programs set
        aside and restored after, so that each child's hook fires."""
        rows, handles = [], []

        def count(block):
            return sum(math.prod(p.shape or ())
                       for p in block._own_params().values()
                       if not is_deferred(p) or p._shape_known())

        def register(block, prefix):
            def hook(blk, args, out, _name=prefix or type(block).__name__):
                first = out[0] if isinstance(out, (list, tuple)) else out
                shape = tuple(getattr(first, "shape", ()))
                rows.append((_name, type(blk).__name__, shape, count(blk)))
            handles.append(block.register_forward_hook(hook))
            for name, child in block.named_children():
                register(child, (prefix + "." if prefix else "") + name)

        register(self, "")
        set_aside = []
        for m in self.modules():
            graph = m.__dict__.get("_cached_graph")
            if graph is not None:
                set_aside.append((m, graph))
                m.__dict__["_cached_graph"] = None
        try:
            with _ag.pause():
                self(*inputs)
        finally:
            for h in handles:
                h.remove()
            for m, graph in set_aside:
                m.__dict__["_cached_graph"] = graph

        lines = ["%s" % ("-" * 68),
                 "%-28s %-14s %14s %8s" % ("Layer", "Type",
                                           "Output Shape", "Params"),
                 "=" * 68]
        for name, typ, shape, n in rows:
            lines.append("%-28s %-14s %14s %8d"
                         % (name[:28] or "(self)", typ[:14], str(shape), n))
        unique = {id(p): tuple(p.shape or ())
                  for p in self.collect_params().values()}
        total = sum(math.prod(s) for s in unique.values()
                    if s and all(d > 0 for d in s))
        lines.append("=" * 68)
        lines.append("Total params: %d" % total)
        lines.append("-" * 68)
        out = "\n".join(lines)
        print(out)
        return out


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
        self.__dict__.pop("_replica_graphs", None)
        self.__dict__["_cached_graph"] = _CachedGraph(self, remat) \
            if active else None
        super().hybridize(active, static_alloc=static_alloc,
                          static_shape=static_shape)

    def __call__(self, *args, **kwargs):
        out = _nd_call(self.__call__, args, kwargs)
        if out is not None:
            return out
        cached = self.__dict__.get("_cached_graph")
        if in_shape_pass():         # its inputs are transformed already
            return nn.Module.__call__(self, *args, **kwargs)
        rep = _replica_params(self, args, kwargs)
        if cached is None or _in_program():
            if rep is not None:
                return _replica_call(self, rep[1], args, kwargs)
            return nn.Module.__call__(
                self, *self._apply_input_transform(args), **kwargs)
        if rep is not None:
            cached = self._replica_graph(*rep)
        return cached(args, kwargs)

    def _replica_graph(self, ctx, params):
        """The programs of this block for the copies `params` of context
        `ctx` (new ones when the copies changed)."""
        graphs = self.__dict__.setdefault("_replica_graphs", {})
        graph = graphs.get(ctx)
        if graph is None or graph.replica_ids != [id(t) for t in
                                                  params.values()]:
            graph = graphs[ctx] = _CachedGraph(
                self, self.__dict__["_cached_graph"].remat, params)
        return graph

    def set_input_transform(self, fn):
        """Install a preprocessing function of NDArrays applied to the
        first positional input (uint8 pixels to the normalized compute
        dtype: `io.device_feed.normalize_transform`); None removes it.
        A hybridized block applies it inside the forward it captures, so
        the program's static input is the uint8 batch and the float
        tensor exists only inside the replay; an eager call applies it
        before `forward`.  Deferred widths are inferred from its output.
        Installing or removing one drops the block's programs."""
        self._input_transform = fn
        cached = self.__dict__.get("_cached_graph")
        if cached is not None:
            cached.clear()
        self.__dict__.pop("_replica_graphs", None)

    def _apply_input_transform(self, args):
        """`args` with the input transform applied to the first, a
        tensor or an NDArray (which comes back as the same kind)."""
        fn = getattr(self, "_input_transform", None)
        if fn is None or not args:
            return args
        x = args[0]
        if isinstance(x, NDArray):
            return (fn(x),) + tuple(args[1:])
        if isinstance(x, torch.Tensor):
            return (unwrap(fn(_wrap(x))),) + tuple(args[1:])
        return args

    def forward(self, x, *args, **kwargs):
        """The forward of a block written as `hybrid_forward(self, F, x,
        *args, **params)` (ref: HybridBlock.forward): `F` is `mx.nd`, the
        inputs and this block's own parameters (`_own_params`, by
        attribute name) come in as NDArrays, and the NDArrays it returns
        go out as their tensors.  Its `nd` ops record for autograd when
        torch's grad mode is on, as the port's other blocks do.  A
        parameter without data takes its shape from `infer_shape` and is
        initialized before the call."""
        if type(self).hybrid_forward is HybridBlock.hybrid_forward:
            raise NotImplementedError(
                "%s defines neither forward nor hybrid_forward"
                % type(self).__name__)
        from .. import ndarray as F
        params = self._own_params()
        if not in_shape_pass() and any(map(is_deferred, params.values())):
            self._finish_deferred(x, *args)
            params = self._own_params()
        return call_on_ndarrays(self.hybrid_forward, F, x, *args,
                                **kwargs, **params)

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError

    def infer_shape(self, *args):
        """Fill the unknown widths of the parameters from the inputs (ref:
        HybridBlock.infer_shape).  A block may override it with its own
        rule (`Dense`, `Conv2D` and user blocks do); this default runs
        the forward once on the meta device, as the JAX package runs it
        under `jax.eval_shape`: parameters with data and the inputs as
        empty meta tensors, a parameter without data but with a known
        shape as one too, and each child's rule recording the shapes it
        finds.  An op with no meta path raises an MXNetError naming it."""
        if in_shape_pass():
            return
        metas = {n: torch.empty(p.shape, dtype=p.dtype, device="meta")
                 for n, p in self.named_parameters() if not is_deferred(p)}
        ins = tuple(torch.empty(a.shape, dtype=a.dtype, device="meta")
                    if isinstance(a, torch.Tensor) else a for a in args)
        from ..ops import attention
        watch = _capture._Watch(record=False)
        try:
            with shape_pass(), _ag.pause(), attention.shapes_only(), \
                    watch:
                torch.func.functional_call(self, metas, ins)
        except DeferredInitializationError:
            raise
        except Exception as exc:
            raise MXNetError(
                "infer_shape of %s: its forward failed on meta tensors at "
                "%s: %s: %s" % (type(self).__name__, watch.last,
                                type(exc).__name__, exc)) from exc

    def _finish_deferred(self, *args):
        """`infer_shape(*args)`, then initialize every parameter of the
        tree whose shape it made known."""
        self.infer_shape(*args)
        for p in self.parameters():
            if is_deferred(p) and p._shape_known() \
                    and p.__dict__.get("_deferred_init") is not None:
                p._finish_deferred_init()

    def inference_engine(self, **kwargs):
        """Build a `serving.InferenceEngine` over this block; keyword
        arguments go to `InferenceEngine` (device, buckets, max_batch,
        queue_cap, example_shape, wire_dtype, ...)."""
        from ..serving import InferenceEngine
        return InferenceEngine(self, **kwargs)


# -- parameters on several contexts ------------------------------------------

_REPLICA = threading.local()


def _replica_params(block, args, kwargs):
    """(context, {name: copy}) when the first tensor among the call's
    arguments belongs to a context on which `block`'s parameters have
    copies other than themselves; else None (always inside a replica
    call or a program: the outer call chose the tensors)."""
    if getattr(_REPLICA, "on", False) or _in_program():
        return None
    params = block.named_parameters()
    head = next(params, None)
    if head is None or not head[1].__dict__.get("_replicas"):
        return None
    first = next((a for a in tree_flatten((args, kwargs))[0]
                  if isinstance(a, torch.Tensor)), None)
    if first is None:
        return None
    ctx = replica_of(first)
    out = {}
    for name, p in itertools.chain([head], params):
        reps = p.__dict__.get("_replicas")
        if not reps or ctx not in reps:
            return None
        out[name] = reps[ctx]
    return ctx, out


def _replica_call(block, params, args, kwargs):
    """`block`'s call on the tensors `params` in place of its parameters
    (its own `__call__` applies its input transform)."""
    _REPLICA.on = True
    try:
        return torch.func.functional_call(block, params, tuple(args), kwargs)
    finally:
        _REPLICA.on = False


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

    def __init__(self, block, remat, replica=None):
        self.block = block
        self.remat = remat
        #: {name: copy} of one context's parameter copies, or None for
        #: the parameters themselves
        self.replica = replica
        self.replica_ids = None if replica is None else \
            [id(t) for t in replica.values()]
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
        if params is None:
            params = self.replica

        def run(*a, **kw):
            with _ProgramScope(training, recording):
                if params is None:
                    return self.block.forward(
                        *self.block._apply_input_transform(a), **kw)
                # the block's __call__ applies its input transform
                return torch.func.functional_call(self.block, params, a, kw)
        if self.remat and recording:
            return torch.utils.checkpoint.checkpoint(
                run, *args, use_reentrant=False, preserve_rng_state=False,
                context_fn=_rnd.remat_contexts, **kwargs)
        return run(*args, **kwargs)

    def _check_params(self):
        if self.params is None:
            self.named = list(self.replica.items()) \
                if self.replica is not None \
                else list(self.block.named_parameters())
            self.params = [p for _, p in self.named]
            self.sparse_grads = any(
                getattr(p, "grad_stype", "default") == "row_sparse"
                for p in self.params)
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
        if warm < self.WARMUP or (recording and self.sparse_grads):
            # a row_sparse gradient's row count depends on the data, so a
            # recorded call of a block that has one runs eagerly
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
