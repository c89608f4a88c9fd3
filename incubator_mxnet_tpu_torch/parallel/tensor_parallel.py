"""Tensor parallelism of the PyTorch port: the layer forms that the JAX
package gets from XLA's partitioner when a `ShardedTrainer`'s
`param_spec_fn` shards parameters over a mesh axis other than the
batch's (incubator_mxnet_tpu/parallel/trainer.py, `_param_shardings`).

The port has no partitioner, so it keeps the same contract by hand.
`ShardedTrainer` derives a `Plan` once, from the specs and the block's
structure, and runs its step as `spmd.run_replicas` bodies over the
(data, model) mesh with the plan active (`active`); the layers read it
(`role(layer)`):

* **column parallel**: a `Dense` whose weight has the spec ("model",
  None).  The replica holds out/tp rows of the (out, in) weight and
  computes its slice of the outputs; a replicated bias is sliced
  (`split_to`, whose backward gathers the bias gradient whole on every
  model replica); the input passes `copy_to`, the identity whose
  backward sums over "model" (Megatron's f);
* **row parallel**: the spec (None, "model").  The model-sharded input
  gives a partial product, summed by `reduce_from` (psum; its backward
  is the identity: Megatron's g), and the bias is added once, after the
  sum; a replicated input is split first (`split_to`);
* `PositionwiseFFN` with ffn1 column and ffn2 row parallel keeps the
  hidden activation sharded through GELU; `MultiHeadAttention` with
  query, key and value column and proj row parallel runs num_heads/tp
  heads of the same head dim (`local_heads`).  Each applies f once to
  its input (`enter`);
* a column-parallel `Dense` with no row partner all-gathers its output
  (`gather_from`, whose backward takes this replica's slice of its
  cotangent);
* any other sharded parameter (an embedding split on the vocab, a conv
  weight, a sharded bias) is all-gathered over "model" at the start of
  the step's forward (`gather_from`).

Every model replica so computes the same loss, and f's backward sums
the input cotangents over "model": every replicated value, and the
gradient of every replicated parameter, comes out equal on every model
replica.  A gather's backward takes the replica's own slice of that
common cotangent, which is the reduce-scatter of the cotangents divided
by their number.  The trainer then sums each gradient over the data
axis only, among the replicas that hold the same model coordinate.

Dropout under an active plan raises: each replica would draw its own
mask where the plan needs one mask on every model replica.

Counters (`monitor.events`): ``tp.column`` and ``tp.row`` per Dense
call, ``tp.heads_local`` per attention call on local heads,
``tp.gathered`` per gathered parameter or output.  They count what
Python runs: a replayed captured step counts nothing.
"""
from __future__ import annotations

import contextlib
import threading

from ..monitor import events

__all__ = ["Plan", "active", "current", "role", "enter", "local_heads",
           "dense", "copy_to", "reduce_from", "gather_from", "split_to"]

_LOCAL = threading.local()

#: the roles of a Dense (the rest are blocks' roles)
_COLUMN = ("column", "column_in", "column_gather")
_ROW = ("row", "row_in")


class Plan:
    """What each layer of `block` does under the specs `specs`
    ({structural parameter name: P}) over mesh axis `axis` of size
    `size` (module doc).  `tp_dim` maps each sharded parameter to its
    sharded dimension, `roles` each planned module's structural name to
    its role, and `gathered` holds the parameters all-gathered at the
    step's start."""

    def __init__(self, block, specs, axis, size):
        from ..gluon.nn import Dense
        from ..models.transformer import MultiHeadAttention, \
            PositionwiseFFN
        self.axis, self.size = axis, int(size)
        self.tp_dim = {}
        for name, spec in specs.items():
            for d, a in enumerate(tuple(spec)):
                if a is None:
                    continue
                if a != axis:
                    raise NotImplementedError(
                        "parameter %s: a spec over %r (the port shards "
                        "parameters over %r only)" % (name, a, axis))
                if name in self.tp_dim:
                    raise ValueError("parameter %s: two dimensions over %r"
                                     % (name, axis))
                self.tp_dim[name] = d
        mods = dict(block.named_modules())

        def kind(path):
            m = mods.get(path)
            if not isinstance(m, Dense) or \
                    (m.bias is not None and path + ".bias" in self.tp_dim):
                return None
            return {0: "column", 1: "row"}.get(self.tp_dim.get(path +
                                                               ".weight"))
        self.roles = {}
        for name, m in mods.items():
            p = name + "." if name else ""
            if isinstance(m, MultiHeadAttention) and \
                    all(kind(p + c) == "column"
                        for c in ("query", "key", "value")) and \
                    kind(p + "proj") == "row":
                if m._num_heads % self.size:
                    raise ValueError(
                        "%s: %d heads do not split over %d %r replicas"
                        % (name or "the block", m._num_heads, self.size,
                           axis))
                if m._seq_parallel is not None:
                    raise NotImplementedError(
                        "%s: tensor parallel attention with seq_parallel"
                        % name)
                self.roles[name] = "heads"
                self.roles.update({p + c: "column_in"
                                   for c in ("query", "key", "value")})
                self.roles[p + "proj"] = "row_in"
            elif isinstance(m, PositionwiseFFN) and \
                    kind(p + "ffn1") == "column" and kind(p + "ffn2") == "row":
                self.roles[name] = "ffn"
                self.roles[p + "ffn1"] = "column_in"
                self.roles[p + "ffn2"] = "row_in"
        for name in mods:
            if name not in self.roles and kind(name) is not None:
                self.roles[name] = {"column": "column_gather",
                                    "row": "row"}[kind(name)]
        self.gathered = set(self.tp_dim) - {
            n + ".weight" for n, r in self.roles.items()
            if r in _COLUMN + _ROW}
        self._by_id = {}

    def bind(self, blocks):
        """Make the plan's roles those of the modules of each of `blocks`
        (the trainer's replica shells, copies of one tree)."""
        for b in blocks:
            for name, m in b.named_modules():
                if name in self.roles:
                    self._by_id[id(m)] = self.roles[name]
        return self


@contextlib.contextmanager
def active(plan):
    """Inside: the calling thread's layers follow `plan` (run it inside a
    `spmd.run_replicas` body, whose axis collectives it issues)."""
    prev = getattr(_LOCAL, "plan", None)
    _LOCAL.plan = plan
    try:
        yield
    finally:
        _LOCAL.plan = prev


def current():
    """The calling thread's active `Plan`, or None."""
    return getattr(_LOCAL, "plan", None)


def role(layer):
    """`layer`'s role under the active plan, or None."""
    plan = getattr(_LOCAL, "plan", None)
    return None if plan is None else plan._by_id.get(id(layer))


def _axis():
    return _LOCAL.plan.axis


def copy_to(x):
    """The identity whose backward sums the cotangents over the model
    axis (Megatron's f)."""
    from . import spmd
    return spmd._collective("tp_copy", _axis(), (), x)


def reduce_from(x):
    """The sum over the model axis whose backward is the identity
    (Megatron's g)."""
    from . import spmd
    return spmd._collective("tp_sum", _axis(), (), x)


def gather_from(x, dim):
    """The model replicas' pieces of `x` concatenated along `dim`; the
    backward takes this replica's piece of the cotangent."""
    from . import spmd
    events.incr("tp.gathered")
    return spmd._collective("gather", _axis(), (dim % x.dim(),), x)


def split_to(x, dim):
    """This model replica's piece of a replicated `x` along `dim`; the
    backward gathers the pieces' cotangents."""
    from . import spmd
    return spmd._collective("split", _axis(), (dim % x.dim(),), x)


def enter(block, x):
    """A planned attention or FFN block's input through f (once for the
    block's column layers); any other block's `x` as it is."""
    return copy_to(x) if role(block) in ("heads", "ffn") else x


def local_heads(block, num_heads):
    """The heads an attention block runs on this replica: num_heads/tp
    of the same head dim under the plan, else all of them."""
    if role(block) != "heads":
        return num_heads
    events.incr("tp.heads_local")
    return num_heads // _LOCAL.plan.size


def dense(layer, x):
    """A planned `Dense`'s forward on this replica (module doc), or None
    where the plan has no role for it."""
    r = role(layer)
    if r is None:
        return None
    from ..ops import nn as ops
    if layer._flatten and x.ndim > 2:
        x = x.reshape(x.shape[0], -1)
    bias = layer.bias
    if r in _COLUMN:
        events.incr("tp.column")
        if r != "column_in":
            x = copy_to(x)
        out = ops.fully_connected(
            x, layer.weight, None if bias is None else split_to(bias, 0),
            no_bias=bias is None, flatten=False)
        if layer.act is not None:
            out = ops.activation(out, act_type=layer.act)
        return gather_from(out, -1) if r == "column_gather" else out
    events.incr("tp.row")
    if r == "row":
        x = split_to(x, -1)
    out = reduce_from(ops.fully_connected(x, layer.weight, None,
                                          no_bias=True, flatten=False))
    if bias is not None:
        out = out + bias.to(out.dtype)
    if layer.act is not None:
        out = ops.activation(out, act_type=layer.act)
    return out
