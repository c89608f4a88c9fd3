"""Captured programs of the PyTorch port: what a hybridized block and a
`gluon.Trainer` replay instead of running their Python again (the
counterpart of the JAX package's jitted executables: `_CachedGraph` in
incubator_mxnet_tpu/gluon/block.py, `_fused_multi` in
incubator_mxnet_tpu/optimizer/optimizer.py).

`capture(fn, device, pool=None)` captures `fn()` and returns `(program,
result)`; `program.replay()` runs what `fn` issued, on the same tensors,
and `program.ran` says whether the capture itself ran it once (a
recording does; a CUDA graph's capture only records its launches):

* on a CUDA device the program is a `torch.cuda.CUDAGraph` (in the
  memory pool `pool`, where given), captured with the port's generator
  registered (`random.register_with_graph`) and replayed on the current
  stream;
* on the CPU, where the caller asked for it, the program is the list of
  aten ops that `fn` issued, recorded under a `TorchDispatchMode` while
  they ran.  A replay issues each op again on the recorded arguments and
  copies each fresh result into the storage of the recorded one, so that
  every tensor keeps its storage across replays, as in a graph's pool.
  It is not a fallback: a CUDA tensor never takes it.

Either program keeps a CUDA graph's rules, so that the CPU tests catch
what breaks them: Python values are frozen at capture, a replay reads
and writes the storage that the capture saw (a tensor replaced since is
not read), and its results are the same tensors each replay.  A host
read of a device value (`.item()`, `nonzero`, ...) inside `fn` raises
`CaptureError` naming the op, as does any other failure of a capture,
with the last op issued before it.  Nothing falls back to eager.  A
failed CUDA capture leaves the generators it held (the device's default
one and the port's) marked as capturing; each is given a copy of its own
state, at the same seed and offset, so that it draws again.

The kernels' launch counters (`ops.attention`, `ops.conv_stats`) count
what their wrappers issue, a capture's launches into its graph included;
a replay runs no wrapper and counts nothing, so a replayed step's
launches are read from the profiler's kernel names.
"""
from __future__ import annotations

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_map

from . import random as _rnd
from .base import MXNetError

__all__ = ["CaptureError", "capture"]

_aten = torch.ops.aten
#: ops whose result is a host value read from the device, or whose shape
#: depends on device values
_HOST_READS = frozenset((_aten._local_scalar_dense, _aten.nonzero,
                         _aten.equal, _aten.is_nonzero,
                         _aten.masked_select, _aten._unique2,
                         _aten.unique_consecutive, _aten.unique_dim))


class CaptureError(MXNetError):
    """A program could not be captured."""


class _Watch(TorchDispatchMode):
    """Refuses host reads and names the last op issued; with `record`,
    keeps (op, args, kwargs, result) of every op it lets run."""

    def __init__(self, record):
        super().__init__()
        self.ops = [] if record else None
        self.last = None

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        self.last = func
        if func.overloadpacket in _HOST_READS:
            raise CaptureError(
                "%s reads a device value on the host, which a captured "
                "program cannot do" % func)
        out = func(*args, **kwargs)
        if self.ops is not None:
            self.ops.append((func, args, kwargs, out))
        return out


def _alias(t):
    """A tensor's storage under a version counter of its own (a replay
    neither bumps the versions that autograd checks nor records)."""
    return t.data if isinstance(t, torch.Tensor) else t


def _same_storage(a, b):
    return (isinstance(b, torch.Tensor) and a.untyped_storage().data_ptr()
            == b.untyped_storage().data_ptr())


class _Recording:
    """The aten ops one capture issued on the CPU, replayed in order."""

    def __init__(self, ops):
        self._plan = [(func, tree_map(_alias, args), tree_map(_alias, kw),
                       [_alias(o) if isinstance(o, torch.Tensor) else None
                        for o in tree_flatten(out)[0]])
                      for func, args, kw, out in ops]

    #: the capture ran the ops
    ran = True

    def pool(self):
        return None

    @torch.no_grad()
    def replay(self):
        for func, args, kwargs, outs in self._plan:
            fresh = tree_flatten(func(*args, **kwargs))[0]
            for rec, new in zip(outs, fresh):
                if rec is not None and not _same_storage(rec, new):
                    rec.copy_(new)


class _Graph:
    """A captured CUDA graph."""

    def __init__(self, graph):
        self.graph = graph

    #: a capture runs nothing on the device
    ran = False

    def pool(self):
        return self.graph.pool()

    def replay(self):
        self.graph.replay()


def _release_generators(device):
    """Out of capture, at the same seed and offset, the generators that a
    failed capture on `device` held."""
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    for gen in (torch.cuda.default_generators[index],
                _rnd.generator(device)):
        gen.graphsafe_set_state(gen.clone_state())


def _failed(watch, exc):
    return CaptureError("capture failed at %s: %s: %s"
                        % (watch.last, type(exc).__name__, exc))


def capture(fn, device, pool=None):
    """Capture `fn()` on `device` ("cuda..." or "cpu"); returns
    (program, what fn returned)."""
    device = torch.device(device)
    if device.type == "cpu":
        watch = _Watch(record=True)
        try:
            with watch:
                out = fn()
        except CaptureError:
            raise
        except Exception as exc:
            raise _failed(watch, exc) from exc
        return _Recording(watch.ops), out
    if device.type != "cuda":
        raise CaptureError("no captured programs on %s" % device)
    graph = torch.cuda.CUDAGraph()
    _rnd.register_with_graph(graph, device)
    watch = _Watch(record=False)
    try:
        with torch.cuda.device(device), torch.cuda.graph(graph, pool=pool):
            with watch:
                out = fn()
    except Exception as exc:
        _release_generators(device)
        if isinstance(exc, CaptureError):
            raise
        raise _failed(watch, exc) from exc
    return _Graph(graph), out
