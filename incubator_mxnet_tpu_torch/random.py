"""Random state of the PyTorch port (counterpart of incubator_mxnet_tpu/random.py).

One `torch.Generator` per device, created on first use and seeded from
the base seed that `seed(n)` sets; the initializer and dropout draw from
it explicitly.  Torch's generators give other numbers than JAX's
threefry from the same seed, so tests make shared inputs with numpy.

Two helpers serve captured programs (`graph_capture`):

* `register_with_graph(graph, device)` registers the device's generator
  with a CUDA graph before its capture, so that every replay draws new
  numbers, in the sequence eager calls would draw;
* `remat_contexts()` gives the two contexts that
  `torch.utils.checkpoint` enters around a block's forward and its
  recompute (`hybridize(remat=True)`).  Torch's checkpoint restores only
  its own generators, so a dropout mask drawn from the port's generator
  in the forward is kept under the first and used again, in order, by
  the recompute under the second (`remat_mask`), instead of being drawn
  anew.  A kept mask is a device tensor, so it is right in a replayed
  graph too.
"""
from __future__ import annotations

import threading

import torch

__all__ = ["seed", "generator", "register_with_graph", "remat_contexts",
           "remat_mask"]

_LOCK = threading.Lock()
_BASE_SEED = 0
_GENERATORS = {}


def _key(device):
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def seed(seed_state: int) -> None:
    """Reseed the generators of all devices, and of those created later."""
    global _BASE_SEED
    with _LOCK:
        _BASE_SEED = int(seed_state)
        for gen in _GENERATORS.values():
            gen.manual_seed(_BASE_SEED)


def generator(device) -> torch.Generator:
    """The generator of `device`, seeded from the base seed at creation."""
    dev = _key(device)
    gen = _GENERATORS.get(dev)
    if gen is None:
        with _LOCK:
            gen = _GENERATORS.get(dev)
            if gen is None:
                gen = torch.Generator(device=dev)
                gen.manual_seed(_BASE_SEED)
                _GENERATORS[dev] = gen
    return gen


def register_with_graph(graph, device):
    """Register `device`'s generator with the CUDA graph `graph` (before
    its capture begins)."""
    graph.register_generator_state(generator(device))


_REMAT = threading.local()


class _RematScope:
    """Keeps (`keep`) or hands back the dropout masks of one checkpointed
    forward, in the order they were drawn."""

    def __init__(self, masks, keep):
        self._masks, self._keep, self._prev = masks, keep, None

    def __enter__(self):
        self._prev = getattr(_REMAT, "scope", None)
        self._pos = 0
        _REMAT.scope = self
        return self

    def __exit__(self, *exc):
        _REMAT.scope = self._prev

    def mask(self, draw):
        if self._keep:
            self._masks.append(draw())
            return self._masks[-1]
        self._pos += 1
        return self._masks[self._pos - 1]


def remat_contexts():
    """(forward context, recompute context) for one checkpointed call:
    `context_fn` of `torch.utils.checkpoint.checkpoint`."""
    masks = []
    return _RematScope(masks, keep=True), _RematScope(masks, keep=False)


def remat_mask(draw):
    """The dropout mask `draw()` gives, kept inside a checkpointed
    forward, and the kept one inside its recompute."""
    scope = getattr(_REMAT, "scope", None)
    return draw() if scope is None else scope.mask(draw)
