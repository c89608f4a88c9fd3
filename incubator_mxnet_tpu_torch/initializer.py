"""Parameter initializers of the PyTorch port (counterpart of
incubator_mxnet_tpu/initializer.py): the same classes, registry and
name dispatch.

`init(name, tensor, generator)` fills `tensor` in place.  As in the JAX
package, the parameter's name picks the fill for every initializer:
`*bias`, `*beta`, `*running_mean` and `*moving_mean` get zeros,
`*gamma`, `*running_var` and `*moving_var` ones, anything else the
initializer's own weight fill.  Random fills draw from the generator
given, which the parameters pass as their device's (`random.generator`),
in f32, and are rounded once into the tensor's dtype.  Torch's
generators give other numbers than JAX's threefry, so only the
distributions agree with the JAX package, not the values.
"""
from __future__ import annotations

import json
import math
import re

import numpy as np
import torch

from .base import MXNetError

__all__ = ["Initializer", "Zero", "One", "Constant", "Uniform", "Normal",
           "Orthogonal", "Xavier", "MSRAPrelu", "Bilinear", "LSTMBias",
           "Mixed", "register", "create"]

_REGISTRY = {}
_ALIASES = {"zeros": "zero", "ones": "one", "gaussian": "normal"}


def register(klass):
    _REGISTRY[klass.__name__.lower()] = klass
    return klass


def create(name, **kwargs):
    """An initializer from an instance, a callable, a registered name
    ('zeros', 'ones', 'xavier', 'msraprelu', ...) with its keyword
    arguments, or None (the default `Uniform()`)."""
    if isinstance(name, Initializer):
        return name
    if name is None:
        return Uniform()
    if callable(name):
        return name
    key = _ALIASES.get(name.lower(), name.lower())
    if key not in _REGISTRY:
        raise MXNetError("unknown initializer %r (one of %s)"
                         % (name, ", ".join(sorted(_REGISTRY))))
    return _REGISTRY[key](**kwargs)


@torch.no_grad()
def _fill_random(tensor, draw):
    """`draw(t)` fills an f32 tensor of `tensor`'s shape and device in
    place; the result is rounded once into `tensor`."""
    if tensor.dtype == torch.float32:
        draw(tensor)
    else:
        tmp = torch.empty(tensor.shape, device=tensor.device,
                          dtype=torch.float32)
        draw(tmp)
        tensor.copy_(tmp)


@torch.no_grad()
def _fill_host(tensor, value):
    """Copy a numpy array of `tensor`'s shape into it."""
    tensor.copy_(torch.from_numpy(np.ascontiguousarray(value)))


class Initializer:
    """Base initializer: `__call__(name, tensor, generator)` fills
    `tensor` in place, by the name dispatch (module doc)."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def __call__(self, name, tensor, generator=None):
        if not isinstance(name, str):
            name = ""
        self.init_weight(name, tensor, generator)

    @torch.no_grad()
    def init_weight(self, name, tensor, generator=None):
        if name.endswith(("bias", "beta", "running_mean", "moving_mean")):
            tensor.zero_()
        elif name.endswith(("gamma", "running_var", "moving_var")):
            tensor.fill_(1.0)
        else:
            self._init_weight(name, tensor, generator)

    def _init_weight(self, name, tensor, generator):
        raise NotImplementedError

    def dumps(self):
        return json.dumps([self.__class__.__name__.lower(), self._kwargs])

    def __repr__(self):
        return self.__class__.__name__


@register
class Zero(Initializer):
    def _init_weight(self, name, tensor, generator):
        tensor.zero_()


@register
class One(Initializer):
    def _init_weight(self, name, tensor, generator):
        tensor.fill_(1.0)


@register
class Constant(Initializer):
    def __init__(self, value=0.0):
        super().__init__(value=value)
        self.value = value

    def _init_weight(self, name, tensor, generator):
        tensor.fill_(self.value)


@register
class Uniform(Initializer):
    """U(-scale, scale) weights (ref: mx.init.Uniform, default 0.07)."""

    def __init__(self, scale=0.07):
        super().__init__(scale=scale)
        self.scale = scale

    def _init_weight(self, name, tensor, generator):
        _fill_random(tensor, lambda t: t.uniform_(-self.scale, self.scale,
                                                  generator=generator))


@register
class Normal(Initializer):
    """N(0, sigma²) weights."""

    def __init__(self, sigma=0.01):
        super().__init__(sigma=sigma)
        self.sigma = sigma

    def _init_weight(self, name, tensor, generator):
        _fill_random(tensor, lambda t: t.normal_(0.0, self.sigma,
                                                 generator=generator))


@register
class Orthogonal(Initializer):
    """scale × the orthonormal factor of the SVD of a random (out, in)
    matrix, uniform in [-1, 1) or normal; the SVD runs in f64 on the
    host."""

    def __init__(self, scale=1.414, rand_type="uniform"):
        super().__init__(scale=scale, rand_type=rand_type)
        self.scale = scale
        self.rand_type = rand_type

    def _init_weight(self, name, tensor, generator):
        nout = tensor.shape[0]
        nin = int(np.prod(tensor.shape[1:]))
        tmp = torch.empty((nout, nin), device=tensor.device,
                          dtype=torch.float32)
        if self.rand_type == "uniform":
            tmp.uniform_(-1.0, 1.0, generator=generator)
        else:
            tmp.normal_(0.0, 1.0, generator=generator)
        u, _, v = torch.linalg.svd(tmp.cpu().double(), full_matrices=False)
        q = u if u.shape == tmp.shape else v
        tensor.copy_((self.scale * q).reshape(tensor.shape))


@register
class Xavier(Initializer):
    """ref: initializer.py Xavier: uniform in ±sqrt(magnitude / factor)
    or normal with that deviation, factor the mean of the fans ('avg'),
    fan in ('in') or fan out ('out'), each fan times the kernel's
    spatial size."""

    def __init__(self, rnd_type="uniform", factor_type="avg", magnitude=3):
        super().__init__(rnd_type=rnd_type, factor_type=factor_type,
                         magnitude=magnitude)
        self.rnd_type = rnd_type
        self.factor_type = factor_type
        self.magnitude = float(magnitude)

    def scale(self, shape):
        """The bound (uniform) or deviation (gaussian) for `shape`."""
        if len(shape) < 2:
            raise MXNetError("Xavier requires ndim >= 2 (got %r)"
                             % (tuple(shape),))
        hw_scale = float(np.prod(shape[2:])) if len(shape) > 2 else 1.0
        fan_in = shape[1] * hw_scale
        fan_out = shape[0] * hw_scale
        factor = {"avg": (fan_in + fan_out) / 2.0,
                  "in": fan_in, "out": fan_out}[self.factor_type]
        return math.sqrt(self.magnitude / factor)

    def _init_weight(self, name, tensor, generator):
        scale = self.scale(tuple(tensor.shape))
        if self.rnd_type == "uniform":
            _fill_random(tensor, lambda t: t.uniform_(-scale, scale,
                                                      generator=generator))
        else:
            _fill_random(tensor, lambda t: t.normal_(0.0, scale,
                                                     generator=generator))


@register
class MSRAPrelu(Xavier):
    """Xavier gaussian with magnitude 2 / (1 + slope²)."""

    def __init__(self, factor_type="avg", slope=0.25):
        magnitude = 2.0 / (1 + slope ** 2)
        super().__init__("gaussian", factor_type, magnitude)
        self._kwargs = {"factor_type": factor_type, "slope": slope}


@register
class Bilinear(Initializer):
    """The bilinear upsampling kernel over the last two axes."""

    def _init_weight(self, name, tensor, generator):
        shape = tuple(tensor.shape)
        f = np.ceil(shape[3] / 2.0)
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        i = np.arange(int(np.prod(shape)))
        x = i % shape[3]
        y = (i // shape[3]) % shape[2]
        weight = ((1 - np.abs(x / f - c)) * (1 - np.abs(y / f - c))
                  ).astype(np.float32)
        _fill_host(tensor, weight.reshape(shape))


@register
class LSTMBias(Initializer):
    """Zeros, with the forget gate's quarter set to `forget_bias`."""

    def __init__(self, forget_bias=1.0):
        super().__init__(forget_bias=forget_bias)
        self.forget_bias = forget_bias

    def _init_weight(self, name, tensor, generator):
        num_hidden = tensor.shape[0] // 4
        tensor.zero_()
        tensor[num_hidden:2 * num_hidden] = self.forget_bias


class Mixed:
    """ref: initializer.Mixed: the initializer of the first pattern
    (a regular expression) that matches the parameter's name."""

    def __init__(self, patterns, initializers):
        self.map = list(zip([re.compile(p) for p in patterns], initializers))

    def __call__(self, name, tensor, generator=None):
        for prog, init in self.map:
            if prog.match(name):
                init(name, tensor, generator)
                return
        raise MXNetError("no initializer pattern matches %r" % name)
