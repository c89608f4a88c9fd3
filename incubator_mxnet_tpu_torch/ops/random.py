"""Random sampling operators of the PyTorch port (counterpart of
incubator_mxnet_tpu/ops/random.py; ref: src/operator/random/sample_op.*,
multisample_op.*, unique_sample_op.cc).

The JAX ops take an explicit threefry key (`_rng_key`) that the
package's stateful facade splits per call.  Here `_rng_key` is the
device's `torch.Generator` (`random.generator(device)`, seeded by
`mx.random.seed`), which `invoke` passes in; the samples land on the
generator's device.  Torch's generators give other numbers than JAX's
threefry from the same seed, so the ops are held to the JAX package by
the moments of their samples, not by the samples.
"""
from __future__ import annotations

import torch

from ..base import nd_dtype
from .registry import register


def _shape(shape):
    return (int(shape),) if isinstance(shape, int) else tuple(
        int(s) for s in shape)


def _draw(fn, shape, gen, dtype=torch.float32):
    return fn(_shape(shape), generator=gen, device=gen.device, dtype=dtype)


def _std_gamma(alpha, shape, gen):
    """Gamma(alpha, 1) samples of `shape` (alpha a number or a tensor that
    broadcasts to it), in f32."""
    a = torch.as_tensor(alpha, dtype=torch.float32, device=gen.device)
    return torch._standard_gamma(a.expand(_shape(shape)).contiguous(),
                                 generator=gen)


def _poisson(lam, gen):
    return torch.poisson(lam, generator=gen)


@register("_random_uniform", ndarray_inputs=(), differentiable=False,
          needs_rng=True)
def _random_uniform(low=0.0, high=1.0, shape=(), dtype="float32",
                    _rng_key=None):
    u = _draw(torch.rand, shape, _rng_key, nd_dtype(dtype))
    return u * (high - low) + low


@register("_random_normal", ndarray_inputs=(), differentiable=False,
          needs_rng=True)
def _random_normal(loc=0.0, scale=1.0, shape=(), dtype="float32",
                   _rng_key=None):
    return _draw(torch.randn, shape, _rng_key, nd_dtype(dtype)) * scale \
        + loc


@register("_random_gamma", ndarray_inputs=(), differentiable=False,
          needs_rng=True)
def _random_gamma(alpha=1.0, beta=1.0, shape=(), dtype="float32",
                  _rng_key=None):
    return (_std_gamma(alpha, shape, _rng_key) * beta).to(nd_dtype(dtype))


@register("_random_exponential", ndarray_inputs=(), differentiable=False,
          needs_rng=True)
def _random_exponential(lam=1.0, shape=(), dtype="float32", _rng_key=None):
    e = torch.empty(_shape(shape), dtype=torch.float32,
                    device=_rng_key.device).exponential_(generator=_rng_key)
    return (e / lam).to(nd_dtype(dtype))


@register("_random_poisson", ndarray_inputs=(), differentiable=False,
          needs_rng=True)
def _random_poisson(lam=1.0, shape=(), dtype="float32", _rng_key=None):
    rate = torch.full(_shape(shape), float(lam), device=_rng_key.device)
    return _poisson(rate, _rng_key).to(nd_dtype(dtype))


@register("_random_randint", ndarray_inputs=(), differentiable=False,
          needs_rng=True)
def _random_randint(low=0, high=1, shape=(), dtype="int32", _rng_key=None):
    return torch.randint(int(low), int(high), _shape(shape),
                         generator=_rng_key, device=_rng_key.device,
                         dtype=nd_dtype(dtype))


@register("_random_negative_binomial", ndarray_inputs=(),
          differentiable=False, needs_rng=True)
def _random_negative_binomial(k=1, p=1.0, shape=(), dtype="float32",
                              _rng_key=None):
    lam = _std_gamma(float(k), shape, _rng_key) * (1.0 - p) / p
    return _poisson(lam, _rng_key).to(nd_dtype(dtype))


@register("_random_generalized_negative_binomial", ndarray_inputs=(),
          differentiable=False, needs_rng=True)
def _random_generalized_negative_binomial(mu=1.0, alpha=1.0, shape=(),
                                          dtype="float32", _rng_key=None):
    if alpha == 0.0:
        lam = torch.full(_shape(shape), float(mu), device=_rng_key.device)
    else:
        lam = _std_gamma(1.0 / alpha, shape, _rng_key) * (mu * alpha)
    return _poisson(lam, _rng_key).to(nd_dtype(dtype))


# sample_* family: per-element distribution parameters (tensor inputs)


def _per_element(t, shape):
    return t.reshape(t.shape + (1,) * len(_shape(shape)))


@register("_sample_uniform", ndarray_inputs=("low", "high"),
          differentiable=False, needs_rng=True)
def _sample_uniform(low, high, shape=(), dtype="float32", _rng_key=None):
    u = _draw(torch.rand, tuple(low.shape) + _shape(shape), _rng_key,
              nd_dtype(dtype))
    lo = _per_element(low, shape)
    return lo + u * (_per_element(high, shape) - lo)


@register("_sample_normal", ndarray_inputs=("mu", "sigma"),
          differentiable=False, needs_rng=True)
def _sample_normal(mu, sigma, shape=(), dtype="float32", _rng_key=None):
    n = _draw(torch.randn, tuple(mu.shape) + _shape(shape), _rng_key,
              nd_dtype(dtype))
    return _per_element(mu, shape) + n * _per_element(sigma, shape)


@register("_sample_gamma", ndarray_inputs=("alpha", "beta"),
          differentiable=False, needs_rng=True)
def _sample_gamma(alpha, beta, shape=(), dtype="float32", _rng_key=None):
    s = tuple(alpha.shape) + _shape(shape)
    g = _std_gamma(_per_element(alpha, shape), s, _rng_key)
    return (g * _per_element(beta, shape)).to(nd_dtype(dtype))


@register("_sample_multinomial", ndarray_inputs=("data",),
          differentiable=False, needs_rng=True)
def _sample_multinomial(data, shape=(), get_prob=False, dtype="int32",
                        _rng_key=None):
    """Categorical draws from (batched) probability rows."""
    shape = _shape(shape)
    n = 1
    for s in shape:
        n *= s
    rows = data.reshape(-1, data.shape[-1]).float()
    draws = torch.multinomial(rows, n, replacement=True, generator=_rng_key)
    if data.ndim == 1:
        out = draws.reshape(shape) if shape else draws[0, 0]
    else:
        out = draws.reshape((data.shape[0],) + shape) if shape \
            else draws[:, 0]
    out = out.to(nd_dtype(dtype))
    if get_prob:
        logp = torch.log(torch.clamp_min(rows, 1e-30))
        lp = torch.gather(logp, -1, draws)
        return out, lp.reshape(out.shape)
    return out


@register("_shuffle", ndarray_inputs=("data",), differentiable=False,
          needs_rng=True)
def _shuffle(data, _rng_key=None):
    perm = torch.randperm(data.shape[0], generator=_rng_key,
                          device=_rng_key.device)
    return data.index_select(0, perm.to(data.device))


@register("_sample_unique_zipfian", ndarray_inputs=(), differentiable=False,
          needs_rng=True)
def _sample_unique_zipfian(range_max=1, shape=(), _rng_key=None):
    """Log-uniform (zipfian) candidates without replacement per leading
    row: p(k) proportional to log(1 + 1/(k + 1))."""
    shape = _shape(shape)
    n = shape[-1] if shape else 1
    lead = 1
    for s in shape[:-1]:
        lead *= s
    k = torch.arange(int(range_max), dtype=torch.float32,
                     device=_rng_key.device)
    p = torch.log1p(1.0 / (k + 1.0))
    rows = torch.multinomial(p.expand(lead, -1), n, replacement=False,
                             generator=_rng_key)
    return rows.reshape(shape).to(torch.int32)
