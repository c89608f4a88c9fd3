"""Automatic mixed precision of the PyTorch port (counterpart of
incubator_mxnet_tpu/contrib/amp/__init__.py; ref: python/mxnet/contrib/
amp/amp.py).

`init` makes the ops of `lists.TARGET_DTYPE_OPS` cast their float32
inputs to the target dtype and the ops of `lists.FP32_OPS` cast their
bfloat16 and float16 inputs to float32, as the JAX `init` does by
wrapping the op registry's functions.  Two places are wrapped:

* the Gluon layers call `ops.nn`'s functions through the module
  attribute (`ops.fully_connected(...)` after `from ...ops import nn as
  ops`), so `_PORT_OPS` maps a reference op name to the port functions
  that implement it (a Convolution is `convolution` and the fused
  pointwise product with BatchNorm statistics, `conv1x1_bn_stats`) and
  `init` rebinds those attributes to cast-wrapped versions.  The
  registry entries of these ops look their function up in `ops.nn` when
  they run, so the rebinding covers `mx.nd.FullyConnected` too;
* every other listed op that the registry holds (`dot`, `batch_dot`,
  `exp`, `log`, `sum`, `mean`, `norm`, ...) has its registry entry's
  function wrapped, so `mx.nd.dot` and `NDArray.exp` cast.

`turn_off` restores both.  Names the port lacks are skipped, as the JAX
`_try_get` returns None for them.

Default target is bfloat16 (float32's exponent range, so no loss
scaling); float16 pairs with the dynamic `LossScaler`.
"""
from __future__ import annotations

import functools
from contextlib import contextmanager

import torch

from . import lists
from .loss_scaler import LossScaler
from ...base import torch_dtype
from ...ops import nn as _nn
from ...ops import registry as _registry

__all__ = ["init", "init_trainer", "scale_loss", "unscale",
           "convert_hybrid_block", "convert_model", "convert_symbol",
           "LossScaler", "lists", "current_target", "normalize_dtype",
           "turn_off"]

#: reference op name -> the (module, attribute) pairs of the port
#: functions that implement it
_PORT_OPS = {
    "FullyConnected": ((_nn, "fully_connected"),),
    "Convolution": ((_nn, "convolution"), (_nn, "conv1x1_bn_stats")),
    "BatchNorm": ((_nn, "batch_norm"),),
    "LayerNorm": ((_nn, "layer_norm"),),
    "softmax": ((_nn, "softmax"),),
    "log_softmax": ((_nn, "log_softmax"),),
}

_LOW_FLOATS = (torch.bfloat16, torch.float16)

# target name; (module or OpDef, attribute) -> original function
_CURRENT = {"target": None, "orig": {}}


def _wrap_cast(fn, to_dtype, from_dtypes):
    """`fn` with its positional tensor arguments of `from_dtypes` cast to
    `to_dtype` (keyword arguments pass as they are, as in the JAX wrap)."""
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        args = tuple(a.to(to_dtype) if isinstance(a, torch.Tensor)
                     and a.dtype in from_dtypes else a for a in args)
        return fn(*args, **kwargs)
    return wrapped


def init(target_dtype="bfloat16", target_precision_ops=None,
         conditional_fp32_ops=None, fp32_ops=None):
    """Turn AMP on process-wide (ref: amp.init()).

    target_precision_ops / fp32_ops extend (not replace) the built-in
    lists; conditional_fp32_ops is folded into fp32_ops, as in the JAX
    package (no per-attribute conditions)."""
    target = torch_dtype(target_dtype)
    name = str(target).replace("torch.", "")
    if _CURRENT["target"] is not None:
        if _CURRENT["target"] == name:
            return
        _restore()
    target_list = list(lists.TARGET_DTYPE_OPS) + list(
        target_precision_ops or [])
    f32_list = list(lists.FP32_OPS) + list(fp32_ops or [])
    for cond in (conditional_fp32_ops or []):
        f32_list.append(cond[0] if isinstance(cond, (tuple, list)) else cond)
    policy = {}
    for op in target_list:
        policy.setdefault(op, (target, (torch.float32,)))
    for op in f32_list:
        policy.setdefault(op, (torch.float32, _LOW_FLOATS))
    for op, (to_dtype, from_dtypes) in policy.items():
        if op in _PORT_OPS:
            for mod, attr in _PORT_OPS[op]:
                fn = getattr(mod, attr)
                _CURRENT["orig"][mod, attr] = fn
                setattr(mod, attr, _wrap_cast(fn, to_dtype, from_dtypes))
            continue
        od = _registry._REGISTRY.get(op)
        if od is None or (od, "fn") in _CURRENT["orig"]:
            continue
        _CURRENT["orig"][od, "fn"] = od.fn
        od.fn = _wrap_cast(od.fn, to_dtype, from_dtypes)
    _CURRENT["target"] = name


def current_target():
    """The active AMP target dtype name ('bfloat16'/'float16'), or None
    when AMP is off."""
    return _CURRENT["target"]


_DTYPE_ALIASES = {"bf16": "bfloat16", "fp16": "float16",
                  "half": "float16"}


def normalize_dtype(amp):
    """Canonical AMP target for trainer ``amp=`` / MXNET_AMP_DTYPE
    values: 'bfloat16' | 'float16' | None (off).  Accepts the common
    aliases (bf16/fp16/half) and the off spellings (''/0/off/none/
    float32/fp32); anything else raises."""
    if amp in (None, False, 0):
        return None
    s = str(amp).strip().lower()
    if s in ("", "0", "off", "none", "float32", "fp32"):
        return None
    s = _DTYPE_ALIASES.get(s, s)
    if s not in ("bfloat16", "float16"):
        raise ValueError(
            "unsupported AMP dtype %r (use 'bfloat16' or 'float16')"
            % (amp,))
    return s


def _restore():
    for (mod, attr), fn in _CURRENT["orig"].items():
        setattr(mod, attr, fn)
    _CURRENT["orig"].clear()
    _CURRENT["target"] = None


def turn_off():
    """Undo init() (the reference has no public off switch, but a
    process-wide rebinding needs one)."""
    _restore()


def init_trainer(trainer, loss_scaler=None):
    """Attach a dynamic loss scaler to a gluon Trainer (ref:
    amp.init_trainer); scale 1 for a bfloat16 target."""
    if loss_scaler is None:
        needs_scaling = _CURRENT["target"] == "float16"
        loss_scaler = LossScaler(init_scale=2.0 ** 16 if needs_scaling
                                 else 1.0)
    trainer._amp_loss_scaler = loss_scaler
    # the configured rescale_grad composes with the loss scale: the step
    # sees original / loss_scale
    trainer._amp_original_scale = trainer._scale
    return trainer


def _live_grads(trainer):
    return [_grad_leaf(p.grad) for p in trainer._params
            if p.requires_grad and p.grad is not None]


def _grad_leaf(g):
    """The dense tensor holding a gradient's values: for a row_sparse one
    (torch's COO gradient of an `Embedding(sparse_grad=True)`) its values,
    which the checks read and the zeroing and unscaling write in place."""
    return g._values() if g.is_sparse else g


@contextmanager
def scale_loss(loss, trainer):
    """``with amp.scale_loss(loss, trainer) as l: autograd.backward(l)``:
    multiplies the loss by the current scale and sets the trainer's
    rescale so that `trainer.step()` unscales the gradients; on exit
    checks the gradients for overflow, zeroing them (the step then
    updates with zero gradients) and backing the scale off when one is
    found."""
    scaler = getattr(trainer, "_amp_loss_scaler", None)
    if scaler is None:
        scaler = init_trainer(trainer)._amp_loss_scaler
    scale = scaler.loss_scale
    trainer._scale = trainer._amp_original_scale / scale
    if isinstance(loss, (list, tuple)):
        yield [l * scale for l in loss]
    else:
        yield loss * scale
    if scale == 1.0:
        return
    grads = _live_grads(trainer)
    # one device flag over every gradient, one host read
    overflow = bool(grads) and not bool(torch.stack(
        [torch.isfinite(g).all() for g in grads]).all())
    if overflow:
        for g in grads:
            g.zero_()
    scaler.update(overflow)


def unscale(trainer):
    """Divide the current gradients by the loss scale, for callers that
    read or clip them between backward and step (ref: amp.unscale)."""
    scaler = getattr(trainer, "_amp_loss_scaler", None)
    if scaler is None or scaler.loss_scale == 1.0:
        return
    for g in _live_grads(trainer):
        g.div_(scaler.loss_scale)
    trainer._scale = getattr(trainer, "_amp_original_scale", 1.0)


_KEEP_F32_FRAGMENTS = ("gamma", "beta", "moving_mean", "moving_var",
                       "running_mean", "running_var", "mean", "var")


def convert_hybrid_block(block, target_dtype="bfloat16"):
    """Cast a block's parameters to the target dtype, keeping the
    normalisation statistics and affines in float32 (ref:
    amp.convert_hybrid_block; pair with `init()` so that activations are
    cast at the listed ops)."""
    from ...gluon.block import cast_parameter
    dt = torch_dtype(target_dtype)
    for name, param in block.collect_params().items():
        if not any(f in name for f in _KEEP_F32_FRAGMENTS):
            cast_parameter(param, dt)
    return block


def convert_symbol(sym, target_dtype="bfloat16", target_dtype_ops=None,
                   fp32_ops=None, widest_dtype_ops=None,
                   excluded_sym_names=(), data_names=("data",)):
    """The symbol graph pass: the port has no symbol API yet."""
    raise NotImplementedError("amp.convert_symbol is not yet ported (the "
                              "symbol API is not ported)")


def convert_model(sym, arg_params, aux_params, target_dtype="bfloat16",
                  target_dtype_ops=None, fp32_ops=None,
                  excluded_sym_names=(), cast_optional_params=False):
    """Symbolic-API conversion (ref: amp.convert_model), params-only form
    (`sym=None`): the arg params (torch tensors) cast to the target dtype
    but the normalisation statistics and affines; aux params unchanged.
    A symbol raises "not yet ported"."""
    if sym is not None:
        raise NotImplementedError("amp.convert_model with a symbol is not "
                                  "yet ported (the symbol API is not "
                                  "ported); pass sym=None")
    dt = torch_dtype(target_dtype)
    new_args = {k: v if any(f in k for f in _KEEP_F32_FRAGMENTS)
                else v.to(dt) for k, v in arg_params.items()}
    return None, new_args, dict(aux_params)
