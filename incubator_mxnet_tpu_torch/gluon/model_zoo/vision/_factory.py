"""What every model-zoo factory of the PyTorch port does with its
`pretrained`, `ctx` and `root` arguments (ref: model_zoo.vision's
`get_*` functions)."""
from __future__ import annotations

from ....base import MXNetError


def check_pretrained(pretrained):
    """There are no downloadable weights: `pretrained=True` raises."""
    if pretrained:
        raise MXNetError("pretrained weights unavailable (no egress); "
                         "load_parameters from a local file instead")


def build(cls, *args, pretrained=False, ctx=None, root=None, **kwargs):
    """`cls(*args, **kwargs)` with random weights, initialized on `ctx`
    when one is given (else by the caller's `initialize`)."""
    check_pretrained(pretrained)
    net = cls(*args, **kwargs)
    if ctx is not None:
        net.initialize(ctx=ctx)
    return net
