"""Run chosen phases of chip_smoke.py on the card, without the rest.

    python3 tools/chip_phases.py kernel_nms train_ssd train_rcnn

starts as chip_smoke.py does (`chip_smoke.setup`: the same settings and
the build of every kernel), then calls each `chip_smoke.phase_<name>` in
the order given, handing it the arguments its signature names (`torch`,
`mx`, `att`, `cs`).  Each phase prints its own JSON line and fails as it
does inside chip_smoke.py.  It imports nothing of the JAX package.
"""
import inspect
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402


def main(names):
    import torch
    if not torch.cuda.is_available():
        print("chip_phases: no CUDA device", file=sys.stderr)
        return 1
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch.ops import attention as att
    from incubator_mxnet_tpu_torch.ops import conv_stats as cs
    chip_smoke.setup(torch)
    given = dict(torch=torch, mx=mx, att=att, cs=cs)
    for name in names:
        fn = getattr(chip_smoke, "phase_" + name)
        fn(*(given[p] for p in inspect.signature(fn).parameters))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
