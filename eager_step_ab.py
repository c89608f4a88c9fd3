#!/usr/bin/env python3
"""Eager bf16 BERT-base training step (chip_smoke's train_bf16 config:
batch 16 x 512, Adam lr 1e-4, dropout 0) of two source trees in turns,
on one card, to tell a change's effect on the eager host path from the
card's and host's noise:

    python3 eager_step_ab.py PARENT_TREE CHANGE_TREE

runs parent, change, change, parent, each in a fresh process that
builds the tree's kernels, takes 3 warm-up steps and prints the median
and least of 10 steps' ms (host clock around a synchronized step).
"""
import os
import statistics
import subprocess
import sys
import time


def _measure(name):
    import numpy as np
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch.ops import _kernels
    _kernels.build_all()
    rs = np.random.RandomState(0)
    x = torch.from_numpy(rs.randint(0, 30522, (16, 512)).astype(np.int32))
    y = torch.from_numpy(rs.randint(0, 30522, (16, 512)).astype(np.float32))
    x, y = x.cuda(), y.cuda()
    mx.random.seed(0)
    net = mx.models.bert_base(dropout=0.0, output_hidden=True,
                              device="cuda:0").cast("bfloat16")
    head = mx.models.FusedMLMCELoss(30522, 768, device="cuda:0") \
        .cast("bfloat16")
    params = dict(net.collect_params())
    params.update({"l." + k: v for k, v in head.collect_params().items()})
    trainer = mx.gluon.Trainer(params, "adam", {"learning_rate": 1e-4})

    def step():
        with mx.autograd.record():
            loss = head(net(x), y)
        mx.autograd.backward(loss)
        trainer.step(16)

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    ms = []
    for _ in range(10):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    print("%s eager bf16 step ms median %.2f min %.2f"
          % (name, statistics.median(ms), min(ms)), flush=True)


def main():
    if len(sys.argv) == 2:
        _measure(sys.argv[1])
        return 0
    parent, change = (os.path.abspath(p) for p in sys.argv[1:3])
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    for name, tree in (("parent", parent), ("change", change),
                       ("change", change), ("parent", parent)):
        env = dict(os.environ, PYTHONPATH=tree)
        rc = subprocess.call([sys.executable, os.path.abspath(__file__),
                              name], env=env, cwd=tree)
        if rc:
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())
