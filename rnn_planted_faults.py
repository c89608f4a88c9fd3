#!/usr/bin/env python3
"""Planted faults through chip_smoke.py's recurrent checks, on one card:

    python3 rnn_planted_faults.py

1. `train_gnmt`'s parity (`chip_smoke._gnmt_parity`, the f32 batch-2
   gnmt_large step against its CPU copy under the spread rule) with the
   LSTM's input and forget gates swapped in the card's step only
   (`ops.rnn._lstm_cell` on CUDA tensors);
2. `generate_seq2seq` with `ops.rnn.rnn_varlen` running without its
   per-row freeze, so that a padded prompt encodes its pad tail.

Each must fail its check.  Prints one JSON line per fault (the check's
message and, for the parity, its numbers) and exits 1 if a planted fault
passed.  It imports nothing of the JAX package.
"""
import json
import os
import sys


def main():
    import torch
    if not torch.cuda.is_available():
        print("rnn_planted_faults: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import chip_smoke
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch.ops import attention as att
    from incubator_mxnet_tpu_torch.ops import conv_stats as cs
    from incubator_mxnet_tpu_torch.ops import rnn as ops_rnn

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell, varlen = ops_rnn._lstm_cell, ops_rnn.rnn_varlen

    def gates_swapped(gates, c):
        if gates.device.type != "cuda":
            return cell(gates, c)
        h = c.shape[-1]
        return cell(torch.cat([gates[:, h:2 * h], gates[:, :h],
                               gates[:, 2 * h:]], dim=-1), c)

    def unfrozen(data, parameters, state, state_cell=None,
                 sequence_length=None, **kw):
        return ops_rnn.rnn(data, parameters, state, state_cell, **kw)

    ops_rnn._lstm_cell = gates_swapped
    try:
        parity = chip_smoke._gnmt_parity(torch, mx)
    finally:
        ops_rnn._lstm_cell = cell
    caught = [_caught("gate_order", lambda: chip_smoke._spread_checks(
        "planted_gate_order", parity), parity=parity)]
    ops_rnn.rnn_varlen = unfrozen
    try:
        caught.append(_caught("no_varlen_freeze", lambda: (
            chip_smoke.phase_generate_seq2seq(torch, mx, att, cs))))
    finally:
        ops_rnn.rnn_varlen = varlen
    return 0 if all(caught) else 1


def _caught(name, check, **row):
    """Run the check `check`; print and return whether it failed, as it
    must with the fault `name` planted."""
    try:
        check()
        row.update(failed=False)
    except RuntimeError as exc:
        row.update(failed=True, msg=str(exc)[:400])
    print(json.dumps(dict(planted=name, **row)), flush=True)
    return row["failed"]


if __name__ == "__main__":
    sys.exit(main())
