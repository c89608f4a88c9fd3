"""Whether the in-process replica group's collective across cards can be
captured: `torch.cuda.nccl.all_reduce` over one tensor a card, one CUDA
graph a card captured on that card's stream at once, then the graphs
replayed and the sums checked.

    python3 tools/nccl_capture_probe.py

Prints one JSON line: the cards, whether each stage worked, and the
error where one failed.  Needs two cards or more; imports nothing of
the JAX package.
"""
import contextlib
import json
import sys


def main():
    import torch
    n = torch.cuda.device_count()
    out = {"probe": "nccl_capture", "cards": n}
    if n < 2:
        out["run"] = False
        print(json.dumps(out))
        return 0
    ts = [torch.full((1 << 20,), float(i + 1), device="cuda:%d" % i)
          for i in range(n)]
    torch.cuda.nccl.all_reduce(ts)          # the communicator, eagerly
    torch.cuda.synchronize()
    for i, t in enumerate(ts):
        t.fill_(float(i + 1))
    streams = [torch.cuda.Stream(device=i) for i in range(n)]
    graphs = [torch.cuda.CUDAGraph() for _ in range(n)]
    stage = "capture"
    try:
        with contextlib.ExitStack() as stack:
            for i in range(n):
                stack.enter_context(torch.cuda.device(i))
                stack.enter_context(torch.cuda.graph(
                    graphs[i], stream=streams[i],
                    capture_error_mode="relaxed"))
            torch.cuda.nccl.all_reduce(ts, streams=streams)
        stage = "replay"
        for g in graphs:
            g.replay()
        torch.cuda.synchronize()
        want = float(n * (n + 1) // 2)
        out["sums_right"] = all(bool((t == want).all()) for t in ts)
        out["captured"] = True
    except Exception as exc:     # noqa: BLE001 — the probe reports it
        out.update(captured=False, stage=stage,
                   error="%s: %s" % (type(exc).__name__, str(exc)[:400]))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
