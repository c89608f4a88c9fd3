"""Start N workers of a distributed job on this host (the dmlc `local`
tracker's role; counterpart of the repo's tools/launch.py):

    python -m incubator_mxnet_tpu_torch.tools.launch -n 2 -- \
        python train.py

Each worker gets DMLC_NUM_WORKER, DMLC_WORKER_ID, DMLC_ROLE=worker,
DMLC_PS_ROOT_URI and DMLC_PS_ROOT_PORT, from which
`base.ensure_distributed` (called by `kvstore.create("dist_*")` and by
anyone who wants the group) joins one `torch.distributed` process group;
worker 0 hosts its rendezvous store, so there are no server or scheduler
processes.  Every line a worker prints comes out prefixed with its rank
("[1] ...").  The first worker that fails kills the others, as does the
`timeout`; the exit code is the first failure's (124 for the timeout).
For several hosts, run it once per host with `--base-rank`,
`--total-workers` and `--coordinator` set to worker 0's address.
"""
from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys
import threading
import time


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _stream(proc, rank, out):
    for line in proc.stdout:
        out.write("[%d] %s" % (rank, line))
        out.flush()


def launch(num_workers, command, base_rank=0, total_workers=None,
           coordinator=None, timeout=None, env=None, out=sys.stdout):
    """Run `command` (an argument list) as `num_workers` workers; returns
    0 when all succeed, else the first nonzero exit code (124 when
    `timeout` seconds passed first).  `env` adds to each worker's
    environment."""
    coordinator = coordinator or "127.0.0.1:%d" % _free_port()
    uri, port = coordinator.rsplit(":", 1)
    total = total_workers or num_workers
    procs, threads = [], []
    try:
        for i in range(num_workers):
            rank = base_rank + i
            wenv = dict(os.environ)
            wenv.update(env or {})
            wenv.update({"DMLC_ROLE": "worker",
                         "DMLC_NUM_WORKER": str(total),
                         "DMLC_WORKER_ID": str(rank),
                         "DMLC_PS_ROOT_URI": uri,
                         "DMLC_PS_ROOT_PORT": port})
            p = subprocess.Popen(command, env=wenv, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)
            procs.append(p)
            t = threading.Thread(target=_stream, args=(p, rank, out),
                                 daemon=True)
            t.start()
            threads.append(t)
        deadline = None if timeout is None else time.time() + timeout
        rc = 0
        while True:
            codes = [p.poll() for p in procs]
            failed = [c for c in codes if c not in (None, 0)]
            if failed and rc == 0:
                rc = failed[0]
                for q in procs:
                    if q.poll() is None:
                        q.kill()
            if all(c is not None for c in codes):
                break
            if deadline is not None and time.time() > deadline:
                rc = rc or 124
                for q in procs:
                    if q.poll() is None:
                        q.kill()
                break
            time.sleep(0.1)
        for t in threads:
            t.join(timeout=5)
        return rc
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="launch N distributed workers on this host")
    ap.add_argument("-n", "--num-workers", type=int, required=True)
    ap.add_argument("--coordinator", default=None,
                    help="host:port of worker 0's rendezvous store "
                         "(default: a free localhost port)")
    ap.add_argument("--base-rank", type=int, default=0,
                    help="first rank on this host (several hosts)")
    ap.add_argument("--total-workers", type=int, default=None,
                    help="world size across all hosts (default: -n)")
    ap.add_argument("--timeout", type=float, default=None,
                    help="bound on the whole run, in seconds")
    ap.add_argument("command", nargs=argparse.REMAINDER,
                    help="worker command (after --)")
    args = ap.parse_args(argv)
    cmd = args.command[1:] if args.command[:1] == ["--"] else args.command
    if not cmd:
        ap.error("no worker command given")
    return launch(args.num_workers, cmd, base_rank=args.base_rank,
                  total_workers=args.total_workers,
                  coordinator=args.coordinator, timeout=args.timeout)


if __name__ == "__main__":
    sys.exit(main())
