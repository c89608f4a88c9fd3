"""Where a run of chip_smoke.py spends its time, phase by phase.

    python3 tools/phase_times.py [CHECKOUT]

imports chip_smoke.py and the port from CHECKOUT (a directory holding a
checkout of this repo; by default this one), wraps each module-level
function that its `main()` calls by name (`setup`, every `phase_*`,
`_serving_retired`, ...) so that each call made from `main()` itself is
timed on the host's clock (a phase that another phase calls counts in
its caller), and runs `main()`.  After main's own lines it prints one
JSON line: {"phase_seconds": {name: s}, "main_s": s, "other_s": s,
"rc": main's return}.  Two checkouts compare in one call on one card:

    python3 tools/phase_times.py build/parent
    python3 tools/phase_times.py

It imports nothing of the JAX package.
"""
import collections
import json
import os
import sys
import time


def main(checkout):
    checkout = os.path.abspath(checkout)
    sys.path.insert(0, checkout)
    os.chdir(checkout)
    import chip_smoke
    seconds = collections.Counter()
    depth = [0]

    def timed(name, fn):
        def call(*args, **kwargs):
            depth[0] += 1
            t0 = time.monotonic()
            try:
                return fn(*args, **kwargs)
            finally:
                depth[0] -= 1
                if depth[0] == 0:
                    seconds[name] += time.monotonic() - t0
        return call

    for name in chip_smoke.main.__code__.co_names:
        fn = getattr(chip_smoke, name, None)
        if callable(fn) and getattr(fn, "__module__", None) == "chip_smoke" \
                and name != "main":
            setattr(chip_smoke, name, timed(name, fn))
    t0 = time.monotonic()
    rc = chip_smoke.main()
    main_s = time.monotonic() - t0
    print(json.dumps(dict(phase_seconds=dict(seconds), main_s=main_s,
                          other_s=main_s - sum(seconds.values()), rc=rc)),
          flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1] if len(sys.argv) > 1 else os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
