"""Run one cell of the benchmark once, on the card, and print its result.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  The cell's set-up (its traffic and weights
from ``--seed``, the program's model and kernels, one warm pass of every
shape) is timed as ``setup_s``; then the window measures ``--seconds`` of
work with tracing off (``--trace 0``: the cell's end-to-end metrics), or a
profiled slice of the same work gives its per-layer metrics (``--trace
1``).  What the program produced is then held against the plain reference
in ``reference/``.  The last line of standard output is one JSON object
(``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, with
``--trace 1`` a ``breakdown``, and last the numbers compared beside their
limits, which also end standard error).  Without CUDA, with fewer cards
than the cell asks for, or with the JAX package or JAX loaded at the end,
it prints no result and exits with code 2.
"""

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path.insert(0, str(HERE))
sys.path.insert(1, str(ROOT))

# Build and kernel caches stay inside the checkout, at fixed paths.
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / "build" / "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton_cache"))

import harness  # noqa: E402


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None, device=None, tweak=None) -> int:
    args = parse(argv)
    try:
        result, checks = harness.run_cell(ROOT, args.workload, args.seed, args.seconds,
                                          bool(args.trace), STARTED, device=device, tweak=tweak)
        found = harness.forbidden_modules()
        if found:
            raise harness.RunFailed(f"loaded in this process: {', '.join(found)}")
    except harness.RunFailed as e:
        print(f"no result: {e}", file=sys.stderr)
        return 2
    for name, (value, limit) in checks.items():
        print(f"check {name}: {value!r} (limit {limit!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
