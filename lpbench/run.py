"""Run one cell of the benchmark of ``ipx_torch`` once.

    python3 lpbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Sets up (imports, the port's CUDA kernels
loaded, or built with nvcc into ``build/ipx_torch/`` on a first run, a
warm-up), calls the cell's entry back to back for ``--seconds``, judges
every answer against the plain reference, and prints one JSON object as
the last line of standard output: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``: each number compared beside its limit, which are also the last
lines of standard error.  Exits non-zero with no result without a card,
without the program, or with a JAX module loaded.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path[0] = str(ROOT)     # the checkout's root, not this directory

from lpbench import harness  # noqa: E402


def _plain(v):
    """Non-finite floats as strings: the line stays JSON."""
    if isinstance(v, float) and not math.isfinite(v):
        return str(v)
    if isinstance(v, dict):
        return {k: _plain(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_plain(x) for x in v]
    return v


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        res = harness.run(args.workload, args.seed, args.seconds,
                          bool(args.trace), t_start=T_START)
    except harness.Refused as e:
        print(f"lpbench: {e}", file=sys.stderr)
        return e.code
    for name, c in res["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(_plain(res)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
