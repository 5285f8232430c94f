#!/usr/bin/env python3
"""Run one cell of the port's benchmark once, on the card:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Prints an information line (card, power limit, peak memory, the cell's
inputs) and then, last on standard output, the result as one JSON object;
the numbers that decided `correct` follow on standard error. Without a
CUDA card, or with fewer cards than the cell asks for, it exits with code
3 and prints no result. See README.md.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    from portbench import harness

    harness.set_cache_dirs()
    try:
        harness.run(args.workload, args.seed, args.seconds,
                    bool(args.trace), t_start=T_START)
    except harness.Refused as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
