"""Run one cell of the port's benchmark once and print its result line.

    python3 bench_port/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Needs as many CUDA cards as the cell asks for; without them it exits with
code 2 and prints no result.
"""

import time

T0 = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    try:
        import torch

        from bench_port import harness
        _, cell, _, _, _ = harness.load_cell(args.workload)
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < cell["chips"]:
            print(f"bench_port: {args.workload} needs {cell['chips']} CUDA "
                  f"card(s); torch.cuda.is_available() is "
                  f"{torch.cuda.is_available()}", file=sys.stderr)
            return 2
        result, lines = harness.run(args.workload, args.seed, args.seconds,
                                    bool(args.trace), "cuda", T0)
    except Exception:
        traceback.print_exc()
        return 1
    found = harness.banned_modules()
    if found:
        print(f"bench_port: the run loaded {found}", file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
