"""Readings that a cell's limits are set from, on the card, in one process.

    python3 portbench/calibrate.py --workload robot-nao.corr \\
        --seeds 11,12,13 --mode program [--set KEY=VALUE ...] [--out FILE]

For each seed one run of the cell with a window of one unit (one fit), and
its compared numbers: `--mode program` as the benchmark runs it (the lower
readings), `tf32` the program with TF32 matrix products (the control), or
`fault:<name>` with a fault of faults.py planted (the upper readings).
`--set` replaces a setting of the configuration (a JSON value), to read the
program as it runs at another setting, such as its own default.
Prints one JSON line a seed, and appends it to --out. The benchmark's own
runs never run this.
"""

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import faults  # noqa: E402
import run  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--mode", default="program")
    ap.add_argument("--set", action="append", default=[])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import contextlib

    import torch

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 3
    config_set = {k: json.loads(v) for k, v in
                  (kv.split("=", 1) for kv in args.set)}
    for seed in (int(s) for s in args.seeds.split(",")):
        ctx, precision = contextlib.nullcontext(), None
        if args.mode == "tf32":
            precision = "tf32"
        elif args.mode.startswith("fault:"):
            ctx = faults.planted(args.mode.split(":", 1)[1])
        elif args.mode != "program":
            raise ValueError(f"unknown mode {args.mode!r}")
        with ctx:
            res = run.run(args.workload, seed, 0.0, False,
                          program_precision=precision, config_set=config_set)
        line = json.dumps({"workload": args.workload, "mode": args.mode,
                           "set": config_set,
                           "seed": seed, "correct": res["correct"],
                           "metrics": res["metrics"],
                           "numbers": {k: v["value"] for k, v in
                                       res["checks"].items()}})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return 0


if __name__ == "__main__":
    sys.exit(main())
