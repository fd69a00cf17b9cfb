"""A/A runs of a cell on the card: one tree run as two sides, in turns, the
spread that a bound is set from.

    python3 portbench/aa.py --workload robot-nao.corr \\
        --side A=<checkout> --side B=<checkout> \\
        --seeds 4294967311,4294967357,... --seconds 51 --out aa.json

Each side is a checkout of the tree (`git archive` unpacked; the same tree
twice for A/A), with a HOME, XDG_CACHE_HOME and TMPDIR of its own beside
it. A side's first run builds its kernels and is kept apart (`first`).
Then pair i runs seed i on both sides, A first in even pairs and B first
in odd ones; each run is `portbench/run.py --trace 0` of that checkout, in
a process of its own. A run records its rate, its set-up, each unit's
seconds (from the `window:` line), `correct` and the process's CPU
seconds beside its wall seconds. The file is written again after every
run. Last it prints the split of the spread and the bound that
`yardstick.bounds` gives. The benchmark's own runs never run this.
"""

import argparse
import json
import os
import resource
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import run  # noqa: E402
from yardstick import bounds  # noqa: E402

# a run's whole allowance: set-up, the window and the reference's check
RUN_TIMEOUT_S = 600


def one_run(checkout: str, workload: str, seed: int, seconds: float) -> dict:
    env_root = os.path.abspath(checkout) + ".env"
    env = dict(os.environ)
    for key, sub in (("HOME", "home"), ("XDG_CACHE_HOME", "cache"),
                     ("TMPDIR", "tmp")):
        env[key] = os.path.join(env_root, sub)
        os.makedirs(env[key], exist_ok=True)
    cmd = [sys.executable, "portbench/run.py", "--workload", workload,
           "--seed", str(seed), "--seconds", str(seconds), "--trace", "0"]
    ru0 = resource.getrusage(resource.RUSAGE_CHILDREN)
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=checkout, env=env, capture_output=True,
                          text=True, timeout=RUN_TIMEOUT_S)
    wall = time.perf_counter() - t0
    ru1 = resource.getrusage(resource.RUSAGE_CHILDREN)
    out = {"seed": seed, "rc": proc.returncode, "wall_s": wall,
           "process_cpu_s": (ru1.ru_utime - ru0.ru_utime)
           + (ru1.ru_stime - ru0.ru_stime)}
    for line in proc.stderr.splitlines():
        if line.startswith("window: "):
            ends = json.loads(line.split("each ending at ", 1)[1]
                              .rsplit(" s", 1)[0])
            out["ends_s"] = ends
            out["unit_s"] = [round(u, 3) for u in bounds.unit_seconds(ends)]
    try:
        res = json.loads(proc.stdout.strip().splitlines()[-1])
    except (IndexError, json.JSONDecodeError):
        out["stderr_tail"] = proc.stderr[-3000:]
        return out
    metrics = {k: v["value"] for k, v in res["metrics"].items()}
    out.update(metrics=metrics, correct=res["correct"],
               attempted=res["attempted"], checks=res["checks"],
               memory_peak_bytes=res["device"]["memory_peak_bytes"],
               kind=res["device"]["kind"])
    return out


def summary(record: dict, metric: str) -> dict:
    sides = list(record["sides"])
    sets = [[r["metrics"][metric] for r in record["sides"][s]
             if r.get("correct")] for s in sides]
    out = {"sides": sides, "median": [statistics.median(v) for v in sets],
           "quartile_spread": [bounds.quartile_spread(v) for v in sets],
           "range_all": bounds.relative_range(sets[0] + sets[1]),
           "bound": bounds.bound_from_sets(*sets[:2])}
    runs = [r for s in sides for r in record["sides"][s] if r.get("unit_s")]
    out["split"] = bounds.spread_split(runs)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--side", action="append", required=True,
                    help="NAME=CHECKOUT, twice")
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--commit", default=None)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    sides = dict(s.split("=", 1) for s in args.side)
    if len(sides) != 2:
        raise SystemExit("aa: give two sides")
    names = list(sides)
    seeds = [int(s) for s in args.seeds.split(",")]
    # the cell's end-to-end metric besides its set-up
    metric = next(m["name"] for m in run.Cell(HERE, args.workload).end_to_end
                  if m["name"] != "setup_s")
    record = {"workload": args.workload, "commit": args.commit,
              "card": run.card_line(), "run_seconds": args.seconds,
              "metric": metric, "order": [], "first": {},
              "sides": {n: [] for n in names}}

    def save():
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)

    for n in names:
        r = one_run(sides[n], args.workload, 1, 1.0)
        record["first"][n] = r
        print(f"first {n}: rc {r['rc']} setup "
              f"{r.get('metrics', {}).get('setup_s')}", flush=True)
        save()
    for i, seed in enumerate(seeds):
        for n in (names if i % 2 == 0 else names[::-1]):
            r = one_run(sides[n], args.workload, seed, args.seconds)
            record["sides"][n].append(r)
            record["order"].append([n, seed])
            print(f"{n} seed {seed}: rc {r['rc']} correct "
                  f"{r.get('correct')} {metric} "
                  f"{r.get('metrics', {}).get(metric)} setup "
                  f"{r.get('metrics', {}).get('setup_s')} units "
                  f"{r.get('unit_s')}", flush=True)
            save()
    record["card_after"] = run.card_line()
    try:
        record["summary"] = summary(record, metric)
    except (statistics.StatisticsError, ValueError) as e:
        record["summary"] = f"no summary: {e}"
    save()
    print(json.dumps(record["summary"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
