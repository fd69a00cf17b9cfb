"""Runs one cell of the benchmark of reart_tpu_torch once.

    python3 portbench/run.py --workload robot-nao.corr --seed 7 \\
        --seconds 30 --trace 0

from the root of a checkout. One process: set-up (the kernels built on
first use into reart_tpu_torch/_build/, the inputs and weights made from
the seed, a warm-up on the cell's own shapes), then the measured window,
then, with --trace 1, a short profiled segment, and last the comparison
with the plain reference that decides `correct`. The last line of standard
output is one JSON object: correct, attempted, failed, metrics (the cell's
end-to-end metrics, or with --trace 1 its per-layer ones), device, with
--trace 1 a breakdown, and last the numbers compared, each beside its
limit; the same numbers are the last lines of standard error.

Everything is found by name: workloads/<cell>.json names the cell's
configuration (configs/<name>.json), its traffic (traffic/<mix>.json,
whose `driver` names drivers/<driver>.py) and its limits; the cell's
metrics are BENCHMARK.json's, and each per-layer metric is read by
metrics/<metric>.py. A run needs a CUDA device and exits non-zero without
one; nothing here imports JAX or the JAX package.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# the harness's folder first (the root has a run.py of its own), then the
# root, where the program is
sys.path[:] = [HERE, ROOT] + [p for p in sys.path if p not in (HERE, ROOT)]

FORBIDDEN = ("jax", "jaxlib", "flax", "reart_tpu")


class Cell:
    """A cell's files, read by name from a benchmark directory."""

    def __init__(self, bench_dir: str, name: str):
        self.name, self.dir = name, bench_dir
        self.workload = _load_json(bench_dir, "workloads", name)
        self.config = _load_json(bench_dir, "configs",
                                 self.workload["config"])
        self.traffic = _load_json(bench_dir, "traffic",
                                  self.workload["traffic"])
        with open(os.path.join(os.path.dirname(bench_dir),
                               "BENCHMARK.json")) as f:
            manifest = json.load(f)
        entry = [w for w in manifest["workloads"] if w["name"] == name]
        if len(entry) != 1:
            raise ValueError(f"BENCHMARK.json has no workload {name!r}")
        self.chips = entry[0]["chips"]

        def mine(metrics):
            return [m for m in metrics
                    if name in m.get("workloads", [name])]

        self.end_to_end = mine(manifest["end_to_end"])
        self.per_layer = mine(manifest["per_layer"])

    def module(self, kind: str, name: str):
        return _load_module(os.path.join(self.dir, kind, f"{name}.py"),
                            f"portbench_{kind}_{name}")


def _load_json(bench_dir, kind, name):
    with open(os.path.join(bench_dir, kind, f"{name}.json")) as f:
        return json.load(f)


def _load_module(path, modname):
    spec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, jaxlib's, flax's or
    the JAX package's, compared whole."""
    return sorted({m for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


def _num(x):
    return x if isinstance(x, (int, float)) and math.isfinite(x) else str(x)


def run(workload: str, seed: int, seconds: float, trace: bool,
        device=None, bench_dir: str = HERE, t0: float = T0,
        program_precision=None, config_set: dict | None = None) -> dict:
    """One run of a cell -> the result line's object. `device` None is the
    card (a run of the benchmark); tests pass "cpu". `program_precision`
    runs the program's side, from set-up through the window, below the
    configuration's precision, for the control: "tf32" (TF32 matrix
    products on the card) or "bfloat16" (autocast, the CPU's stand-in);
    the benchmark's own runs never pass it, nor `config_set`, settings
    that replace the configuration's (for the limits' readings)."""
    import torch

    cell = Cell(bench_dir, workload)
    cell.config.update(config_set or {})
    dev = torch.device("cuda" if device is None else device)
    driver = cell.module("drivers", cell.traffic["driver"]).driver(
        cell, seed, dev)
    try:
        return _run(cell, driver, dev, seconds, trace, t0, program_precision)
    finally:
        driver.close()


def _run(cell, driver, dev, seconds, trace, t0, program_precision):
    import contextlib

    import torch

    import reart_tpu_torch  # noqa: F401  (sets the precision it states)

    cuda = dev.type == "cuda"
    lowered = contextlib.nullcontext()
    if program_precision == "tf32":
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
    elif program_precision == "bfloat16":
        lowered = torch.autocast(dev.type, dtype=torch.bfloat16)
    elif program_precision is not None:
        raise ValueError(f"unknown program_precision {program_precision!r}")
    with lowered:
        print(f"setup: process start to set-up {time.perf_counter() - t0:.2f}"
              f" s", file=sys.stderr)
        for stage, took in driver.setup().items():
            print(f"setup: {stage} {took:.2f} s", file=sys.stderr)
        setup_s = time.perf_counter() - t0
        window = driver.window(seconds)
    print(f"window: {window['units']} units in {window['seconds']:.3f} s, "
          f"each ending at {[round(e, 3) for e in window['ends']]} s",
          file=sys.stderr)
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    device_info = {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
        "count": cell.chips, "memory_peak_bytes": int(peak)}
    result = {"correct": False, "attempted": window["units"],
              "failed": window.get("failed", 0)}
    if trace:
        from yardstick.trace import traced

        work, state = driver.traced_work()
        tr = traced(work, cuda)
        ctx = {"cell": cell, "window": window, "trace": tr,
               "traced": state, "device": device_info}
        metrics = {}
        for m in cell.per_layer:
            value = cell.module("metrics", m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device_info.update(busy_s=tr.busy_s, window_s=tr.window_s)
        result["breakdown"] = tr.breakdown()
    else:
        values = dict(window["end_to_end"], setup_s=setup_s)
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    result["metrics"] = metrics
    result["device"] = device_info
    bad = forbidden_modules()
    if bad:
        raise RuntimeError(f"modules of JAX or the JAX package are loaded: "
                           f"{', '.join(bad)}")
    from yardstick.compare import judge

    t_check = time.perf_counter()
    numbers = driver.check_numbers()
    print(f"check: the reference took {time.perf_counter() - t_check:.2f} s",
          file=sys.stderr)
    correct, checks = judge(numbers, cell.workload["limits"])
    result["correct"] = correct
    result["checks"] = {k: {"value": _num(v["value"]),
                            "limit": _num(v["limit"])}
                        for k, v in checks.items()}
    return result


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        out = f"nvidia-smi not read ({e})"
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", required=True, type=int)
    ap.add_argument("--seconds", required=True, type=float)
    ap.add_argument("--trace", default=0, type=int, choices=[0, 1])
    args = ap.parse_args(argv)

    import torch

    cell = Cell(HERE, args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"portbench: the cell needs {cell.chips} CUDA device(s); "
              f"torch.cuda.is_available() is "
              f"{torch.cuda.is_available()}, device_count "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 3
    print(f"card: {card_line()}", file=sys.stderr, flush=True)
    result = run(args.workload, args.seed, args.seconds, bool(args.trace))
    for k, v in result["checks"].items():
        print(f"check {k} {v['value']} limit {v['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
