"""A run of the harness on the CPU at a tiny size: a dropped-in cell is
found by name, the reference agrees with the program's CPU path, and the
comparison comes out not correct under the control and each fault."""

import ast
import json
import os
import subprocess
import sys

import pytest

from conftest import BENCH, ROOT, TINY, TINY_LIMIT

import faults
import run as harness

FORBIDDEN = {"jax", "jaxlib", "flax", "reart_tpu"}


CELLS = sorted(TINY)


def _driver(cell):
    import importlib

    with open(os.path.join(BENCH, "traffic",
                           TINY[cell]["traffic"] + ".json")) as f:
        name = json.load(f)["driver"]
    return importlib.import_module(f"drivers.{name}")


@pytest.mark.parametrize("cell", CELLS)
def test_a_dropped_in_cell_is_found_and_agrees(tiny_bench, cell):
    res = harness.run(cell, 2 ** 31 + 11, 0.0, False, device="cpu",
                      bench_dir=tiny_bench)
    assert res["correct"], res["checks"]
    assert "setup_s" in res["metrics"] and len(res["metrics"]) == 2
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert list(res)[-1] == "checks"


def test_the_window_runs_whole_units_until_its_seconds_are_out(tiny_bench):
    # a closed loop of whole fits, closed by the first fit that ends past
    # the window's seconds
    import torch

    cell = harness.Cell(tiny_bench, "tiny.fit")
    driver = cell.module("drivers", "fit").driver(cell, 3,
                                                  torch.device("cpu"))
    driver.setup()
    window = driver.window(1.5)
    ends = window["ends"]
    assert window["units"] == len(ends) >= 1
    assert ends[-1] >= 1.5 and all(e < 1.5 for e in ends[:-1])
    assert window["seconds"] >= ends[-1]


@pytest.mark.parametrize("cell", CELLS)
def test_the_traced_run_reads_no_device_metric_on_the_cpu(tiny_bench, cell):
    res = harness.run(cell, 5, 0.0, True, device="cpu",
                      bench_dir=tiny_bench)
    assert res["correct"], res["checks"]
    # no device here: the device readers find nothing, and no CPU number
    # stands under a device metric's name (the program's own phase timers
    # are host clocks, and are read on any device)
    assert not {k for k in res["metrics"]} & {
        "mfu.fit", "mfu.train", "device.idle_pct.fit",
        "device.idle_pct.train", "nn1_bidir_coords_roofline",
        "blend3_roofline", "assign.solve_ms"}
    assert res["device"]["busy_s"] == 0.0 and res["device"]["window_s"] > 0
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.mark.parametrize("cell", CELLS)
def test_the_lower_precision_control_is_not_correct(tiny_bench, cell):
    # the card's control is TF32; the CPU has none, and bfloat16 autocast
    # stands in for it here
    try:
        res = harness.run(cell, 7, 0.0, False, device="cpu",
                          bench_dir=tiny_bench, program_precision="bfloat16")
    except (TypeError, RuntimeError):
        # a control that crashes has failed (the sequence's finalize turns
        # bfloat16 tensors into numpy arrays, which numpy has no type for)
        return
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("cell,fault", [
    (cell, fault) for cell in CELLS for fault in _driver(cell).FAULTS])
def test_a_planted_fault_is_not_correct(tiny_bench, monkeypatch, cell,
                                        fault):
    faults.plant(monkeypatch, fault)
    res = harness.run(cell, 7, 0.0, False, device="cpu",
                      bench_dir=tiny_bench)
    assert not res["correct"], (fault, res["checks"])


def test_a_solve_stopped_short_of_the_exact_matching_is_not_correct(
        tiny_bench):
    # the reference solves the assignment exactly; the program's auction
    # bounded at one sweep a phase leaves rows to its greedy completion
    res = harness.run("tiny.fit", 7, 0.0, False, device="cpu",
                      bench_dir=tiny_bench, config_set={"assign_sweeps": 1})
    assert not res["correct"], res["checks"]
    assert res["checks"]["assign.loss"]["value"] > TINY_LIMIT
    assert res["checks"]["start.loss"]["value"] <= TINY_LIMIT


def test_a_run_without_a_card_exits_non_zero_and_prints_no_result():
    proc = subprocess.run(
        [sys.executable, os.path.join(BENCH, "run.py"), "--workload",
         "robot-nao.corr", "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=ROOT, timeout=300,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "CUDA device" in proc.stderr


def test_no_module_of_jax_or_the_jax_package_is_loaded(tiny_bench):
    code = (
        "import sys, json\n"
        f"sys.path[:0] = [{tiny_bench!r}, {ROOT!r}]\n"
        "import run\n"
        f"run.run('tiny.fit', 3, 0.0, True, device='cpu', "
        f"bench_dir={tiny_bench!r})\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=ROOT, timeout=600,
                          env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert proc.returncode == 0, proc.stderr[-2000:]
    loaded = set(json.loads(proc.stdout.strip().splitlines()[-1]))
    assert "reart_tpu_torch" in loaded
    assert not loaded & FORBIDDEN


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module \
                and not node.level:
            yield node.module.split(".")[0]


def test_the_reference_imports_nothing_of_the_program():
    ref = os.path.join(BENCH, "reference")
    for name in os.listdir(ref):
        if name.endswith(".py"):
            mods = set(_imports(os.path.join(ref, name)))
            assert not mods & (FORBIDDEN | {"reart_tpu_torch"}), name


def test_no_file_of_the_benchmark_imports_jax():
    for dirpath, _, files in os.walk(BENCH):
        for name in files:
            if name.endswith(".py"):
                mods = set(_imports(os.path.join(dirpath, name)))
                assert not mods & FORBIDDEN, name
