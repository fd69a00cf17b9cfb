"""Shared set-up of the benchmark's CPU tests: the harness's folder on the
import path, and a copy of the benchmark with a tiny cell dropped in.

Run from the repository's root: python -m pytest portbench/tests -q
"""

import json
import os
import shutil
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
# the harness's folder first (the root has a run.py of its own)
sys.path[:] = [BENCH, ROOT] + [p for p in sys.path if p not in (BENCH, ROOT)]

# Tiny cells: each cell kind at a size a CPU test run holds, on a
# configuration and a traffic mix of the benchmark's. The fit's assignment
# boundaries are two iterations apart, so the steps the reference follows
# cross one; the backbone keeps its widths (SA1 takes 512 centroids) on two
# pairs of 1024 points. The fit and sequence cells are not in
# BENCHMARK.json (PERF.md says why); their drivers and readers are kept,
# and their metrics are added to the copy.
FIT_STAGES = ("start", "recon_mid", "assign", "assign_mid")
FIT_LIMITS = tuple(f"{s}.{n}" for s in FIT_STAGES
                   for n in ("loss", "grad", "change"))
TINY = {
    "tiny.fit": dict(
        base="robot-nao", traffic="fit", limits=FIT_LIMITS,
        config={"n_frames": 3, "num_points": 96, "num_parts": 4,
                "hidden": 16, "n_iter": 14, "assign_iter": 6,
                "assign_gap": 2, "downsample": 2},
        mix={"warmup_fit": {"n_iter": 6, "assign_iter": 3},
             "trace_fit": {"n_iter": 8, "assign_iter": 3}},
        metrics={"end_to_end": [
                     {"name": "fit_iters_per_s", "unit": "iters/s",
                      "better": "higher", "bound": 0.25,
                      "source": "host_clock", "workloads": ["tiny.fit"]}],
                 "per_layer": [
                     {"name": name, "unit": unit, "better": better,
                      "source": "device_trace", "layer": "fit",
                      "moves": "fit_iters_per_s", "workloads": ["tiny.fit"]}
                     for name, unit, better in (
                         ("mfu.fit", "%", "higher"),
                         ("device.idle_pct.fit", "%", "lower"),
                         ("nn1_bidir_coords_roofline", "%", "higher"),
                         ("blend3_roofline", "%", "higher"),
                         ("assign.solve_ms", "ms", "lower"))]}),
    "tiny.sequence": dict(
        base="robot-nao", traffic="sequence",
        limits=FIT_LIMITS + ("energy.ass_err", "energy.group_err"),
        config={"n_frames": 4, "num_points": 240, "num_parts": 6,
                "hidden": 16, "assign_gap": 2, "downsample": 2},
        mix={"fit": {"n_iter": 40, "assign_iter": 12},
             "check_workers": 2},
        metrics={"end_to_end": [
                     {"name": "seq_s", "unit": "s", "better": "lower",
                      "bound": 0.25, "source": "host_clock",
                      "workloads": ["tiny.sequence"]}],
                 "per_layer": [
                     {"name": f"finalize.{k}_s", "unit": "s",
                      "better": "lower", "source": "program_span",
                      "layer": "finalize", "moves": "seq_s",
                      "workloads": ["tiny.sequence"]}
                     for k in ("energy", "viz")]}),
    "tiny.corr": dict(
        base="robot-nao", traffic="corr",
        limits=("start.loss", "start.grad", "start.change"),
        config={"n_frames": 3, "num_points": 2048},
        corr={"batch": 2, "steps": 4},
        mix={"warmup_steps": 1, "trace_steps": 2},
        like="robot-nao.corr"),
}
# Every number agrees with the program's CPU path to 2e-4 or less on the
# seeds the tests use (float32 rounding: the program's auction, run to
# convergence, returns the reference's exact matching); the control and
# the faults read 1e-2 and more.
TINY_LIMIT = 1e-3


@pytest.fixture
def tiny_bench(tmp_path):
    """A copy of the benchmark (portbench/ and BENCHMARK.json) with the tiny
    cells added as a later change would add cells: new files and new
    BENCHMARK.json entries only. -> the copy's benchmark folder."""
    bench = tmp_path / "portbench"
    shutil.copytree(BENCH, bench,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        manifest = json.load(f)
    for name, spec in TINY.items():
        cfg_name, mix = name.replace(".", "-"), name.replace(".", "-")
        with open(bench / "configs" / f"{spec['base']}.json") as f:
            config = {**json.load(f), **spec["config"], "name": cfg_name}
        config["corr"] = {**config.get("corr", {}), **spec.get("corr", {})}
        (bench / "configs" / f"{cfg_name}.json").write_text(
            json.dumps(config))
        with open(bench / "traffic" / f"{spec['traffic']}.json") as f:
            traffic = {**json.load(f), **spec["mix"]}
        (bench / "traffic" / f"{mix}.json").write_text(json.dumps(traffic))
        limits = {k: TINY_LIMIT for k in spec["limits"]}
        (bench / "workloads" / f"{name}.json").write_text(json.dumps(
            {"config": cfg_name, "traffic": mix, "limits": limits}))
        manifest["configs"].append(
            {"name": cfg_name, "source": "https://github.com/stevenlsw/reart",
             "file": f"portbench/configs/{cfg_name}.json", "reduced": [],
             "why": "a test size"})
        manifest["workloads"].append(
            {"name": name, "config": cfg_name, "traffic": mix, "chips": 1,
             "why": "a test size"})
        for m in manifest["end_to_end"] + manifest["per_layer"]:
            if spec.get("like") in m.get("workloads", []):
                m["workloads"].append(name)
        for kind, extra in spec.get("metrics", {}).items():
            manifest[kind] += extra
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))
    return str(bench)
