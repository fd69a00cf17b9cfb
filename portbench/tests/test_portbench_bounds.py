"""A bound in BENCHMARK.json comes from A/A runs kept under bounds/: the
rule of yardstick/bounds.py, recomputed from the runs, gives the bound as
written. The next change of a bound has to bring its runs."""

import json
import os

import pytest

from conftest import BENCH, ROOT

from yardstick import bounds

# cell -> the end-to-end metric whose bound its A/A runs set
SET_BY_RUNS = {"robot-nao.corr": "train_steps_per_s"}


def _bound(metric):
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        manifest = json.load(f)
    return next(m["bound"] for m in manifest["end_to_end"]
                if m["name"] == metric)


def _kept_records(cell):
    """The cell's A/A records: the one the bound was set from, and a
    repeat on another machine, which has to give the same bound."""
    with open(os.path.join(BENCH, "bounds", f"{cell}.json")) as f:
        record = json.load(f)
    return [record, record["repeat"]]


@pytest.mark.parametrize("cell,which", [
    (cell, which) for cell in sorted(SET_BY_RUNS) for which in (0, 1)])
def test_the_bound_is_what_the_rule_gives_from_the_kept_runs(cell, which):
    metric = SET_BY_RUNS[cell]
    record = _kept_records(cell)[which]
    assert record["workload"] == cell and record["metric"] == metric
    assert record["commit"] and "H100" in record["card"]
    with open(os.path.join(BENCH, "workloads", f"{cell}.json")) as f:
        config = json.load(f)["config"]
    with open(os.path.join(BENCH, "configs", f"{config}.json")) as f:
        unit_steps = json.load(f)["corr"]["steps"]
    sets = []
    for runs in record["sides"].values():
        assert len(runs) >= 8
        assert all(r["correct"] and r["rc"] == 0 for r in runs)
        for r in runs:
            # every unit's seconds, and the rate they make
            assert len(r["unit_s"]) == r["attempted"] >= 5
            assert r["unit_s"] == pytest.approx(
                bounds.unit_seconds(r["ends_s"]), abs=1e-3)
            steps = r["metrics"][metric] * r["ends_s"][-1]
            assert steps == pytest.approx(unit_steps * r["attempted"],
                                          rel=2e-3)
        sets.append([r["metrics"][metric] for r in runs])
    assert len(sets) == 2
    # the same seeds on both sides
    seeds = [[r["seed"] for r in runs] for runs in record["sides"].values()]
    assert seeds[0] == seeds[1] and len(set(seeds[0])) == len(seeds[0])
    assert _bound(metric) == bounds.bound_from_sets(*sets)


@pytest.mark.parametrize("a,b,want", [
    # steady sets: the floor of 1%
    ([100.0] * 8, [100.0] * 8, 0.01),
    # five times the wider quartile spread (Q1 97.25, Q3 102.75 of b:
    # 5.5%, 27.5%) over twice the range (20%), capped
    ([100.0] * 8, [95, 97, 98, 100, 100, 102, 103, 105], 0.25),
    # twice the range: one far run in 16, quartile spreads 0
    ([100.0] * 8, [100.0] * 7 + [96.0], 0.08),
    # over the cap of 25%
    ([100.0] * 8, [100.0] * 7 + [80.0], 0.25),
])
def test_the_rule_takes_the_larger_part_and_clamps(a, b, want):
    assert bounds.bound_from_sets(a, b) == want


def test_the_rule_rounds_up_to_a_tenth_of_a_per_cent():
    # range 2.04 / 100 -> 4.08% -> 4.1%
    a = [100.0] * 8
    b = [100.0] * 7 + [97.96]
    assert bounds.bound_from_sets(a, b) == 0.041


def test_units_and_the_split_of_a_spread():
    assert bounds.unit_seconds([4.0, 8.5, 12.0]) == pytest.approx(
        [4.0, 4.5, 3.5])
    steady = {"unit_s": [5.0] + [4.0] * 8}
    slower = {"unit_s": [5.0] + [4.4] * 8}
    split = bounds.spread_split([steady, slower] * 2)
    assert split["within"] == 0 and split["drift"] == 0
    assert split["between"] > 0.05
    drifting = {"unit_s": [5.0] + [4.0] * 4 + [5.0] * 4}
    split = bounds.spread_split([drifting] * 4)
    assert split["between"] == 0 and split["drift"] == pytest.approx(
        1 / 4.5)
