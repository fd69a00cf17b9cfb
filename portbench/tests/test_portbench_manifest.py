"""BENCHMARK.json and the files it names: the contract's forms, and every
name found by its own file."""

import json
import os
import re

import pytest

from conftest import BENCH, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def manifest():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_names_and_units_use_the_allowed_characters():
    m = manifest()
    names = [e["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for e in m[k]]
    names += [w[k] for w in m["workloads"] for k in ("config", "traffic")]
    names += [r for c in m["configs"] for r in c["reduced"]]
    for name in names:
        assert NAME.match(name), name
    for metric in m["end_to_end"] + m["per_layer"]:
        assert UNIT.match(metric["unit"]), metric["unit"]
        assert metric["better"] in ("lower", "higher")
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        seen = [e["name"] for e in m[kind]]
        assert len(seen) == len(set(seen)), kind


def test_the_manifest_keeps_the_contracts_form():
    m = manifest()
    assert set(m) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert m["paths"] == ["portbench"]
    assert 1 <= m["run_seconds"] <= 51
    assert any(e["name"] == "setup_s" for e in m["end_to_end"])
    for e in m["end_to_end"]:
        assert 0.01 <= e["bound"] <= 0.25
        assert e["source"] in ("host_clock", "device_trace")
    for w in m["workloads"]:
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    pairs = [(w["config"], w["traffic"]) for w in m["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert len(json.dumps(m)) <= 64 * 1024


def test_every_metric_moves_one_its_cells_report():
    m = manifest()
    cells = {w["name"] for w in m["workloads"]}
    reported = {e["name"]: set(e.get("workloads", cells))
                for e in m["end_to_end"]}
    for e in m["end_to_end"]:
        assert set(e.get("workloads", cells)) <= cells
    for cell in cells:
        got = [e for e in m["end_to_end"] if cell in reported[e["name"]]]
        assert "setup_s" in [e["name"] for e in got] and len(got) >= 2
        assert any(cell in p.get("workloads", cells) for p in m["per_layer"])
    for p in m["per_layer"]:
        assert p["moves"] in reported, p["name"]
        for cell in p.get("workloads", cells):
            assert cell in cells
            assert cell in reported[p["moves"]], (p["name"], cell)


@pytest.mark.parametrize("kind", ["configs", "workloads", "per_layer"])
def test_every_entry_has_its_own_file(kind):
    m = manifest()
    for e in m[kind]:
        if kind == "configs":
            path = os.path.join(ROOT, e["file"])
            assert path == os.path.join(BENCH, "configs", e["name"] + ".json")
        elif kind == "workloads":
            path = os.path.join(BENCH, "workloads", e["name"] + ".json")
            with open(path) as f:
                w = json.load(f)
            assert (w["config"], w["traffic"]) == (e["config"], e["traffic"])
            with open(os.path.join(BENCH, "traffic",
                                   w["traffic"] + ".json")) as f:
                driver = json.load(f)["driver"]
            assert os.path.isfile(os.path.join(BENCH, "drivers",
                                               driver + ".py"))
        else:
            path = os.path.join(BENCH, "metrics", e["name"] + ".py")
        assert os.path.isfile(path), path


def test_a_configuration_lists_what_it_cut():
    m = manifest()
    for c in m["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert set(c["reduced"]) == set(cfg["published"])
        for key in c["reduced"]:
            assert not key.endswith(("_dim", "_rank")) and key != "hidden"
