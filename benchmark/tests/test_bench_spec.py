"""BENCHMARK.json and the data files it names, against the benchmark's
contract."""
from __future__ import annotations

import json
import re

import pytest

from bench_tiny import REPO

SPEC = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "benchmark/run.py"]
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51


@pytest.mark.parametrize("conf", SPEC["configs"], ids=lambda c: c["name"])
def test_config_file_states_its_source_assumed_and_reduced(conf):
    assert set(conf) == {"name", "source", "file", "reduced", "why"}
    cfg = json.loads((REPO / conf["file"]).read_text())
    assert cfg["source"] == conf["source"]
    assert cfg["reduced"] == conf["reduced"] == []
    assert cfg["assumed"]
    assert (REPO / "benchmark" / "families" / f"{cfg['family']}.py").exists()


@pytest.mark.parametrize("cell", SPEC["workloads"], ids=lambda c: c["name"])
def test_cell_files_and_metrics(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert cell["chips"] == 1 and len(cell["why"]) <= 200
    bench = REPO / "benchmark"
    traffic = json.loads((bench / "traffic" / f"{cell['traffic']}.json")
                         .read_text())
    limits = json.loads((bench / "limits" / f"{cell['name']}.json")
                        .read_text())
    assert limits and (bench / "loops" / f"{traffic['loop']}.py").exists()
    family = json.loads((REPO / next(
        c["file"] for c in SPEC["configs"] if c["name"] == cell["config"])
    ).read_text())["family"]
    assert (bench / "families" / f"{family}_{traffic['loop']}.py").exists()
    e2e = [m["name"] for m in SPEC["end_to_end"]
           if cell["name"] in m.get("workloads", [cell["name"]])]
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = [m for m in SPEC["per_layer"] if cell["name"] in m["workloads"]]
    assert layer and all(m["moves"] in e2e for m in layer)


def test_names_units_and_metrics():
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in SPEC[k]]
    assert len(names) == len(set(names)) and all(map(NAME.match, names))
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert (REPO / "benchmark" / "metrics" / f"{m['name']}.py").exists()
        assert "bound" not in m
    texts = ([x["why"] for k in ("configs", "workloads") for x in SPEC[k]]
             + [m["layer"] for m in SPEC["per_layer"]]
             + [c["source"] for c in SPEC["configs"]] + SPEC["command"])
    assert all(1 <= len(s) <= 200 and "\n" not in s and "\t" not in s
               for s in texts)
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024
