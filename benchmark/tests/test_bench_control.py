"""The control on the card: the reference computed in TF32 (the nearest
precision below the float32 with TF32 off that the configurations state)
and put in the program's place fails a cell's limits, where the program's
own path passes them. At a quarter of each configuration's splats and
half its resolution, one seed; `python3 benchmark/readings.py` reads the
same at the cells' own sizes."""
from __future__ import annotations

import json

import pytest
import torch

from bench_tiny import REPO


def _quarter(tmp):
    import shutil

    shutil.copy(REPO / "BENCHMARK.json", tmp / "BENCHMARK.json")
    for d in ("configs", "traffic", "limits", "metrics", "loops", "families"):
        shutil.copytree(REPO / "benchmark" / d, tmp / "benchmark" / d)
    for p in (tmp / "benchmark" / "configs").glob("*.json"):
        cfg = json.loads(p.read_text())
        for k in ("max_gs", "env_max_gs", "num_gs", "pool_cap"):
            if k in cfg:
                cfg[k] //= 4
        cfg["height"], cfg["width"] = cfg["height"] // 2, cfg["width"] // 2
        p.write_text(json.dumps(cfg))
    return tmp


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["gs3d-train", "envgs-train-early",
                                      "gs3d-view"])
def test_the_control_fails_where_the_program_passes(tmp_path, workload):
    if not torch.cuda.is_available():
        pytest.skip("the control runs in TF32, which only the card has")
    from benchmark import harness, readings

    c = harness.load_cell(workload, _quarter(tmp_path))
    seed = 2 ** 31 + 11
    out = readings.readings(c, seed, "cuda", control=True, faults=[])
    limits = c["limits"]
    assert all(v <= limits[k] for k, v in out["program"].items()), out
    assert any(v > limits[k] for k, v in out["control"].items()), out
