"""A tiny copy of the benchmark for CPU tests: BENCHMARK.json and the
directories the harness reads by name under a temporary root, the
configurations cut to a few thousand splats at 64x48 and the viewer's
sample to its first frame, so that each cell runs end to end in seconds
on the CPU."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[2]
DATA = ("configs", "traffic", "limits", "metrics", "loops", "families")
TINY = {"envgs-sedan-budget": dict(max_gs=3000, env_max_gs=800, height=48,
                                   width=64, pair_cap=2 ** 16,
                                   env_pair_cap=2 ** 16),
        "gs3d-mipnerf360": dict(num_gs=3000, pool_cap=4096, height=48,
                                width=64, pair_cap=2 ** 16)}


def tiny_root(tmp: Path) -> Path:
    """tmp holding BENCHMARK.json and tiny copies of the data files."""
    shutil.copy(REPO / "BENCHMARK.json", tmp / "BENCHMARK.json")
    for d in DATA:
        shutil.copytree(REPO / "benchmark" / d, tmp / "benchmark" / d,
                        ignore=shutil.ignore_patterns("__pycache__"))
    for name, upd in TINY.items():
        p = tmp / "benchmark" / "configs" / f"{name}.json"
        cfg = {**json.loads(p.read_text()), **upd}
        key = "base_scale" if "base_scale" in cfg["scene"] else "scale"
        cfg["scene"][key] = 0.03  # a few pixels at 64x48
        p.write_text(json.dumps(cfg))
    p = tmp / "benchmark" / "traffic" / "orbit-120.json"
    p.write_text(json.dumps({**json.loads(p.read_text()), "sample_from": 1,
                             "sampled_frames": 1, "warm_frames": 1}))
    return tmp


def run(root: Path, workload: str, seed: int = 2 ** 31 + 7,
        fault: str | None = None, seconds: float = 0.5) -> dict:
    from benchmark import harness

    torch.set_num_threads(2)
    return harness.main(["--workload", workload, "--seed", str(seed),
                         "--seconds", str(seconds), "--trace", "0"],
                        device="cpu", root=root, fault=fault)
