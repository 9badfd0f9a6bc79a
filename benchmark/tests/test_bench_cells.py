"""Each cell end to end on the CPU at a tiny size (the harness's look for a
card skipped): the program and the reference agree within the cell's
limits, each planted fault of the timed path turns `correct` false, and a
cell made only of new files, a new loop among them, is found by name."""
from __future__ import annotations

import json
import math

import pytest

from bench_tiny import run, tiny_root

CELLS = ("gs3d-train", "envgs-train-early", "gs3d-view")
FAULTS = [("gs3d-train", "stale"), ("gs3d-train", "half_batch"),
          ("envgs-train-early", "stale"), ("envgs-train-early", "half_batch"),
          ("gs3d-view", "altered")]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("workload", CELLS)
def test_cell_is_correct_on_the_cpu(root, workload):
    line = run(root, workload)
    assert line["correct"] and line["failed"] == 0 and line["attempted"] > 0
    assert list(line)[-1] == "checks"
    assert all(math.isfinite(v["value"]) and v["value"] <= v["limit"]
               for v in line["checks"].values())
    assert "setup_s" in line["metrics"] and len(line["metrics"]) >= 2


@pytest.mark.parametrize("workload,fault", FAULTS)
def test_a_planted_fault_is_not_correct(root, workload, fault):
    assert not run(root, workload, fault=fault)["correct"]


NEW_LOOP = '''
import time

import torch

from benchmark import harness


def run(c, args, device, t_start, fault=None):
    inputs = c["family"].make_inputs(c["cfg"], c["traffic"], args.seed,
                                     device)
    frame = c["sides"].Program(c["cfg"], inputs).render()
    ref = c["sides"].Reference(c["cfg"], inputs).render()
    setup_s = time.perf_counter() - t_start
    return dict(setup_s=setup_s, attempted=1, failed=0, peak=0,
                e2e={"setup_s": setup_s, "render_fps": 1.0},
                checks={"frame_max_abs": float((frame - ref).abs().max())})
'''

NEW_SIDES = '''
import torch

from benchmark.reference import gauss3d


class Program:
    def __init__(self, cfg, inputs):
        from envgs_tpu_torch.models import gaussians, gaussiant
        from envgs_tpu_torch.utils.camera import Camera
        from benchmark.families.gs3d_train import make_pool

        self.T = gaussiant
        self.pool = make_pool(gaussians, inputs.scene, cfg["num_gs"],
                              cfg["sh_degree"])
        K, R, T = inputs.views[0]
        self.cam = Camera(cfg["height"], cfg["width"], K, R, T)
        self.cfg = gaussiant.GaussianTConfig(pair_cap=cfg["pair_cap"])

    def render(self):
        with torch.no_grad():
            return self.T.render_gaussiant(self.pool, self.cam, self.cfg).rgb


class Reference:
    def __init__(self, cfg, inputs):
        self.step = gauss3d.Step(cfg, {"start_iter": 0}, inputs)
        K, R, T = inputs.views[0]
        self.cam = gauss3d.Cam(cfg["height"], cfg["width"], K, R, T)
        self.cfg = cfg

    def render(self):
        with torch.no_grad():
            return gauss3d.render(self.step.state0["pool"], self.cam,
                                  self.cfg["sh_degree"], self.step.active)
'''


def test_a_cell_of_new_files_alone(root):
    """A new loop, the family's sides in it, a traffic mix, a limits file,
    a per-layer metric reader and the entries: the harness runs the cell
    and finds each file by name."""
    from benchmark import harness

    bench = root / "benchmark"
    (bench / "loops" / "render-new.py").write_text(NEW_LOOP)
    (bench / "families" / "gs3d_render-new.py").write_text(NEW_SIDES)
    (bench / "traffic" / "one-frame-new.json").write_text(json.dumps(
        {"loop": "render-new", "views": 1, "yaw_deg": 0.0}))
    (bench / "limits" / "gs3d-new.json").write_text(json.dumps(
        {"frame_max_abs": 1e-2}))
    (bench / "metrics" / "new_metric.new.py").write_text(
        "def read(ctx):\n    return 42.0\n")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "gs3d-new", "config": "gs3d-mipnerf360",
                              "traffic": "one-frame-new", "chips": 1,
                              "why": "a new cell"})
    spec["end_to_end"].append({"name": "render_fps.new", "unit": "frames/s",
                               "better": "higher", "bound": 0.1,
                               "source": "host_clock",
                               "workloads": ["gs3d-new"]})
    spec["per_layer"].append({"name": "new_metric.new", "unit": "%",
                              "better": "higher", "source": "device_trace",
                              "layer": "device", "moves": "render_fps.new",
                              "workloads": ["gs3d-new"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    line = run(root, "gs3d-new")
    assert line["correct"], line
    assert line["metrics"]["render_fps.new"]["value"] == 1.0
    _, layer = harness.cell_metrics(spec, "gs3d-new")
    assert [m["name"] for m in layer] == ["new_metric.new"]
    assert harness.metric_reader(bench, "new_metric.new")(None) == 42.0
