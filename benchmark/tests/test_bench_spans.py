"""The readers of the program's spans and counters (spans.py and the
metrics that use it) on a record made by a tiny step or frame of each
cell's program side on the CPU under the profiler: each reads a number
where it reads host ms or counters, None for device ms (no CUDA event off
the card), and None from a program that keeps no such record."""
from __future__ import annotations

import argparse

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from bench_tiny import tiny_root
from benchmark import harness
from envgs_tpu_torch.utils import timer

SEED = 2 ** 31 + 11
ITERATIONS = 2
# the readers this file holds to the record, by cell
METRICS = {
    "gs3d-train": ("fwd_ms.gs3d", "bwd_ms.gs3d", "project_ms.gs3d",
                   "bin_ms.gs3d", "bin_slot_use.gs3d"),
    "envgs-train-early": ("project_ms.envgs", "bin_ms.envgs",
                          "bin_slot_use.envgs", "fwd_host_ms.envgs",
                          "bwd_host_ms.envgs"),
    "gs3d-view": ("project_ms.view", "bin_ms.view", "bin_slot_use.view"),
}


def ctx(iterations: int = ITERATIONS):
    return argparse.Namespace(trace=argparse.Namespace(iterations=iterations))


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("bench"))


def record(root, workload: str, iterations: int = ITERATIONS):
    """Fill the program's record with `iterations` steps or frames of the
    cell's program side (one more before them, outside the profiler)."""
    torch.set_num_threads(2)
    c = harness.load_cell(workload, root)
    inputs = c["family"].make_inputs(c["cfg"], c["traffic"], SEED, "cpu")
    side = c["sides"].Program(c["cfg"], c["traffic"], inputs)
    train = c["traffic"]["loop"] == "train"
    state = side.state0 if train else None

    def one(i):
        nonlocal state
        if train:
            state, _ = side.step(state, i)
        else:
            side.render(i)

    one(0)
    timer.RECORD.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        for i in range(iterations):
            one(i + 1)


@pytest.mark.parametrize("workload", list(METRICS))
def test_each_reader_reads_the_record_of_a_tiny_cpu_run(root, workload):
    record(root, workload)
    assert len(timer.RECORD) == ITERATIONS
    spec = {m["name"]: m for m in harness.load_cell(workload, root)
            ["spec"]["per_layer"]}
    for name in METRICS[workload]:
        assert workload in spec[name]["workloads"]
        got = harness.metric_reader(root / "benchmark", name)(ctx())
        if "host" in name:
            assert got > 0, name
        elif "slot_use" in name:
            assert 0 < got <= 100, name
        else:
            assert got is None, name  # device ms: no CUDA event on the CPU


def test_readers_take_the_median_over_the_last_roots(root, monkeypatch):
    def fake(name, ms, kept):
        return {"root": 0, "name": name, "host_ms": {"render.bin": ms},
                "device_ms": {"render.bin": ms},
                "counts": {"bin.kept": kept, "bin.slots": 200}}

    recs = [fake("train.step", 100.0, 200), fake("render", 50.0, 0),
            fake("train.step", 3.0, 20), fake("train.step", 1.0, 10),
            fake("train.step", 2.0, 40)]
    monkeypatch.setattr(timer, "read_spans", lambda: recs)
    read = lambda name: harness.metric_reader(  # noqa: E731
        root / "benchmark", name)(ctx(3))
    assert read("bin_ms.gs3d") == 2.0
    assert read("bin_slot_use.gs3d") == 10.0
    assert read("bin_ms.view") == 50.0


def test_a_program_without_spans_reads_none(root, monkeypatch):
    monkeypatch.delattr(timer, "read_spans")
    for names in METRICS.values():
        for name in names:
            assert harness.metric_reader(root / "benchmark", name)(
                ctx()) is None
