"""Runs one cell of BENCHMARK.json once and prints its result line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Everything particular to a cell is a file found by name under the
benchmark's directory: its configuration in the file BENCHMARK.json names,
whose `family` picks `families/<family>.py` (the inputs made from the
seed); its traffic mix `traffic/<mix>.json`, whose `loop` picks
`loops/<loop>.py` (the closed loop, its window and what it compares) and,
with the family, `families/<family>_<loop>.py` (the program's side and the
reference's); its limits `limits/<workload>.json`; each per-layer
metric's reader `metrics/<metric>.py`. A cell made of new files and
entries needs no edit of a file that is there.

A loop returns the set-up seconds, the window's counts, its end-to-end
quantities under their base names (an end-to-end metric `x.<suffix>` of
the cell reports the quantity `x`: cells of one quantity may hold bounds
of their own), and the numbers it compared. After the window (and, with
--trace 1, a short profiled sub-window and the stage timings) the
program's state is freed and the reference, rebuilt from the seed, judges
what the timed path produced. Each number compared and its limit end the
result line (under "checks") and standard error.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import importlib.util
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
# the JAX side of the repository, which nothing the benchmark runs may load
FORBIDDEN = ("jax", "jaxlib", "flax", "envgs_tpu")


class NoCard(RuntimeError):
    pass


def module(path: Path):
    """The module of the Python file at `path`, loaded once."""
    name = "benchmark_file_" + "".join(
        ch if ch.isalnum() else "_" for ch in str(path))
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
    return sys.modules[name]


def load_cell(name: str, root: Path = ROOT) -> dict:
    """{spec, cell, cfg, traffic, limits, bench, family, loop, sides} of
    workload `name`: its entries and data, and the modules of its family,
    its loop and the family's sides in that loop."""
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cell = next((w for w in spec["workloads"] if w["name"] == name), None)
    if cell is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in spec["configs"] if c["name"] == cell["config"])
    bench = root / spec["paths"][0]
    cfg = json.loads((root / conf["file"]).read_text())
    traffic = json.loads((bench / "traffic" / f"{cell['traffic']}.json")
                         .read_text())
    limits = json.loads((bench / "limits" / f"{name}.json").read_text())
    fam, loop = cfg["family"], traffic["loop"]
    return dict(spec=spec, cell=cell, cfg=cfg, traffic=traffic, limits=limits,
                bench=bench,
                family=module(bench / "families" / f"{fam}.py"),
                loop=module(bench / "loops" / f"{loop}.py"),
                sides=module(bench / "families" / f"{fam}_{loop}.py"))


def metric_reader(bench: Path, name: str):
    return module(bench / "metrics" / f"{name}.py").read


def cell_metrics(spec: dict, cell: str) -> tuple[list, list]:
    """(end-to-end, per-layer) metric entries that cell reports: those
    whose `workloads` list it, or, without the key, every cell (a per-layer
    metric: every cell that reports the metric it moves)."""
    e2e = [m for m in spec["end_to_end"]
           if cell in m.get("workloads", [cell])]
    names = {m["name"] for m in e2e}
    layer = [m for m in spec["per_layer"]
             if cell in m.get("workloads", [cell] if m["moves"] in names
                              else [])]
    return e2e, layer


def tree_clone(x):
    """A device copy of a state: every tensor of nested (named) tuples
    cloned, anything else as it is."""
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, tuple):
        items = [tree_clone(v) for v in x]
        return type(x)(*items) if hasattr(x, "_fields") else tuple(items)
    return x


def norm64(x: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(x.detach().double()))


def worst(values) -> float:
    """The largest value, inf where any is not finite."""
    values = list(values)
    return (max(values) if all(math.isfinite(v) for v in values)
            else float("inf"))


def free():
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


@contextlib.contextmanager
def tf32(on: bool):
    """The control's precision: TF32 matmuls and convolutions on (the
    configurations state float32 with TF32 off)."""
    b = torch.backends
    old = (b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32)
    b.cuda.matmul.allow_tf32 = b.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32 = old


# ---- the run ----

def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def peak_bytes(device) -> int:
    if torch.device(device).type == "cuda":
        return int(torch.cuda.max_memory_allocated())
    return 0


def log(msg: str):
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def check_no_jax():
    """Exit without a result if this process has loaded JAX or the JAX
    package (top-level module names compared whole)."""
    found = sorted({m.split(".")[0] for m in list(sys.modules)}
                   & set(FORBIDDEN))
    if found:
        print(f"the run loaded {found}: the benchmark runs the port alone",
              file=sys.stderr)
        raise SystemExit(3)


def power_limit() -> str | None:
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    return r.stdout.strip().splitlines()[0] if r.returncode == 0 and \
        r.stdout.strip() else None


def layer_metrics(c: dict, entries: list, out: dict) -> dict:
    """{name: {value, unit}} of the per-layer metrics whose readers find
    something to read."""
    from benchmark import counts

    tr = out["trace"]
    ops = out["ops_fn"](c["cfg"], out["walks"])
    ctx = argparse.Namespace(trace=tr, stage_ms=out["stage_ms"],
                             walks=out["walks"], counts=counts,
                             ops_per_iteration=ops, cfg=c["cfg"],
                             e2e=out["e2e"])
    res = {}
    for m in entries:
        v = metric_reader(c["bench"], m["name"])(ctx)
        if v is not None:
            res[m["name"]] = {"value": v, "unit": m["unit"]}
    return res


def result_line(c: dict, args, out: dict, chips: int) -> dict:
    # a gap that is not finite reads as the largest float (JSON has no inf)
    checks = {k: {"value": v if math.isfinite(v) else sys.float_info.max,
                  "limit": c["limits"][k]}
              for k, v in out["checks"].items()}
    correct = all(math.isfinite(v["value"]) and v["value"] <= v["limit"]
                  for v in checks.values())
    e2e, layer = cell_metrics(c["spec"], args.workload)
    on_card = out["peak"] > 0
    device = {"platform": "gpu" if on_card else "cpu",
              "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
              "count": chips, "memory_peak_bytes": out["peak"]}
    if on_card:
        device["card_and_power_limit"] = power_limit()
    if args.trace:
        metrics = layer_metrics(c, layer, out)
        device.update(busy_s=out["trace"].busy_s,
                      window_s=out["trace"].window_s)
    else:
        metrics = {m["name"]: {"value": out["e2e"][m["name"].split(".")[0]],
                               "unit": m["unit"]}
                   for m in e2e if m["name"].split(".")[0] in out["e2e"]}
    line = {"correct": correct, "attempted": out["attempted"],
            "failed": out["failed"], "metrics": metrics, "device": device}
    if args.trace:
        line["breakdown"] = out["trace"].breakdown()
    line["checks"] = checks
    return line


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None, t_start: float | None = None, device: str = "cuda",
         root: Path = ROOT, fault: str | None = None) -> dict:
    """One run of a cell. `device` "cpu" and `fault` are for the tests: the
    harness's look for a card skipped, a fault planted in the timed path."""
    t_start = time.perf_counter() if t_start is None else t_start
    args = parse(argv)
    c = load_cell(args.workload, root)
    chips = c["cell"]["chips"]
    if device == "cuda" and not (torch.cuda.is_available()
                                 and torch.cuda.device_count() >= chips):
        raise NoCard(f"{args.workload} needs {chips} CUDA card(s)")
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    out = c["loop"].run(c, args, device, t_start, fault)
    line = result_line(c, args, out, chips)
    check_no_jax()
    print(json.dumps(line), flush=True)
    for name, v in line["checks"].items():
        print(f"check {name} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr, flush=True)
    return line
