"""The readings a cell's limits are set from, on the card at the cell's own
size: for each seed, the program's numbers against the reference (the
lower reading), the control's (the reference in TF32, put in the
program's place; the upper reading) and each planted fault's.

    python3 benchmark/readings.py --workload gs3d-train \\
        --seeds 1 2 3 --control 1 2 --faults stale half_batch

One JSON line per seed. A training cell needs no window: the first steps
are the program's own calls from the seeded state. The benchmark's runs
do not run this.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark import harness  # noqa: E402


def readings(c: dict, seed: int, device, control: bool, faults: list,
             raw: bool = False) -> dict:
    """{seed, program, each fault, control: the numbers compared}; with
    `raw`, also what each side produced ("raw": {side: numbers})."""
    loop = c["loop"]
    ref, _ = loop.reference_numbers(c, seed, device)
    sides = {"program": loop.program_numbers(c, seed, device)}
    for f in faults:
        sides[f] = loop.program_numbers(c, seed, device, f)
    if control:
        sides["control"], _ = loop.reference_numbers(c, seed, device,
                                                     control=True)
    out = {"seed": seed}
    out.update({k: loop.checks(v, ref) for k, v in sides.items()})
    if raw:
        out["raw"] = dict(sides, reference=ref)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", type=int, nargs="*", default=[],
                    help="the seeds to read the control and the faults on")
    ap.add_argument("--faults", nargs="*", default=[])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--raw", action="store_true",
                    help="print what each side produced too")
    args = ap.parse_args(argv)
    c = harness.load_cell(args.workload)
    for seed in args.seeds:
        t0 = time.perf_counter()
        line = readings(c, seed, args.device, seed in args.control,
                        args.faults if seed in args.control else [], args.raw)
        line["seconds"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
