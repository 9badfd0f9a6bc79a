"""The "view" loop: one viewer in a closed loop over the orbit's poses, the
next pose taken once the last frame's RGB is in host memory. render_fps is
the frames over the window's seconds, frame_ms_p95 the 95th percentile of
every frame's latency, from its pose taken to its RGB in host memory.

The cell's family gives the two sides in `families/<family>_view.py`:
`Program` (the timed path) and `Reference`, each built from the inputs the
benchmark made from the seed, with `render(i) -> (rgb (H, W, 3) in host
memory, a device flag of truncation)` the frame of pose i.
"""
from __future__ import annotations

import statistics
import time

import numpy as np
import torch

from benchmark import harness
from benchmark.trace import profile

FAULTS = ("altered",)


def sampled_frames(traffic: dict, seed: int) -> list:
    """The seeded sample of the window's frames the reference judges,
    among the first `sample_from` (which every run reaches)."""
    gen = torch.Generator().manual_seed(int(seed) % 2 ** 63)
    pick = torch.randperm(traffic["sample_from"], generator=gen)
    return sorted(pick[:traffic["sampled_frames"]].tolist())


def altered(rgb):
    """A planted fault: one value of the frame altered where it is made."""
    rgb = rgb.copy()
    rgb[0, 0, 0] += 0.25
    return rgb


def checks(frames: dict, ref_frames: dict) -> dict:
    """Over the sampled frames: the widest gap of a served value from the
    reference's render of its pose, and the largest mean gap of a frame (a
    value that is not finite, or no frame, reads inf)."""
    gaps = [np.abs(frames[i].astype(np.float64) - ref_frames[i])
            for i in frames]
    return {"frame_max_abs": harness.worst(
                [float(g.max()) for g in gaps] or [float("inf")]),
            "frame_mean_abs": harness.worst(
                [float(g.mean()) for g in gaps] or [float("inf")])}


def program_numbers(c: dict, seed: int, device, fault=None) -> dict:
    """The program's renders of the run's sampled frames."""
    inputs = c["family"].make_inputs(c["cfg"], c["traffic"], seed, device)
    view = c["sides"].Program(c["cfg"], c["traffic"], inputs)
    frames = {}
    for i in sampled_frames(c["traffic"], seed):
        rgb = view.render(i)[0]
        frames[i] = altered(rgb) if fault == "altered" else rgb
    del view, inputs
    harness.free()
    return frames


def reference_numbers(c: dict, seed: int, device, control: bool = False,
                      frames: list | None = None):
    """The reference's renders of the sampled frames (TF32 on for the
    control) -> ({frame: rgb}, what its blends walked)."""
    from benchmark.reference.raster_blend import WALKS

    if frames is None:
        frames = sampled_frames(c["traffic"], seed)
    WALKS.clear()
    with harness.tf32(control):
        inputs = c["family"].make_inputs(c["cfg"], c["traffic"], seed,
                                         device)
        view = c["sides"].Reference(c["cfg"], c["traffic"], inputs)
        out = {i: view.render(i)[0] for i in frames}
    walks = list(WALKS)
    del view, inputs
    harness.free()
    return out, walks


def run(c: dict, args, device, t_start: float, fault=None) -> dict:
    cfg, traffic = c["cfg"], c["traffic"]
    harness.log("set-up: process to harness "
                f"{time.perf_counter() - t_start:.2f} s")
    inputs = c["family"].make_inputs(cfg, traffic, args.seed, device)
    view = c["sides"].Program(cfg, traffic, inputs)
    harness.sync(device)
    harness.log("set-up: inputs and state "
                f"{time.perf_counter() - t_start:.2f} s")
    for i in range(traffic["warm_frames"]):
        view.render(i)
    harness.sync(device)
    setup_s = time.perf_counter() - t_start
    harness.log(f"set-up {setup_s:.2f} s")
    sample = set(sampled_frames(traffic, args.seed))
    kept, lat, bads, frames = {}, [], [], 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < args.seconds:
        ts = time.perf_counter()
        rgb, bad = view.render(frames)
        if fault == "altered":
            rgb = altered(rgb)
        lat.append(time.perf_counter() - ts)
        bads.append(torch.as_tensor(bad))
        if frames in sample:
            kept[frames] = rgb
        frames += 1
    window_s = time.perf_counter() - t0
    failed = int(torch.stack(bads).sum())
    harness.log(f"window {window_s:.2f} s, {frames} frames, {failed} failed;"
                f" frame ms min {min(lat) * 1e3:.2f} median "
                f"{statistics.median(lat) * 1e3:.2f} max {max(lat) * 1e3:.2f}")
    p95 = statistics.quantiles(lat, n=20)[18] if len(lat) > 1 else lat[0]
    out = dict(setup_s=setup_s, attempted=frames, failed=failed,
               e2e={"setup_s": setup_s, "render_fps": frames / window_s,
                    "frame_ms_p95": p95 * 1e3})
    out["peak"] = harness.peak_bytes(device)
    if args.trace:
        out["stage_ms"] = view.stage_ms()
        out["trace"] = profile(lambda i: view.render(i),
                               traffic["trace_iterations"])
        out["ops_fn"] = view.ops_per_frame
    del view, inputs
    harness.free()
    t_ref = time.perf_counter()
    ref, walks = reference_numbers(c, args.seed, device, frames=sorted(kept))
    harness.log(f"reference {time.perf_counter() - t_ref:.2f} s")
    out["walks"] = walks
    out["checks"] = checks(kept, ref)
    if sample - set(kept):  # a frame that never came is not correct
        out["checks"] = {k: float("inf") for k in out["checks"]}
    return out
