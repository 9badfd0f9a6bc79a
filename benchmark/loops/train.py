"""The "train" loop: a closed loop of one training step at a time.

Set-up builds the program's step and its seeded state and drives the first
`ref_steps` steps of an episode through the window's own call; the window
then runs episodes of `episode_steps` steps, each from a device copy of
the seeded state (the copy is timed), one view after the other.
train_steps_per_s is the steps completed over the window's seconds.

The cell's family gives the two sides in `families/<family>_train.py`:
`Program` (the timed path) and `Reference` (the plain reference), each
built from the inputs the benchmark made from the seed, with `state0`,
`step(state, k) -> (state, {"loss", "bad"})`, `leaves(state)` and
`moments(state)` ({name: tensor}: the parameters and Adam's first moments).
"""
from __future__ import annotations

import contextlib
import statistics
import time

import torch

from benchmark import harness
from benchmark.trace import profile

B1 = 0.9  # Adam's first-moment decay
FAULTS = ("stale", "half_batch")


def numbers(side, state0, states: list, losses: list) -> dict:
    """What a side's first steps produced: each step's loss, each leaf's
    first gradient as the optimizer got it (its first moment after step 1,
    from zero, over 1 - b1) and its change over the steps, as norms."""
    grads = {k: harness.norm64(v) / (1.0 - B1)
             for k, v in side.moments(states[0]).items()}
    p0, pn = side.leaves(state0), side.leaves(states[-1])
    return dict(loss=[float(x) for x in losses], grad=grads,
                change={k: harness.norm64(pn[k] - p0[k]) for k in p0})


def first_steps(side, n: int, fault: str | None = None):
    """-> (states after each of the episode's first n steps, losses): the
    window's own call from the seeded state. A planted fault: "stale" (the
    step hands its input state back), "half_batch" (the side's)."""
    ctx = (side.half_batch() if fault == "half_batch"
           else contextlib.nullcontext())
    state, states, losses = side.state0, [], []
    with ctx:
        for k in range(n):
            new, st = side.step(state, k)
            state = state if fault == "stale" else new
            states.append(state)
            losses.append(st["loss"])
    return states, losses


def checks(p: dict, r: dict) -> dict:
    """The numbers compared: the first step's loss gap, relative, and by
    the worst leaf the gap between the program's and the reference's
    change norms over the steps, against the reference's norm of that leaf
    or of the median leaf, whichever is larger. Leaves whose reference
    gradient is under a thousandth of the median leaf's (nought to
    rounding, or not trained by the step, as EnvGS's env set before the
    reflection starts) are left out of the change; the median is over the
    leaves whose reference gradient is not zero.

    The later steps' losses and the first gradient's norms are not
    compared (`gradient_gap` reads the latter): the blend's backward
    rebuilds each pixel's transmittance from its end over a set of pairs
    that depends on the pair layout (ROADMAP Queue 3 item 1, in both
    packages and in the reference's frozen copy), so where the program's
    and the reference's binnings differ, a few elements of the gradient
    take rebuilt values orders of magnitude apart, and the norms with them.
    Adam's first step moves each element by its rate whatever its
    gradient's size, so the change, and the losses after it, stay close."""
    g_med = statistics.median(g for g in r["grad"].values() if g > 0)
    kept = [k for k in r["change"] if r["grad"][k] >= 1e-3 * g_med]
    c_med = statistics.median(r["change"][k] for k in kept)
    a, b = p["loss"][0], r["loss"][0]
    return {"loss1_gap": abs(a - b) / abs(b) if b else abs(a - b),
            "change_gap": harness.worst(
                [abs(p["change"][k] - r["change"][k])
                 / max(r["change"][k], c_med) for k in kept])}


def gradient_gap(p: dict, r: dict) -> float:
    """By the worst leaf, the gap of the first gradient's norms against the
    reference's norm of that leaf or of the median leaf (not compared: see
    `checks`)."""
    g_med = statistics.median(g for g in r["grad"].values() if g > 0)
    return harness.worst([abs(p["grad"][k] - r["grad"][k])
                          / max(r["grad"][k], g_med) for k in r["grad"]])


def program_numbers(c: dict, seed: int, device, fault=None) -> dict:
    """The program's first steps from the seed, outside any window."""
    inputs = c["family"].make_inputs(c["cfg"], c["traffic"], seed, device)
    side = c["sides"].Program(c["cfg"], c["traffic"], inputs)
    states, losses = first_steps(side, c["traffic"]["ref_steps"], fault)
    nums = numbers(side, side.state0, states, losses)
    del side, inputs, states, losses
    harness.free()
    return nums


def reference_numbers(c: dict, seed: int, device, control: bool = False):
    """The reference's first steps from the seed (TF32 on for the
    control) -> (numbers, what its blends walked)."""
    from benchmark.reference.raster_blend import WALKS

    WALKS.clear()
    with harness.tf32(control):
        inputs = c["family"].make_inputs(c["cfg"], c["traffic"], seed,
                                         device)
        side = c["sides"].Reference(c["cfg"], c["traffic"], inputs)
        t0 = time.perf_counter()
        states, losses = first_steps(side, c["traffic"]["ref_steps"])
        nums = numbers(side, side.state0, states, losses)
        harness.log(f"reference steps {time.perf_counter() - t0:.2f} s "
                    f"(TF32 {control})")
    walks = list(WALKS)
    del side, inputs, states, losses
    harness.free()
    return nums, walks


def run(c: dict, args, device, t_start: float, fault=None) -> dict:
    cfg, traffic = c["cfg"], c["traffic"]
    harness.log("set-up: process to harness "
                f"{time.perf_counter() - t_start:.2f} s")
    inputs = c["family"].make_inputs(cfg, traffic, args.seed, device)
    tr = c["sides"].Program(cfg, traffic, inputs)
    harness.sync(device)
    harness.log("set-up: inputs and state "
                f"{time.perf_counter() - t_start:.2f} s")
    states, losses = first_steps(tr, traffic["ref_steps"], fault)
    prog = numbers(tr, tr.state0, states, losses)
    del states, losses
    harness.tree_clone(tr.state0)  # warms the episode's restore
    harness.sync(device)
    setup_s = time.perf_counter() - t_start
    harness.log(f"set-up {setup_s:.2f} s")

    steps, bads, k = 0, [], traffic["episode_steps"]
    t0 = time.perf_counter()
    while True:
        if k == traffic["episode_steps"]:
            state, k = harness.tree_clone(tr.state0), 0
        state, st = tr.step(state, k)
        bads.append(st["bad"])
        steps, k = steps + 1, k + 1
        if time.perf_counter() - t0 >= args.seconds:
            break
    harness.sync(device)
    window_s = time.perf_counter() - t0
    failed = int(torch.stack(bads).sum())
    harness.log(f"window {window_s:.2f} s, {steps} steps, {failed} failed")
    out = dict(setup_s=setup_s, attempted=steps, failed=failed,
               e2e={"setup_s": setup_s, "train_steps_per_s": steps / window_s})
    out["peak"] = harness.peak_bytes(device)
    if args.trace:
        out["stage_ms"] = tr.stage_ms(harness.tree_clone(tr.state0))
        box = {"state": harness.tree_clone(tr.state0)}

        def one(i):
            box["state"], _ = tr.step(box["state"], i)

        out["trace"] = profile(one, traffic["trace_iterations"])
        out["ops_fn"] = tr.ops_per_step
        del box
    del tr, inputs, state, bads
    harness.free()
    t_ref = time.perf_counter()
    ref, walks = reference_numbers(c, args.seed, device)
    harness.log(f"reference {time.perf_counter() - t_ref:.2f} s")
    out["walks"] = walks
    out["checks"] = checks(prog, ref)
    harness.log(f"gradient gap (not compared) {gradient_gap(prog, ref)!r}; "
                f"losses {prog['loss']} against {ref['loss']}")
    return out
