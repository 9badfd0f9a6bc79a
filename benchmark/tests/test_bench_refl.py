"""The envgs-train cell (EnvGS with the reflection on) end to end on the CPU
at 64x48, and the reference's tracer against the program's.

The cell's configuration is shrunk here, inside `tiny_root`'s copy: the
program and the reference agree within the cell's limits, each planted
fault turns `correct` false, a per-tile cap below the tiles' need counts
in `failed`, and with that count not read the run is not correct: the
uncapped reference sees the truncation itself."""
from __future__ import annotations

import json
import math

import pytest
import torch

from bench_tiny import run, tiny_root

CELL = "envgs-train"
TINY = dict(max_gs=3000, env_max_gs=800, height=48, width=64,
            pair_cap=2 ** 16, env_pair_cap=2 ** 16)
# one 64-splat chunk a ray tile: far below what the tiles' cones meet
CUT_CAP = 64


def _refl_root(tmp, **upd):
    root = tiny_root(tmp)
    p = root / "benchmark" / "configs" / "envgs-sedan-refl.json"
    cfg = {**json.loads(p.read_text()), **TINY, **upd}
    cfg["scene"]["base_scale"] = 0.03  # a few pixels at 64x48
    p.write_text(json.dumps(cfg))
    return root


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return _refl_root(tmp_path_factory.mktemp("refl"))


@pytest.fixture(scope="module")
def cut_root(tmp_path_factory):
    return _refl_root(tmp_path_factory.mktemp("refl_cut"),
                      env_per_tile_cap=CUT_CAP)


def test_envgs_train_is_correct_on_the_cpu(root):
    line = run(root, CELL)
    assert line["correct"] and line["failed"] == 0 and line["attempted"] > 0
    assert all(math.isfinite(v["value"]) and v["value"] <= v["limit"]
               for v in line["checks"].values())
    assert {"setup_s", "train_steps_per_s.envgs"} <= set(line["metrics"])


@pytest.mark.parametrize("fault", ["stale", "half_batch"])
def test_a_planted_fault_is_not_correct(root, fault):
    assert not run(root, CELL, fault=fault)["correct"]


def test_a_cap_below_the_tiles_need_fails_its_steps(cut_root):
    line = run(cut_root, CELL)
    assert line["failed"] == line["attempted"] > 0


def test_the_uncapped_reference_sees_a_truncation(cut_root, monkeypatch):
    """The program's count of the cut chunks read as 0: no step fails, and
    the reference, which has no cap, still finds the program wrong."""
    from benchmark import harness

    sides = harness.load_cell(CELL, cut_root)["sides"]
    init = sides.Program.__init__

    def blind(self, *a):
        init(self, *a)
        step = self._step

        def unread(*args, **kw):
            state, stats = step(*args, **kw)
            return state, {**stats,
                           "trace_cut": torch.zeros_like(stats["trace_cut"])}

        self._step = unread

    monkeypatch.setattr(sides.Program, "__init__", blind)
    line = run(cut_root, CELL)
    assert line["failed"] == 0 and not line["correct"], line["checks"]


def _scene(P=40, seed=0):
    """A faint env set on a patch of a dome (opacity 0.1: no ray's T nears
    the cutoff, so the chunking does not matter) and a 20x24 grid of rays
    from near the origin toward it."""
    g = torch.Generator().manual_seed(seed)
    xyz = torch.cat([torch.rand((P, 2), generator=g) * 4.0 - 2.0,
                     8.0 + torch.rand((P, 1), generator=g)], 1)
    quat = torch.randn((P, 4), generator=g) * 0.2 + torch.tensor(
        [1.0, 0.0, 0.0, 0.0])
    scale2 = 0.3 + 0.3 * torch.rand((P, 2), generator=g)
    opacity = torch.full((P,), 0.1)
    colors = torch.rand((P, 3), generator=g)
    H, W = 20, 24
    yy, xx = torch.meshgrid(torch.linspace(-0.25, 0.25, H),
                            torch.linspace(-0.3, 0.3, W), indexing="ij")
    d = torch.stack([xx, yy, torch.ones_like(xx)], -1)
    o = 0.05 * torch.randn((H, W, 3), generator=g)
    return xyz, quat, scale2, opacity, colors, o, d


def test_reference_tracer_against_the_programs():
    """Forward (rgb, acc, depth) and the K4 gradients into the surfels and
    the rays against the program's plain tiled tracer at its default cap
    (which cuts nothing here), acc also against its exact per-ray
    tracer."""
    from benchmark.reference import tracer as ref
    from envgs_tpu_torch.ops import tracer as prog
    from envgs_tpu_torch.ops.tracer_ref import (
        prepare_trace_scene,
        trace_rays_reference,
    )

    torch.set_num_threads(2)
    leaves = [x.clone().requires_grad_(True) for x in _scene()]
    xyz, quat, scale2, opacity, colors, o, d = leaves
    got = ref.trace(xyz, quat, scale2, opacity, colors, o, d)
    scene = prepare_trace_scene(xyz, quat, scale2, opacity, colors)
    bg = torch.zeros(3)
    tiled = prog.trace_rays(scene, o, d, bg, needs=(True, False, True))
    exact = trace_rays_reference(scene, o, d, bg)
    assert int(tiled.cut_chunks) == 0 and int(tiled.dropped_pairs) == 0
    assert float(got["acc"].detach().max()) > 0.05
    torch.testing.assert_close(got["rgb"], tiled.rgb, atol=2e-6, rtol=1e-5)
    torch.testing.assert_close(got["depth"], tiled.dpt, atol=2e-5, rtol=1e-5)
    # acc = 1 - prod(1 - alpha) is the same in any blend order: there the
    # per-ray tracer applies too
    for want in (tiled, exact):
        torch.testing.assert_close(got["acc"], want.acc, atol=2e-6,
                                   rtol=1e-5)
    w = torch.randn((20, 24, 3), generator=torch.Generator().manual_seed(1))

    def grads(rgb, acc):
        return torch.autograd.grad((rgb * w).sum() + acc.sum(), leaves)

    g_ref = grads(got["rgb"], got["acc"])
    g_prog = grads(tiled.rgb, tiled.acc)
    for name, a, b in zip(("xyz", "quat", "scale", "opacity", "colors", "o",
                           "d"), g_ref, g_prog):
        assert float(a.abs().max()) > 0, name
        torch.testing.assert_close(a, b, atol=1e-4 * float(b.abs().max()),
                                   rtol=1e-4, msg=name)


def test_trace_counts_by_hand_and_the_walk_a_tiny_tile_records():
    """One 16x16 tile of parallel rays and two faint surfels facing them
    that every ray meets: both contribute at every ray (2 x 256), K3
    counts 41 operations a (slot, ray), K4 41 + 2 (17 + 6)."""
    from benchmark import counts_trace
    from benchmark.reference import trace_blend as TB
    from benchmark.reference.raster_blend import WALKS

    packed = torch.zeros((3, TB.LO))
    for r, z in ((0, 2.0), (1, 3.0)):
        packed[r, TB._C_MEAN + 2] = z
        packed[r, TB._C_TU] = packed[r, TB._C_TV + 1] = 1e-3  # wide
        packed[r, TB._C_N + 2] = 1.0
        packed[r, TB._C_OPAC] = 0.5
    gidx = torch.tensor([0, 1] + [2] * 62, dtype=torch.int32)
    bounds = torch.tensor([0, 64], dtype=torch.int32)
    yy, xx = torch.meshgrid(torch.arange(16.0), torch.arange(16.0),
                            indexing="ij")
    rays = torch.zeros((1, 8, 256))
    rays[0, 0], rays[0, 1] = xx.reshape(-1) * 0.01, yy.reshape(-1) * 0.01
    rays[0, 5] = 1.0
    WALKS.clear()
    TB.trace_blend_torch(packed, gidx, rays, bounds, 1, 1, train=True)
    (w,) = WALKS
    assert w["walked"] == 512.0 and w["nray"] == 256 and w["A"] == 0
    assert counts_trace.trace_fwd(w) == (
        (3 * 32 + 64 + 8 * 256 + 13 * 256) * 4, 512.0 * 41)
    assert counts_trace.trace_bwd(w) == (
        (2 * 3 * 32 + 64 + 2 * 8 * 256 + 2 * 13 * 256) * 4,
        512.0 * (41 + 2 * (17 + 6)))
