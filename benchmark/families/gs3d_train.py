"""The two sides of a 3DGS training cell (the "train" loop).

`Program` is the timed path: `models/gaussiant.py::make_gaussiant_train_step`
of envgs_tpu_torch over a pool built from the benchmark's inputs.
`Reference` is the plain reference's step (`benchmark.reference.gauss3d`)
over the same inputs. Both hand out the episode's k-th step (view k mod
views), the parameters and Adam's first moments by field.
"""
from __future__ import annotations

import contextlib

import torch

from benchmark import counts
from benchmark.reference.gauss3d import Step as Reference


def make_pool(G, raw: dict, n_active: int, sh_degree: int):
    """The program's pool over the raw tensors, its first `n_active` slots
    active, SH degree `sh_degree` active, zero statistics."""
    cap = raw["xyz"].shape[0]
    dev = raw["xyz"].device
    z = lambda: torch.zeros(cap, device=dev)  # noqa: E731
    active = torch.zeros(cap, dtype=torch.bool, device=dev)
    active[:n_active] = True
    stats = G.GaussianStats(
        active=active, max_radii2d=z(), grad_accum=z(), weight_accum=z(),
        denom=z(), sh_degree=torch.tensor(sh_degree, dtype=torch.int32,
                                          device=dev))
    return G.GaussianPool(G.GaussianParams(**raw), stats, sh_degree)


class Program:
    """The program's 3DGS step over the inputs: `state0` (the seeded state,
    Adam's step count at the traffic's start iteration), `step(state, k)`
    -> (state, stats)."""

    def __init__(self, cfg: dict, traffic: dict, inputs):
        from envgs_tpu_torch.models import gaussians, gaussiant
        from envgs_tpu_torch.utils.camera import Camera

        self.T, self.inputs = gaussiant, inputs
        pool = make_pool(gaussians, inputs.scene, cfg["num_gs"],
                         cfg["sh_degree"])
        state = gaussiant.init_gaussiant_state(pool)
        dev = inputs.targets.device
        opt = state.opt._replace(step=torch.tensor(
            traffic["start_iter"], dtype=torch.int32, device=dev))
        self.state0 = state._replace(opt=opt)
        self.cfg = gaussiant.GaussianTConfig(
            sh_degree=cfg["sh_degree"], pair_cap=cfg["pair_cap"],
            ssim_weight=cfg["ssim_weight"])
        K, R, T = inputs.views[0]
        cam = Camera(cfg["height"], cfg["width"], K, R, T, cfg["znear"],
                     cfg["zfar"])
        self._step = gaussiant.make_gaussiant_train_step(self.cfg, cam)

    def step(self, state, k: int):
        i = k % len(self.inputs.views)
        K, R, T = self.inputs.views[i]
        state, info = self._step(state, K, R, T, self.inputs.targets[i])
        bad = ~torch.isfinite(info["loss"]) | (info["pair_overflow"] > 0)
        return state, {"loss": info["loss"], "bad": bad}

    @staticmethod
    def leaves(state) -> dict:
        return {k: v for k, v in state.pool.params._asdict().items()
                if v is not None}

    @staticmethod
    def moments(state) -> dict:
        return {k: v for k, v in state.opt.mu._asdict().items()
                if v is not None}

    @contextlib.contextmanager
    def half_batch(self):
        """A planted fault: the bottom half of the rendered image is taken
        for the target's, so the losses see the top half of the pixels."""
        T = self.T
        real = T.render_gaussiant
        target = {}

        def half(pool, cam, cfg, means2d_zero=None):
            out = real(pool, cam, cfg, means2d_zero)
            h = out.rgb.shape[0] // 2
            rgb = torch.cat([out.rgb[:h], target["rgb"][h:]], 0)
            return out._replace(rgb=rgb)

        real_step = self._step

        def step(state, K, R, T_, tgt):
            target["rgb"] = tgt
            return real_step(state, K, R, T_, tgt)

        T.render_gaussiant, self._step = half, step
        try:
            yield
        finally:
            T.render_gaussiant, self._step = real, real_step

    def stage_ms(self, state, reps: int = 5) -> dict:
        return {}  # the 3DGS step has no `mark` hook

    def ops_per_step(self, cfg: dict, walks: list) -> float | None:
        """Operations of one step from the reference's walks: the blends
        and their backward, the per-Gaussian work of every Gaussian, Adam
        over every parameter, SSIM."""
        rw = [w for w in walks if w["blend"] == "raster"]
        if not rw:
            return None
        blends = sum(counts.raster_fwd(w)[1] + counts.raster_bwd(w)[1]
                     for w in rw) / len(rw)
        splats = cfg["num_gs"] * (counts.OPS_SH3 + counts.OPS_PREP_GAUSS3D) * (
            1 + counts.BWD)
        n_params = sum(v.numel() for v in self.leaves(self.state0).values())
        H, W = cfg["height"], cfg["width"]
        return (blends + splats + counts.adam_ops(n_params)
                + counts.ssim_ops(H, W) * (1 + counts.BWD))


__all__ = ["Program", "Reference", "make_pool"]
