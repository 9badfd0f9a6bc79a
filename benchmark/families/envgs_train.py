"""The two sides of an EnvGS training cell (the "train" loop).

`Program` is the timed path: `train/trainer.py::make_train_step` of
envgs_tpu_torch over pools built from the benchmark's inputs. `Reference`
is the plain reference's step (`benchmark.reference.envgs`) over the same
inputs. Both hand out the episode's k-th step (view k mod views,
iteration start + k), the parameters and Adam's first moments by
"pool.field".
"""
from __future__ import annotations

import contextlib
import statistics

import torch

from benchmark import counts
from benchmark.reference.envgs import BaseStep as Reference


def _program():
    from envgs_tpu_torch.models import gaussians
    from envgs_tpu_torch.models.envgs import EnvGSConfig
    from envgs_tpu_torch.train import trainer
    from envgs_tpu_torch.train.optimizer import LRConfig
    from envgs_tpu_torch.train.supervisor import LossConfig
    from envgs_tpu_torch.utils.camera import Camera

    return gaussians, EnvGSConfig, trainer, LRConfig, LossConfig, Camera


def make_pool(G, raw: dict, sh_degree: int):
    """A fully active pool of the program over the raw tensors, SH degree
    `sh_degree` active, zero statistics."""
    n = raw["xyz"].shape[0]
    dev = raw["xyz"].device
    z = lambda: torch.zeros(n, device=dev)  # noqa: E731
    stats = G.GaussianStats(
        active=torch.ones(n, dtype=torch.bool, device=dev),
        max_radii2d=z(), grad_accum=z(), weight_accum=z(), denom=z(),
        sh_degree=torch.tensor(sh_degree, dtype=torch.int32, device=dev))
    return G.GaussianPool(G.GaussianParams(**raw), stats, sh_degree)


class Program:
    """The program's train step over the inputs: `state0` (the seeded
    state at the traffic's start iteration), `step(state, k, mark=None)`
    -> (state, stats)."""

    def __init__(self, cfg: dict, traffic: dict, inputs):
        G, EnvGSConfig, trainer, LRConfig, LossConfig, Camera = _program()
        self.trainer = trainer
        H, W = cfg["height"], cfg["width"]
        dev = inputs.targets.device
        self.inputs, self.traffic = inputs, traffic
        sh = cfg["sh_degree"]
        state = trainer.init_train_state(
            make_pool(G, inputs.scene["base"], sh),
            make_pool(G, inputs.scene["env"], sh))
        start = torch.tensor(traffic["start_iter"], dtype=torch.int32,
                             device=dev)
        self.state0 = state._replace(
            opt_base=state.opt_base._replace(step=start),
            opt_env=state.opt_env._replace(step=start.clone()))
        K, R, T = inputs.views[0]
        cam = Camera(H, W, K, R, T, cfg["znear"], cfg["zfar"])
        model = EnvGSConfig(
            specular_channels=cfg["specular_channels"],
            reflection_start_iter=cfg["reflection_start_iter"],
            pair_cap=cfg["pair_cap"], env_pair_cap=cfg["env_pair_cap"])
        loss = LossConfig(**{**cfg["loss"], "perc_loss_weight": 0.0})
        lr = LRConfig(**cfg["lr"])
        self._step = trainer.make_train_step(cam, model, loss, lr, lr,
                                             has_norm=True)
        ones = torch.ones((H, W, 1), device=dev)
        self.batches = [trainer.Batch(rgb=inputs.targets[i], msk=ones,
                                      norm=inputs.norms[i])
                        for i in range(len(inputs.views))]

    def step(self, state, k: int, mark=None):
        i = k % len(self.batches)
        K, R, T = self.inputs.views[i]
        kw = {} if mark is None else {"mark": mark}
        state, stats = self._step(state, self.batches[i], K, R, T,
                                  self.traffic["start_iter"] + k, **kw)
        bad = (~torch.isfinite(stats["loss"]) | (stats["pair_overflow"] > 0)
               | (stats["trace_dropped"] > 0))
        return state, {"loss": stats["loss"], "bad": bad}

    @staticmethod
    def leaves(state) -> dict:
        return {f"{pool}.{k}": v for pool in ("base", "env")
                for k, v in getattr(state, pool).params._asdict().items()
                if v is not None}

    @staticmethod
    def moments(state) -> dict:
        return {f"{pool}.{k}": v for pool in ("base", "env")
                for k, v in getattr(state, "opt_" + pool).mu._asdict().items()
                if v is not None}

    @contextlib.contextmanager
    def half_batch(self):
        """A planted fault: the losses see the top half of every map and
        target alone (half of the batch's pixels left out, the mean taken
        over the rest)."""
        tr = self.trainer
        real = tr.compute_losses

        def half(out, gt_rgb, gt_msk, gt_norm, *a, **kw):
            h = gt_rgb.shape[0] // 2
            cut = lambda x: x[:h] if (x is not None and x.dim() >= 2  # noqa: E731
                                      and x.shape[0] == 2 * h) else x
            out = out._replace(**{k: cut(v) for k, v in out._asdict().items()})
            return real(out, cut(gt_rgb), cut(gt_msk), cut(gt_norm), *a, **kw)

        tr.compute_losses = half
        try:
            yield
        finally:
            tr.compute_losses = real

    def stage_ms(self, state, reps: int = 5) -> dict:
        """Median device ms of the step's forward with its losses and of
        its backward over `reps` steps, from the step's `mark` hook (CUDA
        events)."""
        marks = []

        def mark(name):
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            marks[-1].append((name, e))

        for k in range(reps + 1):  # the first warms up
            e0 = torch.cuda.Event(enable_timing=True)
            e0.record()
            marks.append([("start", e0)])
            state, _ = self.step(state, k, mark=mark)
        torch.cuda.synchronize()
        times = {}
        for run in marks[1:]:
            for (_, a), (name, b) in zip(run, run[1:]):
                times.setdefault(name, []).append(a.elapsed_time(b))
        return {k: statistics.median(v) for k, v in times.items()}

    def ops_per_step(self, cfg: dict, walks: list) -> float | None:
        """Operations of one step from the reference's walks (the mean over
        the steps it took): the base pass's blends and their backward, the
        per-splat work of every base surfel, Adam over every parameter,
        SSIM. The cell's iterations come before the reflection's start, so
        nothing is traced."""
        rw = [w for w in walks if w["blend"] == "raster"]
        if not rw:
            return None
        blends = sum(counts.raster_fwd(w)[1] + counts.raster_bwd(w)[1]
                     for w in rw) / len(rw)
        splats = (cfg["max_gs"] * (counts.OPS_SH3 + counts.OPS_PREP_SURFEL)
                  * (1 + counts.BWD))
        n_params = sum(v.numel() for v in self.leaves(self.state0).values())
        H, W = cfg["height"], cfg["width"]
        return (blends + splats + counts.adam_ops(n_params)
                + counts.ssim_ops(H, W) * (1 + counts.BWD))


__all__ = ["Program", "Reference", "make_pool"]
