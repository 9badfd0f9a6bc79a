"""The two sides of an EnvGS training cell with the reflection on (the
"train" loop).

`Program` is `envgs_train.Program`, the same `train/trainer.py::
make_train_step` path, with the env cull's per-tile cap from the
configuration (`env_per_tile_cap`); a step is bad where its loss is not
finite or any capacity counter is positive: base pairs past `pair_cap`,
env slots past `env_pair_cap` (`trace_dropped`), env chunks past the
per-tile cap (`trace_cut`). `Reference` is the plain reference's step
with the reflection on (`benchmark.reference.envgs_refl`), whose cull has
no cap.
"""
from __future__ import annotations

import torch

from benchmark import counts, counts_trace
from benchmark.families import envgs_train
from benchmark.reference.envgs_refl import ReflStep as Reference


class Program(envgs_train.Program):

    def __init__(self, cfg: dict, traffic: dict, inputs):
        super().__init__(cfg, traffic, inputs)
        _, EnvGSConfig, trainer, LRConfig, LossConfig, Camera = \
            envgs_train._program()
        K, R, T = inputs.views[0]
        cam = Camera(cfg["height"], cfg["width"], K, R, T, cfg["znear"],
                     cfg["zfar"])
        model = EnvGSConfig(
            specular_channels=cfg["specular_channels"],
            reflection_start_iter=cfg["reflection_start_iter"],
            pair_cap=cfg["pair_cap"], env_pair_cap=cfg["env_pair_cap"],
            env_per_tile_cap=cfg["env_per_tile_cap"])
        loss = LossConfig(**{**cfg["loss"], "perc_loss_weight": 0.0})
        lr = LRConfig(**cfg["lr"])
        self._step = trainer.make_train_step(cam, model, loss, lr, lr,
                                             has_norm=True)

    def step(self, state, k: int, mark=None):
        i = k % len(self.batches)
        K, R, T = self.inputs.views[i]
        kw = {} if mark is None else {"mark": mark}
        state, stats = self._step(state, self.batches[i], K, R, T,
                                  self.traffic["start_iter"] + k, **kw)
        bad = (~torch.isfinite(stats["loss"]) | (stats["pair_overflow"] > 0)
               | (stats["trace_dropped"] > 0) | (stats["trace_cut"] > 0))
        return state, {"loss": stats["loss"], "bad": bad}

    def ops_per_step(self, cfg: dict, walks: list) -> float | None:
        """The base step's operations (`envgs_train.Program`) and the env
        pass's from the reference's trace walks (the mean over its steps):
        K3 and K4 on the (slot, ray) evaluations that contribute, the env
        set's per-splat work (SH colours, its table's rotation) forward and
        backward."""
        base = super().ops_per_step(cfg, walks)
        tw = [w for w in walks if w["blend"] == "trace"]
        if base is None or not tw:
            return None
        blends = sum(counts_trace.trace_fwd(w)[1] + counts_trace.trace_bwd(w)[1]
                     for w in tw) / len(tw)
        splats = (cfg["env_max_gs"] * (counts.OPS_SH3 + counts.OPS_ROT)
                  * (1 + counts.BWD))
        return base + blends + splats


__all__ = ["Program", "Reference"]
