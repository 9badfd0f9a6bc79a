"""EnvGS's training step with the reflection on, in plain PyTorch, from the
method's definitions (Xie et al. 2024, the sedan recipe on
configs/models/envgs.yaml).

From `reflection_start_iter` the image is the composite
rgb = (1 - s) base + s env of the base pass's colour and the env set traced
along the rays reflected off it (`tracer.py`), s the base pass's specular
map. The recipe's filters are off (every pixel is traced). The reflected
ray of a pixel starts where its camera ray meets the base pass's depth,
o + depth d (d through the pixel centre at view depth 1), and leaves in
d - 2 (d.n) n about the unit rendered normal n. The env set's SH colours
are seen from the mean of those origins. The losses are the base step's
(`envgs.py`) on the composite; the gradient reaches both sets, and the
base set also through the rays and the colours' view origin. Adam moves
both sets.
"""
from __future__ import annotations

import torch

from benchmark.reference import losses
from benchmark.reference.adam import adam, rates
from benchmark.reference.envgs import FIELDS, BaseStep
from benchmark.reference.geometry import Cam, sh_colors, unit
from benchmark.reference.surfels import base_pass
from benchmark.reference.tracer import trace


def env_pass(pool: dict, o: torch.Tensor, d: torch.Tensor,
             degree: int) -> dict:
    """The env set traced along the rays o, d (H, W, 3) -> trace's maps."""
    sh = torch.cat([pool["features_dc"], pool["features_rest"]], 1)
    colors = sh_colors(sh, pool["xyz"], o.reshape(-1, 3).mean(0), degree)
    return trace(pool["xyz"], pool["rotation"], torch.exp(pool["scaling"]),
                 torch.sigmoid(pool["opacity"][:, 0]), colors, o, d)


class ReflStep(BaseStep):
    """The base step's interface (`state0`, `step`, `leaves`, `moments`)
    with the reflection on."""

    def loss(self, pools: dict, k: int) -> torch.Tensor:
        cfg, w = self.cfg, self.w
        it = self.traffic["start_iter"] + k
        assert it >= cfg["reflection_start_iter"]
        i = k % len(self.inputs.views)
        K, R, T = self.inputs.views[i]
        cam = Cam(cfg["height"], cfg["width"], K, R, T)
        b = base_pass(pools["base"], cam, cfg["sh_degree"])
        d = cam.pixel_directions(0.5)
        n = unit(b["normal"])
        ref_o = cam.center + d * b["depth"]
        ref_d = d - 2.0 * (d * n).sum(-1, keepdim=True) * n
        e = env_pass(pools["env"], ref_o, ref_d, cfg["sh_degree"])
        rgb = (1.0 - b["spec"]) * b["rgb"] + b["spec"] * e["rgb"]
        gt = self.inputs.targets[i]
        loss = (w["img_loss_weight"] * (rgb - gt).abs().mean()
                + w["ssim_loss_weight"] * (1.0 - losses.ssim(rgb, gt)))
        depth = b["depth"][..., 0]
        if it >= w["gs_norm_loss_start_iter"]:
            loss = loss + w["gs_norm_loss_weight"] * losses.normal_consistency(
                b["normal"], b["surf_normal"], depth)
        if it >= w["norm_loss_start_iter"]:
            loss = loss + w["norm_loss_weight"] * losses.normal_prior(
                b["normal"], self.inputs.norms[i], R, depth)
        return loss

    def step(self, state: dict, k: int):
        it = self.traffic["start_iter"] + k
        pools = {p: {f: v.detach().requires_grad_(True)
                     for f, v in state[p].items()} for p in ("base", "env")}
        loss = self.loss(pools, k)
        leaves = [pools[p][f] for p in ("base", "env") for f in FIELDS]
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(x) if g is None else g
                 for g, x in zip(grads, leaves)]
        lr = rates(it, self.cfg["lr"]["reflection_start_iter"],
                   self.cfg["lr"]["normal_prop_until_iter"])
        new = {}
        for j, p in enumerate(("base", "env")):
            g = dict(zip(FIELDS, grads[j * len(FIELDS):(j + 1) * len(FIELDS)]))
            new[p], new["opt_" + p] = adam(state[p], g, state["opt_" + p], lr)
        return new, {"loss": loss.detach()}
