"""EnvGS's training step before the reflection starts, in plain PyTorch,
from the method's definitions (Xie et al. 2024, the sedan recipe on
configs/models/envgs.yaml).

Before `reflection_start_iter` the image is the base pass's colour alone:
the environment set is not traced, so its parameters get no gradient and
Adam leaves them where they are. The loss is the recipe's: 0.8 L1 + 0.2
(1 - SSIM) of the image, 0.04 times 2DGS's normal consistency and 0.01
times the monocular normal prior's loss, both weighted by the depth. Its
gradient comes from autograd through the surfels' projection, SH colours
and the plain blend with its hand-written backward (K2's plain version,
which rebuilds the transmittance as the packages do). From the
reflection's start the env pass would need a plain tracer, which this
reference does not have (the program's env cull drops candidates there,
ROADMAP Queue 3 item 9): the step refuses.
"""
from __future__ import annotations

import torch

from benchmark.reference import losses
from benchmark.reference.adam import adam, adam_state, rates
from benchmark.reference.geometry import Cam
from benchmark.reference.surfels import base_pass

FIELDS = ("xyz", "features_dc", "features_rest", "scaling", "rotation",
          "opacity", "specular", "roughness")


class BaseStep:
    """`state0`, `step(state, k) -> (state, {"loss"})` the episode's k-th
    step (view k mod views, iteration start + k), `leaves` and `moments`
    {"pool.field": tensor}."""

    def __init__(self, cfg: dict, traffic: dict, inputs):
        self.cfg, self.traffic, self.inputs = cfg, traffic, inputs
        w = cfg["loss"]
        assert w["img_loss_type"] == "L1" and w["use_dpt_scale_gs_norm_loss"]
        assert w["use_dpt_scale_norm_loss"] and w["gs_dist_loss_weight"] == 0
        self.w = w
        pools = {p: {k: inputs.scene[p][k].clone() for k in FIELDS}
                 for p in ("base", "env")}
        start = traffic["start_iter"]
        self.state0 = dict(pools, opt_base=adam_state(pools["base"], start),
                           opt_env=adam_state(pools["env"], start))

    def loss(self, base: dict, k: int) -> torch.Tensor:
        cfg, w = self.cfg, self.w
        it = self.traffic["start_iter"] + k
        if it >= cfg["reflection_start_iter"]:
            raise NotImplementedError("the reference has no env pass")
        i = k % len(self.inputs.views)
        K, R, T = self.inputs.views[i]
        cam = Cam(cfg["height"], cfg["width"], K, R, T)
        b = base_pass(base, cam, cfg["sh_degree"])
        gt = self.inputs.targets[i]
        loss = (w["img_loss_weight"] * (b["rgb"] - gt).abs().mean()
                + w["ssim_loss_weight"] * (1.0 - losses.ssim(b["rgb"], gt)))
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
        base = {f: v.detach().requires_grad_(True)
                for f, v in state["base"].items()}
        loss = self.loss(base, k)
        grads = dict(zip(FIELDS, torch.autograd.grad(loss, list(base.values()),
                                                     allow_unused=True)))
        grads = {f: torch.zeros_like(base[f]) if g is None else g
                 for f, g in grads.items()}
        lr = rates(it, self.cfg["lr"]["reflection_start_iter"],
                   self.cfg["lr"]["normal_prop_until_iter"])
        new_base, opt_base = adam(state["base"], grads, state["opt_base"], lr)
        zero = {f: torch.zeros_like(v) for f, v in state["env"].items()}
        new_env, opt_env = adam(state["env"], zero, state["opt_env"], lr)
        return (dict(base=new_base, env=new_env, opt_base=opt_base,
                     opt_env=opt_env), {"loss": loss.detach()})

    @staticmethod
    def leaves(state) -> dict:
        return {f"{p}.{f}": v for p in ("base", "env")
                for f, v in state[p].items()}

    @staticmethod
    def moments(state) -> dict:
        return {f"{p}.{f}": v for p in ("base", "env")
                for f, v in state["opt_" + p]["m"].items()}
