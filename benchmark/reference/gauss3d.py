"""Plain 3DGS rendering (Kerbl et al. 2023, the repository's 3DGS family),
written from the method's definitions.

- A Gaussian of centre p, rotation R and scales s has the covariance
  R diag(s^2) R^T; the EWA projection J W Sigma W^T J^T, J the perspective
  Jacobian at the view-space centre clamped to 1.3 times the half field
  of view, plus 0.3 px^2 on the diagonal (the screen low-pass), gives the
  screen covariance and its inverse, the conic.
- It is drawn where its view depth exceeds the near plane 0.2, the screen
  covariance is positive definite and the disc of radius ceil(3 sqrt of
  the larger eigenvalue) meets the image.
- It reaches every pixel of every tile its box (ceil(3 sigma_x), ceil(3
  sigma_y)) overlaps, in view-depth order (ties in pool order); K1's plain
  version in gauss3d mode blends them (alpha = min(0.99, o exp(-rho / 2))
  from 1/255, a pixel done once T (1 - alpha) < 1e-4, 64-pair windows).
"""
from __future__ import annotations

import torch

from benchmark.reference import losses
from benchmark.reference.adam import adam, adam_state, rates
from benchmark.reference.geometry import Cam, rotation, sh_colors
from benchmark.reference.raster_blend import LO, blend_tiles_train
from benchmark.reference.surfels import NEAR, bin_pairs, tile_box, tiles_of


def project(xyz, quat, scales, cam: Cam):
    """-> (conic (P, 3) a, b, c of the inverse, centre (P, 2), view depth
    (P,), box half-widths (P, 2), drawn (P,))."""
    Rm = rotation(quat)
    Ms = Rm * scales[:, None, :]
    cov = Ms @ Ms.transpose(1, 2)
    t = cam.to_view(xyz)
    z = torch.clamp(t[:, 2], min=1e-6)
    fx, fy = cam.K[0, 0], cam.K[1, 1]
    lx, ly = 1.3 * 0.5 * cam.W / fx, 1.3 * 0.5 * cam.H / fy
    x = torch.clamp(t[:, 0] / z, -lx, lx) * z
    y = torch.clamp(t[:, 1] / z, -ly, ly) * z
    zero = torch.zeros_like(z)
    J = torch.stack([torch.stack([fx / z, zero, -fx * x / (z * z)], -1),
                     torch.stack([zero, fy / z, -fy * y / (z * z)], -1)], 1)
    JW = J @ cam.R
    S = JW @ cov @ JW.transpose(1, 2)
    a, b, c = S[:, 0, 0] + 0.3, S[:, 0, 1], S[:, 1, 1] + 0.3
    det = a * c - b * b
    inv = torch.where(det > 0, det, torch.ones_like(det))
    conic = torch.stack([c / inv, -b / inv, a / inv], -1)
    h = cam.pixel_matrix()
    ph = xyz @ h[:, :3].T + h[:, 3]
    w = ph[:, 2]
    centre = ph[:, :2] / torch.where(w == 0, torch.ones_like(w), w)[:, None]
    mid = 0.5 * (a + c)
    radius = torch.ceil(3.0 * torch.sqrt(mid + torch.sqrt(
        torch.clamp(mid * mid - det, min=0.1))))
    half = torch.ceil(3.0 * torch.sqrt(torch.clamp(torch.stack([a, c], -1),
                                                   min=0.0)))
    drawn = ((t[:, 2] > NEAR) & (det > 0)
             & (centre[:, 0] + radius >= 0)
             & (centre[:, 0] - radius <= cam.W - 1)
             & (centre[:, 1] + radius >= 0)
             & (centre[:, 1] - radius <= cam.H - 1))
    return conic, centre, t[:, 2], half, drawn


def render(pool: dict, cam: Cam, degree: int, active) -> torch.Tensor:
    """The (H, W, 3) image of a pool of raw parameters (log scales, logit
    opacities, SH coefficients), differentiable in each of them."""
    P = pool["xyz"].shape[0]
    tx, ty = tiles_of(cam.H, cam.W)
    sh = torch.cat([pool["features_dc"], pool["features_rest"]], 1)
    colors = sh_colors(sh, pool["xyz"], cam.center, degree)
    conic, centre, depth, half, drawn = project(
        pool["xyz"], pool["rotation"], torch.exp(pool["scaling"]), cam)
    drawn = drawn & active
    with torch.no_grad():
        order, slots, bounds = bin_pairs(
            depth, drawn, tile_box(centre, half, tx, ty), tx, ty)
    zeros = depth.new_zeros((P, 5))
    table = torch.cat([conic, depth[:, None], zeros, centre,
                       (torch.sigmoid(pool["opacity"][:, 0]) * drawn)[:, None],
                       zeros[:, :3], colors], 1)[order]
    table = torch.nn.functional.pad(table, (0, LO - table.shape[1], 0, 1))
    img, _ = blend_tiles_train(table, None, slots, bounds, 3, tx, ty,
                               mode="gauss3d")
    img = img[:, :cam.H, :cam.W]
    return img[:3].permute(1, 2, 0)



FIELDS = ("xyz", "features_dc", "features_rest", "scaling", "rotation",
          "opacity", "specular", "roughness")


class Step:
    """3DGS's training step: (1 - w) L1 + w (1 - SSIM) of the rendered
    image against the view's target, its gradient by autograd (the blend's
    through K2's plain version), Adam at the rates of the iteration that
    the optimizer's step count names. `state0`, `step(state, k) -> (state,
    {"loss"})` the episode's k-th step (view k mod views), `leaves` and
    `moments` {field: tensor}."""

    def __init__(self, cfg: dict, traffic: dict, inputs):
        self.cfg, self.inputs = cfg, inputs
        pool = {k: inputs.scene[k].clone() for k in FIELDS}
        self.active = torch.zeros(cfg["pool_cap"], dtype=torch.bool,
                                  device=pool["xyz"].device)
        self.active[:cfg["num_gs"]] = True
        self.state0 = dict(pool=pool, opt=adam_state(pool,
                                                     traffic["start_iter"]))

    def step(self, state: dict, k: int):
        cfg = self.cfg
        i = k % len(self.inputs.views)
        K, R, T = self.inputs.views[i]
        pool = {f: v.detach().requires_grad_(True)
                for f, v in state["pool"].items()}
        rgb = render(pool, Cam(cfg["height"], cfg["width"], K, R, T),
                     cfg["sh_degree"], self.active)
        gt, w = self.inputs.targets[i], cfg["ssim_weight"]
        loss = ((1 - w) * (rgb - gt).abs().mean()
                + w * (1.0 - losses.ssim(rgb, gt)))
        grads = torch.autograd.grad(loss, list(pool.values()),
                                    allow_unused=True)
        grads = {f: torch.zeros_like(pool[f]) if g is None else g
                 for f, g in zip(FIELDS, grads)}
        new, opt = adam(state["pool"], grads, state["opt"],
                        rates(state["opt"]["step"]))
        return dict(pool=new, opt=opt), {"loss": loss.detach()}

    @staticmethod
    def leaves(state) -> dict:
        return dict(state["pool"])

    @staticmethod
    def moments(state) -> dict:
        return dict(state["opt"]["m"])
