"""Training losses (port of the single-image path of
envgs_tpu/train/supervisor.py).

The EnvGS loss stack: image loss against the bg-composed ground truth,
SSIM, normal consistency (rendered against depth-derived), the monocular
normal prior, distortion, env-opacity sparsity and the mask loss, each
behind its weight and its start iteration. The JAX package's band-parallel
SSIM, LPIPS and chained aux supervisors are not ported.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from envgs_tpu_torch.models.envgs import EnvGSOutput
from envgs_tpu_torch.ops.losses import cos_sim, l1, psnr, ssim
from envgs_tpu_torch.utils.transforms import normalize


class LossConfig(NamedTuple):
    """envgs.yaml supervisor_cfg defaults (the JAX package's fields;
    perc_loss_* stay inert: LPIPS is not ported)."""

    img_loss_weight: float = 0.8
    img_loss_type: str = "L1"
    ssim_loss_weight: float = 0.2
    # normal consistency (rendered vs depth-derived)
    gs_norm_loss_weight: float = 0.04
    gs_norm_loss_start_iter: int = 0
    use_dpt_scale_gs_norm_loss: bool = True
    use_acc_scale_gs_norm_loss: bool = False
    # monocular normal prior
    norm_loss_weight: float = 0.01
    norm_loss_start_iter: int = 0
    use_dpt_scale_norm_loss: bool = True
    use_acc_scale_norm_loss: bool = False
    # distortion
    gs_dist_loss_weight: float = 0.0
    gs_dist_loss_start_iter: int = 3000
    # env opacity sparsity
    env_opacity_loss_weight: float = 0.0
    env_opacity_loss_type: str = "sparse"
    env_opacity_loss_start_iter: int = 0
    # mask loss
    msk_loss_weight: float = 0.0
    msk_loss_start_iter: int = 7000
    # perceptual (needs LPIPS weights the repository does not hold)
    perc_loss_weight: float = 0.01
    perc_loss_start_iter: int = 21000


def _quantile_bisect(d: torch.Tensor, ps, iters: int = 30) -> torch.Tensor:
    """Quantiles of d at the levels ps by 30 halvings of [min, max] on the
    empirical CDF (the JAX package's iterates)."""
    lo, hi = torch.min(d), torch.max(d)
    n = float(d.numel())
    ps = torch.as_tensor(ps, dtype=torch.float32, device=d.device)
    los = lo.expand(ps.shape).clone()
    his = hi.expand(ps.shape).clone()
    flat = d.reshape(-1, 1)
    for _ in range(iters):
        mid = 0.5 * (los + his)
        cnt = torch.sum(flat <= mid, dim=0).to(torch.float32)
        go_hi = cnt / n < ps
        los, his = torch.where(go_hi, mid, los), torch.where(go_hi, his, mid)
    return 0.5 * (los + his)


def normalize_depth_map(d: torch.Tensor, p: float = 0.01) -> torch.Tensor:
    """Inverse-normalized depth in [0, 1] between the p and 1-p quantiles."""
    q = _quantile_bisect(d, [p, 1.0 - p])
    near, far = q[0], q[1]
    span = torch.where(far - near == 0, torch.ones_like(far), far - near)
    return torch.clamp(1.0 - (d - near) / span, 0.0, 1.0)


def compute_losses(
    out: EnvGSOutput,
    gt_rgb: torch.Tensor,  # (H, W, 3)
    gt_msk: torch.Tensor,  # (H, W, 1)
    gt_norm: torch.Tensor | None,  # (H, W, 3) in [0, 1] encoding, or None
    R: torch.Tensor,  # (3, 3) world->view rotation
    it: int,
    cfg: LossConfig,
    bg_brightness: float = 0.0,
):
    """-> (total loss, stats dict of 0-d tensors)."""
    stats = {}
    itf = float(it)
    loss = gt_rgb.new_zeros(())

    gt = gt_rgb + bg_brightness * (1.0 - gt_msk)
    rgb = out.rgb_map
    stats["psnr"] = psnr(rgb, gt).detach()
    if cfg.img_loss_weight > 0:
        if cfg.img_loss_type == "L1":
            img_loss = l1(rgb, gt)
        elif cfg.img_loss_type == "L2":
            img_loss = torch.mean((rgb - gt) ** 2)
        elif cfg.img_loss_type == "CHARB":
            img_loss = torch.mean(torch.sqrt((rgb - gt) ** 2 + 1e-6))
        elif cfg.img_loss_type == "HUBER":
            d = torch.abs(rgb - gt)
            img_loss = torch.mean(torch.where(d < 1.0, 0.5 * d * d, d - 0.5))
        else:
            raise ValueError(cfg.img_loss_type)
        stats["img_loss"] = img_loss
        loss = loss + cfg.img_loss_weight * img_loss

    if cfg.ssim_loss_weight > 0:
        ssim_loss = 1.0 - ssim(rgb, gt)
        stats["ssim_loss"] = ssim_loss
        loss = loss + cfg.ssim_loss_weight * ssim_loss

    if cfg.gs_norm_loss_weight > 0:
        gl = 1.0 - torch.sum(out.norm_map * out.surf_norm_map, dim=-1)
        if cfg.use_acc_scale_gs_norm_loss:
            gl = gl * out.acc_map[..., 0].detach()
        if cfg.use_dpt_scale_gs_norm_loss:
            gl = gl * normalize_depth_map(out.dpt_map[..., 0].detach())
        gl = torch.mean(gl)
        stats["gs_norm_loss"] = gl
        if itf >= cfg.gs_norm_loss_start_iter:
            loss = loss + cfg.gs_norm_loss_weight * gl

    if cfg.norm_loss_weight > 0 and gt_norm is not None:
        nm = normalize(normalize(out.norm_map) @ R.T)  # world -> view
        ng = normalize(gt_norm * 2.0 - 1.0)
        nl = torch.sum(torch.abs(nm - ng), dim=-1) + (1.0 - cos_sim(nm, ng))
        if cfg.use_acc_scale_norm_loss:
            nl = nl * out.acc_map[..., 0].detach()
        if cfg.use_dpt_scale_norm_loss:
            nl = nl * normalize_depth_map(out.dpt_map[..., 0].detach())
        nl = torch.mean(nl)
        stats["norm_loss"] = nl
        if itf >= cfg.norm_loss_start_iter:
            loss = loss + cfg.norm_loss_weight * nl

    if cfg.gs_dist_loss_weight > 0:
        dl = torch.mean(out.dist_map)
        stats["gs_dist_loss"] = dl
        if itf >= cfg.gs_dist_loss_start_iter:
            loss = loss + cfg.gs_dist_loss_weight * dl

    if cfg.env_opacity_loss_weight > 0:
        v = torch.clamp(out.env_opacity, 1e-3, 1 - 1e-3)
        if cfg.env_opacity_loss_type == "sparse":
            el = torch.mean(torch.log(v) + torch.log(1 - v))
        else:
            el = torch.mean(torch.abs(1 - v))
        stats["env_opacity_loss"] = el
        if itf >= cfg.env_opacity_loss_start_iter:
            loss = loss + cfg.env_opacity_loss_weight * el

    if cfg.msk_loss_weight > 0:
        ml = torch.mean((out.acc_map - gt_msk) ** 2)
        stats["msk_loss"] = ml
        if itf >= cfg.msk_loss_start_iter:
            loss = loss + cfg.msk_loss_weight * ml

    stats["loss"] = loss
    return loss, {k: v.detach() for k, v in stats.items()}
