"""Training losses (port of the single-image path of
envgs_tpu/train/supervisor.py).

The EnvGS loss stack: image loss against the bg-composed ground truth,
SSIM, normal consistency (rendered against depth-derived), the monocular
normal prior, distortion, env-opacity sparsity, the mask loss and the
perceptual loss (LPIPS, ops/lpips.py, when VGG16 weights exist), each
behind its weight and its start iteration, then the chained aux
supervisors (train/aux_supervisors.py) of an AuxLossConfig. With `band`
the inputs are one horizontal band of the image on one rank of the bands'
axis, and the windowed and image-global terms are made band-exact, as the
JAX package makes them.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from envgs_tpu_torch.models.envgs import EnvGSOutput
from envgs_tpu_torch.ops.losses import cos_sim, l1, psnr, ssim, ssim_masked
from envgs_tpu_torch.parallel.collectives import (
    axis_index,
    pmax,
    pmin,
    ppermute,
    psum,
)
from envgs_tpu_torch.train.aux_supervisors import compute_aux_losses
from envgs_tpu_torch.utils.transforms import normalize


class LossConfig(NamedTuple):
    """envgs.yaml supervisor_cfg defaults (the JAX package's fields)."""

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
    # perceptual (inert without VGG16 weights, ops/lpips.py)
    perc_loss_weight: float = 0.01
    perc_loss_start_iter: int = 21000


def _quantile_bisect(d: torch.Tensor, ps, axis_name=None,
                     iters: int = 30) -> torch.Tensor:
    """Quantiles of d at the levels ps by 30 halvings of [min, max] on the
    empirical CDF (the JAX package's iterates). With `axis_name` (a
    parallel.collectives.Axis) d is one band of an image and the bounds
    and counts are the image's (pmin / pmax / psum over the axis): every
    band runs the single image's iterates."""
    d = d.detach()
    lo, hi = torch.min(d), torch.max(d)
    n = torch.tensor(float(d.numel()), dtype=torch.float32, device=d.device)
    if axis_name is not None:
        lo, hi = pmin(lo, axis_name), pmax(hi, axis_name)
        n = psum(n, axis_name)
    ps = torch.as_tensor(ps, dtype=torch.float32, device=d.device)
    los = lo.expand(ps.shape).clone()
    his = hi.expand(ps.shape).clone()
    flat = d.reshape(-1, 1)
    for _ in range(iters):
        mid = 0.5 * (los + his)
        cnt = torch.sum(flat <= mid, dim=0).to(torch.float32)
        if axis_name is not None:
            cnt = psum(cnt, axis_name)
        go_hi = cnt / n < ps
        los, his = torch.where(go_hi, mid, los), torch.where(go_hi, his, mid)
    return 0.5 * (los + his)


def normalize_depth_map(d: torch.Tensor, p: float = 0.01,
                        axis_name=None) -> torch.Tensor:
    """Inverse-normalized depth in [0, 1] between the p and 1-p quantiles
    (of the whole image with `axis_name`: d is then one band of it)."""
    q = _quantile_bisect(d, [p, 1.0 - p], axis_name)
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
    lpips_fn=None,
    aux_cfg=None,  # AuxLossConfig | None: the chained aux supervisors
    gt_dpt: torch.Tensor | None = None,  # (H, W, 1) metric depth prior
    band: tuple | None = None,  # (axis, n_bands, H_global): band-exact
):
    """-> (total loss, stats dict of 0-d tensors).

    With `band`, the inputs are one band of rows on one rank of the axis
    (a parallel.collectives.Axis) and the windowed and global terms are
    band-exact: SSIM exchanges win // 2-row halos with the neighbouring
    bands (each window of the image computed by exactly one band, the
    share scaled so that the caller's pmean equals the image's value) and
    the depth normalization's quantiles are the image's. The pmean of
    every term over the axis is then the single image's, the `psnr` stat
    excepted: it stays a band's.

    `lpips_fn(rgb, gt)` is the perceptual loss (None: off), which enters
    the loss only past perc_loss_start_iter (strictly, as in the JAX
    package; before that it is evaluated for its stat alone, without a
    graph). `aux_cfg` adds every enabled aux supervisor on the rendered
    depth, accumulation and `gt_dpt`; its stats take the `aux_` prefix."""
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
        if band is None:
            ssim_loss = 1.0 - ssim(rgb, gt)
        else:
            axis, n_bands, H_g = band
            k = 11 // 2
            h = rgb.shape[0]
            z = torch.cat([rgb, gt], dim=-1)
            fwd = [(i, i + 1) for i in range(n_bands - 1)]
            bwd = [(i + 1, i) for i in range(n_bands - 1)]
            z_ext = torch.cat([ppermute(z[-k:], axis, fwd), z,
                               ppermute(z[:k], axis, bwd)], dim=0)
            grow = axis_index(axis) * h + torch.arange(h, device=z.device)
            mask = ((grow >= k) & (grow <= H_g - 1 - k)).to(rgb.dtype)
            n_g = (H_g - 2 * k) * (rgb.shape[1] - 2 * k) * rgb.shape[2]
            share = ssim_masked(z_ext[..., :3], z_ext[..., 3:],
                                mask[:, None, None], n_g)
            # the caller pmeans the losses over the axis: pmean == psum
            ssim_loss = 1.0 - share * n_bands
        stats["ssim_loss"] = ssim_loss
        loss = loss + cfg.ssim_loss_weight * ssim_loss

    if cfg.gs_norm_loss_weight > 0:
        gl = 1.0 - torch.sum(out.norm_map * out.surf_norm_map, dim=-1)
        if cfg.use_acc_scale_gs_norm_loss:
            gl = gl * out.acc_map[..., 0].detach()
        if cfg.use_dpt_scale_gs_norm_loss:
            gl = gl * normalize_depth_map(
                out.dpt_map[..., 0].detach(),
                axis_name=None if band is None else band[0])
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
            nl = nl * normalize_depth_map(
                out.dpt_map[..., 0].detach(),
                axis_name=None if band is None else band[0])
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

    if cfg.perc_loss_weight > 0 and lpips_fn is not None:
        if itf > cfg.perc_loss_start_iter:
            pl_ = lpips_fn(rgb, gt)
            loss = loss + cfg.perc_loss_weight * pl_
        else:
            with torch.no_grad():
                pl_ = lpips_fn(rgb, gt)
        stats["perc_loss"] = pl_

    if aux_cfg is not None and any(
            isinstance(v, (int, float)) and v > 0 for v in aux_cfg):
        out_d = {"dpt_map": out.dpt_map[..., 0], "acc_map": out.acc_map,
                 "occ": out.acc_map}
        batch_d = {"msk": gt_msk}
        if gt_dpt is not None:
            batch_d["dpt"] = gt_dpt[..., 0]
        aux_loss, aux_stats = compute_aux_losses(aux_cfg, out_d, batch_d, it)
        for k, v in aux_stats.items():
            stats["aux_" + k] = v
        loss = loss + aux_loss

    stats["loss"] = loss
    return loss, {k: v.detach() for k, v in stats.items()}
