"""Auxiliary supervisors: the reference's non-EnvGS loss modules as plain
functions (port of envgs_tpu/train/aux_supervisors.py).

- depth: smooth-L1 / L1 / L2, the scale-and-shift-invariant MSE / MAE
  (MiDaS / MonoSDF) and the scale-invariant log loss (AdaBins);
- flow: weighted L1;
- proposal (mip-NeRF 360): the distortion loss and the outer-measure
  envelope over the proposal levels, the NeRF histogram stop-gradiented;
- temporal (k-planes): plane TV, time-plane smoothness, the t-residual;
- geometry (SDF): eikonal, finite-difference curvature, annealed normal
  smoothness;
- displacement: residual L2 and the Geman-McClure elastic energy over the
  warp Jacobian's singular values;
- masks and motion: mIoU, BCE, occupancy entropy, K-neighbour scene-flow
  agreement.

Masks are {0, 1} float tensors and every reduction is a mask-weighted mean
(no boolean indexing), as in the JAX package. `compute_aux_losses` folds
every branch whose weight is positive and whose inputs are present into
one loss and a stats dict.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

# ---------------------------------------------------------------------------
# Depth losses (DepthSupervisor)
# ---------------------------------------------------------------------------


def smoothl1(x, y, mask=None):
    """F.smooth_l1_loss (beta = 1): 0.5 d^2 for |d| < 1, else |d| - 0.5."""
    d = x - y
    ad = torch.abs(d)
    v = torch.where(ad < 1.0, 0.5 * d * d, ad - 0.5)
    if mask is None:
        return torch.mean(v)
    return torch.sum(v * mask) / torch.clamp(torch.sum(mask), min=1.0)


def compute_scale_and_shift(pred, tgt, mask):
    """Least-squares (s, t) aligning pred to tgt on the mask, (H, W) maps;
    (0, 0) where the system is singular."""
    a00 = torch.sum(mask * pred * pred)
    a01 = torch.sum(mask * pred)
    a11 = torch.sum(mask)
    b0 = torch.sum(mask * pred * tgt)
    b1 = torch.sum(mask * tgt)
    det = a00 * a11 - a01 * a01
    ok = torch.abs(det) > 1e-12
    det = torch.where(ok, det, torch.ones_like(det))
    zero = torch.zeros_like(det)
    s = torch.where(ok, (a11 * b0 - a01 * b1) / det, zero)
    t = torch.where(ok, (-a01 * b0 + a00 * b1) / det, zero)
    return s, t


def _gradient_loss(diff, mask):
    """The masked gradient-matching term at one scale."""
    d = diff * mask
    gx = torch.abs(d[:, 1:] - d[:, :-1]) * (mask[:, 1:] * mask[:, :-1])
    gy = torch.abs(d[1:, :] - d[:-1, :]) * (mask[1:, :] * mask[:-1, :])
    return torch.sum(gx) + torch.sum(gy)


def scale_shift_invariant_loss(pred, tgt, mask, alpha: float = 0.5,
                               scales: int = 4, kind: str = "mse"):
    """pred aligned to tgt by compute_scale_and_shift, the masked MSE (or
    MAE) of the residual plus alpha times its gradient term over `scales`
    strides (1, 2, 4, ...)."""
    s, t = compute_scale_and_shift(pred, tgt, mask)
    res = s * pred + t - tgt
    M = torch.sum(mask)
    err = res * res if kind == "mse" else torch.abs(res)
    data = torch.sum(mask * err) / torch.clamp(2.0 * M, min=1.0)
    reg = 0.0
    for sc in range(scales):
        step = 2 ** sc
        reg = reg + _gradient_loss(res[::step, ::step], mask[::step, ::step])
    return data + alpha * reg / torch.clamp(M, min=1.0)


def _max0(x):
    """max(x, 0) with the JAX package's gradient at a tie: half (the mean
    of relu's 0 and clamp's 1), e.g. at a hole (0) of a depth prior."""
    return 0.5 * (torch.relu(x) + torch.clamp(x, min=0.0))


def scale_invariant_log_loss(pred, tgt, mask, alpha: float = 10.0,
                             beta: float = 0.15, eps: float = 1e-8):
    """alpha sqrt(var(g) + beta mean(g)^2), g = log(pred) - log(tgt) over
    the masked pixels."""
    n = torch.clamp(torch.sum(mask), min=1.0)
    g = (torch.log(_max0(pred) + eps) - torch.log(_max0(tgt) + eps)) * mask
    mean_g = torch.sum(g) / n
    var_g = torch.sum(mask * (g - mean_g) ** 2) / n
    return alpha * torch.sqrt(torch.clamp(var_g + beta * mean_g ** 2,
                                          min=1e-12))


def depth_loss(dpt_map, dpt_gt, mask=None, kind: str = "smoothl1", **kw):
    """The depth loss of `kind` (smoothl1, l1, l2, ssimse, ssimae, silog);
    the mask defaults to dpt_gt != 0."""
    if mask is None:
        mask = dpt_gt != 0
    mask = mask.to(torch.float32)
    n = torch.clamp(torch.sum(mask), min=1.0)
    if kind == "smoothl1":
        return smoothl1(dpt_map, dpt_gt, mask)
    if kind == "l1":
        return torch.sum(torch.abs(dpt_map - dpt_gt) * mask) / n
    if kind == "l2":
        return torch.sum((dpt_map - dpt_gt) ** 2 * mask) / n
    if kind in ("ssimse", "ssimae"):
        return scale_shift_invariant_loss(
            dpt_map, dpt_gt, mask, kind="mse" if kind == "ssimse" else "mae",
            **kw)
    if kind == "silog":
        return scale_invariant_log_loss(dpt_map, dpt_gt, mask, **kw)
    raise ValueError(f"unknown depth loss kind {kind!r}")


# ---------------------------------------------------------------------------
# Flow (FlowSupervisor)
# ---------------------------------------------------------------------------


def flow_loss(flo_map, flow_gt, flow_weight=None):
    """L1 of the flow map, weighted by flow_weight when given."""
    d = torch.abs(flo_map - flow_gt)
    if flow_weight is None:
        return torch.mean(d)
    return torch.sum(d * flow_weight) / (torch.sum(flow_weight) + 1e-8)


# ---------------------------------------------------------------------------
# Proposal (ProposalSupervisor), mip-NeRF 360
# ---------------------------------------------------------------------------


def lossfun_distortion(t, w):
    """The distortion loss: the inter-interval term plus the
    intra-interval one. t: (..., S + 1) bin edges, w: (..., S)."""
    ut = 0.5 * (t[..., 1:] + t[..., :-1])
    dut = torch.abs(ut[..., :, None] - ut[..., None, :])
    inter = torch.sum(w * torch.sum(w[..., None, :] * dut, dim=-1), dim=-1)
    intra = torch.sum(w * w * (t[..., 1:] - t[..., :-1]), dim=-1) / 3.0
    return inter + intra


def _searchsorted_pair(t1, t0):
    """For each edge of t0, the indices (lo, hi) into t1 that straddle it."""
    hi = torch.searchsorted(
        t1.reshape(-1, t1.shape[-1]).contiguous(),
        t0.reshape(-1, t0.shape[-1]).contiguous(), right=True,
    ).reshape(t0.shape)
    n = t1.shape[-1] - 1
    hi = torch.clamp(hi, 0, n)
    lo = torch.clamp(hi - 1, 0, n)
    return lo, hi


def inner_outer(t0, t1, y1):
    """(inner, outer) measure of the histogram (t1, y1) on the intervals
    of t0."""
    cy1 = torch.cat([torch.zeros_like(y1[..., :1]), torch.cumsum(y1, dim=-1)],
                    dim=-1)
    idx_lo, idx_hi = _searchsorted_pair(t1, t0)
    cy1_lo = torch.gather(cy1, -1, idx_lo)
    cy1_hi = torch.gather(cy1, -1, idx_hi)
    y0_outer = cy1_hi[..., 1:] - cy1_lo[..., :-1]
    y0_inner = torch.where(idx_hi[..., :-1] <= idx_lo[..., 1:],
                           cy1_lo[..., 1:] - cy1_hi[..., :-1],
                           torch.zeros_like(y0_outer))
    return y0_inner, y0_outer


def lossfun_outer(t, w, t_env, w_env, eps: float = 1.1920929e-07):
    """The proposal envelope loss: NeRF weight above the proposal's outer
    measure, squared, over the weight."""
    _, w_outer = inner_outer(t, t_env, w_env)
    return torch.clamp(w - w_outer, min=0.0) ** 2 / (w + eps)


def proposal_loss(s_vals, weights, s_vals_prop, weights_prop,
                  dist_loss_weight: float = 0.0,
                  prop_loss_weight: float = 1.0):
    """-> (weighted total, stats): the distortion over the NeRF and every
    proposal histogram, and the envelope of each proposal level over the
    stop-gradiented NeRF histogram."""
    stats = {}
    total = 0.0
    if dist_loss_weight > 0:
        dist = torch.mean(lossfun_distortion(s_vals, weights))
        for tp, wp in zip(s_vals_prop, weights_prop):
            dist = dist + torch.mean(lossfun_distortion(tp, wp))
        stats["dist_loss"] = dist
        total = total + dist_loss_weight * dist
    if prop_loss_weight > 0 and len(s_vals_prop):
        t, w = s_vals.detach(), weights.detach()
        prop = 0.0
        for tp, wp in zip(s_vals_prop, weights_prop):
            prop = prop + torch.mean(lossfun_outer(t, w, tp, wp))
        stats["prop_loss"] = prop
        total = total + prop_loss_weight * prop
    return total, stats


# ---------------------------------------------------------------------------
# Temporal (TemporalSupervisor), k-planes regularizers
# ---------------------------------------------------------------------------


def plane_tv(plane):
    """Mean squared first differences along the two trailing (h, w) axes
    of (..., h, w), each axis over its own count, doubled."""
    h, w = plane.shape[-2], plane.shape[-1]
    lead = 1
    for s in plane.shape[:-2]:
        lead *= int(s)
    htv = torch.sum(torch.square(plane[..., 1:, :] - plane[..., :-1, :]))
    wtv = torch.sum(torch.square(plane[..., :, 1:] - plane[..., :, :-1]))
    return 2.0 * (htv / (lead * (h - 1) * w) + wtv / (lead * h * (w - 1)))


def planes_tv(planes):
    return sum(plane_tv(p) for p in planes)


def plane_smoothness(plane):
    """Mean squared second difference along the trailing (time) axis."""
    d1 = plane[..., 1:] - plane[..., :-1]
    d2 = d1[..., 1:] - d1[..., :-1]
    return torch.mean(torch.square(d2))


def time_planes_smooth(planes):
    return sum(plane_smoothness(p) for p in planes)


def t_resd_loss(t_resd):
    """L2 of the time residual."""
    return torch.mean(torch.square(t_resd))


# ---------------------------------------------------------------------------
# Geometry (GeometrySupervisor), SDF regularizers
# ---------------------------------------------------------------------------


def eikonal(grads, th: float = 1.0):
    """((|g| - th)^2).mean()."""
    return torch.mean((torch.linalg.norm(grads, dim=-1) - th) ** 2)


def curvature_loss(sdf, sampled_sdf, delta: float):
    """Mean |finite-difference Laplacian|; sampled_sdf (..., 3, 2) holds
    the +-delta taps along each axis."""
    curv = (torch.sum(sampled_sdf, dim=-1) - 2.0 * sdf[..., None]) / delta ** 2
    return torch.mean(torch.abs(curv))


def norm_smooth_loss(grad_pts, grad_nbr, it, max_weight: float,
                     ann_iter: int = 1, weight_mask=None):
    """-> (loss, weight): the distance of the unit normals of surface
    points and of their jittered neighbours (weight_mask-weighted mean when
    given), and its weight annealed linearly to max_weight over ann_iter
    iterations."""
    nv = grad_pts / (torch.linalg.norm(grad_pts, dim=-1, keepdim=True) + 1e-8)
    nn = grad_nbr / (torch.linalg.norm(grad_nbr, dim=-1, keepdim=True) + 1e-8)
    d = torch.linalg.norm(nv - nn, dim=-1)
    if weight_mask is not None:
        loss = torch.sum(d * weight_mask) / torch.clamp(
            torch.sum(weight_mask), min=1.0)
    else:
        loss = torch.mean(d)
    return loss, min(it, ann_iter) * max_weight / ann_iter


# ---------------------------------------------------------------------------
# Displacement (DisplacementSupervisor)
# ---------------------------------------------------------------------------


def elastic_crit(jac):
    """Geman-McClure elastic energy (scale 0.03) of the log singular
    values of the warp Jacobian, (..., 3, 3) -> (...)."""
    s = torch.linalg.svdvals(jac)
    log_s = torch.log(torch.clamp(s, min=1e-6))
    sq = torch.sum(log_s ** 2, dim=-1)
    scale = 0.03
    return 2.0 * (sq / scale ** 2) / (sq / scale ** 2 + 4.0) * scale ** 2


def displacement_loss(resd=None, jacobian=None, weights=None,
                      resd_loss_weight: float = 0.0,
                      elas_loss_weight: float = 0.0,
                      reduce_by_weight: bool = True):
    """-> (weighted total, stats): the elastic energy (weighted per sample
    by `weights`, summed per ray, averaged) and the residual's L2."""
    stats = {}
    total = 0.0
    if jacobian is not None and elas_loss_weight > 0:
        e = elastic_crit(jacobian)
        if reduce_by_weight and weights is not None:
            e = e * weights.reshape(e.shape)
        e = torch.mean(torch.sum(e.reshape(e.shape[0], -1), dim=-1))
        stats["elas_loss"] = e
        total = total + elas_loss_weight * e
    if resd is not None and resd_loss_weight > 0:
        r = torch.mean(torch.square(resd))
        stats["resd_loss"] = r
        total = total + resd_loss_weight * r
    return total, stats


# ---------------------------------------------------------------------------
# Mask / opacity (MaskSupervisor, OpacitySupervisor)
# ---------------------------------------------------------------------------


def miou_loss(x, y):
    """1 - mean IoU of soft masks, per leading row ((B, N, 1) or (N,));
    the union stop-gradiented."""
    xf = x.reshape(1, -1) if x.ndim <= 1 else x.reshape(x.shape[0], -1)
    yf = y.reshape(1, -1) if y.ndim <= 1 else y.reshape(y.shape[0], -1)
    inter = torch.sum(xf * yf, dim=-1)
    union = torch.sum(xf + yf, dim=-1) - inter
    return 1.0 - torch.mean(inter / (union.detach() + 1e-8))


def bce_loss(pred, tgt, eps: float = 1e-7):
    p = torch.clamp(pred, eps, 1.0 - eps)
    return -torch.mean(tgt * torch.log(p) + (1.0 - tgt) * torch.log(1.0 - p))


def occupancy_entropy(occ, eps: float = 1e-8):
    """-mean(occ log occ)."""
    return -torch.mean(occ * torch.log(torch.clamp(occ, min=eps)))


# ---------------------------------------------------------------------------
# Motion consistency (MotionConsistencySupervisor)
# ---------------------------------------------------------------------------


def motion_consistency_loss(xyz, ms3, mask, K: int = 8, radius: float = 0.1):
    """Mean |scene flow - its K nearest in-ball neighbours' mean flow| over
    the masked rows. Masked-out rows are moved to 1e9 so that no row picks
    them; a row with no neighbour in the ball adds 0."""
    maskf = mask.reshape(-1).to(torch.float32)
    big = 1e9
    p = torch.where(maskf[:, None] > 0, xyz, torch.full_like(xyz, big))
    d2 = torch.sum((p[:, None, :] - p[None, :, :]) ** 2, dim=-1)
    d2 = d2 + torch.eye(p.shape[0], device=p.device) * big  # not itself
    neg, idx = torch.topk(-d2, K, dim=-1)
    valid = ((-neg) <= radius * radius).to(torch.float32)
    has_nbr = (torch.sum(valid, dim=-1) > 0).to(torch.float32)
    nbr = torch.sum(ms3[idx] * valid[..., None], dim=1) / (
        torch.sum(valid, dim=-1, keepdim=True) + 1e-6)
    per = torch.mean(torch.abs(ms3 - nbr), dim=-1) * has_nbr * maskf
    return torch.sum(per) / torch.clamp(torch.sum(maskf), min=1.0)


# ---------------------------------------------------------------------------
# The config-driven aggregate
# ---------------------------------------------------------------------------


class AuxLossConfig(NamedTuple):
    """The aux supervisors' weights; 0 switches a branch off."""
    dpt_loss_weight: float = 0.0
    dpt_loss_kind: str = "smoothl1"
    flow_loss_weight: float = 0.0
    dist_loss_weight: float = 0.0
    prop_loss_weight: float = 0.0
    tv_loss_weight: float = 0.0
    time_smooth_weight: float = 0.0
    t_resd_loss_weight: float = 0.0
    eikonal_loss_weight: float = 0.0
    curvature_loss_weight: float = 0.0
    resd_loss_weight: float = 0.0
    elas_loss_weight: float = 0.0
    msk_loss_weight: float = 0.0
    ent_loss_weight: float = 0.0


def compute_aux_losses(cfg: AuxLossConfig, output: dict, batch: dict,
                       it=0):
    """-> (loss, stats): every branch whose weight is positive and whose
    keys are present (not None) in `output` (and `batch` for the targets),
    weighted and summed."""
    loss = 0.0
    stats = {}

    def have(*ks, d=None):
        src = output if d is None else d
        return all(k in src and src[k] is not None for k in ks)

    if cfg.dpt_loss_weight > 0 and have("dpt_map") and have("dpt", d=batch):
        v = depth_loss(output["dpt_map"], batch["dpt"], kind=cfg.dpt_loss_kind)
        stats["dpt_loss"] = v
        loss = loss + cfg.dpt_loss_weight * v
    if cfg.flow_loss_weight > 0 and have("flo_map") and have("flow", d=batch):
        v = flow_loss(output["flo_map"], batch["flow"],
                      batch.get("flow_weight"))
        stats["flow_loss"] = v
        loss = loss + cfg.flow_loss_weight * v
    if (cfg.prop_loss_weight > 0 or cfg.dist_loss_weight > 0) and have(
            "s_vals", "weights", "s_vals_prop", "weights_prop"):
        v, st = proposal_loss(
            output["s_vals"], output["weights"], output["s_vals_prop"],
            output["weights_prop"], dist_loss_weight=cfg.dist_loss_weight,
            prop_loss_weight=cfg.prop_loss_weight)
        stats.update(st)
        loss = loss + v
    if cfg.tv_loss_weight > 0 and have("spatial_planes"):
        v = planes_tv(output["spatial_planes"])
        stats["tv_loss"] = v
        loss = loss + cfg.tv_loss_weight * v
    if cfg.time_smooth_weight > 0 and have("temporal_planes"):
        v = time_planes_smooth(output["temporal_planes"])
        stats["time_smooth_loss"] = v
        loss = loss + cfg.time_smooth_weight * v
    if cfg.t_resd_loss_weight > 0 and have("t_resd"):
        v = t_resd_loss(output["t_resd"])
        stats["t_resd_loss"] = v
        loss = loss + cfg.t_resd_loss_weight * v
    if cfg.eikonal_loss_weight > 0 and have("gradients"):
        v = eikonal(output["gradients"])
        stats["eikonal_loss"] = v
        loss = loss + cfg.eikonal_loss_weight * v
    if cfg.curvature_loss_weight > 0 and have("sdf", "sampled_sdf",
                                              "finite_diff_delta"):
        v = curvature_loss(output["sdf"], output["sampled_sdf"],
                           output["finite_diff_delta"])
        stats["curvature_loss"] = v
        loss = loss + cfg.curvature_loss_weight * v
    if (cfg.resd_loss_weight > 0 or cfg.elas_loss_weight > 0) and (
            have("resd") or have("jacobian")):
        v, st = displacement_loss(
            resd=output.get("resd"), jacobian=output.get("jacobian"),
            weights=output.get("weights"),
            resd_loss_weight=cfg.resd_loss_weight,
            elas_loss_weight=cfg.elas_loss_weight)
        stats.update(st)
        loss = loss + v
    if cfg.msk_loss_weight > 0 and have("acc_map") and have("msk", d=batch):
        v = miou_loss(output["acc_map"], batch["msk"])
        stats["msk_loss"] = v
        loss = loss + cfg.msk_loss_weight * v
    if cfg.ent_loss_weight > 0 and have("occ"):
        v = occupancy_entropy(output["occ"])
        stats["ent_loss"] = v
        loss = loss + cfg.ent_loss_weight * v
    return loss, stats
