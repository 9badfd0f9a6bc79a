"""ENeRF image-based model family (port of envgs_tpu/models/enerf.py): a
shared 2D conv encoder over the source views (16 channels at 1/2, 32 at
1/4), a variance plane sweep over depth hypotheses at 1/4 (uniform in
disparity) and then about that depth at 1/2, a 3D conv regularizer to a
softmax depth distribution (depth and its spread), depth-guided samples
rendered by a learned blend of the source colors with a density head, and
quadrature compositing (models/nerf.py::volume_render).

Tensors keep the JAX package's NHWC layout; the convolutions are
`F.conv2d` / `F.conv3d` on NCHW / NCDHW views, the weights stored in JAX's
HWIO / DHWIO layout (so that parameters, Adam moments and `latest.npz`
cross leaf for leaf) and transposed to OIHW / OIDHW at the call. "SAME"
padding is XLA's: a stride-2 3x3 convolution pads (0, 1) on an even size
and (1, 1) on an odd one. TF32 stays off (envgs_tpu_torch/__init__.py). The
family launches no kernel of the repo.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from envgs_tpu_torch.models.nerf import volume_render
from envgs_tpu_torch.models.regressors import MLP, jclip, jmax
from envgs_tpu_torch.train.families import tree_flatten
from envgs_tpu_torch.train.optax_adam import (
    AdamState,
    adam_init,
    adam_update,
    grads_of,
)
from envgs_tpu_torch.utils.camera import Camera

# the 3D convolutions (cost heads): they start positive, so the logits are a
# smoothed mean of the variance and the photoconsistent depth peaks from
# the first step
_CONVS3 = ("cr0a", "cr0b", "cr1a", "cr1b")


def _same_pad(size: int, k: int, stride: int) -> tuple:
    """XLA's SAME padding of one axis -> (before, after)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _conv(x: torch.Tensor, p, stride: int = 1) -> torch.Tensor:
    """x (N, H, W, Cin), p = [w (kh, kw, Cin, Cout), b] -> (N, H', W',
    Cout), SAME as XLA pads it."""
    w, b = p
    kh, kw = w.shape[:2]
    ph = _same_pad(x.shape[1], kh, stride)
    pw = _same_pad(x.shape[2], kw, stride)
    xn = F.pad(x.permute(0, 3, 1, 2), (pw[0], pw[1], ph[0], ph[1]))
    y = F.conv2d(xn, w.permute(3, 2, 0, 1), stride=stride)
    return y.permute(0, 2, 3, 1) + b


def _conv3(x: torch.Tensor, p) -> torch.Tensor:
    """x (N, D, H, W, Cin), p = [w (k, k, k, Cin, Cout), b], stride 1 SAME
    (symmetric) -> (N, D, H, W, Cout)."""
    w, b = p
    y = F.conv3d(x.permute(0, 4, 1, 2, 3), w.permute(4, 3, 0, 1, 2),
                 padding=w.shape[0] // 2)
    return y.permute(0, 2, 3, 4, 1) + b


class ENeRFConfig(NamedTuple):
    """Static hyperparameters (CostVolumeSampler's defaults, two levels)."""

    feat_dims: tuple = (16, 32)  # channels at 1/2, 1/4
    n_planes: tuple = (64, 8)  # depth hypotheses per level
    n_samples: int = 4  # color samples about the regressed depth
    cost_dim: int = 8  # the 3D regularizer's width
    ibr_hidden: int = 32
    guide_sigma: float = 3.0  # samples within +- guide_sigma * std
    bg_brightness: float = 0.0

    def init(self, generator: torch.Generator | None = None,
             device=None) -> "ENeRFNetwork":
        return ENeRFNetwork(self, generator, device)


class ENeRFNetwork(nn.Module):
    """The encoder (`fe0`, `fe0b`, `fe1`, `fe1b`), the cost regularizers
    (`cr0a`, `cr0b` at 1/4; `cr1a`, `cr1b` at 1/2), each [w, b] in JAX's
    layout, and the IBR heads `agg` (per-view blend logit), `sig` /
    `sig_out` (density), `rgb_res` (a tanh residual). Convolution weights
    start at N(0, 2 / fan_in) (the cost heads' |w| + 1 / fan_in), biases at
    0. JAX's parameters: the dict of those twelve."""

    def __init__(self, cfg: ENeRFConfig,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        f0, f1 = cfg.feat_dims
        c = cfg.cost_dim
        shapes = dict(fe0=(3, 3, 3, f0), fe0b=(3, 3, f0, f0),
                      fe1=(3, 3, f0, f1), fe1b=(3, 3, f1, f1),
                      cr0a=(3, 3, 3, f1, c), cr0b=(3, 3, 3, c, 1),
                      cr1a=(3, 3, 3, f0, c), cr1b=(3, 3, 3, c, 1))
        convs = {}
        for name, shape in shapes.items():
            fan_in = math.prod(shape[:-1])
            w = torch.randn(shape, generator=generator,
                            device=device) * math.sqrt(2.0 / fan_in)
            if name in _CONVS3:
                w = torch.abs(w) + 1.0 / fan_in
            convs[name] = nn.ParameterList([
                nn.Parameter(w),
                nn.Parameter(torch.zeros(shape[-1], device=device))])
        self.convs = nn.ModuleDict(convs)
        h = cfg.ibr_hidden
        kw = dict(skips=(), generator=generator, device=device)
        self.agg = MLP(2 * (f0 + 3) + 1, h, 1, 1, **kw)
        self.sig = MLP(2 * (f0 + 3), h, 1, h, **kw)
        self.sig_out = MLP(h, h, 0, 1, **kw)
        self.rgb_res = MLP(h + 3, h, 1, 3, out_actvn="tanh", **kw)

    def __getitem__(self, name: str):
        return self.convs[name]

    def jax_params(self) -> dict:
        tree = {k: list(p) for k, p in self.convs.items()}
        for name in ("agg", "sig", "sig_out", "rgb_res"):
            tree[name] = getattr(self, name).jax_params()
        return tree

    @torch.no_grad()
    def load_jax(self, params: dict):
        for k, p in self.convs.items():
            for t, a in zip(p, params[k]):
                t.copy_(torch.tensor(np.asarray(a)))
        for name in ("agg", "sig", "sig_out", "rgb_res"):
            getattr(self, name).load_jax(params[name])


def enerf_params_from_jax(params: dict, cfg: ENeRFConfig,
                          device=None) -> ENeRFNetwork:
    """JAX's parameter dict (numpy or JAX arrays; convolutions [w, b] in
    HWIO / DHWIO, the heads [(w, b), ...]) -> the port's network."""
    net = ENeRFNetwork(cfg, device=device)
    net.load_jax(params)
    return net


def feature_net(net: ENeRFNetwork, imgs: torch.Tensor) -> list:
    """(S, H, W, 3) -> [(S, H/2, W/2, f0), (S, H/4, W/4, f1)] (sizes
    rounded up)."""
    x = torch.relu(_conv(imgs, net["fe0"], stride=2))
    l0 = torch.relu(_conv(x, net["fe0b"]))
    x = torch.relu(_conv(l0, net["fe1"], stride=2))
    l1 = torch.relu(_conv(x, net["fe1b"]))
    return [l0, l1]


def _scaled_K(K: torch.Tensor, sx: float, sy: float) -> torch.Tensor:
    S = torch.tensor([[sx, 0, 0], [0, sy, 0], [0, 0, 1]],
                     dtype=K.dtype, device=K.device)
    return S @ K


def _bilinear(img: torch.Tensor, x: torch.Tensor,
              y: torch.Tensor) -> torch.Tensor:
    """img (H, W, C); x / y (...,) pixel coordinates -> (..., C), zeros
    outside [0, W-1] x [0, H-1]; the corners floor(x), floor(x) + 1
    clipped to the image."""
    H, W = img.shape[:2]
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx = x - x0
    wy = y - y0
    # clamping the float first equals JAX's int cast then clip for every
    # finite coordinate (the cast of an out-of-range float is undefined)
    x0i = torch.clamp(x0, 0, W - 1).to(torch.int64)
    x1i = torch.clamp(x0i + 1, 0, W - 1)
    y0i = torch.clamp(y0, 0, H - 1).to(torch.int64)
    y1i = torch.clamp(y0i + 1, 0, H - 1)
    v = (img[y0i, x0i] * ((1 - wx) * (1 - wy))[..., None]
         + img[y0i, x1i] * (wx * (1 - wy))[..., None]
         + img[y1i, x0i] * ((1 - wx) * wy)[..., None]
         + img[y1i, x1i] * (wx * wy)[..., None])
    inside = (x >= 0) & (x <= W - 1) & (y >= 0) & (y <= H - 1)
    return v * inside[..., None]


def _project(pts: torch.Tensor, K: torch.Tensor, R: torch.Tensor,
             T: torch.Tensor):
    """World points (..., 3) -> (x, y, z) in a camera (z floored at 1e-6
    for the division)."""
    p = pts @ R.T + T
    z = jmax(p[..., 2], 1e-6)
    x = p[..., 0] / z * K[0, 0] + K[0, 2]
    y = p[..., 1] / z * K[1, 1] + K[1, 2]
    return x, y, p[..., 2]


def _backproject(cam: Camera, depth: torch.Tensor, sx: float = 1.0,
                 sy: float = 1.0) -> torch.Tensor:
    """The pixel grid at scale (sx, sy) and z-depths (..., h, w) -> world
    points (..., h, w, 3)."""
    h, w = depth.shape[-2:]
    K = _scaled_K(cam.K, sx, sy)
    ii, jj = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=depth.device),
        torch.arange(w, dtype=torch.float32, device=depth.device),
        indexing="ij")
    d = torch.stack([(jj - K[0, 2]) / K[0, 0], (ii - K[1, 2]) / K[1, 1],
                     torch.ones_like(jj)], -1)
    return (d * depth[..., None] - cam.T) @ cam.R  # R^T (p - T)


def cost_volume(feat_src: torch.Tensor, src_cams: list, tgt_cam: Camera,
                depth_hyps: torch.Tensor, scale: float) -> torch.Tensor:
    """The variance plane sweep: feat_src (S, h, w, C) at `scale`,
    depth_hyps (D, h, w) or (D, 1, 1) target z-depths -> (D, h, w, C), the
    variance over the sources that see each point, 10 where fewer than
    two do."""
    D = depth_hyps.shape[0]
    h, w = feat_src.shape[1:3]
    pts = _backproject(tgt_cam, torch.broadcast_to(depth_hyps, (D, h, w)),
                       scale, scale)
    warped, valid = [], []
    for feat, cam in zip(feat_src, src_cams):
        K = _scaled_K(cam.K, scale, scale)
        x, y, _ = _project(pts, K, cam.R, cam.T)
        Hs, Ws = feat.shape[:2]
        warped.append(_bilinear(feat, x, y))
        valid.append((x >= 0) & (x <= Ws - 1) & (y >= 0) & (y <= Hs - 1))
    warped = torch.stack(warped)  # (S, D, h, w, C)
    valid = torch.stack(valid).to(warped.dtype)  # (S, D, h, w)
    cnt = torch.sum(valid, dim=0)[..., None]
    cnt_s = jmax(cnt, 1.0)
    vm = valid[..., None]
    mean = torch.sum(warped * vm, dim=0) / cnt_s
    var = torch.sum((warped ** 2) * vm, dim=0) / cnt_s - mean ** 2
    return torch.where(cnt >= 2.0, var, torch.full_like(var, 10.0))


def depth_regression(net: ENeRFNetwork, cr_keys: tuple,
                     volume: torch.Tensor, depth_hyps: torch.Tensor):
    """The 3D regularizer -> softmax(-logits) over the D planes -> (depth,
    std) (h, w), the std floored at sqrt(1e-8)."""
    a, b = cr_keys
    x = torch.relu(_conv3(volume[None], net[a]))
    logits = _conv3(x, net[b])[0, ..., 0]  # (D, h, w)
    prob = torch.softmax(-logits, dim=0)
    dh = torch.broadcast_to(depth_hyps, prob.shape)
    depth = torch.sum(prob * dh, dim=0)
    var = torch.sum(prob * (dh - depth[None]) ** 2, dim=0)
    return depth, torch.sqrt(jmax(var, 1e-8))


def _upsample(img: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """Nearest-neighbour (..., h, w) -> (..., H, W): row i * h // H."""
    h, w = img.shape[-2:]
    dev = img.device
    yi = torch.clamp(torch.arange(H, device=dev) * h // H, 0, h - 1)
    xi = torch.clamp(torch.arange(W, device=dev) * w // W, 0, w - 1)
    return img[..., yi[:, None], xi[None, :]]


class ENeRFOutput(NamedTuple):
    rgb_map: torch.Tensor  # (H, W, 3)
    dpt_map: torch.Tensor  # (H, W)
    acc_map: torch.Tensor  # (H, W)
    depth_coarse: torch.Tensor  # (H/4, W/4) the cost volume's depth
    depth_std: torch.Tensor  # (H/4, W/4)
    rgb_coarse: torch.Tensor | None  # (H/4, W/4, 3) the level-0 render


def _ibr_render(cfg: ENeRFConfig, net: ENeRFNetwork, tgt_cam: Camera,
                src_imgs: torch.Tensor, src_cams: list, f0: torch.Tensor,
                depth: torch.Tensor, std: torch.Tensor, near: float,
                far: float, scale: float) -> dict:
    """Depth-guided samples (n_samples over depth +- guide_sigma std,
    clipped to [near, far]) at `scale`, each projected into the sources
    (their rgb and f0 features sampled), the learned blend of the source
    colors plus a residual, the density head, volume_render."""
    ts = torch.linspace(-1.0, 1.0, cfg.n_samples, dtype=depth.dtype,
                        device=depth.device)
    z_vals = jclip(depth[..., None] + ts * cfg.guide_sigma * std[..., None],
                   near, far)
    z_vals = torch.sort(z_vals, dim=-1).values  # (h, w, n)
    pts = _backproject(tgt_cam, z_vals.permute(2, 0, 1), scale,
                       scale).permute(1, 2, 0, 3)  # (h, w, n, 3)
    per_src = []
    for img, feat, cam in zip(src_imgs, f0, src_cams):
        x, y, _ = _project(pts, cam.K, cam.R, cam.T)
        per_src.append(torch.cat([_bilinear(img, x, y),
                                  _bilinear(feat, x * 0.5, y * 0.5)], -1))
    src_feat = torch.stack(per_src)  # (S, h, w, n, 3 + f0)
    S = src_feat.shape[0]
    mean = torch.mean(src_feat, dim=0)
    var = torch.mean(src_feat ** 2, dim=0) - mean ** 2
    glob = torch.cat([mean, var], -1)  # (h, w, n, 2 (3 + f0))
    per_view_in = torch.cat([
        torch.broadcast_to(glob[None], (S, *glob.shape)),
        torch.sum((src_feat - mean[None]) ** 2, -1, keepdim=True)], -1)
    wsrc = torch.softmax(net.agg(per_view_in)[..., 0], dim=0)
    rgb_blend = torch.sum(wsrc[..., None] * src_feat[..., :3], dim=0)
    hid = net.sig(glob)
    sigma = F.softplus(net.sig_out(hid)[..., 0] - 1.0)
    rgb_res = net.rgb_res(torch.cat([hid, rgb_blend], -1)) * 0.1
    rgb_s = jclip(rgb_blend + rgb_res, 0.0, 1.0)
    return volume_render(rgb_s, sigma, z_vals, bg_color=cfg.bg_brightness)


def render_enerf(cfg: ENeRFConfig, net: ENeRFNetwork, tgt_cam: Camera,
                 src_imgs: torch.Tensor, src_cams: list, near: float,
                 far: float, render_coarse: bool = False) -> ENeRFOutput:
    """The two-level forward of one target view from src_imgs (S, H, W,
    3) and their cameras."""
    H, W = tgt_cam.H, tgt_cam.W
    dev, dt = src_imgs.device, src_imgs.dtype
    feats = feature_net(net, src_imgs)
    # level 0: the whole range, uniform in disparity, at 1/4
    t = torch.linspace(0.0, 1.0, cfg.n_planes[0], dtype=dt, device=dev)
    dh0 = (1.0 / (1.0 / near * (1 - t) + 1.0 / far * t))[:, None, None]
    vol0 = cost_volume(feats[1], src_cams, tgt_cam, dh0, 0.25)
    depth0, std0 = depth_regression(net, ("cr0a", "cr0b"), vol0, dh0)
    # level 1: about depth0 at 1/2
    h1, w1 = feats[0].shape[1:3]
    d_up = _upsample(depth0, h1, w1)
    s_up = _upsample(std0, h1, w1)
    t1 = torch.linspace(-1.0, 1.0, cfg.n_planes[1], dtype=dt, device=dev)
    dh1 = jclip(d_up[None] + t1[:, None, None] * cfg.guide_sigma
                * s_up[None], near, far)
    vol1 = cost_volume(feats[0], src_cams, tgt_cam, dh1, 0.5)
    depth1, std1 = depth_regression(net, ("cr1a", "cr1b"), vol1, dh1)
    rgb_coarse = None
    if render_coarse:  # the level-0 render (supervised in the step)
        rgb_coarse = _ibr_render(cfg, net, tgt_cam, src_imgs, src_cams,
                                 feats[0], depth0, std0, near, far,
                                 0.25)["rgb_map"]
    out = _ibr_render(cfg, net, tgt_cam, src_imgs, src_cams, feats[0],
                      _upsample(depth1, H, W), _upsample(std1, H, W), near,
                      far, 1.0)
    return ENeRFOutput(rgb_map=out["rgb_map"], dpt_map=out["dpt_map"],
                       acc_map=out["acc_map"], depth_coarse=depth0,
                       depth_std=std0, rgb_coarse=rgb_coarse)


def make_enerf_train_step(cfg: ENeRFConfig, tgt_cam: Camera, n_srcs: int,
                          near: float, far: float, lr: float = 5e-4):
    """-> (init, step): init(generator, device) -> (network, AdamState);
    step(net, state, Kt, Rt, Tt, src_imgs, Ks, Rs, Ts, target) -> (state,
    {"loss", "psnr"}), the network updated in place: the rgb L2 of the
    full render plus half that of the level-0 render against the target
    at every 4th pixel, one Adam step. Cameras take tgt_cam's size; the
    sources' K, R, T are stacked (S, ...). `grads_out` and `mark` as in
    models/nerf.py::make_nerf_train_step."""
    H, W = tgt_cam.H, tgt_cam.W

    def init(generator=None, device=None):
        net = cfg.init(generator, device)
        return net, adam_init(tree_flatten(net.jax_params()))

    def step(net: ENeRFNetwork, state: AdamState, Kt, Rt, Tt, src_imgs, Ks,
             Rs, Ts, target, grads_out=None, mark=None):
        cam = Camera(H, W, Kt, Rt, Tt)
        cams = [Camera(H, W, Ks[i], Rs[i], Ts[i]) for i in range(n_srcs)]
        out = render_enerf(cfg, net, cam, src_imgs, cams, near, far,
                           render_coarse=True)
        loss = torch.mean((out.rgb_map - target) ** 2)
        h0, w0 = out.rgb_coarse.shape[:2]
        tgt0 = target[: h0 * 4: 4, : w0 * 4: 4]
        loss = loss + 0.5 * torch.mean((out.rgb_coarse - tgt0) ** 2)
        if mark:
            mark("forward")
        params = tree_flatten(net.jax_params())
        grads = grads_of(loss, params)
        if grads_out is not None:
            grads_out["grads"] = grads
        if mark:
            mark("backward")
        state = adam_update(params, grads, state, lr)
        if mark:
            mark("optimizer")
        loss = loss.detach()
        return state, dict(loss=loss, psnr=-10.0 * torch.log10(loss + 1e-10))

    return init, step
