"""PointPlanes model family: dynamic point-based rendering, the reference's
PointPlanesSampler (R4DV) (port of envgs_tpu/models/point_planes.py).

An optimizable point cloud whose per-frame motion, geometry and appearance
come from K-Planes features of (x, t):

- `resd`: the displacement, resd_scale * tanh(MLP), the head zero at
  start (an identity warp);
- `geo`: MLP -> radius in [radius_min, radius_max] and alpha, each through
  a shifted sigmoid;
- `rgb`: MLP -> per-point SH coefficients, evaluated toward the camera.

The points render as isotropic 3D Gaussians (scales = radius, the
identity quaternion) through the 3DGS rasterizer (`ops/raster3d.py`: K5,
gauss3d K1 and gauss3d K2 on a CUDA tensor, their plain versions on a CPU
tensor). The optimizer is the optax Adam of the JAX package written out
(train/optax_adam.py). `point_planes_params_from_jax` /
`point_planes_params_to_jax` carry the weights across the packages in the
JAX parameter dict (`points`, `planes`, `resd`, `geo`, `rgb`).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from envgs_tpu_torch.models.embedders import KPlanesEmbedder
from envgs_tpu_torch.models.regressors import MLP
from envgs_tpu_torch.ops.raster3d import Raster3DOutput, render_gaussians3d
from envgs_tpu_torch.train.families import tree_flatten
from envgs_tpu_torch.train.optax_adam import AdamState, adam_update, grads_of
from envgs_tpu_torch.train.optax_adam import adam_init as adam_init_params
from envgs_tpu_torch.utils.camera import Camera
from envgs_tpu_torch.utils.sh import eval_sh_color
from envgs_tpu_torch.utils.transforms import normalize


class PointPlanesConfig(NamedTuple):
    """Static hyperparameters (PointPlanesSampler defaults, scaled down).
    raster_backend: "pallas" (the kernels on a CUDA tensor, the plain
    versions on a CPU tensor) or "ref" (the reference rasterizer)."""

    n_frames: int = 8
    radius_min: float = 0.001
    radius_max: float = 0.015
    radius_shift: float = -5.0
    alpha_shift: float = 5.0
    resd_scale: float = 0.1  # the displacement's range
    sh_deg: int = 2
    feat_width: int = 64
    bg_brightness: float = 0.0
    raster_backend: str = "pallas"
    pair_cap: int = 2 ** 20
    bounds: tuple = ((-1.0, -1.0, -1.0), (1.0, 1.0, 1.0))

    @property
    def embedder_kwargs(self) -> dict:
        """The K-Planes grid: 8 features at (16, 32), one time cell per
        frame (at least 2)."""
        return dict(n_features=8, resolutions=(16, 32),
                    n_frames=self.n_frames,
                    time_resolution=max(self.n_frames, 2),
                    bounds=self.bounds)

    def init(self, points, generator: torch.Generator | None = None,
             device=None) -> "PointPlanes":
        return PointPlanes(self, points, generator, device)


class PointPlanes(nn.Module):
    """The family's parameters: `points` (N, 3), the K-Planes `planes` and
    the `resd` / `geo` / `rgb` MLPs (two hidden layers of feat_width)."""

    def __init__(self, cfg: PointPlanesConfig, points,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        self.points = nn.Parameter(torch.tensor(
            np.array(points, np.float32), device=device))
        self.planes = KPlanesEmbedder(**cfg.embedder_kwargs,
                                      generator=generator, device=device)
        F, w = self.planes.out_dim, cfg.feat_width
        self.resd = MLP(F, w, 2, 3, skips=(), generator=generator,
                        device=device)
        with torch.no_grad():  # the identity warp at start: tanh stays
            self.resd.weights[-1].zero_()  # in its linear range early
        self.geo = MLP(F, w, 2, 2, skips=(), generator=generator,
                       device=device)
        self.rgb = MLP(F, w, 2, 3 * (cfg.sh_deg + 1) ** 2, skips=(),
                       generator=generator, device=device)

    def jax_tree(self) -> dict:
        """The JAX parameter dict, holding the module's own tensors."""
        return dict(points=self.points, planes=dict(self.planes.planes),
                    resd=self.resd.jax_params(), geo=self.geo.jax_params(),
                    rgb=self.rgb.jax_params())


def point_planes_params_from_jax(params: dict, cfg: PointPlanesConfig,
                                 device=None) -> PointPlanes:
    """JAX's parameter dict (numpy or JAX arrays: `points`, `planes` by
    key, `resd` / `geo` / `rgb` as [(w, b), ...]) -> the port's module."""
    model = PointPlanes(cfg, np.asarray(params["points"]), device=device)
    with torch.no_grad():
        for k, v in params["planes"].items():
            model.planes.planes[k].copy_(torch.as_tensor(np.asarray(v)))
    for name in ("resd", "geo", "rgb"):
        getattr(model, name).load_jax(
            [(np.asarray(w), np.asarray(b)) for w, b in params[name]])
    return model


def point_planes_params_to_jax(model: PointPlanes) -> dict:
    """Inverse of point_planes_params_from_jax: numpy arrays in JAX's
    parameter dict."""
    def np_(x):
        return x.detach().cpu().numpy()

    tree = model.jax_tree()
    return dict(points=np_(tree["points"]),
                planes={k: np_(v) for k, v in tree["planes"].items()},
                **{name: [(np_(w), np_(b)) for w, b in tree[name]]
                   for name in ("resd", "geo", "rgb")})


def point_planes_forward(cfg: PointPlanesConfig, model: PointPlanes, t,
                         cam: Camera) -> Raster3DOutput:
    """Render frame `t` (in [0, 1]) from `cam`."""
    pts = model.points
    feat = model.planes(pts, t)  # (N, F)
    x = pts + cfg.resd_scale * torch.tanh(model.resd(feat))
    geo = model.geo(feat)  # (N, 2)
    radius = cfg.radius_min + (cfg.radius_max - cfg.radius_min) * (
        torch.sigmoid(geo[..., 0] + cfg.radius_shift))
    alpha = torch.sigmoid(geo[..., 1] + cfg.alpha_shift)
    K = (cfg.sh_deg + 1) ** 2
    sh = model.rgb(feat).reshape(-1, 3, K)
    dirs = normalize(x - cam.center[None, :])
    rgb = torch.clamp(eval_sh_color(cfg.sh_deg, sh, dirs), max=1.0)
    N = x.shape[0]
    quats = torch.cat([torch.ones((N, 1), device=x.device),
                       torch.zeros((N, 3), device=x.device)], -1)
    scales3 = radius[:, None].expand(N, 3)
    return render_gaussians3d(x, quats, scales3, alpha, rgb, cam,
                              bg_color=cfg.bg_brightness,
                              pair_cap=cfg.pair_cap,
                              backend=cfg.raster_backend)


def flat_params(model: PointPlanes) -> list:
    """The module's tensors in the JAX parameter dict's leaf order."""
    return tree_flatten(model.jax_tree())


def adam_init(model: PointPlanes) -> AdamState:
    return adam_init_params(flat_params(model))


def make_point_planes_train_step(cfg: PointPlanesConfig,
                                 cam_template: Camera, lr: float = 5e-3):
    """-> (init, step): init(points, generator, device) -> (model,
    AdamState); step(model, state, t, K, R, T, target) -> (state, {"loss",
    "psnr", "pair_overflow" (not with the ref backend)}), the model's
    parameters updated in place. The photometric MSE and one Adam step.
    With `grads_out` (a dict) the step also hands back its gradients
    ("grads", in flat_params order); `mark` (a callable) is called with
    "forward", "backward" and "optimizer" as each stage is queued."""
    H, W = cam_template.H, cam_template.W
    znear, zfar = cam_template.znear, cam_template.zfar

    def init(points, generator=None, device=None):
        model = cfg.init(points, generator, device)
        return model, adam_init(model)

    def step(model: PointPlanes, state: AdamState, t, K, R, T, target,
             grads_out: dict | None = None, mark=None):
        cam = Camera(H, W, K, R, T, znear, zfar)
        out = point_planes_forward(cfg, model, t, cam)
        loss = torch.mean((out.rgb - target) ** 2)
        if mark:
            mark("forward")
        params = flat_params(model)
        grads = grads_of(loss, params)
        if grads_out is not None:
            grads_out["grads"] = grads
        if mark:
            mark("backward")
        state = adam_update(params, grads, state, lr)
        if mark:
            mark("optimizer")
        loss = loss.detach()
        info = dict(loss=loss, psnr=-10.0 * torch.log10(loss + 1e-10))
        if out.num_pairs is not None:  # the reference has no pair budget
            info["pair_overflow"] = torch.clamp(out.num_pairs - cfg.pair_cap,
                                                min=0)
        return state, info

    return init, step
