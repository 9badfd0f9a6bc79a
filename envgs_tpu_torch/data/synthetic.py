"""Synthetic reflective scene generator (port of envgs_tpu/data/
synthetic.py): a specular floor reflecting a colorful environment dome plus
diffuse blobs, with known ground-truth pools, cameras on a ring, and the
multi-view capture rendered from those pools.

The pools and cameras are the JAX package's, draw for draw, and the capture
is rendered as the JAX package renders it: `forward_envgs` in training mode
at iteration 10**6 through the exact reference renderers (the `ref`
backends, ops/raster_ref.py and ops/tracer_ref.py), with the reflection
pass on from iteration 0 and a pair cap of 2**14, on the pools' device. The
images agree with the JAX package's to float32 rounding.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from envgs_tpu_torch.models.envgs import EnvGSConfig, forward_envgs
from envgs_tpu_torch.models.gaussians import GaussianPool, create_pool, logit
from envgs_tpu_torch.utils.camera import Camera, make_camera


def _quat_z_to(n: np.ndarray) -> np.ndarray:
    """(P, 4) wxyz quaternions rotating local +z onto each row of n."""
    n = n / np.clip(np.linalg.norm(n, axis=-1, keepdims=True), 1e-9, None)
    z = np.array([0.0, 0.0, 1.0], np.float32)
    w = 1.0 + n @ z
    xyz = np.cross(np.broadcast_to(z, n.shape), n)
    # antipodal case (n == -z): rotate pi about x
    flip = w < 1e-6
    q = np.concatenate([w[:, None], xyz], axis=-1).astype(np.float32)
    q[flip] = np.array([0.0, 1.0, 0.0, 0.0], np.float32)
    return q / np.clip(np.linalg.norm(q, axis=-1, keepdims=True), 1e-9, None)


def make_gt_pools(seed: int = 0, n_floor: int = 900, n_env: int = 512,
                  cap: int | None = None, env_cap: int | None = None,
                  floor_specular: float = 0.55, device="cuda"):
    """Ground-truth (base, env) Gaussian pools for the reflective scene."""
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.tensor(np.asarray(a, np.float32), device=device)

    # --- base set: specular floor grid at z=0 + diffuse blobs above it ---
    g = int(np.sqrt(n_floor * 2 // 3))
    xs = np.linspace(-2.0, 2.0, g)
    fx, fy = np.meshgrid(xs, xs)
    floor = np.stack([fx.ravel(), fy.ravel(), np.zeros(g * g)], -1)
    spacing = xs[1] - xs[0]
    n_blob = max(n_floor - floor.shape[0], 16)
    centers = np.array([[-0.8, 0.5, 0.45], [0.9, -0.3, 0.35],
                        [0.1, 0.9, 0.6]], np.float32)
    blob = (centers[rng.integers(0, 3, n_blob)]
            + rng.normal(scale=0.18, size=(n_blob, 3))).astype(np.float32)
    blob[:, 2] = np.abs(blob[:, 2] - 0.1) + 0.15
    xyz = np.concatenate([floor, blob]).astype(np.float32)
    P = xyz.shape[0]

    # floor: smooth checker-ish grey; blobs: saturated random colors
    floor_col = 0.35 + 0.15 * np.stack([
        np.sin(2.0 * floor[:, 0]) * np.sin(2.0 * floor[:, 1]),
        np.cos(1.5 * floor[:, 0]),
        np.sin(1.0 * floor[:, 1]),
    ], -1)
    blob_col = rng.random((n_blob, 3)) * 0.8 + 0.2
    colors = np.concatenate([floor_col, blob_col]).astype(np.float32)

    cap = cap or -(-P // 256) * 256
    base = create_pool(xyz, colors, cap=cap, sh_degree=1,
                       init_opacity=0.95, seed=seed, device=device)
    quat = np.zeros((cap, 4), np.float32)
    quat[:, 0] = 1.0
    quat[:floor.shape[0]] = _quat_z_to(
        np.broadcast_to(np.array([0, 0, 1.0]), (floor.shape[0], 3)))
    # blobs keep create_pool's random orientations
    quat[floor.shape[0]:P] = (
        base.params.rotation.cpu().numpy()[floor.shape[0]:P])
    scal = np.full((cap, 2), np.log(0.5 * spacing), np.float32)
    scal[floor.shape[0]:P] = np.log(0.08)
    spec = np.full((cap, 1), float(logit(1e-3)), np.float32)
    spec[:floor.shape[0]] = float(logit(floor_specular))
    base = base._replace(params=base.params._replace(
        rotation=t(quat), scaling=t(scal), specular=t(spec)))

    # --- env set: colorful dome, normals pointing inward ---
    dirs = rng.normal(size=(n_env, 3))
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    dirs[:, 2] = np.abs(dirs[:, 2])  # upper hemisphere
    R_dome = 10.0
    env_xyz = (dirs * R_dome).astype(np.float32)
    env_col = (0.5 + 0.5 * np.stack([
        np.sin(3.0 * dirs[:, 0] + 1.0),
        np.sin(5.0 * dirs[:, 1]),
        np.cos(4.0 * dirs[:, 2]),
    ], -1)).astype(np.float32)
    env_cap = env_cap or -(-n_env // 256) * 256
    env = create_pool(env_xyz, env_col, cap=env_cap, sh_degree=1,
                      init_opacity=0.9, seed=seed + 1, device=device)
    # area per splat ~ hemisphere area / n; normals point inward (-dir)
    s = np.sqrt(2 * np.pi * R_dome ** 2 / max(n_env, 1))
    env_n = np.concatenate(
        [-dirs, np.tile([0.0, 0.0, 1.0], (env_cap - n_env, 1))]
    ).astype(np.float32)
    env = env._replace(params=env.params._replace(
        rotation=t(_quat_z_to(env_n)),
        scaling=t(np.full((env_cap, 2), np.log(0.6 * s), np.float32))))
    return base, env


def make_cameras(n_views: int, H: int, W: int, radius: float = 3.2,
                 height: float = 1.6, look=(0.0, 0.0, 0.25),
                 device="cuda") -> list[Camera]:
    """Ring of cameras above the floor looking at the scene center."""
    cams = []
    look = np.asarray(look, np.float64)
    up = np.array([0.0, 0.0, 1.0])
    f = 0.9 * max(H, W)
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float32)
    for t in np.linspace(0, 2 * np.pi, n_views, endpoint=False):
        c = np.array([radius * np.cos(t), radius * np.sin(t), height])
        fwd = look - c
        fwd = fwd / np.linalg.norm(fwd)
        right = np.cross(fwd, up)
        right = right / np.linalg.norm(right)
        down = np.cross(fwd, right)
        R = np.stack([right, down, fwd]).astype(np.float32)
        T = (-R @ c).astype(np.float32)
        cams.append(make_camera(H, W, K, R, T, 0.02, 60.0, device=device))
    return cams


class Scene(NamedTuple):
    cams: list
    images: list  # (H, W, 3) float32 in [0, 1], numpy
    masks: list  # (H, W, 1) float32
    normals: list  # (H, W, 3) [0,1]-encoded VIEW-space normals
    gt_base: GaussianPool
    gt_env: GaussianPool


def capture_view(base: GaussianPool, env: GaussianPool, cam: Camera,
                 cfg: EnvGSConfig):
    """(image, mask, normal) numpy arrays of one ground-truth view."""
    with torch.no_grad():
        out = forward_envgs(base, env, cam, 10 ** 6, cfg)
    image = np.clip(out.rgb_map.cpu().numpy(), 0, 1).astype(np.float32)
    mask = (out.acc_map.cpu().numpy() > 0.5).astype(np.float32)
    n = out.norm_map.cpu().numpy()
    n = n / np.clip(np.linalg.norm(n, axis=-1, keepdims=True), 1e-8, None)
    n_view = n @ cam.R.cpu().numpy().T  # world -> view
    return image, mask, ((n_view + 1.0) / 2.0).astype(np.float32)


def make_scene(n_views: int = 12, H: int = 128, W: int = 128,
               seed: int = 0, device="cuda") -> Scene:
    """Render the ground-truth multi-view capture from the known pools."""
    base, env = make_gt_pools(seed=seed, device=device)
    cams = make_cameras(n_views, H, W, device=device)
    cfg = EnvGSConfig(raster_backend="ref", tracer_backend="ref",
                      reflection_start_iter=0, pair_cap=2 ** 14)
    views = [capture_view(base, env, cam, cfg) for cam in cams]
    images, masks, normals = (list(x) for x in zip(*views))
    return Scene(cams, images, masks, normals, base, env)
