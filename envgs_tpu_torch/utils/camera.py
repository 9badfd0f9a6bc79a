"""Camera model, projection matrices and ray generation (port of
envgs_tpu/utils/camera.py; same column-vector conventions: x_v = R x_w + T,
pixel centers on integer coordinates)."""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from envgs_tpu_torch.utils.transforms import normalize


class Camera(NamedTuple):
    """A single pinhole camera; K, R, T are fp32 tensors on one device."""

    H: int
    W: int
    K: torch.Tensor  # (3, 3) intrinsics
    R: torch.Tensor  # (3, 3) world->view rotation
    T: torch.Tensor  # (3,) world->view translation
    znear: float = 0.01
    zfar: float = 100.0

    @property
    def view(self) -> torch.Tensor:
        """(4, 4) world->view transform."""
        top = torch.cat([self.R, self.T[:, None]], dim=-1)
        bottom = top.new_tensor([[0.0, 0.0, 0.0, 1.0]])
        return torch.cat([top, bottom], dim=0)

    @property
    def center(self) -> torch.Tensor:
        """(3,) camera center in world space (-R^T T)."""
        return -self.R.T @ self.T

    @property
    def pix_from_world(self) -> torch.Tensor:
        """(3, 4) world -> (x_pix*w, y_pix*w, w=z_view), built from K so an
        off-center principal point is exact: x_pix = fx x/z + cx - 0.5."""
        K = self.K
        z = K.new_zeros(())
        o = K.new_ones(())
        pix_from_view = torch.stack(
            [
                torch.stack([K[0, 0], K[0, 1], K[0, 2] - 0.5, z]),
                torch.stack([z, K[1, 1], K[1, 2] - 0.5, z]),
                torch.stack([z, z, o, z]),
            ],
            dim=0,
        )
        return pix_from_view @ self.view

    def crop_rows(self, row0: int, band_h: int) -> "Camera":
        """Camera viewing rows [row0, row0 + band_h) of this camera's image
        (the principal point shifted up by row0)."""
        K = self.K.clone()
        K[1, 2] = K[1, 2] - float(row0)
        return self._replace(H=band_h, K=K)


def make_camera(H, W, K, R, T, znear=0.01, zfar=100.0,
                device: torch.device | str | None = None) -> Camera:
    def f32(x):
        return torch.as_tensor(x, dtype=torch.float32, device=device)

    return Camera(int(H), int(W), f32(K), f32(R), f32(T).reshape(3),
                  float(znear), float(zfar))


def get_rays(cam: Camera, z_depth: bool = True, correct_pix: bool = True,
             i0=None):
    """Camera rays for every pixel: (ray_o (3,), ray_d (H, W, 3)).

    With z_depth=True, ray_d is scaled so that `o + t * d` has view depth t
    (not normalized) — the contract the surfel tracer expects.

    i0: the global pixel row of row 0 (the band row-crop: cam holds the
    full image's K with H the band's height; adding the offset here keeps
    every ray bit-identical to the full image's get_rays)."""
    dev = cam.K.device
    i = torch.arange(cam.H, dtype=torch.float32, device=dev)
    if i0 is not None:
        i = i + i0
    j = torch.arange(cam.W, dtype=torch.float32, device=dev)
    if correct_pix:
        i = i + 0.5
        j = j + 0.5
    ii, jj = torch.meshgrid(i, j, indexing="ij")
    pix = torch.stack([jj, ii, torch.ones_like(ii)], dim=-1)  # (H, W, 3)
    Kinv = torch.linalg.inv(cam.K)
    d_world = (pix @ Kinv.T) @ cam.R  # R^T @ d, row-vector form
    if not z_depth:
        d_world = normalize(d_world)
    return cam.center, d_world


def camera_path_interpolate(cams: list, n_out: int, kind: str = "orbit"):
    """Novel-view camera path (host numpy, as the JAX package computes it)
    -> n_out Cameras on the first camera's device.

    'orbit': a circle about the cameras' mean center, in the plane normal
    to their mean up direction, each camera facing the mean center;
    'spiral': the same with a height that swings by a tenth of the radius;
    any other kind ('linear', 'cubic'): along the given cameras, centers
    interpolated linearly and rotations as the nearest rotation to the
    linear blend."""
    host = lambda x: x.detach().cpu().numpy()  # noqa: E731
    Ks = np.stack([host(c.K) for c in cams])
    Rs = np.stack([host(c.R) for c in cams])
    Ts = np.stack([host(c.T).reshape(3) for c in cams])
    centers = np.einsum("nij,nj->ni", -Rs.transpose(0, 2, 1), Ts)
    look = centers.mean(0).astype(np.float64)
    K = Ks.mean(0)
    H, W = cams[0].H, cams[0].W

    def cam(R, T):
        return make_camera(H, W, K, R, T, cams[0].znear, cams[0].zfar,
                           device=cams[0].K.device)

    out = []
    if kind in ("orbit", "spiral"):
        c0 = centers.mean(0)
        radius = np.linalg.norm(centers - c0, axis=-1).mean()
        up = -Rs.mean(0)[1]  # the world's up, for y-down cameras
        up = up / np.linalg.norm(up)
        a = np.cross(up, centers[0] - c0)  # a basis of the orbit's plane
        a = a / (np.linalg.norm(a) + 1e-8)
        b = np.cross(a, up)
        for t in np.linspace(0, 2 * np.pi, n_out, endpoint=False):
            h = 0.1 * radius * np.sin(2 * t) if kind == "spiral" else 0.0
            c = c0 + radius * (np.cos(t) * b + np.sin(t) * a) + h * up
            fwd = look - c
            fwd = fwd / np.linalg.norm(fwd)
            right = np.cross(fwd, up)
            right = right / np.linalg.norm(right)
            down = np.cross(fwd, right)
            R = np.stack([right, down, fwd], axis=0)
            out.append(cam(R, -R @ c))
    else:
        n_in = len(cams)
        for t in np.linspace(0, n_in - 1, n_out):
            i0 = int(np.floor(t))
            i1 = min(i0 + 1, n_in - 1)
            a = t - i0
            c = (1 - a) * centers[i0] + a * centers[i1]
            u, _, vt = np.linalg.svd((1 - a) * Rs[i0] + a * Rs[i1])
            R = u @ vt
            out.append(cam(R, -R @ c))
    return out
