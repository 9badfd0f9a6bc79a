"""Camera model, projection matrices and ray generation (port of
envgs_tpu/utils/camera.py; same column-vector conventions: x_v = R x_w + T,
pixel centers on integer coordinates)."""
from __future__ import annotations

from typing import NamedTuple

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


def make_camera(H, W, K, R, T, znear=0.01, zfar=100.0,
                device: torch.device | str | None = None) -> Camera:
    def f32(x):
        return torch.as_tensor(x, dtype=torch.float32, device=device)

    return Camera(int(H), int(W), f32(K), f32(R), f32(T).reshape(3),
                  float(znear), float(zfar))


def get_rays(cam: Camera, z_depth: bool = True, correct_pix: bool = True):
    """Camera rays for every pixel: (ray_o (3,), ray_d (H, W, 3)).

    With z_depth=True, ray_d is scaled so that `o + t * d` has view depth t
    (not normalized) — the contract the surfel tracer expects."""
    dev = cam.K.device
    i = torch.arange(cam.H, dtype=torch.float32, device=dev)
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
