"""Plain 3DGS's inputs (`models/gaussiant.py`, the GaussianT family): full
3D Gaussians in a padded pool, training views and targets, made from the
configuration's sizes and the run's seed on the device. The program and
the reference each build their own pool and step from these raw tensors
(`families/gs3d_<loop>.py`).
"""
from __future__ import annotations

import math

import torch

from benchmark import generate
from benchmark.families.envgs import C0, Inputs, _logit


def make_scene(cfg: dict, gen: torch.Generator) -> dict:
    """{field: raw parameter tensor} of a pool of `pool_cap` slots whose
    first `num_gs` hold Gaussians in a slab in front of the camera, with
    random orientations, three equal scale axes, seeded colors and SH rest
    coefficients; the free slots are zero."""
    dev, s = gen.device, cfg["scene"]
    n, cap = cfg["num_gs"], cfg["pool_cap"]
    n_sh = (cfg["sh_degree"] + 1) ** 2
    z0, z1 = s["depth"]
    xyz = torch.cat([
        torch.randn((n, 2), generator=gen, device=dev) * s["spread"],
        z0 + (z1 - z0) * torch.rand((n, 1), generator=gen, device=dev)], -1)
    rgb = torch.rand((n, 3), generator=gen, device=dev)
    rest = torch.randn((n, n_sh - 1, 3), generator=gen, device=dev)
    rot = torch.rand((n, 4), generator=gen, device=dev)

    def padded(x):
        out = torch.zeros((cap,) + tuple(x.shape[1:]), device=dev)
        out[:n] = x
        return out

    full = lambda k, v: padded(torch.full((n, k), v, device=dev))  # noqa: E731
    return dict(xyz=padded(xyz),
                features_dc=padded(((rgb - 0.5) / C0)[:, None, :]),
                features_rest=padded(rest * s["sh_rest_std"]),
                scaling=full(3, math.log(s["scale"])), rotation=padded(rot),
                opacity=full(1, _logit(s["opacity"])),
                specular=full(1, _logit(1e-3)), roughness=full(1, _logit(0.5)))


def make_inputs(cfg: dict, traffic: dict, seed: int, device) -> Inputs:
    """The scene, and the mix's cameras: training views with their targets
    (a mix with "views"), or a viewer's orbit of poses (with "poses")."""
    gen = generate.generator(seed, device)
    scene = make_scene(cfg, gen)
    if "poses" in traffic:
        return Inputs(scene=scene,
                      poses=generate.orbit_poses(cfg, traffic, gen))
    views = generate.train_views(cfg, traffic, gen)
    return Inputs(scene=scene, views=views, targets=generate.smooth_images(
        len(views), cfg["height"], cfg["width"], gen))
