"""EnvGS's inputs: a base set of 2D surfels in a slab before the camera,
an environment set on a dome about it, training views, targets and
monocular normal priors, all made from the configuration's sizes and the
run's seed on the device. The program (`envgs_tpu_torch`) and the
reference (`benchmark.reference`) each build their own pools and steps
from these raw tensors (`families/envgs_<loop>.py`), so what is compared
is what each computed from the benchmark's inputs alone.
"""
from __future__ import annotations

import math
import types

import torch

from benchmark import generate

C0 = 0.28209479177387814  # the SH degree-0 basis: dc = (rgb - 0.5) / C0


def _logit(p: float) -> float:
    return math.log(p / (1.0 - p))


def make_scene(cfg: dict, gen: torch.Generator) -> dict:
    """{"base", "env": {field: raw parameter tensor}} of the configuration's
    scene: base surfels in a slab in front of the camera (x, y normal with
    the configured spread, z uniform over the configured depths), env
    surfels on a dome about it, random orientations, seeded colors and SH
    rest coefficients, the configured scales, opacities, speculars and
    roughnesses."""
    dev, s = gen.device, cfg["scene"]
    n_sh = (cfg["sh_degree"] + 1) ** 2

    def pool(xyz, scale, specular):
        n = xyz.shape[0]
        full = lambda k, v: torch.full((n, k), v, device=dev)  # noqa: E731
        rgb = torch.rand((n, 3), generator=gen, device=dev)
        rest = torch.randn((n, n_sh - 1, 3), generator=gen, device=dev)
        return dict(
            xyz=xyz, features_dc=((rgb - 0.5) / C0)[:, None, :],
            features_rest=rest * s["sh_rest_std"],
            scaling=full(2, math.log(scale)),
            rotation=torch.rand((n, 4), generator=gen, device=dev),
            opacity=full(1, _logit(s["opacity"])),
            specular=full(cfg["specular_channels"], _logit(specular)),
            roughness=full(1, _logit(s["roughness"])))

    P, Pe = cfg["max_gs"], cfg["env_max_gs"]
    z0, z1 = s["base_depth"]
    xyz = torch.cat([
        torch.randn((P, 2), generator=gen, device=dev) * s["base_spread"],
        z0 + (z1 - z0) * torch.rand((P, 1), generator=gen, device=dev)], -1)
    dirs = torch.randn((Pe, 3), generator=gen, device=dev)
    dirs = dirs / dirs.norm(dim=-1, keepdim=True)
    return dict(base=pool(xyz, s["base_scale"], s["base_specular"]),
                env=pool(dirs * s["env_radius"], s["env_scale"],
                         s["env_specular"]))


class Inputs(types.SimpleNamespace):
    """What the benchmark hands both sides: the scene's raw tensors, the
    views, the targets, the normal priors."""


def make_inputs(cfg: dict, traffic: dict, seed: int, device) -> Inputs:
    """The scene, the training views in the seeded order, their targets
    and normal priors."""
    gen = generate.generator(seed, device)
    scene = make_scene(cfg, gen)
    H, W = cfg["height"], cfg["width"]
    views = generate.train_views(cfg, traffic, gen)
    n = len(views)
    return Inputs(scene=scene, views=views,
                  targets=generate.smooth_images(n, H, W, gen),
                  norms=generate.normal_priors(n, H, W, gen))
