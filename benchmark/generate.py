"""The one traffic generator: a cell's cameras, target images and normal
priors from its traffic mix's parameters (`traffic/<mix>.json`) and the
run's seed, made on the device by one `torch.Generator` in a few large
calls. Every seed gets the same set of views and poses in another order,
so seeds change the draws and not the amount of work.

Parameters a mix may set:
- "views", "yaw_deg": training views yawed evenly over [-yaw, +yaw] about
  the configuration's camera, in a seeded order;
- "poses", "yaw_deg", "pitch_deg": a viewer's orbit, yaw = yaw_deg *
  sin(2 pi i / poses), pitch = pitch_deg * sin(4 pi i / poses), walked
  from a seeded start in a seeded direction.
"""
from __future__ import annotations

import math

import torch


def generator(seed: int, device) -> torch.Generator:
    """The run's generator: `seed` taken modulo 2^63 (the driver's seeds
    pass 32 signed bits)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % 2 ** 63)
    return gen


def intrinsics(cfg: dict, device) -> torch.Tensor:
    """The configuration's camera: focal `focal_ratio` x width, the
    principal point at the image's centre."""
    H, W = cfg["height"], cfg["width"]
    f = cfg["focal_ratio"] * W
    return torch.tensor([[f, 0.0, W / 2], [0.0, f, H / 2], [0.0, 0.0, 1.0]],
                        dtype=torch.float32, device=device)


def turned(yaw_deg: float, pitch_deg: float, device) -> torch.Tensor:
    """World-to-view rotation of the camera turned by yaw about the view y
    axis, then pitch about its x axis (the camera stays at the origin)."""
    a, b = math.radians(yaw_deg), math.radians(pitch_deg)
    ry = torch.tensor([[math.cos(a), 0.0, math.sin(a)], [0.0, 1.0, 0.0],
                       [-math.sin(a), 0.0, math.cos(a)]], dtype=torch.float64)
    rx = torch.tensor([[1.0, 0.0, 0.0], [0.0, math.cos(b), -math.sin(b)],
                       [0.0, math.sin(b), math.cos(b)]], dtype=torch.float64)
    return (rx @ ry).to(torch.float32).to(device)


def _order(n: int, gen: torch.Generator) -> list:
    return torch.randperm(n, generator=gen, device=gen.device).tolist()


def train_views(cfg: dict, traffic: dict, gen: torch.Generator) -> list:
    """[(K, R, T)] of the training views, in the seeded order."""
    dev = gen.device
    n, yaw = traffic["views"], traffic["yaw_deg"]
    yaws = [-yaw + 2 * yaw * i / max(n - 1, 1) for i in range(n)]
    K, T = intrinsics(cfg, dev), torch.zeros(3, device=dev)
    return [(K, turned(yaws[i], 0.0, dev), T) for i in _order(n, gen)]


def orbit_poses(cfg: dict, traffic: dict, gen: torch.Generator) -> list:
    """[(K, R, T)] of the viewer's orbit from a seeded start, in a seeded
    direction."""
    dev = gen.device
    n = traffic["poses"]
    start = _order(n, gen)[0]
    step = 1 if _order(2, gen)[0] else -1
    K, T = intrinsics(cfg, dev), torch.zeros(3, device=dev)
    poses = []
    for k in range(n):
        i = (start + step * k) % n
        poses.append((K, turned(traffic["yaw_deg"] * math.sin(2 * math.pi * i / n),
                                traffic["pitch_deg"] * math.sin(4 * math.pi * i / n),
                                dev), T))
    return poses


def smooth_images(n: int, H: int, W: int, gen: torch.Generator,
                  waves: int = 3) -> torch.Tensor:
    """(n, H, W, 3) images in [0.1, 0.9]: each channel a mean of `waves`
    plane waves with seeded frequencies (0.5-2 cycles per 100 pixels),
    directions and phases."""
    dev = gen.device
    freq = (0.5 + 1.5 * torch.rand((n, 3, waves), generator=gen, device=dev)
            ) * (2 * math.pi / 100)
    ang = torch.rand((n, 3, waves), generator=gen, device=dev) * 2 * math.pi
    phase = torch.rand((n, 3, waves), generator=gen, device=dev) * 2 * math.pi
    yy = torch.arange(H, device=dev, dtype=torch.float32)[:, None, None, None]
    xx = torch.arange(W, device=dev, dtype=torch.float32)[None, :, None, None]
    out = []
    for i in range(n):
        arg = (freq[i] * (torch.cos(ang[i]) * xx + torch.sin(ang[i]) * yy)
               + phase[i])
        out.append(0.5 + 0.4 * torch.sin(arg).mean(-1))
    return torch.stack(out)


def normal_priors(n: int, H: int, W: int, gen: torch.Generator
                  ) -> torch.Tensor:
    """(n, H, W, 3) monocular normal priors in the [0, 1] encoding: normals
    facing the camera (view z toward it), tilted by smooth seeded waves of
    up to about 20 degrees."""
    tilt = (smooth_images(n, H, W, gen, waves=2) - 0.5) * 0.9
    nrm = torch.stack([tilt[..., 0], tilt[..., 1],
                       -torch.ones_like(tilt[..., 0])], -1)
    nrm = nrm / nrm.norm(dim=-1, keepdim=True)
    return nrm * 0.5 + 0.5
