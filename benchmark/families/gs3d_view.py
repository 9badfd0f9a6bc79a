"""The two sides of a 3DGS viewer cell (the "view" loop).

`Program` is the timed path: `models/gaussiant.py::render_gaussiant` of
envgs_tpu_torch under `no_grad`, its RGB copied to host memory, over a
pool built from the benchmark's inputs. `Reference` renders the same
poses with the plain reference (`benchmark.reference.gauss3d`).
"""
from __future__ import annotations

import torch

from benchmark import counts
from benchmark.families.gs3d_train import make_pool
from benchmark.reference import gauss3d
from benchmark.reference.geometry import Cam


class Program:
    """`render(i)` the frame of pose i -> (its RGB (H, W, 3) in host
    memory, a device flag of a dropped pair)."""

    def __init__(self, cfg: dict, traffic: dict, inputs):
        from envgs_tpu_torch.models import gaussians, gaussiant
        from envgs_tpu_torch.utils.camera import Camera

        self.T, self.Camera, self.cfg_, self.inputs = (gaussiant, Camera, cfg,
                                                       inputs)
        self.pool = make_pool(gaussians, inputs.scene, cfg["num_gs"],
                              cfg["sh_degree"])
        self.cfg = gaussiant.GaussianTConfig(sh_degree=cfg["sh_degree"],
                                             pair_cap=cfg["pair_cap"])

    def render(self, i: int):
        K, R, T = self.inputs.poses[i % len(self.inputs.poses)]
        cam = self.Camera(self.cfg_["height"], self.cfg_["width"], K, R, T,
                          self.cfg_["znear"], self.cfg_["zfar"])
        with torch.no_grad():
            out = self.T.render_gaussiant(self.pool, cam, self.cfg)
            rgb = out.rgb.cpu().numpy()
        return rgb, out.num_pairs > self.cfg.pair_cap

    def stage_ms(self) -> dict:
        return {}  # render_gaussiant has no spans

    def ops_per_frame(self, cfg: dict, walks: list) -> float | None:
        """Operations of one frame from the reference's walks: the blend,
        and the per-Gaussian SH colours and projection."""
        rw = [w for w in walks if w["blend"] == "raster"]
        if not rw:
            return None
        return (sum(counts.raster_fwd(w)[1] for w in rw) / len(rw)
                + cfg["num_gs"] * (counts.OPS_SH3 + counts.OPS_PREP_GAUSS3D))


class Reference:
    """The plain reference's render of pose i -> (RGB in host memory,
    False)."""

    def __init__(self, cfg: dict, traffic: dict, inputs):
        self.cfg, self.inputs = cfg, inputs
        self.pool = {k: inputs.scene[k] for k in gauss3d.FIELDS}
        self.active = torch.zeros(cfg["pool_cap"], dtype=torch.bool,
                                  device=inputs.scene["xyz"].device)
        self.active[:cfg["num_gs"]] = True

    def render(self, i: int):
        K, R, T = self.inputs.poses[i % len(self.inputs.poses)]
        cam = Cam(self.cfg["height"], self.cfg["width"], K, R, T)
        with torch.no_grad():
            rgb = gauss3d.render(self.pool, cam, self.cfg["sh_degree"],
                                 self.active)
        return rgb.cpu().numpy(), False
