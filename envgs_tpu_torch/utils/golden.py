"""Golden renders: a committed scene rendered through the port and scored
against its committed image (the render path of tests/golden_harness.py,
with the port's modules).

A scene directory holds

    point_cloud.ply      3DGS-format ply of 2D surfels (the base set)
    camera.json          {H, W, K, R, T, znear, zfar, bg, psnr_threshold,
                          model, pair_cap, env_pair_cap}
    golden.png           the expected render (8-bit RGB)
    env_point_cloud.ply  with "model": "envgs": the environment set
    extras.npz           optional: the base set's specular / roughness
                         logits, which the ply format does not store

A plain scene is rasterized alone (the ply's SH colours toward the
camera); an "envgs" scene goes through the whole forward_envgs in render
mode (base raster, reflected rays, env trace, composite). The pools come
from the ply through `train/checkpoints.py::import_ply`, as a user loads
a trained model.
"""
from __future__ import annotations

import json
import os
import struct
import zlib

import numpy as np
import torch

from envgs_tpu_torch.models.envgs import EnvGSConfig, forward_envgs
from envgs_tpu_torch.models.gaussians import GaussianPool
from envgs_tpu_torch.models.gaussiant import pool_colors
from envgs_tpu_torch.ops.common import prepare_splats
from envgs_tpu_torch.ops.raster import rasterize
from envgs_tpu_torch.train.checkpoints import import_ply
from envgs_tpu_torch.utils.camera import Camera, make_camera
from envgs_tpu_torch.utils.ply import load_gaussian_ply

# the tracer backend that goes with each raster backend in an envgs scene
_TRACER = {"pallas": "tiled", "ref": "ref"}


def read_png(path: str) -> np.ndarray:
    """An 8-bit RGB PNG (no interlace) -> (H, W, 3) uint8."""
    with open(path, "rb") as fh:
        data = fh.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG")
    pos, idat, meta = 8, b"", None
    while pos < len(data):
        (ln,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + ln]
        if tag == b"IHDR":
            meta = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat += body
        pos += 12 + ln
    w, h, depth, ctype = meta[0], meta[1], meta[2], meta[3]
    if depth != 8 or ctype != 2:
        raise ValueError(f"{path}: golden images are 8-bit RGB")
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, w * 3 + 1)
    fil, px = rows[:, 0], rows[:, 1:].reshape(h, w, 3).astype(np.int32)
    out = np.zeros_like(px)
    zero = np.zeros(3, np.int32)
    for i in range(h):
        line = px[i].copy()
        up = out[i - 1] if i else np.zeros_like(line)
        if fil[i] == 1:  # sub
            for j in range(1, w):
                line[j] = (line[j] + line[j - 1]) % 256
        elif fil[i] == 2:  # up
            line = (line + up) % 256
        elif fil[i] == 3:  # average
            for j in range(w):
                left = line[j - 1] if j else zero
                line[j] = (line[j] + (left + up[j]) // 2) % 256
        elif fil[i] == 4:  # paeth
            for j in range(w):
                a = line[j - 1] if j else zero
                b = up[j]
                c = up[j - 1] if j else zero
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pr = np.where((pa <= pb) & (pa <= pc), a,
                              np.where(pb <= pc, b, c))
                line[j] = (line[j] + pr) % 256
        out[i] = line
    return out.astype(np.uint8)


def golden_dirs(root: str) -> list[str]:
    """The scene directories under `root` (those holding a camera.json)."""
    if not os.path.isdir(root):
        return []
    return sorted(os.path.join(root, d) for d in os.listdir(root)
                  if os.path.isfile(os.path.join(root, d, "camera.json")))


def scene_spec(scene_dir: str) -> dict:
    with open(os.path.join(scene_dir, "camera.json")) as fh:
        return json.load(fh)


def _camera(spec: dict, device) -> Camera:
    return make_camera(spec["H"], spec["W"], np.asarray(spec["K"], np.float32),
                       np.asarray(spec["R"], np.float32),
                       np.asarray(spec["T"], np.float32),
                       spec.get("znear", 0.02), spec.get("zfar", 100.0),
                       device=device)


def import_pool(ply_path: str, device, extras: dict | None = None
                ) -> GaussianPool:
    """ply -> a pool of the next power of two of its splats (at least
    1024), the SH degree the ply carries; `extras` may hold the raw
    specular / roughness logits of its splats."""
    raw = load_gaussian_ply(ply_path)
    P = raw["xyz"].shape[0]
    cap = max(1024, 1 << (P - 1).bit_length())
    sh_degree = int(round((raw["f_rest"].shape[1] + 1) ** 0.5)) - 1
    pool = import_ply(ply_path, cap=cap, sh_degree=sh_degree, device=device)
    if extras:
        def pad(a):
            a = np.asarray(a, np.float32)
            return torch.tensor(np.concatenate(
                [a, np.zeros((cap - a.shape[0],) + a.shape[1:], np.float32)]),
                device=device)
        pool = pool._replace(params=pool.params._replace(
            specular=pad(extras["specular"]),
            roughness=pad(extras["roughness"])))
    return pool


def render_golden(scene_dir: str, device="cuda",
                  backend: str = "pallas") -> torch.Tensor:
    """The scene's (H, W, 3) render: backend "pallas" runs the kernels on a
    CUDA device and their plain versions on the CPU (with the "tiled"
    tracer for an envgs scene); "ref" the reference rasterizer (and
    tracer)."""
    spec = scene_spec(scene_dir)
    cam = _camera(spec, device)
    if spec.get("model") == "envgs":
        path = os.path.join(scene_dir, "extras.npz")
        extras = dict(np.load(path)) if os.path.exists(path) else {}
        base = import_pool(os.path.join(scene_dir, "point_cloud.ply"), device,
                           extras)
        env = import_pool(os.path.join(scene_dir, "env_point_cloud.ply"),
                          device)
        cfg = EnvGSConfig(
            raster_backend=backend, tracer_backend=_TRACER[backend],
            reflection_start_iter=0, render_mode=True,
            pair_cap=int(spec.get("pair_cap", 2 ** 16)),
            env_pair_cap=int(spec.get("env_pair_cap", 2 ** 16)),
            bg_brightness=float(spec.get("bg", [0.0])[0]))
        return forward_envgs(base, env, cam, 10 ** 6, cfg).rgb_map
    pool = import_pool(os.path.join(scene_dir, "point_cloud.ply"), device)
    prep = prepare_splats(
        pool.params.xyz, pool.params.rotation, pool.get_scaling,
        pool.get_opacity[:, 0], pool_colors(pool, cam.center), cam,
        active=pool.stats.active)
    bg = torch.tensor(spec.get("bg", [0.0, 0.0, 0.0]), dtype=torch.float32,
                      device=device)
    return rasterize(prep, cam, bg, pair_cap=2 ** 17, backend=backend).rgb


def psnr_vs_golden(scene_dir: str, device="cuda", backend: str = "pallas"):
    """(PSNR in dB of the clipped render against golden.png, the render)."""
    with torch.no_grad():
        rgb = render_golden(scene_dir, device, backend)
    img = np.clip(rgb.cpu().numpy(), 0, 1)
    gold = read_png(os.path.join(scene_dir, "golden.png")).astype(
        np.float32) / 255.0
    mse = float(np.mean((img - gold) ** 2))
    return -10.0 * np.log10(max(mse, 1e-12)), rgb
