"""Evaluator and visualizer (port of envgs_tpu/train/evaluator.py).

- per-frame PSNR / SSIM (11-tap window) / LPIPS and render time, with a
  mean/std summary written to `<result_dir>/metrics.json`. LPIPS is the
  graph of ops/lpips.py over the VGG16 npz when one exists, else the host
  LPIPS of ops/losses.py (torchvision's VGG16, where installed), else NaN,
  as in the JAX package;
- typed image dumps {RENDER, DEPTH, ALPHA, NORMAL, SURFACE_NORMAL, SPECULAR,
  DIFFUSE, REFLECTION} plus _gt/_error panels as
  `<result_dir>/<TYPE>/frame####_camera####.png`, written by a bounded
  thread pool (PIL is imported by `save_image`, so an evaluation without
  image dumps does not need it).
"""
from __future__ import annotations

import json
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from envgs_tpu_torch.ops.losses import lpips as lpips_host
from envgs_tpu_torch.ops.losses import psnr, ssim
from envgs_tpu_torch.ops.lpips import default_weight_path, lpips_fn


def _to_u8(im: np.ndarray) -> np.ndarray:
    return np.clip(np.nan_to_num(im) * 255.0, 0, 255).astype(np.uint8)


def save_image(path: str, im: np.ndarray):
    from PIL import Image

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    if im.ndim == 3 and im.shape[-1] == 1:
        im = im[..., 0]
    Image.fromarray(_to_u8(im)).save(path)


def colorize_depth(d: np.ndarray, p: float = 0.01) -> np.ndarray:
    lo, hi = np.quantile(d, p), np.quantile(d, 1 - p)
    nd = 1.0 - np.clip((d - lo) / max(hi - lo, 1e-8), 0, 1)
    return np.repeat(nd[..., None] if nd.ndim == 2 else nd, 3, axis=-1)


def colorize_normal(n: np.ndarray) -> np.ndarray:
    norm = np.linalg.norm(n, axis=-1, keepdims=True)
    return (n / np.clip(norm, 1e-8, None) + 1.0) / 2.0


class Evaluator:
    """Accumulates per-frame metrics; summarize() -> metrics.json dict."""

    def __init__(self, result_dir: str, compute_lpips: bool = True):
        self.result_dir = result_dir
        self.rows = []
        self.compute_lpips = compute_lpips

    def evaluate(self, rgb, gt, name: str = "", render_time: float = 0.0):
        """rgb, gt: (H, W, 3) tensors on one device (or numpy arrays)."""
        rgb = torch.as_tensor(rgb, dtype=torch.float32)
        gt = torch.as_tensor(gt, dtype=torch.float32).to(rgb.device)
        row = {"name": name, "psnr": float(psnr(rgb, gt)),
               "ssim": float(ssim(rgb, gt)), "time": render_time}
        if self.compute_lpips:
            fn = lpips_fn(default_weight_path(), rgb.device)
            if fn is not None:
                with torch.no_grad():
                    row["lpips"] = float(fn(rgb, gt))
            else:
                lp = lpips_host(rgb, gt)
                row["lpips"] = lp if lp is not None else float("nan")
        self.rows.append(row)
        return row

    def summarize(self, extra: dict | None = None) -> dict:
        keys = [k for k in ("psnr", "ssim", "lpips", "time")
                if self.rows and k in self.rows[0]]
        summary = {}
        for k in keys:
            vals = np.asarray([r[k] for r in self.rows], np.float64)
            if np.isnan(vals).all():  # nanmean of nothing warns
                summary[f"{k}_mean"] = summary[f"{k}_std"] = float("nan")
                continue
            summary[f"{k}_mean"] = float(np.nanmean(vals))
            summary[f"{k}_std"] = float(np.nanstd(vals))
        if extra:  # e.g. the tracer's blend order, per-stage render times
            summary.update(extra)
        out = {"summary": summary, "frames": self.rows}
        os.makedirs(self.result_dir, exist_ok=True)
        with open(os.path.join(self.result_dir, "metrics.json"), "w") as f:
            json.dump(out, f, indent=2)
        return out


class Visualizer:
    """Typed-image writer (bounded thread pool, PNG outputs)."""

    TYPES = ("RENDER", "DEPTH", "ALPHA", "NORMAL", "SURFACE_NORMAL",
             "SPECULAR", "DIFFUSE", "REFLECTION")

    def __init__(self, result_dir: str, types=("RENDER",), save_gt: bool = True,
                 save_error: bool = True, workers: int = 2):
        self.result_dir = result_dir
        self.types = types
        self.save_gt = save_gt
        self.save_error = save_error
        self.pool = ThreadPoolExecutor(max_workers=workers)
        self.futures = []

    def _submit(self, path, im):
        self.futures.append(self.pool.submit(save_image, path, im))

    def visualize(self, out, gt: np.ndarray | None, frame: int, camera: int):
        """`out` is an EnvGSOutput; its maps are copied to the host here."""
        tag = f"frame{frame:04d}_camera{camera:04d}.png"
        host = lambda x: x.detach().cpu().numpy()  # noqa: E731
        makers = {
            "RENDER": lambda: host(out.rgb_map),
            "DEPTH": lambda: colorize_depth(host(out.dpt_map)[..., 0]),
            "ALPHA": lambda: np.repeat(host(out.acc_map), 3, -1),
            "NORMAL": lambda: colorize_normal(host(out.norm_map)),
            "SURFACE_NORMAL": lambda: colorize_normal(host(out.surf_norm_map)),
            "SPECULAR": lambda: np.repeat(host(out.spec_map)[..., :1], 3, -1),
            "DIFFUSE": lambda: host(out.dif_rgb_map),
            "REFLECTION": lambda: host(out.ref_rgb_map),
        }
        maps = {t: makers[t]() for t in self.types}
        for t in self.types:
            self._submit(os.path.join(self.result_dir, t, tag), maps[t])
        if gt is not None and "RENDER" in self.types:
            gt = np.asarray(gt)
            stem = os.path.join(self.result_dir, "RENDER", tag[:-4])
            if self.save_gt:
                self._submit(stem + "_gt.png", gt)
            if self.save_error:
                err = ((maps["RENDER"] - gt) ** 2).sum(-1, keepdims=True)
                self._submit(stem + "_error.png",
                             np.repeat(np.clip(err * 10, 0, 1), 3, -1))

    def summarize(self):
        """Wait for every image; close the pool."""
        try:
            for f in self.futures:
                f.result()
        finally:
            self.futures.clear()
            self.pool.shutdown()
