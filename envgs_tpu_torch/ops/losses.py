"""Image losses and quality metrics (port of the parts of
envgs_tpu/ops/losses.py the train step uses): l1, l2, psnr, cos_sim and
SSIM with the 11-tap Gaussian window.

SSIM filters separably with shifted adds, as the JAX package does, and
differentiates with plain autograd. (The JAX package's closed-form SSIM
backward is a measure against its TPU compiler, not a different gradient.)
"""
from __future__ import annotations

import torch


def l1(x, y):
    return torch.mean(torch.abs(x - y))


def l2(x, y):
    return torch.mean((x - y) ** 2)


def cos_sim(x, y, dim=-1, eps=1e-8):
    """Cosine similarity with the smooth normalization (finite gradients
    at zero vectors)."""
    xn = x * torch.rsqrt(torch.sum(x * x, dim=dim, keepdim=True) + eps * eps)
    yn = y * torch.rsqrt(torch.sum(y * y, dim=dim, keepdim=True) + eps * eps)
    return torch.sum(xn * yn, dim=dim)


def psnr(x, y, max_val: float = 1.0):
    m = torch.mean((x - y) ** 2)
    return 10.0 * torch.log10(max_val * max_val / torch.clamp(m, min=1e-10))


def _gaussian_window(size: int, sigma: float, device) -> torch.Tensor:
    x = torch.arange(size, dtype=torch.float32, device=device) - (size - 1) / 2.0
    g = torch.exp(-(x ** 2) / (2 * sigma ** 2))
    return g / torch.sum(g)


def _filter2d_sep(img: torch.Tensor, win: torch.Tensor) -> torch.Tensor:
    """Separable 2D filter of (H, W, C), 'valid' padding, as shifted adds."""
    k = win.shape[0]
    H, W = img.shape[0], img.shape[1]
    out = torch.zeros((H - k + 1, W, img.shape[2]), dtype=img.dtype,
                      device=img.device)
    for i in range(k):
        out = out + win[i] * img[i:H - k + 1 + i]
    out2 = torch.zeros((out.shape[0], W - k + 1, img.shape[2]),
                       dtype=img.dtype, device=img.device)
    for i in range(k):
        out2 = out2 + win[i] * out[:, i:W - k + 1 + i]
    return out2


def ssim(x, y, win_size: int = 11, sigma: float = 1.5, max_val: float = 1.0):
    """SSIM of (H, W, C) images, the mean over the valid windows."""
    win = _gaussian_window(win_size, sigma, x.device)
    C1 = (0.01 * max_val) ** 2
    C2 = (0.03 * max_val) ** 2
    mu_x = _filter2d_sep(x, win)
    mu_y = _filter2d_sep(y, win)
    exx = _filter2d_sep(x * x, win)
    eyy = _filter2d_sep(y * y, win)
    exy = _filter2d_sep(x * y, win)
    mu_x2, mu_y2, mu_xy = mu_x * mu_x, mu_y * mu_y, mu_x * mu_y
    sx, sy, sxy = exx - mu_x2, eyy - mu_y2, exy - mu_xy
    num = (2 * mu_xy + C1) * (2 * sxy + C2)
    den = (mu_x2 + mu_y2 + C1) * (sx + sy + C2)
    return torch.mean(num / den)
