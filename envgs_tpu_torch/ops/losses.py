"""Image losses and quality metrics (port of envgs_tpu/ops/losses.py):
l1 / l2 / mse / charbonnier / huber / l1_reg, psnr, cos_sim, SSIM with the
11-tap Gaussian window, a band's share of an image's SSIM (`ssim_masked`),
MS-SSIM, and the host LPIPS through torchvision's VGG16 when that is
installed.

SSIM filters separably with shifted adds, as the JAX package does, and
differentiates with plain autograd. (The JAX package's closed-form SSIM
backward is a measure against its TPU compiler, not a different gradient.)
`ssim_masked` keeps the JAX package's closed-form backward, as a
torch.autograd.Function.
"""
from __future__ import annotations

import functools
import math

import torch


def l1(x, y):
    return torch.mean(torch.abs(x - y))


def l2(x, y):
    return torch.mean((x - y) ** 2)


def mse(x, y):
    return l2(x, y)


def charbonnier(x, y, eps: float = 1e-3):
    return torch.mean(torch.sqrt((x - y) ** 2 + eps * eps))


def huber(x, y, delta: float = 1.0):
    d = torch.abs(x - y)
    return torch.mean(torch.where(d < delta, 0.5 * d * d,
                                  delta * (d - 0.5 * delta)))


def l1_reg(x):
    return torch.mean(torch.abs(x))


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


def _ssim_fields(x, y, win):
    """The five window-filtered moment maps SSIM is built from."""
    return (_filter2d_sep(x, win), _filter2d_sep(y, win),
            _filter2d_sep(x * x, win), _filter2d_sep(y * y, win),
            _filter2d_sep(x * y, win))


def _ssim_map(fields, C1, C2):
    mu_x, mu_y, exx, eyy, exy = fields
    mu_x2, mu_y2, mu_xy = mu_x * mu_x, mu_y * mu_y, mu_x * mu_y
    sx, sy, sxy = exx - mu_x2, eyy - mu_y2, exy - mu_xy
    num = (2 * mu_xy + C1) * (2 * sxy + C2)
    den = (mu_x2 + mu_y2 + C1) * (sx + sy + C2)
    return num / den


def ssim(x, y, win_size: int = 11, sigma: float = 1.5, max_val: float = 1.0):
    """SSIM of (H, W, C) images, the mean over the valid windows."""
    win = _gaussian_window(win_size, sigma, x.device)
    C1 = (0.01 * max_val) ** 2
    C2 = (0.03 * max_val) ** 2
    return torch.mean(_ssim_map(_ssim_fields(x, y, win), C1, C2))


class _SSIMMasked(torch.autograd.Function):
    """ssim_masked with the JAX package's closed-form backward: with
    A = 2 mu_x mu_y + C1, B = 2 s_xy + C2, D = mu_x^2 + mu_y^2 + C1,
    E = s_x + s_y + C2 and S = A B / (D E), the partials of S through
    each moment map, weighted by the row mask / n_global, pass through one
    stacked full correlation with the (symmetric) window."""

    @staticmethod
    def forward(ctx, x, y, row_mask, n_global, win_size, sigma, max_val):
        win = _gaussian_window(win_size, sigma, x.device)
        C1, C2 = (0.01 * max_val) ** 2, (0.03 * max_val) ** 2
        ctx.save_for_backward(x, y, row_mask)
        ctx.consts = (n_global, win_size, sigma, max_val)
        S = _ssim_map(_ssim_fields(x, y, win), C1, C2)
        return torch.sum(S * row_mask) / n_global

    @staticmethod
    def backward(ctx, g):
        x, y, row_mask = ctx.saved_tensors
        n_global, win_size, sigma, max_val = ctx.consts
        win = _gaussian_window(win_size, sigma, x.device)
        C1, C2 = (0.01 * max_val) ** 2, (0.03 * max_val) ** 2
        mu_x, mu_y, exx, eyy, exy = _ssim_fields(x, y, win)
        mu_x2, mu_y2, mu_xy = mu_x * mu_x, mu_y * mu_y, mu_x * mu_y
        sx, sy, sxy = exx - mu_x2, eyy - mu_y2, exy - mu_xy
        A = 2 * mu_xy + C1
        B = 2 * sxy + C2
        D = mu_x2 + mu_y2 + C1
        E = sx + sy + C2
        inv_DE = 1.0 / (D * E)
        S = A * B * inv_DE
        w = g * row_mask / n_global
        d_exx = -S / E * w
        d_eyy = -S / E * w
        d_exy = 2 * A * inv_DE * w
        d_mu_x = (2 * mu_y * (B - A) * inv_DE
                  + 2 * mu_x * S * (1 / E - 1 / D)) * w
        d_mu_y = (2 * mu_x * (B - A) * inv_DE
                  + 2 * mu_y * S * (1 / E - 1 / D)) * w
        k = win_size - 1
        t = torch.cat([d_mu_x, d_mu_y, d_exx, d_eyy, d_exy], dim=-1)
        t = torch.nn.functional.pad(t, (0, 0, k, k, k, k))
        t = _filter2d_sep(t, win.flip(0))
        C = x.shape[-1]
        t_mu_x, t_mu_y, t_exx, t_eyy, t_exy = (
            t[..., i * C:(i + 1) * C] for i in range(5))
        dx = t_mu_x + 2 * x * t_exx + y * t_exy
        dy = t_mu_y + 2 * y * t_eyy + x * t_exy
        return dx, dy, None, None, None, None, None


def ssim_masked(x, y, row_mask, n_global, win_size: int = 11,
                sigma: float = 1.5, max_val: float = 1.0):
    """This band's share of an image's SSIM mean (the band-parallel SSIM).

    x, y: the band's rows extended by the halo rows of the neighbouring
    bands (win_size // 2 a side), so that every window of the full image
    is computed by exactly one band; row_mask (rows of valid windows, 1, 1)
    keeps the windows this band owns; n_global: the full image's count of
    valid-window elements. The shares of all bands sum to ssim() of the
    image."""
    return _SSIMMasked.apply(x, y, row_mask, n_global, win_size, sigma,
                             max_val)


def msssim(x, y, win_size: int = 11, levels: int = 5):
    """Multi-scale SSIM of (H, W, C) images with the standard level
    weights; the levels are clamped so that the coarsest scale still holds
    one window."""
    max_levels = max(1, int(math.floor(
        math.log2(min(x.shape[0], x.shape[1]) / win_size))) + 1)
    levels = min(levels, max_levels)
    weights = torch.tensor([0.0448, 0.2856, 0.3001, 0.2363, 0.1333],
                           device=x.device)[:levels]
    weights = weights / torch.sum(weights)
    win = _gaussian_window(win_size, 1.5, x.device)
    C1, C2 = 0.01 ** 2, 0.03 ** 2
    vals = []
    for lvl in range(levels):
        mu_x = _filter2d_sep(x, win)
        mu_y = _filter2d_sep(y, win)
        sx = _filter2d_sep(x * x, win) - mu_x * mu_x
        sy = _filter2d_sep(y * y, win) - mu_y * mu_y
        sxy = _filter2d_sep(x * y, win) - mu_x * mu_y
        cs = torch.mean((2 * sxy + C2) / (sx + sy + C2))
        if lvl == levels - 1:
            lum = torch.mean((2 * mu_x * mu_y + C1)
                             / (mu_x * mu_x + mu_y * mu_y + C1))
            vals.append(torch.clamp(lum * cs, min=1e-6))
        else:
            vals.append(torch.clamp(cs, min=1e-6))
            H, W = x.shape[0] // 2 * 2, x.shape[1] // 2 * 2  # 2x average pool
            x = x[:H, :W].reshape(H // 2, 2, W // 2, 2, -1).mean((1, 3))
            y = y[:H, :W].reshape(H // 2, 2, W // 2, 2, -1).mean((1, 3))
    return torch.prod(torch.stack(vals) ** weights)


@functools.lru_cache(maxsize=1)
def _lpips_net():
    """torchvision's pretrained VGG16 features, or None where torchvision
    is not installed or its weights cannot be had (neither machine of this
    repository has torchvision)."""
    try:
        import torchvision

        return torchvision.models.vgg16(weights="IMAGENET1K_V1").features.eval()
    except Exception:  # no package, no cached weights, no network
        return None


def lpips(x, y):
    """LPIPS(VGG) of (H, W, 3) images in [0, 1] (arrays or tensors) on the
    host through torchvision's VGG16 (the lin{i}_w calibration of
    ops/lpips.py's npz applied per tap when the npz carries it) -> float,
    or None without the network. The evaluator's fallback where no npz of
    VGG16 weights exists."""
    net = _lpips_net()
    if net is None:
        return None
    from envgs_tpu_torch.ops.lpips import _SCALE, _SHIFT, load_weights

    lw = load_weights(device="cpu")
    lins = lw[1] if lw is not None else None
    shift = torch.from_numpy(_SHIFT).view(1, 3, 1, 1)
    scale = torch.from_numpy(_SCALE).view(1, 3, 1, 1)

    def prep(a):
        a = torch.as_tensor(a, dtype=torch.float32).cpu()
        return (a.permute(2, 0, 1)[None] * 2 - 1 - shift) / scale

    taps = {3, 8, 15, 22, 29}  # the relu after each tap's last convolution
    with torch.no_grad():
        fx, fy = prep(x), prep(y)
        dist, ti = 0.0, 0
        for i, layer in enumerate(net):
            fx, fy = layer(fx), layer(fy)
            if i in taps:
                nx = fx / (fx.norm(dim=1, keepdim=True) + 1e-10)
                ny = fy / (fy.norm(dim=1, keepdim=True) + 1e-10)
                d2 = (nx - ny) ** 2
                if lins is not None:
                    dist = dist + (d2 * lins[ti].view(1, -1, 1, 1)).sum(
                        dim=1).mean()
                else:
                    dist = dist + d2.mean()
                ti += 1
    return float(dist)
