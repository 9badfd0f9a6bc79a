"""LPIPS(VGG16) as a differentiable PyTorch graph (port of
envgs_tpu/ops/lpips_jax.py).

The evaluator's LPIPS column and the perceptual training loss
(`perc_loss_weight` from `perc_loss_start_iter`) use it when VGG16 weights
exist on disk: `$ENVGS_VGG16_NPZ`, else `data/weights/vgg16.npz`. The npz
layout is the JAX package's (`conv{i}_w` HWIO, `conv{i}_b`, optional
`lin{i}_w`, the `lpips` package's per-channel calibration), so one file
serves both packages. The repository ships no weights and nothing here
downloads any; without the file `load_weights` returns None and the callers
stay inert (loss) or report NaN (evaluator).

The formula: input scaling ((x * 2 - 1) - shift) / scale, the VGG16 taps
after relu1_2 / relu2_2 / relu3_3 / relu4_3 / relu5_3, each tap normalized
over its channels by rsqrt(sum of squares + 1e-10), squared differences,
weighted by lin{i}_w and summed over channels when the npz has them, else
averaged, then averaged over the pixels and summed over the taps. The
convolutions are the library's (F.conv2d, padding 1) as JAX's are
lax.conv outside any Pallas kernel; TF32 stays off (package __init__).
"""
from __future__ import annotations

import functools
import os

import numpy as np
import torch
import torch.nn.functional as F

# VGG16 "features" conv channel plan; "M" = 2x2 / 2 max pool
_PLAN = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
         512, 512, 512, "M", 512, 512, 512, "M"]
# taps: the convolutions (0-based over the convolutions only) after whose
# relu the features are taken
_TAPS = {1, 3, 6, 9, 12}

_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)


def default_weight_path() -> str:
    return os.environ.get(
        "ENVGS_VGG16_NPZ", os.path.join("data", "weights", "vgg16.npz"))


def load_weights(path: str | None = None, device="cpu"):
    """npz {conv0_w (kh, kw, cin, cout), conv0_b (cout), ..., lin0_w (C0,),
    ...} -> (convs [(w (cout, cin, kh, kw), b)], lins [(C,)] or None) on
    `device`, or None when the file does not exist or holds no
    convolution."""
    path = path or default_weight_path()
    if not os.path.exists(path):
        return None
    z = np.load(path)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)  # noqa: E731
    convs = []
    i = 0
    while f"conv{i}_w" in z:
        w = np.transpose(z[f"conv{i}_w"], (3, 2, 0, 1))  # HWIO -> OIHW
        convs.append((t(np.ascontiguousarray(w)), t(z[f"conv{i}_b"])))
        i += 1
    if not convs:
        return None
    lins = None
    if "lin0_w" in z:
        lins = []
        j = 0
        while f"lin{j}_w" in z:
            lins.append(t(z[f"lin{j}_w"]).reshape(-1))
            j += 1
    return convs, lins


def save_weights_from_torchvision(path: str | None = None) -> str:
    """Write torchvision's VGG16 checkpoint in the npz layout, with the
    `lpips` package's lin0..lin4 calibration when that package imports
    (both checkpoints must be in their caches or downloadable: run it on a
    machine that has them). Raises ImportError without torchvision."""
    import torchvision

    net = torchvision.models.vgg16(weights="IMAGENET1K_V1").features
    path = path or default_weight_path()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    out = {}
    i = 0
    for layer in net:
        if isinstance(layer, torch.nn.Conv2d):
            w = layer.weight.detach().cpu().numpy()  # (cout, cin, kh, kw)
            out[f"conv{i}_w"] = np.transpose(w, (2, 3, 1, 0))
            out[f"conv{i}_b"] = layer.bias.detach().cpu().numpy()
            i += 1
    try:
        import lpips as _lpips_pkg

        m = _lpips_pkg.LPIPS(net="vgg", verbose=False)
        for j, lin in enumerate(m.lins):
            out[f"lin{j}_w"] = lin.model[-1].weight.detach().cpu().numpy(
            ).reshape(-1)
    except Exception as e:  # the package or its checkpoint is absent
        print(f"[lpips] lin weights NOT exported ({e}); the npz gives the "
              "uncalibrated VGG distance")
    np.savez_compressed(path, **out)
    return path


def vgg16_taps(convs, x: torch.Tensor) -> list:
    """x (N, H, W, 3) in [0, 1] -> the five tap feature maps (post-relu),
    each (N, C, h, w)."""
    shift = torch.as_tensor(_SHIFT, device=x.device).view(1, 3, 1, 1)
    scale = torch.as_tensor(_SCALE, device=x.device).view(1, 3, 1, 1)
    h = ((x.permute(0, 3, 1, 2) * 2.0 - 1.0) - shift) / scale
    taps = []
    ci = 0
    for item in _PLAN:
        if item == "M":
            h = F.max_pool2d(h, 2, 2)
            continue
        w, b = convs[ci]
        h = F.relu(F.conv2d(h, w, b, padding=1))
        if ci in _TAPS:
            taps.append(h)
        ci += 1
    return taps


def lpips_pair(params, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """LPIPS distance of two (H, W, 3) images in [0, 1], differentiable
    (the perceptual loss). params: (convs, lins) from load_weights. With
    lins each tap gives mean_hw(sum_c lin[c] (nx - ny)_c^2), the lpips
    package's formula; without them mean((nx - ny)^2), the uncalibrated
    VGG distance. Both images go through the network as one batch."""
    convs, lins = params
    dist = x.new_zeros(())
    for i, f in enumerate(vgg16_taps(convs, torch.stack([x, y]))):
        n = f * torch.rsqrt(torch.sum(f * f, dim=1, keepdim=True) + 1e-10)
        d2 = (n[0] - n[1]) ** 2
        if lins is not None:
            dist = dist + torch.mean(torch.sum(d2 * lins[i].view(-1, 1, 1),
                                               dim=0))
        else:
            dist = dist + torch.mean(d2)
    return dist


@functools.lru_cache(maxsize=4)
def lpips_fn(path: str | None = None, device="cpu"):
    """fn(x, y) -> LPIPS over the weights at `path` (default_weight_path)
    on `device`, or None when no weight file exists (the JAX package's
    jitted_lpips). Cached per (path, device): the weights load once."""
    params = load_weights(path, device)
    if params is None:
        return None
    return functools.partial(lpips_pair, params)
