"""Dataset moderators (the port's own copy of envgs_tpu/train/
moderators.py): the render-ratio and centre-crop schedules as functions of
the iteration, snapped to a few buckets so that each bucket's image size
builds its train step once, the view resize / crop they apply on the host
(numpy maps; K stays a tensor on the camera's device), and the alternating
patch / full pattern. Registered under the reference's moderator names.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

from envgs_tpu_torch.engine import MODERATORS


class RatioSchedule(NamedTuple):
    """A linear ramp from ratio_start to ratio_end over [iter_start,
    iter_end], snapped down to `buckets` (DatasetRatioModerator)."""

    ratio_start: float = 0.25
    ratio_end: float = 1.0
    iter_start: int = 0
    iter_end: int = 10000
    buckets: tuple = (0.25, 0.5, 0.75, 1.0)

    def __call__(self, it: int) -> float:
        if it <= self.iter_start:
            r = self.ratio_start
        elif it >= self.iter_end:
            r = self.ratio_end
        else:
            span = max(self.iter_end - self.iter_start, 1)
            t = (it - self.iter_start) / span
            r = self.ratio_start + t * (self.ratio_end - self.ratio_start)
        b = [x for x in self.buckets if x <= r + 1e-6]
        return b[-1] if b else self.buckets[0]


class CenterCropSchedule(NamedTuple):
    """The centre-crop ratio, ramped and snapped as RatioSchedule
    (DatasetCenterCropRatioModerator)."""

    crop_start: float = 0.5
    crop_end: float = 1.0
    iter_start: int = 0
    iter_end: int = 5000
    buckets: tuple = (0.5, 0.75, 1.0)

    def __call__(self, it: int) -> float:
        return RatioSchedule(self.crop_start, self.crop_end, self.iter_start,
                             self.iter_end, self.buckets)(it)


def center_crop_view(view: dict, ratio: float) -> dict:
    """The central `ratio` of the view, its size snapped down to multiples
    of 16; the principal point follows the crop window."""
    if abs(ratio - 1.0) < 1e-6:
        return view
    cam = view["camera"]
    H = max(int(cam.H * ratio) // 16 * 16, 16)
    W = max(int(cam.W * ratio) // 16 * 16, 16)
    y0 = (cam.H - H) // 2
    x0 = (cam.W - W) // 2
    K = cam.K.clone()
    K[0, 2] -= x0
    K[1, 2] -= y0
    out = dict(view)
    out["camera"] = cam._replace(H=H, W=W, K=K)
    for k in ("rgb", "msk", "norm", "dpt"):
        if k in view:
            out[k] = view[k][y0:y0 + H, x0:x0 + W]
    return out


def resize_view(view: dict, ratio: float) -> dict:
    """The view resized by `ratio` (sizes snapped down to multiples of 16,
    nearest samples), K rescaled."""
    if abs(ratio - 1.0) < 1e-6:
        return view
    cam = view["camera"]
    H, W = int(cam.H * ratio) // 16 * 16, int(cam.W * ratio) // 16 * 16
    ry, rx = H / cam.H, W / cam.W
    K = cam.K.clone()
    K[0] *= rx
    K[1] *= ry
    out = dict(view)
    out["camera"] = cam._replace(H=H, W=W, K=K)
    for k in ("rgb", "msk", "norm", "dpt"):
        if k in view:
            im = view[k]
            yy = np.linspace(0, im.shape[0] - 1, H).astype(int)
            xx = np.linspace(0, im.shape[1] - 1, W).astype(int)
            out[k] = im[yy][:, xx]
    return out


class AlternatingSchedule(NamedTuple):
    """The sampling pattern of each iteration, in turn (AlternatingModerator:
    "patch" iterations train a patch crop, "full" ones the whole image)."""

    patterns: tuple = ("patch", "full")

    def __call__(self, it: int) -> str:
        return self.patterns[it % len(self.patterns)]


class NoopSchedule(NamedTuple):
    """NoopModerator: the dataset is left as it is."""

    def __call__(self, it: int):
        return None


MODERATORS.register(RatioSchedule, name="DatasetRatioModerator")
MODERATORS.register(CenterCropSchedule, name="DatasetCenterCropRatioModerator")
MODERATORS.register(AlternatingSchedule, name="AlternatingModerator")
MODERATORS.register(NoopSchedule, name="NoopModerator")
