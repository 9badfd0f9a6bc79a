"""Tensorboard recorder with smoothed stats (port of
envgs_tpu/train/recorder.py).

Windowed SmoothedValue medians and running averages, split-prefixed scalar
and image tags (`TRAIN/loss`, `VAL/psnr_mean`, `VAL/RENDER`), the resolved
config written beside the event files, and the iteration in its state for
resume. Without a writer (recording off, or tensorboard not importable)
it records only the smoothed values.
"""
from __future__ import annotations

import collections
import os

import numpy as np
import torch


class SmoothedValue:
    def __init__(self, window: int = 20):
        self.vals = collections.deque(maxlen=window)
        self.total = 0.0
        self.count = 0

    def update(self, v: float):
        self.vals.append(float(v))
        self.total += float(v)
        self.count += 1

    @property
    def median(self) -> float:
        return float(np.median(self.vals)) if self.vals else 0.0

    @property
    def avg(self) -> float:
        return self.total / max(self.count, 1)


class Recorder:
    def __init__(self, record_dir: str, enabled: bool = True,
                 resolved_config: dict | None = None):
        self.record_dir = record_dir
        self.scalars = collections.defaultdict(SmoothedValue)
        self.iter = 0
        self.writer = None
        if enabled:
            try:
                from torch.utils.tensorboard import SummaryWriter

                os.makedirs(record_dir, exist_ok=True)
                self.writer = SummaryWriter(record_dir)
            except Exception:  # no tensorboard: record nothing to disk
                self.writer = None
        if resolved_config is not None and self.writer is not None:
            import yaml

            with open(os.path.join(record_dir, "config.yaml"), "w") as f:
                yaml.safe_dump(resolved_config, f)

    def record(self, split: str, scalar_stats: dict,
               image_stats: dict | None = None, it: int | None = None):
        """Scalars (each tagged `split/key` with its smoothed median) and
        images ((H, W, 3) in [0, 1], numpy arrays or tensors) at `it`
        (default: the last iteration recorded)."""
        it = self.iter if it is None else it
        self.iter = it
        for k, v in scalar_stats.items():
            self.scalars[k].update(float(v))
            if self.writer is not None:
                self.writer.add_scalar(f"{split}/{k}",
                                       self.scalars[k].median, it)
        if image_stats and self.writer is not None:
            for k, im in image_stats.items():
                if isinstance(im, torch.Tensor):
                    im = im.detach().cpu().numpy()
                self.writer.add_image(f"{split}/{k}", np.clip(im, 0, 1), it,
                                      dataformats="HWC")

    def state_dict(self) -> dict:
        return {"iter": self.iter}

    def load_state_dict(self, d: dict):
        self.iter = int(d.get("iter", 0))

    def close(self):
        if self.writer is not None:
            self.writer.flush()
            self.writer.close()
