"""The committed golden scenes (tests/golden/<name>/) rendered through the
port: ply -> train/checkpoints.py import -> pool -> render, as
tests/golden_harness.py renders them through the JAX package. Each scene
must reach its own camera.json psnr_threshold against its golden.png,
through the plain versions of the kernels (the default backends on CPU
tensors) and through the `ref` oracles; the port's PNG reader equals the
harness's.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_golden.py
"""
import os

import numpy as np
import pytest

from envgs_tpu_torch.utils import golden
from tests.golden_harness import _read_png
from torch_threads import one_thread  # noqa: F401

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
SCENES = golden.golden_dirs(ROOT)


def test_golden_scenes_are_found():
    assert {os.path.basename(d) for d in SCENES} >= {"synthetic",
                                                     "envgs_synthetic"}


@pytest.mark.parametrize("backend", ["pallas", "ref"])
@pytest.mark.parametrize("scene_dir", SCENES,
                         ids=[os.path.basename(d) for d in SCENES])
def test_golden_render_through_the_port(scene_dir, backend,
                                        one_thread):
    thr = golden.scene_spec(scene_dir).get("psnr_threshold", 35.0)
    psnr, rgb = golden.psnr_vs_golden(scene_dir, "cpu", backend)
    assert psnr >= thr, f"{os.path.basename(scene_dir)}: {psnr:.2f} < {thr}"
    assert rgb.shape[-1] == 3 and float(rgb.std()) > 0.01


@pytest.mark.parametrize("scene_dir", SCENES,
                         ids=[os.path.basename(d) for d in SCENES])
def test_png_reader_matches_the_harness(scene_dir):
    path = os.path.join(scene_dir, "golden.png")
    np.testing.assert_array_equal(golden.read_png(path), _read_png(path))
