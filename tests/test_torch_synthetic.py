"""The port's synthetic capture (data/synthetic.py::make_scene) against the
JAX package's: the same pools and cameras rendered through the reference
renderers in training mode, images and normals within 5e-5, masks equal.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_synthetic.py
"""
import numpy as np

from envgs_tpu.data import synthetic as jsyn
from envgs_tpu_torch.data import synthetic as tsyn
from torch_threads import one_thread  # noqa: F401

ATOL = 5e-5  # float32 rounding of the two reference renders


def test_make_scene_matches_jax(one_thread):
    want = jsyn.make_scene(n_views=2, H=64, W=64)
    got = tsyn.make_scene(n_views=2, H=64, W=64, device="cpu")
    for i in range(2):
        np.testing.assert_allclose(got.images[i], want.images[i], rtol=0,
                                   atol=ATOL, err_msg=f"image {i}")
        np.testing.assert_allclose(got.normals[i], want.normals[i], rtol=0,
                                   atol=ATOL, err_msg=f"normal {i}")
        np.testing.assert_array_equal(got.masks[i], want.masks[i])
        assert 0.1 < got.masks[i].mean() < 1.0  # the scene is in view
        np.testing.assert_array_equal(got.cams[i].K.numpy(), want.cams[i].K)
