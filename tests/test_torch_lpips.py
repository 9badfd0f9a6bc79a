"""The port's remaining losses (mse, charbonnier, huber, l1_reg, msssim) and
its LPIPS graph (ops/lpips.py) against the JAX package's, on seeded numpy
inputs and a random VGG16 written as the npz both packages read; the
evaluator's LPIPS column with and without that file.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_lpips.py
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from envgs_tpu.ops import losses as jlosses
from envgs_tpu.ops import lpips_jax as jlp
from envgs_tpu_torch.ops import losses as tlosses
from envgs_tpu_torch.ops import lpips as tlp
from envgs_tpu_torch.train.evaluator import Evaluator

LOSS_RTOL = 1e-6  # the five losses, relative
LOSS_GRAD_RTOL = 1e-5  # their gradients, max|d| / max|ref|
LPIPS_RTOL = 1e-4  # LPIPS, relative: five taps of 3x3 convolutions
LPIPS_GRAD_RTOL = 5e-4  # its gradient with respect to x, of the largest


def write_vgg_npz(path, seed=0, lins=False):
    """A random VGG16 in the JAX package's npz layout (conv{i}_w HWIO,
    conv{i}_b, with `lins` the five lin{i}_w), He-scaled so the taps keep
    their size through the 13 convolutions -> the path."""
    rng = np.random.default_rng(seed)
    out, cin, i = {}, 3, 0
    for item in jlp._PLAN:
        if item == "M":
            continue
        std = np.sqrt(2.0 / (9 * cin))
        out[f"conv{i}_w"] = (rng.normal(size=(3, 3, cin, item)) * std).astype(
            np.float32)
        out[f"conv{i}_b"] = (rng.normal(size=item) * 0.05).astype(np.float32)
        cin, i = item, i + 1
    if lins:
        for j, c in enumerate((64, 128, 256, 512, 512)):
            out[f"lin{j}_w"] = rng.random(c).astype(np.float32)
    np.savez(path, **out)
    return str(path)


def _pair(rng, H=64, W=64):
    x = rng.random((H, W, 3)).astype(np.float32)
    y = np.clip(x + rng.normal(scale=0.1, size=x.shape), 0, 1).astype(
        np.float32)
    return x, y


@pytest.mark.parametrize("name,kw", [
    ("mse", {}), ("charbonnier", {}), ("charbonnier", {"eps": 0.05}),
    ("huber", {}), ("huber", {"delta": 0.1}), ("l1_reg", {}),
    ("msssim", {}), ("msssim", {"levels": 2})])
def test_loss_matches_jax(name, kw):
    """Value within 1e-6 relative, the gradient with respect to every
    argument within 1e-5 of its largest (96x80: msssim runs 3 levels)."""
    rng = np.random.default_rng(1)
    x, y = _pair(rng, 96, 80)
    args = (x,) if name == "l1_reg" else (x, y)
    jf, tf = getattr(jlosses, name), getattr(tlosses, name)
    jv, jg = jax.value_and_grad(
        lambda *a: jf(*a, **kw), argnums=tuple(range(len(args))))(
            *map(jnp.asarray, args))
    targs = [torch.tensor(a, requires_grad=True) for a in args]
    tv = tf(*targs, **kw)
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=LOSS_RTOL)
    for got, want in zip(torch.autograd.grad(tv, targs), jg):
        want = np.asarray(want)
        err = np.abs(got.numpy() - want).max()
        assert err <= LOSS_GRAD_RTOL * np.abs(want).max(), (err,
                                                             np.abs(want).max())


@pytest.mark.parametrize("lins", [False, True], ids=["vgg", "lins"])
def test_lpips_pair_matches_jax(tmp_path, lins):
    """The same npz through both packages' load_weights and lpips_pair at
    64x64: the distance within 1e-4 relative, its gradient with respect to
    x within 5e-4 of the largest; a pair at distance 0 gives 0."""
    path = write_vgg_npz(tmp_path / "vgg16.npz", lins=lins)
    jparams = jlp.load_weights(path)
    tparams = tlp.load_weights(path)
    assert (tparams[1] is not None) == lins == (jparams[1] is not None)
    x, y = _pair(np.random.default_rng(2))
    jv, jgx = jax.value_and_grad(jlp.lpips_pair, argnums=1)(
        jparams, jnp.asarray(x), jnp.asarray(y))
    tx = torch.tensor(x, requires_grad=True)
    tv = tlp.lpips_pair(tparams, tx, torch.tensor(y))
    assert float(jv) > 0
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=LPIPS_RTOL)
    (tgx,) = torch.autograd.grad(tv, tx)
    jgx = np.asarray(jgx)
    err = np.abs(tgx.numpy() - jgx).max()
    assert err <= LPIPS_GRAD_RTOL * np.abs(jgx).max(), (err, np.abs(jgx).max())
    assert float(tlp.lpips_pair(tparams, tx.detach(), tx.detach())) < 1e-9
    # the cached constructor: the same function, one load per (path, device)
    fn = tlp.lpips_fn(path, torch.device("cpu"))
    assert fn is tlp.lpips_fn(path, torch.device("cpu"))
    np.testing.assert_allclose(float(fn(tx.detach(), torch.tensor(y))),
                               float(tv.detach()),
                               rtol=1e-6)


def test_vgg16_taps_match_jax(tmp_path):
    """The five taps (post-relu feature maps) of one image, NCHW against
    JAX's NHWC, within 1e-4 of each tap's largest."""
    path = write_vgg_npz(tmp_path / "vgg16.npz", seed=3)
    x = np.random.default_rng(3).random((1, 48, 40, 3)).astype(np.float32)
    want = jlp.vgg16_taps(jlp.load_weights(path)[0], jnp.asarray(x))
    got = tlp.vgg16_taps(tlp.load_weights(path)[0], torch.tensor(x))
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        w = np.asarray(w).transpose(0, 3, 1, 2)
        assert g.shape == w.shape
        assert np.abs(g.numpy() - w).max() <= 1e-4 * np.abs(w).max()


def test_load_weights_reads_the_jax_layout(tmp_path):
    """One npz, both readers: the same convolutions (HWIO read as OIHW)
    and calibration; no file, or a file without convolutions, gives None
    in both packages, and then the constructor and the host LPIPS give
    None (no torchvision on these machines) and nothing is downloaded."""
    path = write_vgg_npz(tmp_path / "vgg16.npz", seed=4, lins=True)
    jc, jl = jlp.load_weights(path)
    tc, tl = tlp.load_weights(path)
    assert len(tc) == len(jc) == 13 and len(tl) == len(jl) == 5
    for (tw, tb), (jw, jb) in zip(tc, jc):
        np.testing.assert_array_equal(tw.numpy().transpose(2, 3, 1, 0), jw)
        np.testing.assert_array_equal(tb.numpy(), jb)
    for a, b in zip(tl, jl):
        np.testing.assert_array_equal(a.numpy(), b)
    missing = str(tmp_path / "none.npz")
    empty = str(tmp_path / "empty.npz")
    np.savez(empty, other=np.zeros(3))
    for p in (missing, empty):
        assert tlp.load_weights(p) is None and jlp.load_weights(p) is None
    assert tlp.lpips_fn(missing) is None
    try:
        import torchvision  # noqa: F401
    except ImportError:
        x = np.zeros((16, 16, 3), np.float32)
        assert tlosses.lpips(x, x) is None
        with pytest.raises(ImportError):
            tlp.save_weights_from_torchvision(str(tmp_path / "tv.npz"))


@pytest.mark.parametrize("weights", [False, True], ids=["none", "npz"])
def test_evaluator_lpips_column(tmp_path, monkeypatch, weights):
    """Without a weight file the LPIPS column is NaN (as the JAX package
    reports it without weights); with $ENVGS_VGG16_NPZ naming one it is
    the graph's distance, equal to the JAX package's evaluator's."""
    from envgs_tpu.train.evaluator import Evaluator as JEvaluator

    path = str(tmp_path / "vgg16.npz")
    if weights:
        write_vgg_npz(path, seed=5, lins=True)
    monkeypatch.setenv("ENVGS_VGG16_NPZ", path)
    jlp.jitted_lpips.cache_clear()  # keyed by None: reads the variable
    x, y = _pair(np.random.default_rng(6), 40, 48)
    row = Evaluator(str(tmp_path / "t")).evaluate(torch.tensor(x), y)
    jrow = JEvaluator(str(tmp_path / "j")).evaluate(x, y)
    jlp.jitted_lpips.cache_clear()
    if not weights:
        assert np.isnan(row["lpips"]) and np.isnan(jrow["lpips"])
        return
    assert np.isfinite(row["lpips"]) and row["lpips"] > 0
    np.testing.assert_allclose(row["lpips"], jrow["lpips"], rtol=LPIPS_RTOL)
    for k in ("psnr", "ssim"):
        np.testing.assert_allclose(row[k], jrow[k], rtol=1e-4)
