"""Parity of the port's pool maintenance with the JAX package:
densify_and_prune (both split recipes, the weight-quantile split, the
visibility budget, a pool too full for every child) fed JAX's own split
draws, reset_opacity, and create_pool with 3 scale axes."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from envgs_tpu.models import gaussians as jg
from envgs_tpu_torch.models import gaussians as tg

P = 70


def _pools(scale_axes, cap, seed):
    """The same mid-training pool in both packages: random scales (some
    above the split size, some too big), opacities (some below the prune
    floor), statistics and Adam moments."""
    rng = np.random.default_rng(seed)
    xyz = rng.normal(size=(P, 3)).astype(np.float32)
    jp = jg.create_pool(xyz, rng.random((P, 3)).astype(np.float32), cap=cap,
                        sh_degree=1, scale_axes=scale_axes, seed=seed)
    act = np.asarray(jp.stats.active)
    params = {k: np.asarray(v) for k, v in jp.params._asdict().items()
              if v is not None}
    scales = rng.uniform(0.002, 0.06, (cap, scale_axes))
    scales[: cap // 3] *= 0.1  # small enough to clone
    params["scaling"] = np.log(scales).astype(np.float32)
    params["opacity"] = rng.normal(size=(cap, 1)).astype(np.float32) * 2
    denom = np.where(act, rng.integers(0, 4, cap), 0).astype(np.float32)
    stats = dict(
        active=act,
        max_radii2d=(rng.random(cap) * 30).astype(np.float32),
        grad_accum=(rng.random(cap) * 6e-4 * denom).astype(np.float32),
        weight_accum=(rng.random(cap) * denom).astype(np.float32),
        denom=denom, sh_degree=np.asarray(1, np.int32))
    mu, nu = ({k: rng.normal(size=v.shape).astype(np.float32)
               for k, v in params.items()} for _ in range(2))
    jpool = jg.GaussianPool(
        jg.GaussianParams(**{k: jnp.asarray(v) for k, v in params.items()}),
        jg.GaussianStats(**{k: jnp.asarray(v) for k, v in stats.items()}), 1)
    jadam = tuple(jg.GaussianParams(**{k: jnp.asarray(v)
                                       for k, v in m.items()})
                  for m in (mu, nu))
    tpool = tg.pool_from_numpy(params, stats, 1)
    tadam = tuple(tg.GaussianParams(**{k: torch.tensor(v)
                                       for k, v in m.items()})
                  for m in (mu, nu))
    return (jpool, jadam), (tpool, tadam)


def _jax_eps(key, cfg: jg.DensifyConfig, cap):
    """The split draws of envgs_tpu's densify_and_prune, in its order."""
    eps = []
    for _ in range(cfg.split_n + cfg.weight_split_n):
        key, sub = jax.random.split(key)
        eps.append(torch.tensor(np.asarray(jax.random.normal(sub, (cap, 3)))))
    return eps


CASES = {
    # surfels, the default recipe: clone, gradient split, prune by opacity
    # and scene size
    "surfel": (2, 200, dict(spatial_scale=0.4)),
    # 3D Gaussians in a pool too small for every child; the weight-quantile
    # split, screen-size thresholds, the gradient floor and the budget
    "gauss3d": (3, 100, dict(
        spatial_scale=0.5, min_weight_threshold=0.4,
        split_screen_threshold=20.0,
        max_screen_threshold=27.0, min_gradient=2e-5, prune_visibility=True,
        max_gs=40, max_gs_threshold=0.9)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_densify_and_prune_matches_jax(case):
    """Masks, `active` and the slots the children land in exactly; params
    and moments within 1e-6; every statistic reset."""
    axes, cap, kw = CASES[case]
    (jpool, jadam), (tpool, tadam) = _pools(axes, cap, seed=axes)
    jcfg, tcfg = jg.DensifyConfig(**kw), tg.DensifyConfig(**kw)
    key = jax.random.PRNGKey(7)
    jnew, jmom = jax.jit(jg.densify_and_prune, static_argnums=2)(
        jpool, jadam, jcfg, key)
    tnew, tmom = tg.densify_and_prune(tpool, tadam, tcfg,
                                      eps=_jax_eps(key, jcfg, cap))
    np.testing.assert_array_equal(tnew.stats.active.numpy(),
                                  np.asarray(jnew.stats.active))
    before = np.asarray(jpool.stats.active)
    after = np.asarray(jnew.stats.active)
    born = after & ~before
    assert born.sum() > 5 and (before & ~after).sum() > 5, case
    if case == "gauss3d":  # the pool was too small: children were dropped
        assert (~before).sum() == born.sum()
    for k in tg.GaussianParams._fields:
        np.testing.assert_allclose(getattr(tnew.params, k).numpy(),
                                   np.asarray(getattr(jnew.params, k)),
                                   atol=1e-6, rtol=1e-6, err_msg=k)
        for tm, jm in zip(tmom, jmom):
            np.testing.assert_allclose(getattr(tm, k).numpy(),
                                       np.asarray(getattr(jm, k)), atol=1e-6,
                                       err_msg=k)
    for k in jg.GaussianStats._fields:
        np.testing.assert_array_equal(getattr(tnew.stats, k).numpy(),
                                      np.asarray(getattr(jnew.stats, k)))


def test_reset_opacity_matches_jax():
    (jpool, jadam), (tpool, tadam) = _pools(3, 100, seed=5)
    jnew, jmom = jg.reset_opacity(jpool, jadam)
    tnew, tmom = tg.reset_opacity(tpool, tadam)
    np.testing.assert_allclose(tnew.params.opacity.numpy(),
                               np.asarray(jnew.params.opacity), atol=1e-6)
    assert float(tg.sigmoid(tnew.params.opacity).max()) <= 0.01 + 1e-6
    for tm, jm in zip(tmom, jmom):
        for k in tg.GaussianParams._fields:
            np.testing.assert_array_equal(getattr(tm, k).numpy(),
                                          np.asarray(getattr(jm, k)))
    assert not tmom[0].opacity.any() and tmom[0].xyz.any()


def test_create_pool_scale_axes():
    """create_pool(scale_axes=3) against the JAX package's: 3 equal
    3-NN log-scales per point, the same draws for everything else."""
    rng = np.random.default_rng(9)
    xyz = rng.normal(size=(30, 3)).astype(np.float32)
    rgb = rng.random((30, 3)).astype(np.float32)
    jp = jg.create_pool(xyz, rgb, cap=40, scale_axes=3, seed=2)
    tp = tg.create_pool(xyz, rgb, cap=40, scale_axes=3, seed=2)
    assert tuple(tp.params.scaling.shape) == (40, 3)
    for k, v in jp.params._asdict().items():
        if v is not None:
            np.testing.assert_allclose(getattr(tp.params, k).numpy(),
                                       np.asarray(v), atol=1e-6, err_msg=k)
