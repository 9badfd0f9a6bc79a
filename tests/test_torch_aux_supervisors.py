"""The port's aux supervisors (train/aux_supervisors.py) against the JAX
package's, function by function on seeded numpy inputs: values within
1e-5 relative, gradients (where JAX differentiates) within 5e-4 of the
largest, integer outputs equal; AuxLossConfig's fields and defaults; and
compute_aux_losses' stats for the same dicts.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_aux_supervisors.py
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from envgs_tpu.train import aux_supervisors as jaux
from envgs_tpu_torch.train import aux_supervisors as taux

RTOL = 1e-5  # forward values, relative
GRAD_RTOL = 5e-4  # gradients, max|d| / max|ref|


def _depth_pair(rng, H=24, W=20):
    """A depth map, a prior with holes (0) and a mask: |d| on both sides
    of smooth-L1's knee."""
    gt = (rng.random((H, W)) * 4 + 1).astype(np.float32)
    gt[rng.random((H, W)) < 0.2] = 0.0
    pred = (gt * 1.3 + 0.4 + rng.normal(scale=0.8, size=(H, W))).astype(
        np.float32)
    # the prior's holes are masked out, as depth_loss's default mask does:
    # with them in, the closed-form scale and shift cancel to a few
    # float32 ulps of their terms in both packages
    mask = ((rng.random((H, W)) > 0.3) & (gt != 0)).astype(np.float32)
    return pred, gt, mask


def _edges(rng, shape, n):
    """Sorted bin edges (shape + (n,)) and normalized weights (n - 1)."""
    t = np.cumsum(rng.random(shape + (n,)) + 0.05, axis=-1).astype(np.float32)
    w = rng.random(shape + (n - 1,)).astype(np.float32)
    return t, (w / w.sum(-1, keepdims=True)).astype(np.float32)


def _cases():
    """(id, function name, args, kwargs, indices of the arguments to
    differentiate)."""
    rng = np.random.default_rng(0)
    pred, gt, mask = _depth_pair(rng)
    t, w = _edges(rng, (6,), 9)
    tp1, wp1 = _edges(rng, (6,), 5)
    tp2, wp2 = _edges(rng, (6,), 7)
    plane = rng.normal(size=(2, 4, 8, 6)).astype(np.float32)
    tplane = rng.normal(size=(3, 5, 10)).astype(np.float32)
    g3 = rng.normal(size=(40, 3)).astype(np.float32)
    jac = (np.eye(3) + 0.2 * rng.normal(size=(5, 4, 3, 3))).astype(np.float32)
    soft = rng.random((2, 30, 1)).astype(np.float32)
    tgt = (rng.random((2, 30, 1)) > 0.5).astype(np.float32)
    xyz = (rng.random((48, 3)) * 0.5).astype(np.float32)
    f32 = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    c = []
    c.append(("smoothl1", "smoothl1", (pred, gt), {}, (0, 1)))
    c.append(("smoothl1_mask", "smoothl1", (pred, gt, mask), {}, (0, 1)))
    c.append(("scale_and_shift", "compute_scale_and_shift",
              (pred, gt, mask), {}, (0, 1)))
    c.append(("gradient_loss", "_gradient_loss", (pred - gt, mask), {}, (0,)))
    for kind in ("mse", "mae"):
        c.append((f"ssi_{kind}", "scale_shift_invariant_loss",
                  (pred, gt, mask), {"kind": kind}, (0, 1)))
    c.append(("silog", "scale_invariant_log_loss", (pred, gt, mask), {},
              (0, 1)))
    # holes (0) inside the mask: max(0, 0)'s gradient is JAX's half
    holes = (rng.random(gt.shape) > 0.3).astype(np.float32)
    c.append(("silog_holes", "scale_invariant_log_loss", (pred, gt, holes),
              {}, (0, 1)))
    for kind in ("smoothl1", "l1", "l2", "ssimse", "ssimae", "silog"):
        c.append((f"depth_{kind}", "depth_loss", (pred, gt), {"kind": kind},
                  (0,)))
    c.append(("depth_mask", "depth_loss", (pred, gt, mask),
              {"kind": "l1"}, (0,)))
    flo, flow = f32(12, 10, 2), f32(12, 10, 2)
    c.append(("flow", "flow_loss", (flo, flow), {}, (0,)))
    c.append(("flow_weight", "flow_loss",
              (flo, flow, rng.random((12, 10, 1)).astype(np.float32)), {},
              (0,)))
    c.append(("distortion", "lossfun_distortion", (t, w), {}, (0, 1)))
    c.append(("searchsorted_pair", "_searchsorted_pair", (tp1, t), {}, ()))
    c.append(("inner_outer", "inner_outer", (t, tp1, wp1), {}, (2,)))
    c.append(("outer", "lossfun_outer", (t, w, tp1, wp1), {}, (1, 3)))
    c.append(("proposal", "proposal_loss", (t, w, [tp1, tp2], [wp1, wp2]),
              {"dist_loss_weight": 0.1, "prop_loss_weight": 1.0}, (1, 3)))
    c.append(("plane_tv", "plane_tv", (plane,), {}, (0,)))
    c.append(("planes_tv", "planes_tv", ([plane, plane[0] * 2],), {}, (0,)))
    c.append(("plane_smoothness", "plane_smoothness", (tplane,), {}, (0,)))
    c.append(("time_planes_smooth", "time_planes_smooth",
              ([tplane, tplane[:, 1:] * 3],), {}, (0,)))
    c.append(("t_resd", "t_resd_loss", (f32(30, 1),), {}, (0,)))
    c.append(("eikonal", "eikonal", (g3,), {}, (0,)))
    c.append(("curvature", "curvature_loss",
              (f32(40), f32(40, 3, 2), 0.05), {}, (0, 1)))
    c.append(("norm_smooth", "norm_smooth_loss",
              (g3, g3 + 0.1 * f32(40, 3), 50, 0.1, 100), {}, (0, 1)))
    c.append(("norm_smooth_mask", "norm_smooth_loss",
              (g3, g3 + 0.1 * f32(40, 3), 150, 0.1, 100,
               (rng.random(40) > 0.5).astype(np.float32)), {}, (0, 1)))
    c.append(("elastic", "elastic_crit", (jac,), {}, (0,)))
    c.append(("displacement", "displacement_loss", (),
              dict(resd=f32(5, 4, 3), jacobian=jac,
                   weights=rng.random((5, 4)).astype(np.float32),
                   resd_loss_weight=0.5, elas_loss_weight=2.0), ()))
    c.append(("miou", "miou_loss", (soft, tgt), {}, (0,)))
    c.append(("miou_flat", "miou_loss", (soft.reshape(-1), tgt.reshape(-1)),
              {}, (0,)))
    c.append(("bce", "bce_loss", (soft, tgt), {}, (0,)))
    c.append(("entropy", "occupancy_entropy", (soft,), {}, (0,)))
    c.append(("motion", "motion_consistency_loss",
              (xyz, f32(48, 3), (rng.random(48) > 0.25)), {"K": 4,
                                                           "radius": 0.2},
              (1,)))
    return c


CASES = _cases()


def _tree(x, to):
    if isinstance(x, dict):
        return {k: _tree(v, to) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_tree(v, to) for v in x)
    if isinstance(x, np.ndarray):
        return to(x)
    return x


def _leaves(out):
    """The outputs as a flat list of arrays: a (loss, stats) pair gives the
    loss then the stats in key order; a tuple its elements."""
    if isinstance(out, tuple):
        items = []
        for o in out:
            if isinstance(o, dict):
                items += [o[k] for k in sorted(o)]
            else:
                items.append(o)
        return items
    return [out]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().numpy()
    return np.asarray(x)


def _weights(leaves):
    """Seeded cotangents, one per floating leaf, to make a scalar."""
    rng = np.random.default_rng(7)
    return [rng.random(np.shape(_np(v))).astype(np.float32) for v in leaves]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_aux_function_matches_jax(case):
    _, name, args, kw, diff = case
    jf, tf = getattr(jaux, name), getattr(taux, name)
    jargs = _tree(args, jnp.asarray)
    jkw = _tree(kw, jnp.asarray)
    targs = [_tree(a, lambda x: torch.tensor(x, requires_grad=i in diff))
             for i, a in enumerate(args)]
    tkw = _tree(kw, lambda a: torch.tensor(a))
    jl = _leaves(jf(*jargs, **jkw))
    tl = _leaves(tf(*targs, **tkw))
    assert len(jl) == len(tl)
    for j, t in zip(jl, tl):
        j, t = _np(j), _np(t)
        if np.issubdtype(j.dtype, np.integer):
            np.testing.assert_array_equal(t, j)
        else:
            np.testing.assert_allclose(t, j, rtol=RTOL, atol=1e-7)
    if not diff:
        return
    cots = _weights(jl)
    floats = [k for k, v in enumerate(jl)
              if np.issubdtype(_np(v).dtype, np.floating)]

    def jscalar(*dargs):
        a = list(jargs)
        for i, d in zip(diff, dargs):
            a[i] = d
        out = _leaves(jf(*a, **jkw))
        return sum(jnp.sum(out[k] * cots[k]) for k in floats)

    jg = jax.grad(jscalar, argnums=tuple(range(len(diff))))(
        *[jargs[i] for i in diff])
    tscalar = sum((tl[k] * torch.tensor(cots[k])).sum() for k in floats)
    tleaves = [x for i in diff for x in (
        targs[i] if isinstance(targs[i], list) else [targs[i]])]
    jleaves = [x for g in jg for x in (g if isinstance(g, list) else [g])]
    tg = torch.autograd.grad(tscalar, tleaves, allow_unused=True)
    for k, (got, want) in enumerate(zip(tg, jleaves)):
        want = np.asarray(want)
        got = np.zeros_like(want) if got is None else got.numpy()
        scale = np.abs(want).max()
        assert np.abs(got - want).max() <= GRAD_RTOL * max(scale, 1e-30), (
            k, np.abs(got - want).max(), scale)


def test_aux_loss_config_matches_jax():
    assert taux.AuxLossConfig._fields == jaux.AuxLossConfig._fields
    assert tuple(taux.AuxLossConfig()) == tuple(jaux.AuxLossConfig())


def _aux_dicts(rng):
    pred, gt, _ = _depth_pair(rng)
    t, w = _edges(rng, (6,), 9)
    tp, wp = _edges(rng, (6,), 5)
    f32 = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    acc = rng.random((24, 20, 1)).astype(np.float32)
    out = dict(dpt_map=pred, flo_map=f32(24, 20, 2), s_vals=t, weights=w,
               s_vals_prop=[tp], weights_prop=[wp],
               spatial_planes=[f32(2, 3, 6, 5)], temporal_planes=[f32(2, 3, 7)],
               t_resd=f32(10, 1), gradients=f32(30, 3), sdf=f32(30),
               sampled_sdf=f32(30, 3, 2), finite_diff_delta=0.05,
               resd=f32(6, 8, 3), jacobian=(np.eye(3) + 0.1 * f32(6, 8, 3, 3)),
               acc_map=acc, occ=acc)
    out["jacobian"] = out["jacobian"].astype(np.float32)
    batch = dict(dpt=gt, flow=f32(24, 20, 2),
                 flow_weight=rng.random((24, 20, 1)).astype(np.float32),
                 msk=(rng.random((24, 20, 1)) > 0.5).astype(np.float32))
    return out, batch


@pytest.mark.parametrize("drop", [(), ("flo_map", "sdf", "jacobian")])
@pytest.mark.parametrize("kind", ["smoothl1", "ssimse", "silog"])
def test_compute_aux_losses_matches_jax(kind, drop):
    """Every branch on (every weight 0.5), for three depth kinds, and with
    some outputs absent (the have() gating: those branches are skipped,
    the displacement branch runs on the residual alone): the same stats
    keys, each value and the total within RTOL."""
    rng = np.random.default_rng(3)
    out, batch = _aux_dicts(rng)
    for k in drop:
        out[k] = None
    fields = {f: 0.5 for f in jaux.AuxLossConfig._fields if f.endswith(
        ("_weight",))}
    jcfg = jaux.AuxLossConfig(dpt_loss_kind=kind, **fields)
    tcfg = taux.AuxLossConfig(dpt_loss_kind=kind, **fields)
    jl, js = jaux.compute_aux_losses(jcfg, _tree(out, jnp.asarray),
                                     _tree(batch, jnp.asarray), it=10)
    tl, ts = taux.compute_aux_losses(
        tcfg, _tree(out, lambda a: torch.tensor(a)),
        _tree(batch, lambda a: torch.tensor(a)), it=10)
    assert set(ts) == set(js)
    if drop:
        assert not {"flow_loss", "curvature_loss", "elas_loss"} & set(ts)
    for k in js:
        np.testing.assert_allclose(float(ts[k]), float(js[k]), rtol=RTOL,
                                   err_msg=k)
    np.testing.assert_allclose(float(tl), float(jl), rtol=RTOL)
