"""The port's dataset moderators and patch training against the JAX
package's: the ratio and centre-crop schedules, resize_view and
center_crop_view, the sequence of training views `Runner.train` picks
(ratio, crop, patch and alternating runs over more than two epochs, the
steps stubbed out), and the patch camera's contract: its render is the
crop of the full render.

    python -m pytest tests/test_torch_moderators.py
"""
import numpy as np
import pytest
import torch

import envgs_tpu.engine as jengine
from envgs_tpu.models import envgs as jenv
from envgs_tpu.models import gaussians as jg
from envgs_tpu.train import moderators as jmod
from envgs_tpu.train import optimizer as jopt
from envgs_tpu.train import runner as jrunner
from envgs_tpu.train import supervisor as jsup
from envgs_tpu.train import trainer as jtrain
from envgs_tpu.utils.camera import make_camera as jcamera
from envgs_tpu.engine import Registry as jregistry
from envgs_tpu_torch import engine
from envgs_tpu_torch.engine import MODERATORS
from envgs_tpu_torch.models import envgs as tenv
from envgs_tpu_torch.models import gaussians as tg
from envgs_tpu_torch.train import moderators as tmod
from envgs_tpu_torch.train import optimizer as topt
from envgs_tpu_torch.train import supervisor as tsup
from envgs_tpu_torch.train import trainer as ttrain
from envgs_tpu_torch.train.runner import Runner
from envgs_tpu_torch.utils.camera import make_camera as tcamera

# the contract of tests/test_runner_wiring.py::
# test_patch_crop_matches_full_render
PATCH_ATOL = 2e-5
H, W = 64, 96


@pytest.mark.parametrize("args", [(), (0.25, 1.0, 100, 7000),
                                  (0.5, 0.75, 0, 300, (0.5, 0.6, 0.75))])
def test_schedules_equal(args):
    for ours, theirs in ((tmod.RatioSchedule, jmod.RatioSchedule),
                         (tmod.CenterCropSchedule, jmod.CenterCropSchedule)):
        got, want = ours(*args), theirs(*args)
        assert [got(it) for it in range(0, 12000, 37)] == [
            want(it) for it in range(0, 12000, 37)]
    assert tmod.AlternatingSchedule()(3) == jmod.AlternatingSchedule()(3)
    assert tmod.NoopSchedule()(5) is None


def test_moderators_registered_by_reference_name():
    for name, cls in (("DatasetRatioModerator", tmod.RatioSchedule),
                      ("DatasetCenterCropRatioModerator",
                       tmod.CenterCropSchedule),
                      ("AlternatingModerator", tmod.AlternatingSchedule),
                      ("NoopModerator", tmod.NoopSchedule)):
        assert MODERATORS.get(name) is cls
    sched = MODERATORS.build({"type": "DatasetRatioModerator",
                              "ratio_start": 0.5, "iter_end": 10})
    assert sched(0) == 0.5 and sched(10) == 1.0
    assert MODERATORS.build({"type": None}) is None
    with pytest.raises(KeyError, match="DatasetRatioModerater"):
        MODERATORS.get("DatasetRatioModerater")
    # every registry of the JAX package, under its name, in the port; the
    # nine into which neither package registers anything are empty in both
    jregs = {k: v for k, v in vars(jengine).items()
             if isinstance(v, jregistry)}
    assert {k for k, v in vars(engine).items()
            if isinstance(v, engine.Registry)} == set(jregs)
    assert {k: getattr(engine, k).name for k in jregs} == {
        k: v.name for k, v in jregs.items()}
    for k in ("DATALOADERS", "MODELS", "CAMERAS", "SUPERVISORS", "RUNNERS",
              "OPTIMIZERS", "RECORDERS", "EVALUATORS", "VISUALIZERS"):
        assert not jregs[k]._modules and not getattr(engine, k)._modules, k
        with pytest.raises(KeyError, match=jregs[k].name):
            getattr(engine, k).get("anything")


def _views(n=3, seed=0):
    """n views of H x W (rgb, msk, norm, dpt) -> (port views, JAX views)."""
    rng = np.random.default_rng(seed)
    tv, jv = [], []
    for i in range(n):
        K = np.array([[70.0 + i, 0, W / 2 - 0.3], [0, 71.0, H / 2 + 0.7],
                      [0, 0, 1]], np.float32)
        R = np.eye(3, dtype=np.float32)
        T = np.array([0.1 * i, 0, 0], np.float32)
        maps = dict(rgb=rng.random((H, W, 3)).astype(np.float32),
                    msk=(rng.random((H, W, 1)) > 0.2).astype(np.float32),
                    norm=rng.random((H, W, 3)).astype(np.float32),
                    dpt=rng.random((H, W, 1)).astype(np.float32))
        tv.append(dict(maps, camera=tcamera(H, W, K, R, T, device="cpu"),
                       name=f"{i:02d}"))
        jv.append(dict(maps, camera=jcamera(H, W, K, R, T), name=f"{i:02d}"))
    return tv, jv


@pytest.mark.parametrize("ratio", [0.25, 0.5, 0.75, 0.33, 1.0])
def test_resize_and_center_crop_equal(ratio):
    (tv, *_), (jv, *_) = _views(1)
    for ours, theirs in ((tmod.resize_view, jmod.resize_view),
                         (tmod.center_crop_view, jmod.center_crop_view)):
        got, want = ours(tv, ratio), theirs(jv, ratio)
        gc, wc = got["camera"], want["camera"]
        assert (gc.H, gc.W) == (wc.H, wc.W)
        assert gc.K.dtype == torch.float32 and gc.K.device == tv[
            "camera"].K.device
        np.testing.assert_array_equal(gc.K.numpy(), np.asarray(wc.K))
        for k in ("rgb", "msk", "norm", "dpt"):
            np.testing.assert_array_equal(got[k], want[k])
        if ratio == 1.0:
            assert got is tv
        else:  # the source view's camera is left as it was
            assert tv["camera"].H == H and tv["camera"].K[0, 2] == W / 2 - .3


def _runners(tmp_path, total, **mods):
    """A port Runner and a JAX Runner over the same three views, their
    maintenance and steps replaced by recorders of what each step was
    handed -> (port runner, JAX runner, port record, JAX record)."""
    tv, jv = _views()
    rng = np.random.default_rng(1)
    xyz = rng.normal(size=(32, 3)).astype(np.float32) + [0, 0, 4]
    rgb = rng.random((32, 3)).astype(np.float32)
    sched = dict(epochs=1, ep_iter=total)

    def jmods():
        out = {}
        for k, v in mods.items():
            if k == "patch_size":
                out[k] = v
            else:
                out[k] = getattr(jmod, type(v).__name__)(*v)
        return out

    tr = Runner(tv, tg.create_pool(xyz, rgb, 64, device="cpu"),
                tg.create_pool(xyz, rgb, 64, device="cpu"),
                tenv.EnvGSConfig(), tsup.LossConfig(),
                ttrain.ScheduleConfig(**sched), tg.DensifyConfig(),
                tg.DensifyConfig(), topt.LRConfig(), topt.LRConfig(),
                out_root=str(tmp_path / "t"), resume=False, record=False,
                log_every=10 ** 6, **mods)
    jr = jrunner.Runner(jv, jg.create_pool(xyz, rgb, 64),
                        jg.create_pool(xyz, rgb, 64), jenv.EnvGSConfig(),
                        jsup.LossConfig(), jtrain.ScheduleConfig(**sched),
                        jg.DensifyConfig(), jg.DensifyConfig(),
                        jopt.LRConfig(), jopt.LRConfig(),
                        out_root=str(tmp_path / "j"), resume=False,
                        record=False, log_every=10 ** 6, **jmods())
    records = ([], [])
    for r, rec in zip((tr, jr), records):
        r.maintain = lambda st, it, *a, **k: st

        def step_fn(cam, r=r, rec=rec):
            def step(state, batch, K, R, T, it):
                rec.append(dict(
                    it=int(it), H=cam.H, W=cam.W, K=np.asarray(
                        K.cpu() if torch.is_tensor(K) else K),
                    R=np.asarray(R.cpu() if torch.is_tensor(R) else R),
                    **{k: np.asarray(getattr(batch, k).cpu()
                                     if torch.is_tensor(getattr(batch, k))
                                     else getattr(batch, k))
                       for k in ("rgb", "msk", "norm")}))
                return state, {}
            return step

        r._step_fn = step_fn
        r.save = lambda *a, **k: None
    return tr, jr, records[0], records[1]


@pytest.mark.parametrize("mods", [
    dict(ratio_sched=tmod.RatioSchedule(0.25, 1.0, 0, 8)),
    dict(crop_sched=tmod.CenterCropSchedule(0.5, 1.0, 2, 9)),
    dict(patch_size=(24, 40)),
    dict(patch_size=(32, 32), alternating=tmod.AlternatingSchedule()),
    dict(ratio_sched=tmod.RatioSchedule(0.5, 1.0, 0, 6),
         crop_sched=tmod.CenterCropSchedule(0.75, 1.0, 0, 8),
         patch_size=(16, 24)),
], ids=["ratio", "crop", "patch", "alternating", "ratio-crop-patch"])
def test_train_view_sequence_equal(tmp_path, mods):
    """Ten iterations over three views (past two epoch wraps, where the
    view order is drawn again from the generator the patch positions come
    from): the (H, W, K, R) and the maps each step is handed."""
    total = 10
    tr, jr, got, want = _runners(tmp_path, total, **mods)
    tr.train()
    jr.train()
    assert len(got) == len(want) == total
    for g, w in zip(got, want):
        assert (g["it"], g["H"], g["W"]) == (w["it"], w["H"], w["W"])
        for k in ("K", "R", "rgb", "msk", "norm"):
            np.testing.assert_array_equal(g[k], w[k], err_msg=f"{w['it']} "
                                          f"{k}")
    if "patch_size" not in mods or "alternating" in mods:
        # the moderators changed the size
        assert len({(g["H"], g["W"]) for g in got}) > 1
    if "patch_size" in mods:  # patches from more than one position
        assert len({tuple(g["K"][:2, 2]) for g in got
                    if (g["H"], g["W"]) == mods["patch_size"]}) > 1


def _render_pools(seed=0, P=48, cap=64):
    """test_runner_wiring's pools, made by the port."""
    rng = np.random.default_rng(seed)
    xyz = np.concatenate([rng.normal(size=(P, 2)) * 0.5,
                          rng.random((P, 1)) * 2 + 2.0], -1).astype(np.float32)
    base = tg.create_pool(xyz, rng.random((P, 3)).astype(np.float32),
                          cap=cap, sh_degree=1, init_opacity=0.6, seed=seed,
                          device="cpu")
    env = tg.create_pool((xyz * 3).astype(np.float32),
                         rng.random((P, 3)).astype(np.float32), cap=cap,
                         sh_degree=1, init_opacity=0.3, seed=seed + 1,
                         device="cpu")
    return base, env


@pytest.mark.parametrize("reflection", [False, True])
def test_patch_camera_renders_the_crop(tmp_path, reflection):
    """The patch camera `_train_view` hands the step renders the crop of
    the full view's render within PATCH_ATOL (with the reflected pass in
    the tracer's exact per-ray order)."""
    base, env = _render_pools()
    K = np.array([[40.0, 0, 16], [0, 40.0, 16], [0, 0, 1]], np.float32)
    cam = tcamera(32, 32, K, np.eye(3), np.zeros(3), device="cpu")
    view = dict(rgb=np.zeros((32, 32, 3), np.float32), camera=cam)
    cfg = tenv.EnvGSConfig(pair_cap=2 ** 12, env_pair_cap=2 ** 14,
                           render_reflection=reflection,
                           reflection_start_iter=0 if reflection else 10 ** 9,
                           render_mode=True, tracer_exact_order=True)
    r = Runner([view], base, env, cfg, tsup.LossConfig(),
               ttrain.ScheduleConfig(), tg.DensifyConfig(),
               tg.DensifyConfig(), topt.LRConfig(), topt.LRConfig(),
               out_root=str(tmp_path), resume=False, record=False,
               patch_size=(16, 16))
    rng = np.random.default_rng(3)
    with torch.no_grad():
        full = tenv.forward_envgs(base, env, cam, 0, cfg).rgb_map.numpy()
        seen = set()
        for _ in range(3):
            _, pcam, _ = r._train_view(0, 0, rng)
            x0 = int(round(16 - float(pcam.K[0, 2])))
            y0 = int(round(16 - float(pcam.K[1, 2])))
            seen.add((y0, x0))
            crop = tenv.forward_envgs(base, env, pcam, 0, cfg).rgb_map.numpy()
            np.testing.assert_allclose(crop, full[y0:y0 + 16, x0:x0 + 16],
                                       atol=PATCH_ATOL)
    assert len(seen) > 1 and np.abs(full).max() > 0.05


def test_patch_crop_shifts_k_on_its_device(tmp_path):
    """K of the patch camera is a float32 tensor on the view camera's
    device, shifted by the window origin; the view's own K untouched."""
    (tv, *_), _ = _views(1)
    r = Runner([tv], *_render_pools(), tenv.EnvGSConfig(),
               tsup.LossConfig(), ttrain.ScheduleConfig(),
               tg.DensifyConfig(), tg.DensifyConfig(), topt.LRConfig(),
               topt.LRConfig(), out_root=str(tmp_path), resume=False,
               record=False, patch_size=(16, 24))
    K0 = tv["camera"].K.clone()
    view, cam, _ = r._train_view(0, 0, np.random.default_rng(0))
    assert cam.K.device == K0.device and cam.K.dtype == torch.float32
    shift = (K0 - cam.K)[:2, 2]
    y0, x0 = int(shift[1]), int(shift[0])
    assert (cam.H, cam.W) == (16, 24) and view["rgb"].shape == (16, 24, 3)
    np.testing.assert_array_equal(view["rgb"],
                                  tv["rgb"][y0:y0 + 16, x0:x0 + 24])
    assert torch.equal(tv["camera"].K, K0)
    assert torch.equal(cam.K[:2, :2], K0[:2, :2])

