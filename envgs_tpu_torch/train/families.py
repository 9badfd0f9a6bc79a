"""Config-driven training of the other model families (port of
envgs_tpu/train/families.py): the Spacetime Gaussians (`STGSModel` /
`STGSSampler`), PointPlanes (`PointPlanesSampler`), NeRF
(`VolumetricVideoNetwork`, `MultilevelNetwork`, `UniformSampler`,
`ImportanceSampler`), NeuS (`NeusNetwork`) and ENeRF
(`CostVolumeSampler`), registered in `engine.TRAINERS` under the
reference's names, so that

    python -m envgs_tpu_torch train -c configs/exps/stgs_synthetic.yaml

dispatches by `sampler_cfg.type` (or `network_cfg.type`) as the JAX package
does. STGS and PointPlanes render through the 3DGS rasterizer: on a CUDA
tensor each step launches K5, gauss3d K1 and gauss3d K2 once, on a CPU
tensor their plain versions run. NeRF and NeuS train on random batches of
the training views' rays (the indices from np.random.default_rng(0), as
the JAX package picks them) and ENeRF on a target view and its nearest
training views; these three launch no kernel of the repo.

`FamilyLoop` gives each family loop the runner's services: resume from
`latest.npz`, a checkpoint every `save_latest_every` iterations, the
recorder's scalars, log lines with an ETA, an eval cadence. `latest.npz`
holds the leaves of the parameter and optimizer trees in the JAX
package's flattened order (`p<i>`, `o<i>`, `iter`), so a checkpoint of
either package's loop resumes in the other. The port runs one process.
"""
from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from envgs_tpu_torch.engine import TRAINERS, Config, call_filtered
from envgs_tpu_torch.models.gaussians import DensifyConfig, GaussianPool
from envgs_tpu_torch.ops.common import check_backend


def _runner_cfg(cfg: Config):
    rcfg = cfg.get("runner_cfg", {}) or {}
    total = int(rcfg.get("epochs", 1)) * int(rcfg.get("ep_iter", 500))
    return rcfg, total


# ---------------------------------------------------------------------------
# trees in the JAX package's flattened order
# ---------------------------------------------------------------------------

def tree_flatten(tree) -> list:
    """The tensors of a tree in jax.tree_util.tree_flatten's order:
    NamedTuples field by field, dicts by sorted key, lists and tuples in
    order, None left out; a GaussianPool is its params and stats (its
    max_sh_degree is static, not a leaf)."""
    if tree is None:
        return []
    if isinstance(tree, GaussianPool):
        return tree_flatten(tree.params) + tree_flatten(tree.stats)
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_flatten(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for c in tree for x in tree_flatten(c)]
    return [tree]


def tree_unflatten(like, leaves: list):
    """Inverse of tree_flatten: `like`'s structure around `leaves`."""
    it = iter(leaves)

    def build(t):
        if t is None:
            return None
        if isinstance(t, GaussianPool):
            return t._replace(params=build(t.params), stats=build(t.stats))
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, tuple) and hasattr(t, "_fields"):
            return type(t)(*(build(c) for c in t))
        if isinstance(t, (list, tuple)):
            return type(t)(build(c) for c in t)
        return next(it)

    return build(like)


def tensor_like(ref: torch.Tensor, arr) -> torch.Tensor:
    """A checkpoint leaf with the reference leaf's dtype and device (the
    JAX package's jnp_like); another shape raises KeyError (the families'
    shapes are static)."""
    a = np.asarray(arr)
    if a.shape != tuple(ref.shape):
        raise KeyError(f"shape {a.shape} != {tuple(ref.shape)}")
    return torch.tensor(a, dtype=ref.dtype, device=ref.device)


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


class FamilyLoop:
    """The runner's services for a family loop:

        loop = FamilyLoop(cfg, "stgs")
        params, opt_state, start = loop.restore(params, opt_state)
        for it in range(start, loop.total):
            ... step ...
            loop.step_done(it, aux, params, opt_state)
        loop.finish(params, opt_state)
    """

    def __init__(self, cfg: Config, default_exp: str):
        from envgs_tpu_torch.parallel.multihost import is_main_process
        from envgs_tpu_torch.train.recorder import Recorder

        rcfg, self.total = _runner_cfg(cfg)
        self.log_every = int(rcfg.get("log_interval", 50))
        self.save_latest_every = int(rcfg.get("save_latest_every", 1000))
        self.eval_every_iters = int(rcfg.get("eval_every_iters", 0))
        self.resume = bool(rcfg.get("resume", True))
        exp = cfg.get("exp_name", default_exp)
        root = cfg.get("out_root", "data")
        self.model_dir = os.path.join(root, "trained_model", exp)
        self.result_dir = os.path.join(root, "result", exp)
        os.makedirs(self.model_dir, exist_ok=True)
        self.recorder = Recorder(  # rank 0's, as the checkpoints are
            os.path.join(root, "record", exp),
            enabled=bool(rcfg.get("record", True)) and is_main_process(),
            resolved_config=cfg.to_dict() if hasattr(cfg, "to_dict")
            else dict(cfg))
        self._t0 = time.time()
        self._start = 0

    @property
    def latest(self) -> str:
        return os.path.join(self.model_dir, "latest.npz")

    def save(self, it: int, params, opt_state):
        """latest.npz: the iteration and both trees' leaves (rank 0
        alone)."""
        from envgs_tpu_torch.parallel.multihost import is_main_process

        if not is_main_process():
            return
        np.savez_compressed(
            self.latest, iter=it,
            **{f"p{i}": _np(x) for i, x in enumerate(tree_flatten(params))},
            **{f"o{i}": _np(x)
               for i, x in enumerate(tree_flatten(opt_state))})

    def restore(self, params, opt_state):
        """latest.npz -> (params, opt_state, start iteration); the trees as
        given when there is none, resume is off, or its leaves do not
        match (count or shapes)."""
        if not self.resume or not os.path.exists(self.latest):
            return params, opt_state, 0
        z = np.load(self.latest)
        pf, of = tree_flatten(params), tree_flatten(opt_state)
        try:
            new_p = [tensor_like(pf[i], z[f"p{i}"]) for i in range(len(pf))]
            new_o = [tensor_like(of[i], z[f"o{i}"]) for i in range(len(of))]
        except KeyError:
            print(f"[resume] {self.latest} layout mismatch; starting fresh")
            return params, opt_state, 0
        self._start = int(z["iter"])
        print(f"[resume] {self.latest} @ iter {self._start}")
        return (tree_unflatten(params, new_p),
                tree_unflatten(opt_state, new_o), self._start)

    def step_done(self, it: int, aux: dict, params, opt_state,
                  eval_fn=None):
        nxt = it + 1
        if it % self.log_every == 0 or nxt == self.total:
            stats = {k: float(v) for k, v in aux.items()
                     if (v.dim() if torch.is_tensor(v) else np.ndim(v)) == 0}
            self.recorder.record("TRAIN", stats, it=it)
            done = it - self._start + 1
            eta = (time.time() - self._t0) / max(done, 1) * (self.total - nxt)
            line = " ".join(f"{k} {v:.4f}" for k, v in stats.items()
                            if k in ("loss", "psnr"))
            print(f"iter {it}/{self.total} {line} eta {eta / 60:.1f}m",
                  flush=True)
        if self.save_latest_every and nxt % self.save_latest_every == 0:
            self.save(nxt, params, opt_state)
        if (self.eval_every_iters and eval_fn is not None
                and nxt % self.eval_every_iters == 0):
            try:
                eval_fn(nxt)
            except Exception as e:  # an eval must not end the training
                print(f"[eval error ignored] {e}")

    def finish(self, params, opt_state):
        self.save(self.total, params, opt_state)
        self.recorder.close()


def _dataset_kwargs(dcfg: dict) -> dict:
    """dataset_cfg without the keys the loops read themselves (`source`,
    `preload_gs`): the dataset's keyword arguments."""
    return {k: v for k, v in dcfg.items()
            if k not in ("source", "preload_gs")}


def _load_views_generic(cfg: Config, device="cuda"):
    """dataset_cfg -> (train views, eval views): the synthetic scene (a
    time t = i / (n - 1) per view, every `eval_every`-th view held out) or
    a capture on disk (MultiViewDataset), cameras on `device`."""
    dcfg = cfg.get("dataset_cfg", {}) or {}
    if dcfg.get("source", "synthetic") == "synthetic":
        from envgs_tpu_torch.data.synthetic import make_scene

        scene = make_scene(n_views=dcfg.get("n_views", 12),
                           H=dcfg.get("H", 64), W=dcfg.get("W", 64),
                           seed=dcfg.get("seed", 0), device=device)
        split = dcfg.get("eval_every", 4)
        views, eval_views = [], []
        for i, cam in enumerate(scene.cams):
            v = dict(rgb=scene.images[i], camera=cam, name=f"{i:02d}",
                     t=i / max(len(scene.cams) - 1, 1))
            (eval_views if (split and i % split == 0) else views).append(v)
        return views, eval_views
    from envgs_tpu_torch.data.dataset import MultiViewDataset

    kw = _dataset_kwargs(dcfg)
    ds = call_filtered(MultiViewDataset, dict(kw, split="train",
                                              device=device))
    vs = call_filtered(MultiViewDataset, dict(kw, split="val",
                                              device=device))
    return [ds[i] for i in range(len(ds))], [vs[i] for i in range(len(vs))]


def _evaluate(render, eval_views, result_dir, device):
    """PSNR / SSIM (/ LPIPS) of render(view) -> rgb on the held-out views
    into <result_dir>/metrics.json -> the metrics dict."""
    from envgs_tpu_torch.train.evaluator import Evaluator

    ev = Evaluator(result_dir)
    with torch.no_grad():
        for i, v in enumerate(eval_views):
            rgb = torch.clamp(render(v), 0.0, 1.0)
            ev.evaluate(rgb, torch.as_tensor(v["rgb"], dtype=torch.float32,
                                             device=device),
                        name=v.get("name", str(i)))
    summary = ev.summarize()
    print(json.dumps(summary["summary"], indent=2))
    return summary


# sampler_cfg keys of the STGS loop that no tuple holds
_STGS_KEYS = frozenset({"type", "n_points", "pool_cap",
                        "densification_interval", "densify_until_iter",
                        "reset_t_interval"})


@TRAINERS.register(name="STGSModel")
@TRAINERS.register(name="STGSSampler")
def train_stgs(cfg: Config, device="cuda"):
    """The Spacetime-Gaussian family over a (view, time) stream: the pool
    from random points (synthetic) or the capture's SfM cloud, times
    uniform in [0, 1]; densify / prune every densification_interval until
    densify_until_iter (split offsets from a generator seeded with
    runner_cfg.seed), reset_t every reset_t_interval; then
    `point_cloud.ply` (the 4D layout) and the held-out views' metrics.
    -> (final STGSState, the metrics dict or None without held-out
    views)."""
    from envgs_tpu_torch.cli import _named
    from envgs_tpu_torch.models.stgs import (
        STGSConfig,
        init_stgs_pool,
        init_stgs_state,
        make_stgs_train_step,
        render_stgs,
        reset_t,
        save_stgs_ply,
        stgs_lr_config,
        stgs_maintenance,
    )

    mcfg = cfg.get("model_cfg", {}) or {}
    scfg = {**(mcfg.get("network_cfg", {}) or {}),
            **(mcfg.get("sampler_cfg", {}) or {})}
    gcfg = _named(STGSConfig, scfg,
                  frozenset(DensifyConfig._fields) | _STGS_KEYS)
    check_backend("raster", gcfg.raster_backend)
    views, eval_views = _load_views_generic(cfg, device)
    rcfg, total = _runner_cfg(cfg)
    loop = FamilyLoop(cfg, "stgs")

    dcfg = cfg.get("dataset_cfg", {}) or {}
    seed = int(rcfg.get("seed", 0))
    rng = np.random.default_rng(seed)
    if dcfg.get("source", "synthetic") == "synthetic":
        P0 = int(scfg.get("n_points", 2048))
        pts = rng.uniform(-1, 1, (P0, 3)).astype(np.float32)
        pts[:, 2] += 3.0
        cols = rng.random((P0, 3)).astype(np.float32)
    else:
        from envgs_tpu_torch.data.dataset import MultiViewDataset

        ds = call_filtered(MultiViewDataset, dict(
            _dataset_kwargs(dcfg), split="train", device=device))
        pts, cols = ds.load_sfm(dcfg.get("preload_gs"))
    times = rng.random(len(pts)).astype(np.float32)
    cap = int(scfg.get("pool_cap", max(len(pts) * 4, 1024)))
    state = init_stgs_state(init_stgs_pool(pts, times, cols, cap, gcfg,
                                           device=device))
    lr_cfg = stgs_lr_config(duration=gcfg.duration)
    dens = _named(DensifyConfig, dict(scfg, max_gs=cap),
                  frozenset(STGSConfig._fields) | _STGS_KEYS)
    densify_every = int(scfg.get("densification_interval", 200))
    densify_until = int(scfg.get("densify_until_iter", total // 2))
    reset_t_every = int(scfg.get("reset_t_interval", 0))

    step_cache: dict = {}

    def step_for(cam):
        k = (cam.H, cam.W)
        if k not in step_cache:
            step_cache[k] = make_stgs_train_step(gcfg, cam, lr_cfg)
        return step_cache[k]

    def tensor(x):
        return torch.as_tensor(x, dtype=torch.float32, device=device)

    state, _, start = loop.restore(state, ())
    gen = torch.Generator(device=device).manual_seed(seed)
    for it in range(start, loop.total):
        if 0 < it < densify_until and it % densify_every == 0:
            state = stgs_maintenance(state, dens, gen)
        if reset_t_every and it > 0 and it % reset_t_every == 0:
            pool, opt = reset_t(state.pool, state.opt, 0.0, gcfg.duration)
            state = state._replace(pool=pool, opt=opt)
        v = views[int(rng.integers(0, len(views)))]
        cam = v["camera"]
        state, aux = step_for(cam)(state, cam.K, cam.R, cam.T,
                                   float(v.get("t", 0.0)), tensor(v["rgb"]),
                                   it)
        loop.step_done(it, aux, state, ())
    loop.finish(state, ())
    save_stgs_ply(state.pool, os.path.join(loop.model_dir, "point_cloud.ply"))
    if not eval_views:
        return state, None
    return state, _evaluate(
        lambda v: render_stgs(state.pool, v["camera"],
                              float(v.get("t", 0.0)), gcfg).rgb,
        eval_views, loop.result_dir, device)


@TRAINERS.register(name="PointPlanesSampler")
def train_point_planes(cfg: Config, device="cuda"):
    """The PointPlanes family over the frames of a video: points uniform in
    [-1, 1]^3 (synthetic, one frame a view) or the capture's SfM cloud
    (MultiViewVideoDataset), weights from a generator seeded with
    runner_cfg.seed (not the JAX package's draws: a latest.npz of either
    package resumes), Adam at runner_cfg.lr; then the held-out views'
    metrics. -> (the PointPlanes module, the metrics dict or None)."""
    from envgs_tpu_torch.cli import _named
    from envgs_tpu_torch.models.point_planes import (
        PointPlanesConfig,
        flat_params,
        make_point_planes_train_step,
        point_planes_forward,
    )

    dcfg = cfg.get("dataset_cfg", {}) or {}
    scfg = (cfg.get("model_cfg", {}) or {}).get("sampler_cfg", {}) or {}
    rcfg, total = _runner_cfg(cfg)
    lr = float(rcfg.get("lr", 5e-3))
    if dcfg.get("source", "synthetic") == "synthetic":
        views, eval_views = _load_views_generic(cfg, device)
        rng0 = np.random.default_rng(0)
        pts = rng0.uniform(-1, 1, (int(scfg.get("n_points", 2048)), 3)
                           ).astype(np.float32)
        n_frames = int(scfg.get("n_frames", max(len(views), 2)))
    else:
        from envgs_tpu_torch.data.video_dataset import MultiViewVideoDataset

        # (MultiViewVideoDataset hands every other keyword to
        # MultiViewDataset, which takes no others)
        kw = _dataset_kwargs(dcfg)
        ds = MultiViewVideoDataset(**kw, split="train", device=device)
        vs = MultiViewVideoDataset(**kw, split="val", device=device)
        views = [ds[i] for i in range(len(ds))]
        eval_views = [vs[i] for i in range(len(vs))]
        pts, _ = ds.load_sfm(dcfg.get("preload_gs"))
        n_frames = ds.n_frames
    pcfg = _named(PointPlanesConfig, dict(scfg, n_frames=n_frames),
                  {"type", "n_points"})
    check_backend("raster", pcfg.raster_backend)

    init, step = make_point_planes_train_step(pcfg, views[0]["camera"], lr)
    gen = torch.Generator(device=device).manual_seed(int(rcfg.get("seed", 0)))
    model, opt_state = init(pts, gen, device)
    loop = FamilyLoop(cfg, "point_planes")
    tree, opt_state, start = loop.restore(model.jax_tree(), opt_state)
    with torch.no_grad():
        for p, x in zip(flat_params(model), tree_flatten(tree)):
            p.copy_(x)
    rng = np.random.default_rng(0)
    for it in range(start, loop.total):
        v = views[int(rng.integers(0, len(views)))]
        cam = v["camera"]
        opt_state, aux = step(model, opt_state, float(v.get("t", 0.0)),
                              cam.K, cam.R, cam.T,
                              torch.as_tensor(v["rgb"], dtype=torch.float32,
                                              device=device))
        loop.step_done(it, aux, model.jax_tree(), opt_state)
    loop.finish(model.jax_tree(), opt_state)
    if not eval_views:
        return model, None
    return model, _evaluate(
        lambda v: point_planes_forward(pcfg, model, float(v.get("t", 0.0)),
                                       v["camera"]).rgb,
        eval_views, loop.result_dir, device)


def _load_tree(model, tree):
    """Copy a parameter tree (JAX's leaf order) into the module's tensors."""
    with torch.no_grad():
        for p, x in zip(tree_flatten(model.jax_params()), tree_flatten(tree)):
            p.copy_(x)


def _ray_pool(views, device):
    """Every training ray and its color, for random ray batches: (origins,
    unit directions, colors), each (N, 3) on `device`."""
    from envgs_tpu_torch.utils.camera import get_rays

    ro, rd, rgb = [], [], []
    for v in views:
        o, d = get_rays(v["camera"], z_depth=False)
        d = d.reshape(-1, 3)
        ro.append(torch.broadcast_to(o, d.shape))
        rd.append(d)
        rgb.append(torch.as_tensor(v["rgb"], dtype=torch.float32,
                                   device=device).reshape(-1, 3))
    return torch.cat(ro), torch.cat(rd), torch.cat(rgb)


def _eval_rays_loop(render_chunk, eval_views, result_dir, chunk=4096):
    """Each held-out view rendered by render_chunk(origins, directions) ->
    rgb over chunks of `chunk` rays (the last zero-padded to the full
    size) -> metrics.json (PSNR / SSIM / LPIPS) -> the metrics dict."""
    from envgs_tpu_torch.train.evaluator import Evaluator
    from envgs_tpu_torch.utils.camera import get_rays

    ev = Evaluator(result_dir)
    for i, v in enumerate(eval_views):
        cam = v["camera"]
        o, d = get_rays(cam, z_depth=False)
        d = d.reshape(-1, 3)
        o = torch.broadcast_to(o, d.shape)
        outs = []
        with torch.no_grad():
            for s in range(0, len(o), chunk):
                n = min(chunk, len(o) - s)
                pad = (0, 0, 0, chunk - n)
                outs.append(render_chunk(
                    torch.nn.functional.pad(o[s:s + n], pad),
                    torch.nn.functional.pad(d[s:s + n], pad))[:n])
        rgb = torch.cat(outs).reshape(cam.H, cam.W, 3)
        ev.evaluate(torch.clamp(rgb, 0.0, 1.0), torch.as_tensor(
            v["rgb"], dtype=torch.float32, device=rgb.device),
            name=v.get("name", str(i)))
    summary = ev.summarize()
    print(json.dumps(summary["summary"], indent=2))
    return summary


def _near_far(cfg: Config, views):
    """dataset_cfg's near / far, else the first view's camera's (far at
    most 20)."""
    dcfg = cfg.get("dataset_cfg", {}) or {}
    cam = views[0]["camera"]
    return (float(dcfg.get("near", cam.znear)),
            float(dcfg.get("far", min(cam.zfar, 20.0))))


def _ray_family(cfg: Config, device, name: str, config_cls, make_step,
                render, default_rays: int):
    """The NeRF / NeuS loop: the field from a generator seeded with
    runner_cfg.seed (not the JAX package's draws: a latest.npz of either
    package resumes), n_rays random rays a step, the samples' jitter from
    another generator of that seed, then the held-out views rendered in
    chunks. -> (network, metrics dict or None)."""
    from envgs_tpu_torch.cli import _named

    mcfg = cfg.get("model_cfg", {}) or {}
    ncfg = _named(config_cls, {**(mcfg.get("network_cfg", {}) or {}),
                               **(mcfg.get("sampler_cfg", {}) or {})},
                  {"type"})
    views, eval_views = _load_views_generic(cfg, device)
    rcfg, _ = _runner_cfg(cfg)
    n_rays = int(rcfg.get("n_rays", default_rays))
    lr = float(rcfg.get("lr", 5e-4))
    near, far = _near_far(cfg, views)
    loop = FamilyLoop(cfg, name)
    seed = int(rcfg.get("seed", 0))
    init, step = make_step(ncfg, lr)
    net, opt_state = init(torch.Generator(device=device).manual_seed(seed),
                          device)
    tree, opt_state, start = loop.restore(net.jax_params(), opt_state)
    _load_tree(net, tree)
    ro, rd, rgb = _ray_pool(views, device)
    nf = (torch.full((n_rays,), near, device=device),
          torch.full((n_rays,), far, device=device))
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    rng = np.random.default_rng(0)
    for it in range(start, loop.total):
        idx = torch.as_tensor(rng.integers(0, ro.shape[0], n_rays),
                              device=device)
        opt_state, aux = step(net, opt_state, ro[idx], rd[idx], *nf,
                              rgb[idx], generator=gen)
        loop.step_done(it, aux, net.jax_params(), opt_state)
    loop.finish(net.jax_params(), opt_state)
    if not eval_views:
        return net, None

    def render_chunk(o, d):
        n = o.shape[0]
        return render(ncfg, net, o, d, torch.full((n,), near, device=device),
                      torch.full((n,), far, device=device))["rgb_map"]

    return net, _eval_rays_loop(render_chunk, eval_views, loop.result_dir)


@TRAINERS.register(name="VolumetricVideoNetwork")
@TRAINERS.register(name="MultilevelNetwork")
@TRAINERS.register(name="UniformSampler")
@TRAINERS.register(name="ImportanceSampler")
def train_nerf(cfg: Config, device="cuda"):
    """The NeRF family: hierarchical ray-batch training (runner_cfg.n_rays,
    default 1024) and the held-out views. -> (NerfNetworks, metrics dict or
    None)."""
    from envgs_tpu_torch.models.nerf import (
        NerfConfig,
        make_nerf_train_step,
        render_rays_nerf,
    )

    return _ray_family(cfg, device, "nerf", NerfConfig, make_nerf_train_step,
                       render_rays_nerf, 1024)


@TRAINERS.register(name="NeusNetwork")
def train_neus(cfg: Config, device="cuda"):
    """The NeuS family: SDF ray-batch training (runner_cfg.n_rays, default
    512) and the held-out views. -> (NeusNetwork, metrics dict or None)."""
    from envgs_tpu_torch.models.neus import (
        NeusConfig,
        make_neus_train_step,
        render_rays_neus,
    )

    return _ray_family(cfg, device, "neus", NeusConfig, make_neus_train_step,
                       render_rays_neus, 512)


# sampler_cfg keys of the ENeRF loop that no tuple holds: read here (type,
# n_srcs), or left out as the JAX package leaves it (n_depth_hyps: its
# planes are n_planes)
_ENERF_KEYS = frozenset({"type", "n_srcs", "n_depth_hyps"})


@TRAINERS.register(name="CostVolumeSampler")
def train_enerf(cfg: Config, device="cuda"):
    """The ENeRF family: a random training view a step (np.random.
    default_rng(0)) with its n_srcs nearest training views as sources (the
    synthetic scene), or ImageBasedDataset's items (a capture on disk);
    the network from a generator seeded with runner_cfg.seed; then each
    held-out view rendered from its sources. -> (ENeRFNetwork, metrics
    dict or None)."""
    from envgs_tpu_torch.cli import _named
    from envgs_tpu_torch.models.enerf import (
        ENeRFConfig,
        make_enerf_train_step,
        render_enerf,
    )

    dcfg = cfg.get("dataset_cfg", {}) or {}
    scfg = (cfg.get("model_cfg", {}) or {}).get("sampler_cfg", {}) or {}
    ecfg = _named(ENeRFConfig, scfg, _ENERF_KEYS)
    n_srcs = int(scfg.get("n_srcs", 2))
    rcfg, _ = _runner_cfg(cfg)
    lr = float(rcfg.get("lr", 5e-4))

    if dcfg.get("source", "synthetic") == "synthetic":
        views, eval_views = _load_views_generic(cfg, device)
        centers = np.stack([v["camera"].center.cpu().numpy() for v in views])

        def item(i, pool):
            # the nearest training cameras (the target itself left out by
            # the zero-distance guard when pool is the training set)
            v = pool[i]
            dist = np.linalg.norm(
                centers - v["camera"].center.cpu().numpy(), axis=-1)
            dist[dist < 1e-9] = np.inf
            return v, [views[j] for j in np.argsort(dist)[:n_srcs]]
    else:
        from envgs_tpu_torch.data.video_dataset import ImageBasedDataset

        kw = dict(_dataset_kwargs(dcfg), n_srcs=n_srcs, device=device)
        ds = call_filtered(ImageBasedDataset, dict(kw, split="train"))
        vs = call_filtered(ImageBasedDataset, dict(kw, split="val"))
        views = [ds[i] for i in range(len(ds))]
        eval_views = [vs[i] for i in range(len(vs))]

        def item(i, pool):
            v = pool[i]
            return v, [dict(rgb=v["src_inps"][k], camera=v["src_cams"][k])
                       for k in range(n_srcs)]

    def tensor(x):
        return torch.as_tensor(x, dtype=torch.float32, device=device)

    def sources(srcs):
        return (torch.stack([tensor(s["rgb"]) for s in srcs]),
                [s["camera"] for s in srcs])

    near, far = _near_far(cfg, views)
    init, step = make_enerf_train_step(ecfg, views[0]["camera"], n_srcs,
                                       near, far, lr)
    net, opt_state = init(torch.Generator(device=device).manual_seed(
        int(rcfg.get("seed", 0))), device)
    loop = FamilyLoop(cfg, "enerf")
    tree, opt_state, start = loop.restore(net.jax_params(), opt_state)
    _load_tree(net, tree)
    rng = np.random.default_rng(0)
    for it in range(start, loop.total):
        v, srcs = item(int(rng.integers(0, len(views))), views)
        cam = v["camera"]
        imgs, cams = sources(srcs)
        opt_state, aux = step(
            net, opt_state, cam.K, cam.R, cam.T, imgs,
            torch.stack([c.K for c in cams]), torch.stack([c.R for c in cams]),
            torch.stack([c.T for c in cams]), tensor(v["rgb"]))
        loop.step_done(it, aux, net.jax_params(), opt_state)
    loop.finish(net.jax_params(), opt_state)
    if not eval_views:
        return net, None

    at = {id(v): i for i, v in enumerate(eval_views)}

    def render(v):
        _, srcs = item(at[id(v)], eval_views)
        imgs, cams = sources(srcs)
        return render_enerf(ecfg, net, v["camera"], imgs, cams, near,
                            far).rgb_map

    return net, _evaluate(render, eval_views, loop.result_dir, device)
