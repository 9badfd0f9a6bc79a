"""Command-line entry points of the port: train / test / render / mesh /
smoke / ws / dist / sig (port of envgs_tpu/cli.py for the EnvGS family and
the config-driven families: plain 3DGS, Spacetime Gaussians, PointPlanes,
NeRF, NeuS and ENeRF, on the synthetic scene or a capture on disk).

  python -m envgs_tpu_torch smoke            # synthetic end-to-end run
  python -m envgs_tpu_torch train -c configs/exps/envgs_synthetic.yaml
  python -m envgs_tpu_torch train -c <scene config> \
      dataset_cfg.data_root=<capture>
  python -m envgs_tpu_torch train -c configs/exps/gaussiant_synthetic.yaml
  python -m envgs_tpu_torch train -c configs/exps/stgs_synthetic.yaml
  python -m envgs_tpu_torch train -c configs/exps/point_planes_synthetic.yaml
  python -m envgs_tpu_torch train -c configs/exps/nerf_synthetic.yaml
  python -m envgs_tpu_torch train -c configs/exps/neus_synthetic.yaml
  python -m envgs_tpu_torch train -c configs/exps/enerf_synthetic.yaml
  python -m envgs_tpu_torch test  -c configs/exps/envgs_synthetic.yaml \
      model_cfg.sampler_cfg.tracer_backend=tiled
  python -m envgs_tpu_torch render -c <config> --path-kind orbit \
      --path-frames 60 [--path-dir <dir with intri.yml, extri.yml>]
  python -m envgs_tpu_torch mesh -c <config> [--mesh-res 256] \
      [--mesh-stride 1]
  python -m envgs_tpu_torch ws -c <config> [--host 127.0.0.1] [--port 1024]
  python -m envgs_tpu_torch sig --name <experiment> [--signal usr2]

`render` resumes the latest checkpoint (through make_runner) and writes the
frames of a camera path under `<out_root>/result/<exp>/<kind>/`; `mesh`
resumes it too and writes the TSDF-fused mesh of the training views' depths
as `<out_root>/result/<exp>/mesh.ply` (Runner.extract_mesh); `dist` is
`train`, as in the JAX package; `sig` sends SIGUSR1 (status line and a
checkpoint) or SIGUSR2 (checkpoint only) to the running python processes
whose command line names envgs_tpu and `--name`; `--debug-nans` turns on
autograd's anomaly detection (the backward raises at the operation that
made a NaN); `ws` serves renders of the config's resumed state over
websockets on `--host` / `--port` (serve/websocket_server.py; needs the
`websockets` package), its browser viewer at http://<host>:<port>/.

Configs are the JAX package's (engine/config.py: parents via `configs:`,
`_delete_`, CLI `a.b.c=value` overrides). Everything runs on the CUDA card
and raises without one. The backends: `pallas` / `tiled` (the defaults) run
the blends' kernels on the card, `ref` the exact oracles
(envgs_synthetic.yaml names the `ref` tracer, gaussiant_synthetic.yaml the
`ref` rasterizer); any other name raises by name. `dataset_cfg.source:
multiview` reads a capture in easyvolcap layout (data/dataset.py:
`images/<cam>/`, `intri.yml` / `extri.yml`, `sparse/0`, `normals/`,
`envs/points3D.ply`). `train` with `sampler_cfg.type: GaussianTSampler` runs
the 3DGS family's loop, with `STGSModel` / `STGSSampler` the Spacetime
Gaussians', with `PointPlanesSampler` PointPlanes' (a video capture for
PointPlanes: `images/<cam>/<frame>`), with `network_cfg.type:
VolumetricVideoNetwork` NeRF's, `NeusNetwork` NeuS's and with
`CostVolumeSampler` ENeRF's (train/families.py), all through
`engine.TRAINERS`; their other modes raise NotImplementedError naming the
family, as the JAX package has only `train` for them.
`model_cfg.supervisor_cfg.aux_cfg` enables the aux supervisors by weight
(train/aux_supervisors.py::AuxLossConfig).

Several processes: `torchrun --nproc_per_node N -m envgs_tpu_torch <mode>
-c <config>` runs the program on every rank (WORLD_SIZE > 1), each rank on
its card (cuda:LOCAL_RANK) in an NCCL default group (gloo when the caller
asks for the CPU). Training is replicated; rank 0 alone records
and saves; `test` splits the eval views over the ranks and merges their
means (train/runner.py). The band- and splat-parallel train steps are
library functions (parallel/), as in the JAX package.
"""
from __future__ import annotations

import argparse
import json
import os
import signal

import numpy as np
import torch

from envgs_tpu_torch.engine import TRAINERS, Config, call_filtered, load_config
from envgs_tpu_torch.models import gaussians as G
from envgs_tpu_torch.models.envgs import EnvGSConfig
from envgs_tpu_torch.ops.common import BACKENDS, check_backend
from envgs_tpu_torch.train import families  # noqa: F401 (registrations)
from envgs_tpu_torch.train.aux_supervisors import AuxLossConfig
from envgs_tpu_torch.train.optimizer import LRConfig
from envgs_tpu_torch.train.runner import Runner
from envgs_tpu_torch.train.supervisor import LossConfig
from envgs_tpu_torch.train.trainer import CamOptConfig, ScheduleConfig

MODES = ("train", "test", "render", "mesh", "smoke", "ws", "dist", "sig")
UNPORTED_MODES = ()


# sampler_cfg keys that no config tuple holds: build_from_config and
# make_runner read them themselves
_SAMPLER_KEYS = frozenset({
    "type", "pool_cap", "env_pool_cap", "sh_deg", "env_sh_deg", "init_occ",
    "env_init_occ", "init_specular", "init_roughness", "env_preload_gs",
    "env_max_gs", "spatial_scale", "white_bg", "render_reflection_start_iter",
    "xyz_lr_scheduler", "patch_size", "preload_gs", "env_bounds",
    # the reference sampler's scene box: every shipped dataset config sets
    # it, and the JAX EnvGS path reads nothing of it either
    "bounds"})


def _named(cls, cfg: dict, elsewhere=frozenset()):
    """cls(**the keys of cfg that are fields of cls). A key that is neither
    a field nor in `elsewhere` (keys that another reader of the same dict
    takes, or that are left out on purpose) raises by name: a misspelt or
    unported option is not dropped without a word."""
    cfg = dict(cfg or {})
    for k in cfg:
        if k not in cls._fields and k not in elsewhere:
            raise KeyError(
                f"config key {k!r}: {cls.__name__} has no such field and "
                "nothing else of the port reads it")
    return cls(**{k: v for k, v in cfg.items() if k in cls._fields})


def _sampler_keys():
    """Every sampler_cfg key the port reads: the fields of the tuples built
    from it (the env pool's densify options under an `env_` prefix), the
    keys read one by one, and the deliberate omissions."""
    dens = G.DensifyConfig._fields
    return (frozenset(EnvGSConfig._fields) | frozenset(ScheduleConfig._fields)
            | frozenset(dens) | frozenset("env_" + k for k in dens)
            | _SAMPLER_KEYS)


def _load_views(cfg: Config, device="cuda"):
    """dataset_cfg -> (views, eval_views, init_xyz, init_rgb, env_bounds,
    spatial_scale): the synthetic scene, or (any other source) a capture on
    disk read by MultiViewDataset, cameras on `device`."""
    dcfg = cfg.get("dataset_cfg", {})
    source = dcfg.get("source", "synthetic")
    if source != "synthetic":
        from envgs_tpu_torch.data.dataset import MultiViewDataset

        scfg = cfg.get("model_cfg", {}).get("sampler_cfg", {}) or {}
        # val_dataset_cfg overlays dataset_cfg for the eval split (explicit
        # per-split view_sample lists, or another data_root)
        vcfg = dict(dcfg, **(cfg.get("val_dataset_cfg", {}) or {}))
        ds = call_filtered(MultiViewDataset,
                           dict(dcfg, split="train", device=device))
        vs = call_filtered(MultiViewDataset,
                           dict(vcfg, split="val", device=device))
        views = [ds[i] for i in range(len(ds))]
        eval_views = [vs[i] for i in range(len(vs))]
        # preload_gs sits under sampler_cfg in the reference; either place
        init_xyz, init_rgb = ds.load_sfm(
            scfg.get("preload_gs") or dcfg.get("preload_gs"))
        env_bounds = (scfg.get("env_bounds") or dcfg.get("env_bounds")
                      or [[-1, -1, -1], [1, 1, 1]])
        # a scene config pins the SfM-derived spatial_scale; it wins over
        # the camera sphere's
        spatial_scale = float(scfg.get("spatial_scale", ds.spatial_scale))
        return (views, eval_views, init_xyz, init_rgb, env_bounds,
                spatial_scale)
    from envgs_tpu_torch.data.synthetic import make_scene

    scene = make_scene(n_views=dcfg.get("n_views", 12), H=dcfg.get("H", 128),
                       W=dcfg.get("W", 128), seed=dcfg.get("seed", 0),
                       device=device)
    split = dcfg.get("eval_every", 4)
    views, eval_views = [], []
    for i, cam in enumerate(scene.cams):
        v = dict(rgb=scene.images[i], msk=scene.masks[i],
                 norm=scene.normals[i], camera=cam, name=f"{i:02d}")
        (eval_views if (split and i % split == 0) else views).append(v)
    xyz = scene.gt_base.params.xyz.cpu().numpy()[
        scene.gt_base.stats.active.cpu().numpy()]
    rng = np.random.default_rng(0)
    init_xyz = xyz + rng.normal(scale=0.05, size=xyz.shape).astype(np.float32)
    init_rgb = rng.random(init_xyz.shape).astype(np.float32)
    env_bounds = dcfg.get("env_bounds", [[-14, -14, -14], [14, 14, 14]])
    return views, eval_views, init_xyz, init_rgb, env_bounds, 2.5


def build_from_config(cfg: Config, device="cuda"):
    """Config dict -> (views, eval_views, base, env, model_cfg, loss_cfg,
    sched, dens_base, dens_env, lr_base, lr_env, aux_cfg), the pools on
    `device`; aux_cfg is None unless supervisor_cfg.aux_cfg sets a key."""
    mcfg = cfg.get("model_cfg", {})
    scfg = dict(mcfg.get("sampler_cfg", {}) or {})
    for kind in ("raster", "tracer"):  # the backend names, before any work
        check_backend(kind, scfg.get(f"{kind}_backend", BACKENDS[kind][0]))
    (views, eval_views, init_xyz, init_rgb, env_bounds,
     spatial_scale) = _load_views(cfg, device)
    if "render_reflection_start_iter" in scfg:
        scfg.setdefault("reflection_start_iter",
                        scfg["render_reflection_start_iter"])
    if scfg.get("white_bg"):
        scfg.setdefault("bg_brightness", 1.0)
        scfg.setdefault("env_bg_brightness", 1.0)
    spatial_scale = float(scfg.get("spatial_scale", spatial_scale))
    known = _sampler_keys()
    model_cfg = _named(EnvGSConfig, scfg, known)
    rcfg = cfg.get("runner_cfg", {}) or {}
    sched = _named(ScheduleConfig, {**scfg, **rcfg}, known | set(rcfg))

    sup = mcfg.get("supervisor_cfg", {}) or {}
    loss_cfg = _named(LossConfig, sup, {"type", "aux_cfg"})
    # the chained aux supervisors, enabled by weight
    aux_raw = sup.get("aux_cfg", {}) or {}
    aux_cfg = _named(AuxLossConfig, aux_raw) if aux_raw else None

    ocfg = cfg.get("runner_cfg", {}).get("optimizer_cfg", {})
    lr_table = ocfg.get("lr_table", {})
    lr_common = dict(
        xyz=lr_table.get("_xyz", 0.00016),
        features_dc=lr_table.get("_features_dc", 0.0025),
        features_rest=lr_table.get("_features_rest", 0.000125),
        opacity=lr_table.get("_opacity", 0.05),
        scaling=lr_table.get("_scaling", 0.005),
        rotation=lr_table.get("_rotation", 0.001),
        specular=lr_table.get("_specular", 0.01),
        spatial_scale=spatial_scale,
        reflection_start_iter=sched.reflection_start_iter,
        normal_prop_until_iter=sched.normal_prop_until_iter,
    )
    xsched = scfg.get("xyz_lr_scheduler", {}) or {}
    if xsched:
        lr_common.update(
            xyz_lr_init=float(xsched.get("lr_init", lr_common["xyz"])),
            xyz_lr_final=float(xsched.get("lr_final", 1.6e-6)),
            xyz_lr_delay_mult=float(xsched.get("lr_delay_mult", 0.01)),
            xyz_lr_max_steps=int(xsched.get("max_steps", 30000)),
        )
    lr_base = _named(LRConfig, lr_common)
    lr_env = _named(LRConfig, dict(lr_common, use_opacity_pulse=False))

    dens_base = _named(G.DensifyConfig, dict(
        scfg, spatial_scale=spatial_scale,
        max_gs=int(scfg.get("max_gs", 2_000_000))), known)
    env_keys = {k[len("env_"):]: v for k, v in scfg.items()
                if k.startswith("env_")}
    dens_env = _named(G.DensifyConfig, dict(
        env_keys, spatial_scale=spatial_scale,
        max_gs=int(scfg.get("env_max_gs", 700_000))),
        {k[len("env_"):] for k in known if k.startswith("env_")})

    cap = int(scfg.get("pool_cap", scfg.get("max_gs", 2 ** 17)))
    env_cap = int(scfg.get("env_pool_cap", scfg.get("env_max_gs", 2 ** 16)))
    base = G.create_pool(
        init_xyz, init_rgb, cap=cap,
        sh_degree=int(scfg.get("sh_deg", 3)),
        init_opacity=float(scfg.get("init_occ", 0.1)),
        specular_channels=int(scfg.get("specular_channels", 1)),
        init_specular=float(scfg.get("init_specular", 1e-3)),
        init_roughness=float(scfg.get("init_roughness", 0.5)),
        device=device)
    rng = np.random.default_rng(1)
    # env pool init: an SfM ply when the config names one that exists, else
    # random points in a grid over the env bounds at half capacity
    env_ply = scfg.get("env_preload_gs")
    if env_ply and os.path.exists(env_ply):
        from envgs_tpu_torch.utils.ply import load_sfm_ply

        env_xyz, env_rgb = load_sfm_ply(env_ply)
    else:
        from envgs_tpu_torch.utils.grid import sample_points_subgrid

        S = int(round((env_cap / 4) ** (1 / 3)))
        env_xyz = sample_points_subgrid(np.asarray(env_bounds, np.float32),
                                        S=max(S, 2), N=2)
        env_rgb = rng.random(env_xyz.shape).astype(np.float32)
    env = G.create_pool(
        env_xyz, env_rgb, cap=env_cap,
        sh_degree=int(scfg.get("env_sh_deg", 3)),
        init_opacity=float(scfg.get("env_init_occ", 0.1)), device=device)
    return (views, eval_views, base, env, model_cfg, loss_cfg, sched,
            dens_base, dens_env, lr_base, lr_env, aux_cfg)


def _moderators(cfg: Config) -> dict:
    """runner_cfg.moderator_cfg and sampler_cfg.patch_size -> the Runner's
    ratio_sched / crop_sched / alternating / patch_size arguments."""
    from envgs_tpu_torch.train.moderators import (
        AlternatingSchedule,
        CenterCropSchedule,
        RatioSchedule,
    )

    modcfg = cfg.get("runner_cfg", {}).get("moderator_cfg", {}) or {}
    typ = modcfg.get("type")
    out = dict(ratio_sched=None, crop_sched=None, alternating=None)
    if typ == "AlternatingModerator":
        out["alternating"] = AlternatingSchedule(
            patterns=tuple(modcfg.get("patterns", ("patch", "full"))))
    elif typ == "DatasetRatioModerator":
        out["ratio_sched"] = RatioSchedule(
            ratio_start=float(modcfg.get("milestone_start", 0.25)),
            ratio_end=float(modcfg.get("milestone_end", 1.0)),
            iter_start=int(modcfg.get("iter_start", 0)),
            iter_end=int(modcfg.get("iter_end", 10000)))
    elif typ == "DatasetCenterCropRatioModerator":
        out["crop_sched"] = CenterCropSchedule(
            crop_start=float(modcfg.get("milestone_start", 0.5)),
            crop_end=float(modcfg.get("milestone_end", 1.0)),
            iter_start=int(modcfg.get("iter_start", 0)),
            iter_end=int(modcfg.get("iter_end", 5000)))
    elif typ not in (None, "NoopModerator"):
        raise NotImplementedError(
            f"runner_cfg.moderator_cfg.type={typ!r}: no such moderator")
    scfg = cfg.get("model_cfg", {}).get("sampler_cfg", {}) or {}
    patch = scfg.get("patch_size", [-1, -1])
    out["patch_size"] = tuple(patch) if patch and patch[0] > 0 else None
    return out


def make_runner(cfg: Config, device="cuda") -> Runner:
    rcfg = cfg.get("runner_cfg", {})
    moderators = _moderators(cfg)
    (views, eval_views, base, env, model_cfg, loss_cfg, sched, dens_base,
     dens_env, lr_base, lr_env, aux_cfg) = build_from_config(cfg, device)

    ccfg = cfg.get("model_cfg", {}).get("camera_cfg", {}) or {}
    cam_opt = CamOptConfig(
        enabled=ccfg.get("type") == "OptimizableCamera",
        extri_lr=float(ccfg.get("extri_lr", 1e-5)),
        intri_lr=float(ccfg.get("intri_lr", 1e-8)),
        freeze_extri=bool(ccfg.get("freeze_extri", False)),
        freeze_intri=bool(ccfg.get("freeze_intri", False)))
    pcfg = cfg.get("profiler_cfg", {}) or {}
    return Runner(
        views=views, eval_views=eval_views, base=base, env=env,
        model_cfg=model_cfg, loss_cfg=loss_cfg, sched=sched,
        dens_base=dens_base, dens_env=dens_env, lr_base=lr_base,
        lr_env=lr_env,
        exp_name=cfg.get("exp_name", "exp"),
        out_root=cfg.get("out_root", "data"),
        save_latest_every=rcfg.get("save_latest_every", 5000),
        log_every=rcfg.get("log_interval", 50),
        eval_every_iters=rcfg.get("eval_every_iters", 0),
        resume=rcfg.get("resume", True),
        cam_opt=cam_opt,
        aux_cfg=aux_cfg,
        **moderators,
        collect_timing=bool(rcfg.get("collect_timing", False)),
        timer_sync=bool(rcfg.get("timer_sync_cuda", False)),
        timer_record_to_file=rcfg.get("timer_record_to_file"),
        profiler_trace_dir=pcfg.get("trace_dir") if pcfg.get("enabled")
        else None,
        profiler_start=int(pcfg.get("skip_first", 10)),
        profiler_steps=int(pcfg.get("active", 5)),
        record=bool(rcfg.get("record", True)),
        resolved_config=cfg.to_dict())


# sampler_cfg keys of the 3DGS entry point that no 3DGS tuple holds: read
# here (type, pool_cap) or by _load_views (the dataset stack's), or EnvGS
# options of configs/base.yaml the family ignores
_GAUSSIANT_KEYS = frozenset({
    "type", "pool_cap", "preload_gs", "spatial_scale",
    "bounds", "env_bounds", "env_preload_gs", "white_bg", "sh_deg",
    "init_occ", "tracer_backend"})


def train_gaussiant(cfg: Config, device="cuda"):
    """The plain 3DGS family from its config (the `train` mode of a config
    whose sampler_cfg.type is GaussianTSampler): the views of
    dataset_cfg, the loop of train/gaussiant_loop.py, the active pool as
    `<out_root>/trained_model/<exp>/point_cloud.ply`, and PSNR / SSIM of
    the held-out views in `<out_root>/result/<exp>/metrics.json`.
    -> (final state, the metrics.json dict or None without held-out
    views)."""
    from envgs_tpu_torch.models.gaussiant import (
        GaussianTConfig,
        render_gaussiant,
    )
    from envgs_tpu_torch.train.evaluator import Evaluator
    from envgs_tpu_torch.train.gaussiant_loop import (
        train_gaussiant as train_loop,
    )
    from envgs_tpu_torch.utils.ply import save_gaussian_ply

    scfg = dict(cfg.get("model_cfg", {}).get("sampler_cfg", {}) or {})
    gcfg = _named(GaussianTConfig, scfg,
                  frozenset(G.DensifyConfig._fields) | _GAUSSIANT_KEYS)
    check_backend("raster", gcfg.raster_backend)
    views, eval_views, init_xyz, init_rgb, _, spatial_scale = _load_views(
        cfg, device)
    rcfg = cfg.get("runner_cfg", {}) or {}
    state, _ = train_loop(views, [], init_xyz, init_rgb, scfg, rcfg,
                          spatial_scale,
                          torch.Generator(device=device).manual_seed(0))
    exp = cfg.get("exp_name", "gaussiant")
    out_root = cfg.get("out_root", "data")
    model_dir = os.path.join(out_root, "trained_model", exp)
    os.makedirs(model_dir, exist_ok=True)
    act = state.pool.stats.active
    p = state.pool.params
    save_gaussian_ply(os.path.join(model_dir, "point_cloud.ply"),
                      *(t[act].detach().cpu().numpy() for t in (
                          p.xyz, p.features_dc, p.features_rest, p.opacity,
                          p.scaling, p.rotation)))
    if not eval_views:
        return state, None
    ev = Evaluator(os.path.join(out_root, "result", exp))
    with torch.no_grad():
        for i, v in enumerate(eval_views):
            out = render_gaussiant(state.pool, v["camera"], gcfg)
            ev.evaluate(out.rgb, v["rgb"], name=f"{i:04d}")
    summary = ev.summarize()
    print(json.dumps(summary["summary"], indent=2))
    return state, summary


TRAINERS.register(train_gaussiant, name="GaussianTSampler")


def smoke_config() -> Config:
    """The synthetic end-to-end run of `smoke`: 6 views of 64x64, 150
    iterations, the reflection pass from iteration 60."""
    return Config.wrap({
        "exp_name": "smoke",
        "dataset_cfg": {"source": "synthetic", "H": 64, "W": 64,
                        "n_views": 6},
        "model_cfg": {"sampler_cfg": {
            "pool_cap": 1280, "env_pool_cap": 768,
            "reflection_start_iter": 60, "pair_cap": 2 ** 14}},
        "runner_cfg": {"epochs": 1, "ep_iter": 150, "log_interval": 25,
                       "resume": False},
    })


def signal_runs(name: str, which: str = "usr1") -> list:
    """Send SIGUSR1 (`usr1`) or SIGUSR2 (`usr2`) to every python process
    (but this one) whose command line holds `envgs_tpu` and `name` and is
    not itself a `sig` call -> [(pid, command line)] of those signalled.
    Only python interpreters: a wrapper (timeout, a shell) would die of an
    unhandled SIGUSR1."""
    sig = signal.SIGUSR1 if which == "usr1" else signal.SIGUSR2
    me = os.getpid()
    hits = []
    for pid in os.listdir("/proc"):
        if not pid.isdigit() or int(pid) == me:
            continue
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as fh:
                cmd = fh.read().replace(b"\0", b" ").decode("utf-8",
                                                             "ignore")
        except OSError:
            continue
        first = cmd.split(" ", 1)[0]
        if ("python" in os.path.basename(first) and "envgs_tpu" in cmd
                and name in cmd and " sig" not in cmd):
            hits.append((int(pid), cmd.strip()))
    for pid, cmd in hits:
        os.kill(pid, sig)
        print(f"sent {which.upper()} to {pid}: {cmd[:100]}")
    if not hits:
        print(f"no running envgs_tpu process matching {name!r}")
    return hits


def main(argv=None, device="cuda"):
    p = argparse.ArgumentParser("envgs_tpu_torch")
    p.add_argument("mode", choices=MODES + UNPORTED_MODES)
    p.add_argument("-c", "--config", default=None,
                   help="comma-separated config chain")
    p.add_argument("--name", default=None,
                   help="sig mode: a substring of the running training "
                   "process's command line (its experiment or config)")
    p.add_argument("--signal", default="usr1", choices=["usr1", "usr2"],
                   help="sig mode: usr1 = status line + checkpoint, usr2 = "
                   "checkpoint only")
    p.add_argument("--path-kind", default="orbit",
                   choices=["orbit", "spiral", "linear", "cubic"],
                   help="render mode: the camera path's interpolation")
    p.add_argument("--path-frames", type=int, default=60,
                   help="render mode: number of frames")
    p.add_argument("--path-dir", default=None,
                   help="render mode: a saved camera path (intri.yml, "
                   "extri.yml) as the keyframes, interpolated as cubic")
    p.add_argument("--mesh-res", type=int, default=256,
                   help="mesh mode: TSDF grid resolution")
    p.add_argument("--mesh-stride", type=int, default=1,
                   help="mesh mode: fuse every Nth training view")
    p.add_argument("--host", default="127.0.0.1", help="ws mode: bind host")
    p.add_argument("--port", type=int, default=1024, help="ws mode: port")
    p.add_argument("--debug-nans", action="store_true",
                   help="turn on autograd's anomaly detection: a backward "
                   "that makes a NaN raises at the operation (slow)")
    p.add_argument("opts", nargs="*", help="dotted overrides a.b.c=v; in "
                   "smoke mode they apply to the built-in config")
    a = p.parse_intermixed_args(argv)  # overrides may follow -c
    if a.mode in UNPORTED_MODES:
        raise NotImplementedError(f"mode {a.mode!r} is not ported")
    if a.debug_nans:
        torch.autograd.set_detect_anomaly(True)
    if a.mode == "sig":
        name = a.name or (a.opts[0] if a.opts else None)
        if not name:
            p.error("sig requires --name <experiment substring>")
        return signal_runs(name, a.signal)
    if a.mode == "dist":
        a.mode = "train"
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        # torchrun: every rank runs this program (rank 0 serves outputs);
        # NCCL for ranks on cards (a card a rank), gloo for CPU ranks
        from envgs_tpu_torch.parallel.multihost import init_from_env

        dev = torch.device(device)
        device = init_from_env(
            "nccl" if dev.type == "cuda" else "gloo",
            None if (dev.type, dev.index) == ("cuda", None) else dev)

    if a.mode == "smoke":
        from envgs_tpu_torch.engine import merge_dotted

        cfg = Config.wrap(merge_dotted(smoke_config().to_dict(), a.opts))
        runner = make_runner(cfg, device)
        runner.train()
        return runner.test()

    if not a.config:
        p.error("train/test/render/mesh/ws require -c <config[,config2,...]>")
    cfg = load_config(a.config, overrides=a.opts, root=os.getcwd())
    mcfg = cfg.get("model_cfg", {}) or {}
    styp = (mcfg.get("sampler_cfg", {}) or {}).get("type")
    ntyp = (mcfg.get("network_cfg", {}) or {}).get("type")
    if a.mode == "train":
        for typ in (styp, ntyp):
            if typ and typ in TRAINERS:
                return TRAINERS.get(typ)(cfg, device)
    for typ in (styp, ntyp):
        if typ and typ != "EnvGSSampler":
            raise NotImplementedError(
                f"model family {typ!r} in {a.mode} mode: the port's "
                "config-driven entry points are EnvGS (every mode) and "
                f"{', '.join(sorted(TRAINERS._modules))} (train)")
    if a.mode == "ws":
        from envgs_tpu_torch.serve.websocket_server import serve_config

        return serve_config(a.config, a.opts, host=a.host, port=a.port,
                            device=device)
    runner = make_runner(cfg, device)
    if a.mode == "render":
        out = runner.render_path(
            n_frames=a.path_frames, kind=a.path_kind,
            tag="file" if a.path_dir else a.path_kind, path_dir=a.path_dir)
        print(f"[render] wrote {out}")
        return out
    if a.mode == "mesh":
        return runner.extract_mesh(res=a.mesh_res, stride=a.mesh_stride)
    if a.mode == "train":
        runner.train()
    return runner.test()


if __name__ == "__main__":
    main()
