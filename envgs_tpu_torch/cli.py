"""Command-line entry points of the port: train / test / smoke (port of
envgs_tpu/cli.py for the EnvGS family on synthetic data).

  python -m envgs_tpu_torch smoke            # synthetic end-to-end run
  python -m envgs_tpu_torch train -c configs/exps/envgs_synthetic.yaml \
      model_cfg.sampler_cfg.tracer_backend=tiled
  python -m envgs_tpu_torch test  -c configs/exps/envgs_synthetic.yaml \
      model_cfg.sampler_cfg.tracer_backend=tiled

Configs are the JAX package's (engine/config.py: parents via `configs:`,
`_delete_`, CLI `a.b.c=value` overrides). Everything runs on the CUDA card
and raises without one. There is no backend switch: on the card both blends
run their kernels, and a config that names another backend than `pallas` /
`tiled` (envgs_synthetic.yaml names the `ref` tracer) raises until it is
overridden. A mode or option the port lacks (the real-data source,
the moderators, aux supervisors, the other model families, `render`,
`mesh`, `ws`, `dist`, `sig`) raises NotImplementedError naming it.
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from envgs_tpu_torch.engine import Config, load_config
from envgs_tpu_torch.models import gaussians as G
from envgs_tpu_torch.models.envgs import EnvGSConfig
from envgs_tpu_torch.train.optimizer import LRConfig
from envgs_tpu_torch.train.runner import Runner
from envgs_tpu_torch.train.supervisor import LossConfig
from envgs_tpu_torch.train.trainer import CamOptConfig, ScheduleConfig

MODES = ("train", "test", "smoke")
UNPORTED_MODES = ("render", "mesh", "ws", "dist", "sig")


# keys of the JAX package's config tuples that the port leaves out on
# purpose: it has no backend switch (the device of the tensors picks kernel
# or plain version; build_from_config raises on any other value)
OMITTED_KEYS = frozenset({"raster_backend", "tracer_backend"})
# sampler_cfg keys that no config tuple holds: build_from_config and
# make_runner read them themselves
_SAMPLER_KEYS = frozenset({
    "type", "pool_cap", "env_pool_cap", "sh_deg", "env_sh_deg", "init_occ",
    "env_init_occ", "init_specular", "init_roughness", "env_preload_gs",
    "env_max_gs", "spatial_scale", "white_bg", "render_reflection_start_iter",
    "xyz_lr_scheduler", "patch_size",
    # the real-data source's (not ported; the synthetic source ignores them)
    "preload_gs", "env_bounds"})


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
            | _SAMPLER_KEYS | OMITTED_KEYS)


def _load_views(cfg: Config, device="cuda"):
    """dataset_cfg -> (views, eval_views, init_xyz, init_rgb, env_bounds,
    spatial_scale); the synthetic source only."""
    dcfg = cfg.get("dataset_cfg", {})
    source = dcfg.get("source", "synthetic")
    if source != "synthetic":
        raise NotImplementedError(
            f"dataset_cfg.source={source!r}: only the synthetic source is "
            "ported (data/dataset.py is not)")
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
    sched, dens_base, dens_env, lr_base, lr_env), the pools on `device`."""
    mcfg = cfg.get("model_cfg", {})
    scfg = dict(mcfg.get("sampler_cfg", {}) or {})
    for key, default in (("raster_backend", "pallas"),
                         ("tracer_backend", "tiled")):
        if scfg.get(key, default) != default:
            raise NotImplementedError(
                f"sampler_cfg.{key}={scfg[key]!r}: the port has no backend "
                f"switch and runs only {default!r} (its kernels on the "
                f"card); override with model_cfg.sampler_cfg.{key}={default}")
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
    if sup.get("aux_cfg"):
        raise NotImplementedError(
            "supervisor_cfg.aux_cfg: the aux supervisors are not ported")
    loss_cfg = _named(LossConfig, sup, {"type", "aux_cfg"})

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
            dens_base, dens_env, lr_base, lr_env)


def make_runner(cfg: Config, device="cuda") -> Runner:
    rcfg = cfg.get("runner_cfg", {})
    modcfg = rcfg.get("moderator_cfg", {}) or {}
    if modcfg.get("type"):
        raise NotImplementedError(
            f"runner_cfg.moderator_cfg.type={modcfg['type']!r}: the "
            "moderators are not ported")
    scfg = cfg.get("model_cfg", {}).get("sampler_cfg", {}) or {}
    patch = scfg.get("patch_size", [-1, -1])
    if patch and patch[0] > 0:
        raise NotImplementedError(
            "sampler_cfg.patch_size: patch training is not ported")
    (views, eval_views, base, env, model_cfg, loss_cfg, sched, dens_base,
     dens_env, lr_base, lr_env) = build_from_config(cfg, device)

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
        collect_timing=bool(rcfg.get("collect_timing", False)),
        timer_sync=bool(rcfg.get("timer_sync_cuda", False)),
        timer_record_to_file=rcfg.get("timer_record_to_file"),
        profiler_trace_dir=pcfg.get("trace_dir") if pcfg.get("enabled")
        else None,
        profiler_start=int(pcfg.get("skip_first", 10)),
        profiler_steps=int(pcfg.get("active", 5)))


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


def main(argv=None, device="cuda"):
    p = argparse.ArgumentParser("envgs_tpu_torch")
    p.add_argument("mode", choices=MODES + UNPORTED_MODES)
    p.add_argument("-c", "--config", default=None,
                   help="comma-separated config chain")
    p.add_argument("opts", nargs="*", help="dotted overrides a.b.c=v; in "
                   "smoke mode they apply to the built-in config")
    a = p.parse_intermixed_args(argv)  # overrides may follow -c
    if a.mode in UNPORTED_MODES:
        raise NotImplementedError(f"mode {a.mode!r} is not ported")

    if a.mode == "smoke":
        from envgs_tpu_torch.engine import merge_dotted

        cfg = Config.wrap(merge_dotted(smoke_config().to_dict(), a.opts))
        runner = make_runner(cfg, device)
        runner.train()
        return runner.test()

    if not a.config:
        p.error("train/test require -c <config[,config2,...]>")
    cfg = load_config(a.config, overrides=a.opts, root=os.getcwd())
    mcfg = cfg.get("model_cfg", {}) or {}
    styp = (mcfg.get("sampler_cfg", {}) or {}).get("type")
    ntyp = (mcfg.get("network_cfg", {}) or {}).get("type")
    for typ in (styp, ntyp):
        if typ and typ != "EnvGSSampler":
            raise NotImplementedError(
                f"model family {typ!r}: only the EnvGS family has a "
                "config-driven entry point in the port")
    runner = make_runner(cfg, device)
    if a.mode == "train":
        runner.train()
    return runner.test()


if __name__ == "__main__":
    main()
