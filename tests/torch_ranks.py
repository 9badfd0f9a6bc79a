"""Spawned ranks for the port's multi-process tests on the CPU, and the
functions they run (this module imports no JAX: every rank imports it).

    from torch_ranks import run_ranks
    results = run_ranks(fn, world, tmp_path, *args)   # fn(rank, world, *args)

Each rank is a process of torch.multiprocessing.spawn on one thread, in a
gloo group started from a file under tmp_path (no TCP port, so test
workers cannot collide) with a timeout on every collective: a rank that
raises makes spawn end the others and raise here, and a rank left waiting
fails at the timeout instead of hanging the suite. A rank's return value
comes back through a file.
"""
from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

TIMEOUT = datetime.timedelta(seconds=120)


def _entry(rank, world, init_file, out_dir, fn, args):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world, timeout=TIMEOUT)
    try:
        res = fn(rank, world, *args)
        torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run_ranks(fn, world: int, tmp_path, *args) -> list:
    """fn(rank, world, *args) on `world` spawned ranks -> their results in
    rank order. fn must be a module-level function of a JAX-free module."""
    out_dir = os.path.join(str(tmp_path), f"ranks_{fn.__name__}_{world}")
    os.makedirs(out_dir, exist_ok=True)
    init_file = os.path.join(out_dir, "init")
    mp.spawn(_entry, args=(world, init_file, out_dir, fn, args),
             nprocs=world, join=True)
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                       weights_only=False) for r in range(world)]


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else x


def _grads_np(grads: dict) -> dict:
    out = {}
    for k, v in grads.items():
        if hasattr(v, "_asdict"):
            out[k] = {f: _np(t) for f, t in v._asdict().items()
                      if t is not None}
        else:
            out[k] = _np(v)
    return out


# ---- multihost ----

def multihost_worker(rank, world):
    from envgs_tpu_torch.parallel import multihost as mh

    mh.barrier()
    items = list(range(10))
    return dict(index=mh.process_index(), count=mh.process_count(),
                main=mh.is_main_process(), shard=mh.shard_for_host(items),
                sum=mh.allsum_hosts([rank + 1.0, 0.25, 1e-9 * (rank + 1)]))


def collectives_worker(rank, world):
    """Each collective's value and gradient on this rank: x = [rank + 1,
    -rank], every rank's objective weighted by rank + 1."""
    from envgs_tpu_torch.parallel import collectives as C

    ax = C.make_axis("x")
    x = torch.tensor([rank + 1.0, -float(rank)], requires_grad=True)
    w = rank + 1.0
    out, grads = {}, {}
    for name, fn in (
            ("psum", lambda: C.psum(x, ax)), ("pmean", lambda: C.pmean(x, ax)),
            ("pmax", lambda: C.pmax(x, ax)),
            ("all_gather", lambda: C.all_gather(x, ax)),
            ("tiled", lambda: C.all_gather(x, ax, tiled=True)),
            ("ppermute", lambda: C.ppermute(
                x, ax, [(i, i + 1) for i in range(world - 1)]))):
        y = fn()
        out[name] = y.detach().numpy()
        grads[name] = torch.autograd.grad((y * w).sum(), x)[0].numpy()
    out["pmin"] = C.pmin(x, ax).numpy()
    out["index"] = C.axis_index(ax)
    return dict(out=out, grads=grads, reduced=dict(C.REDUCED))


def init_from_env_worker(rank, world, port):
    """init_from_env in a fresh process from torchrun's variables."""
    from envgs_tpu_torch.parallel import multihost as mh

    dist.destroy_process_group()  # the spawn's file group
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), MASTER_ADDR="localhost",
                      MASTER_PORT=str(port))
    dev = mh.init_from_env("gloo", device="cpu", timeout=TIMEOUT)
    out = dict(device=str(dev), index=mh.process_index(),
               count=mh.process_count(), backend=dist.get_backend(),
               sum=mh.allsum_hosts([1.0, rank]))
    return out  # _entry's teardown destroys the env-started group


# ---- losses and the band step ----

def band_losses_worker(rank, world, maps: dict, gt, msk, nrm, R, it,
                       loss_cfg):
    """compute_losses(band=) on this rank's rows -> (pmeaned loss and
    stats, the gradient of the pmeaned loss with respect to the band's
    rows of each map)."""
    from envgs_tpu_torch.models import envgs as tenv
    from envgs_tpu_torch.parallel.sharding import make_mesh, pmean_stats
    from envgs_tpu_torch.train import supervisor as tsup

    mesh = make_mesh(world, "band")
    axis = mesh.axes["band"]
    H = gt.shape[0]
    h = H // world
    rows = slice(rank * h, (rank + 1) * h)
    names = [k for k in maps if k not in ("env_opacity", "dpt_map")]
    leaves = {k: torch.tensor(maps[k][rows], requires_grad=True)
              for k in names}
    leaves["env_opacity"] = torch.tensor(maps["env_opacity"],
                                         requires_grad=True)
    fields = {k: None for k in tenv.EnvGSOutput._fields}
    fields.update(leaves, dpt_map=torch.tensor(maps["dpt_map"][rows]))
    loss, stats = tsup.compute_losses(
        tenv.EnvGSOutput(**fields), torch.tensor(gt[rows]),
        torch.tensor(msk[rows]), torch.tensor(nrm[rows]), torch.tensor(R),
        it, loss_cfg, bg_brightness=0.3, band=(axis, world, H))
    grads = torch.autograd.grad(loss / world, list(leaves.values()))
    g = {k: _np(v) for k, v in zip(leaves, grads)}
    g["env_opacity"] = _np(_sum(grads[-1], axis))
    return dict(stats={k: float(v) for k, v in
                       pmean_stats(stats, axis).items()}, grads=g)


def _sum(x, axis):
    from envgs_tpu_torch.parallel.collectives import psum

    return psum(x.detach(), axis)


def _state(start: dict, device="cpu"):
    from envgs_tpu_torch.train import trainer as ttrain

    return ttrain.state_from_numpy(start, device)


def band_step_worker(rank, world, start, batch, K, cam_args, model_cfg,
                     loss_cfg, lr, it, has_norm, cam_opt=None,
                     cam_start=None, view_idx=0, losses=None):
    """One make_sharded_train_step on this rank's band -> the new state,
    cam residuals, stats and summed gradients, as numpy; with `losses`
    (band_losses_worker's arguments) also its result."""
    from envgs_tpu_torch.parallel.sharding import (
        make_mesh,
        make_sharded_train_step,
    )
    from envgs_tpu_torch.train import trainer as ttrain
    from envgs_tpu_torch.utils.camera import make_camera

    H, W, R, T = cam_args
    cam = make_camera(H, W, K, R, T)
    mesh = make_mesh(world, "band")
    kw = {} if cam_opt is None else dict(cam_opt=cam_opt)
    step = make_sharded_train_step(mesh, cam, model_cfg, loss_cfg, lr, lr,
                                   has_norm=has_norm, **kw)
    state = _state(start)
    tb = ttrain.Batch(*map(torch.tensor, batch))
    grads = {}
    if cam_opt is None:
        new, stats = step(state, tb, cam.K, cam.R, cam.T, it,
                          grads_out=grads)
        res = None
    else:
        cs = ttrain.init_cam_opt(cam_start, "cpu")
        new, cs, stats = step(state, cs, tb, cam.K, cam.R, cam.T, view_idx,
                              it, grads_out=grads)
        res = {k: _np(v) for k, v in cs.res._asdict().items()}
    return dict(state=ttrain.state_to_numpy(new), cam=res,
                stats={k: float(v) for k, v in stats.items()},
                grads=_grads_np(grads),
                losses=None if losses is None else band_losses_worker(
                    rank, world, *losses))


# ---- splat slabs ----

def slab_render_worker(rank, world, starts, K, cam_args, model_cfg):
    """make_splat_sharded_render_base over `world` slabs of each start
    state's base pool -> the decoded renders as numpy."""
    from envgs_tpu_torch.parallel.sharding import make_mesh
    from envgs_tpu_torch.parallel.splat_sharding import (
        make_splat_sharded_render_base,
    )
    from envgs_tpu_torch.utils.camera import make_camera

    H, W, R, T = cam_args
    cam = make_camera(H, W, K, R, T)
    mesh = make_mesh(world, "splat")
    render = make_splat_sharded_render_base(mesh, cam, model_cfg)
    outs = []
    for start in starts:
        with torch.no_grad():
            out = render(_state(start).base)
        outs.append({k: _np(v) for k, v in out._asdict().items()
                     if v is not None})
    return outs


def slab_step_worker(rank, world, start, batch, K, cam_args, model_cfg,
                     loss_cfg, lr, it, n_bands):
    """One make_splat_sharded_train_step, 1-D (n_bands 1) or 2-D
    (n_bands x world / n_bands) -> new state, stats, summed gradients."""
    from envgs_tpu_torch.parallel.sharding import make_mesh
    from envgs_tpu_torch.parallel.splat_sharding import (
        make_splat_sharded_train_step,
    )
    from envgs_tpu_torch.train import trainer as ttrain
    from envgs_tpu_torch.utils.camera import make_camera

    H, W, R, T = cam_args
    cam = make_camera(H, W, K, R, T)
    if n_bands > 1:
        mesh = make_mesh((n_bands, world // n_bands), ("band", "splat"),
                         timeout=TIMEOUT)
    else:
        mesh = make_mesh(world, "splat")
    step = make_splat_sharded_train_step(
        mesh, cam, model_cfg, loss_cfg, lr, lr, has_norm=True,
        band_axis="band" if n_bands > 1 else None,
        slab_pair_cap=2 ** 12, slab_env_cap=2 ** 12)
    grads = {}
    new, stats = step(_state(start), ttrain.Batch(*map(torch.tensor, batch)),
                      cam.K, cam.R, cam.T, it, grads_out=grads)
    return dict(state=ttrain.state_to_numpy(new),
                stats={k: float(v) for k, v in stats.items()},
                grads=_grads_np(grads))


# ---- the runner's split evaluation ----

def runner_test_worker(rank, world, cfg_dict, out_root):
    """Runner.test of a runner built from the config on this rank."""
    from envgs_tpu_torch import cli
    from envgs_tpu_torch.engine import Config

    runner = cli.make_runner(Config.wrap(dict(cfg_dict, out_root=out_root)),
                             device="cpu")
    summary = runner.test(save_images=False)
    return dict(summary=summary["summary"],
                frames=[r["name"] for r in summary["frames"]])
