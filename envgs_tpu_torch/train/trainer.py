"""EnvGS trainer: the train step and the maintenance events of the
schedule (port of envgs_tpu/train/trainer.py).

One step: the forward through both passes in training mode, the losses,
`torch.autograd.grad` of the loss with respect to both pools' parameters
and the four zeros hooks (and, with camera optimisation, the per-view
camera residuals), masked sparse Adam on both pools, and the
densification statistics. The hooks' gradients are the screen-space
(base) and world-space (env) densification gradients and the per-splat
wet of each pass, so no `.grad` is retained and no forward wet is built.
`step_leaves`, `step_grads`, `apply_grads` and `camera_step` are these
parts; the band and slab steps of parallel/ are built on them too, so the
leaf order is known here alone.

`make_maintenance` returns the host-side function that applies every event
due at an iteration, before that iteration's forward: SH one-ups,
densify/prune of both pools, the opacity resets, the specular reset and
the 3DGS-DR tricks (color sabotage, normal propagation), under the JAX
package's exact conditions. The events that draw random numbers (densify
splits, color sabotage) draw from the train state's `torch.Generator`, the
counterpart of the JAX TrainState's key, unless the caller hands the draws
in.

`state_to_numpy` / `state_from_numpy` carry a train state across the two
packages under the JAX field names.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from envgs_tpu_torch.models import gaussians as G
from envgs_tpu_torch.models.camera_opt import (
    CameraResiduals,
    apply_residual,
    init_camera_residuals,
)
from envgs_tpu_torch.models.envgs import EnvGSConfig, forward_envgs
from envgs_tpu_torch.train.optimizer import (
    AdamState,
    LRConfig,
    init_adam,
    lr_tree_for,
    sparse_adam_update,
)
from envgs_tpu_torch.train.supervisor import LossConfig, compute_losses
from envgs_tpu_torch.utils.camera import Camera
from envgs_tpu_torch.utils.timer import span


class ScheduleConfig(NamedTuple):
    """Event cadences (envgs.yaml + EnvGSSampler defaults)."""

    epochs: int = 80
    ep_iter: int = 500
    # base gaussians
    densify_from_iter: int = 500
    densify_until_iter: int = 21000
    init_densification_interval: int = 100
    norm_densification_interval: int = 500
    opacity_reset_interval: int = 3000
    sh_update_iter: int = 1000
    sh_start_iter: int = 0
    # env gaussians
    env_densify_from_iter: int = 500
    env_densify_until_iter: int = 21000
    env_densification_interval: int = 500
    env_opacity_reset_interval: int = 6000
    env_sh_update_iter: int = 1000
    env_sh_start_iter: int = 0
    # 3DGS-DR tricks
    reflection_start_iter: int = 3000
    normal_prop_until_iter: int = 18000
    normal_prop_interval: int = 1000
    color_sabotage_until_iter: int = 18000
    color_sabotage_interval: int = 1000
    reset_specular_all: bool = False
    init_specular: float = 1e-3
    reset_opacity_value: float = 0.01

    @property
    def total_iters(self):
        return self.epochs * self.ep_iter


class TrainState(NamedTuple):
    base: G.GaussianPool
    env: G.GaussianPool
    opt_base: AdamState
    opt_env: AdamState
    # draws of the maintenance events (None: the caller hands them in)
    gen: torch.Generator | None = None


class Batch(NamedTuple):
    """One training view."""

    rgb: torch.Tensor  # (H, W, 3)
    msk: torch.Tensor  # (H, W, 1)
    norm: torch.Tensor  # (H, W, 3) monocular prior (zeros if absent)
    dpt: torch.Tensor | None = None  # (H, W, 1) metric depth prior


def init_train_state(base: G.GaussianPool, env: G.GaussianPool,
                     seed: int | None = None) -> TrainState:
    """A fresh train state; with `seed`, a generator on the pools' device
    for the maintenance events' draws."""
    gen = None
    if seed is not None:
        gen = torch.Generator(device=base.params.xyz.device)
        gen.manual_seed(seed)
    return TrainState(base, env, init_adam(base.params),
                      init_adam(env.params), gen)


class CamOptState(NamedTuple):
    """Optimizable-camera training state: the residuals and their Adam
    moments."""

    res: CameraResiduals
    opt: AdamState


def init_cam_opt(n_views: int, device=None) -> CamOptState:
    res = init_camera_residuals(max(n_views, 1), device)
    return CamOptState(res, init_adam(res))


class CamOptConfig(NamedTuple):
    enabled: bool = False
    extri_lr: float = 1e-5
    intri_lr: float = 1e-8
    freeze_extri: bool = False
    freeze_intri: bool = False


class StepGrads(NamedTuple):
    """A step's gradients, split from autograd's flat list (step_grads):
    both pools' parameters, the four zeros hooks' (the position hooks' and
    the wet hooks') and, with camera optimisation, the view residuals'."""

    base: G.GaussianParams
    env: G.GaussianParams
    means2d: torch.Tensor
    env_means3d: torch.Tensor
    wet_base: torch.Tensor
    wet_env: torch.Tensor
    cam: CameraResiduals | None = None

    def write(self, grads_out: dict | None):
        """Every gradient into a step's `grads_out` under its field's name
        (`cam` only with camera optimisation); None writes nothing."""
        if grads_out is not None:
            grads_out.update((k, v) for k, v in self._asdict().items()
                             if v is not None)


def step_leaves(state: TrainState, m2z_w: int,
                cam_state: CamOptState | None = None):
    """Fresh leaves of both pools' params, the four zeros hooks ((P, m2z_w)
    position, (Pe, 3) env position, (P,) and (Pe,) wet) and, with
    `cam_state`, the camera residuals -> (base params, env params, hooks,
    residuals or None, leaves): the list a step differentiates, in the one
    order step_grads splits (base present params, env present params, the
    hooks, the residuals)."""
    dev = state.base.params.xyz.device
    leaf = lambda x: x.detach().requires_grad_(True)  # noqa: E731
    bparams = G.map_params(leaf, state.base.params)
    eparams = G.map_params(leaf, state.env.params)
    zeros = lambda *s: torch.zeros(s, device=dev, requires_grad=True)  # noqa: E731
    hooks = (zeros(state.base.cap, m2z_w), zeros(state.env.cap, 3),
             zeros(state.base.cap), zeros(state.env.cap))
    cres = (None if cam_state is None
            else CameraResiduals(*map(leaf, cam_state.res)))
    leaves = [*G.present(bparams), *G.present(eparams), *hooks,
              *(cres or ())]
    return bparams, eparams, hooks, cres, leaves


def step_grads(loss: torch.Tensor, leaves: list, bparams, eparams,
               reduce: Callable[[list], list] | None = None) -> StepGrads:
    """The gradients of `loss` with respect to step_leaves' `leaves`, zeros
    where one is unused; `reduce` (the band and slab steps' all-reduce)
    maps the flat list before it is split."""
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g
             for g, x in zip(grads, leaves)]
    if reduce is not None:
        grads = reduce(grads)
    nb, ne = len(G.present(bparams)), len(G.present(eparams))
    g_cam = grads[nb + ne + 4:]
    return StepGrads(G.fill_params(bparams, grads[:nb]),
                     G.fill_params(eparams, grads[nb:nb + ne]),
                     *grads[nb + ne:nb + ne + 4],
                     CameraResiduals(*g_cam) if g_cam else None)


def apply_grads(state: TrainState, g: StepGrads, it: int, lr_base: LRConfig,
                lr_env: LRConfig, base_vis: torch.Tensor,
                base_wet: torch.Tensor, base_radii: torch.Tensor,
                env_vis: torch.Tensor | None, env_wet: torch.Tensor
                ) -> TrainState:
    """Sparse Adam on both pools, then the densification statistics: a
    splat counts as seen where its visibility holds (env_vis None: nowhere)
    or its wet is positive -> the new train state."""
    base, env = state.base, state.env
    new_bp, opt_base = sparse_adam_update(
        base.params, g.base, state.opt_base, lr_tree_for(it, lr_base))
    new_ep, opt_env = sparse_adam_update(
        env.params, g.env, state.opt_env, lr_tree_for(it, lr_env))
    b_stats = G.accumulate_stats(
        base.stats, g.means2d, base_vis | (base_wet > 0), weight=base_wet,
        radii=base_radii)
    env_seen = env_wet > 0 if env_vis is None else env_vis | (env_wet > 0)
    e_stats = G.accumulate_stats(env.stats, g.env_means3d, env_seen,
                                 weight=env_wet)
    return TrainState(base._replace(params=new_bp, stats=b_stats),
                      env._replace(params=new_ep, stats=e_stats),
                      opt_base, opt_env, state.gen)


def camera_step(cam_state: CamOptState, g_cam: CameraResiduals,
                cam_opt: CamOptConfig):
    """The residuals' update: the freeze flags zero their gradients, then
    Adam at eps 1e-15 with the float32 rates -> (new CamOptState, the
    gradient it applied)."""
    if cam_opt.freeze_extri:
        g_cam = g_cam._replace(se3=torch.zeros_like(g_cam.se3))
    if cam_opt.freeze_intri:
        g_cam = g_cam._replace(intr=torch.zeros_like(g_cam.intr))
    f32 = lambda v: float(torch.tensor(v, dtype=torch.float32))  # noqa: E731
    new_res, new_opt = sparse_adam_update(
        cam_state.res, g_cam, cam_state.opt,
        CameraResiduals(f32(cam_opt.extri_lr), f32(cam_opt.intri_lr)),
        eps=1e-15)
    return CamOptState(new_res, new_opt), g_cam


def without_camera(step_impl):
    """The cam-off form of a step_impl(state, cam_state, batch, K, R, T,
    view_idx, it, mark, grads_out): step(state, batch, K, R, T, it,
    mark=None, grads_out=None) -> (new state, stats)."""

    def step(state: TrainState, batch: Batch, K, R, T, it: int,
             mark: Callable[[str], None] | None = None,
             grads_out: dict | None = None):
        new_state, _, stats = step_impl(state, None, batch, K, R, T, 0, it,
                                        mark, grads_out)
        return new_state, stats

    return step


def make_train_step(cam: Camera, model_cfg: EnvGSConfig, loss_cfg: LossConfig,
                    lr_base: LRConfig, lr_env: LRConfig,
                    has_norm: bool = False,
                    cam_opt: CamOptConfig = CamOptConfig(),
                    lpips_fn=None, aux_cfg=None):
    """The train step for the template camera's resolution and planes.

    step(state, batch, K, R, T, it, mark=None, grads_out=None) -> (new
    state, stats dict); with `cam_opt.enabled`, step(state, cam_state,
    batch, K, R, T, view_idx, it, ...) -> (new state, new cam_state, stats):
    the view's SE(3) and intrinsic residuals are applied inside the forward
    and optimized with the pools (Adam, eps 1e-15, the two freeze flags).
    `mark(name)`, when given, is called as each stage ends ("forward",
    "backward", "optimizer"), e.g. to record CUDA events; `grads_out`, a
    dict, receives the step's gradients (StepGrads.write). `lpips_fn` (the
    perceptual loss) and `aux_cfg` (an AuxLossConfig: the chained aux
    supervisors, on `batch.dpt` for the depth prior) go to
    compute_losses."""
    H, W, znear, zfar = cam.H, cam.W, cam.znear, cam.zfar
    # screen-space (raster) or world-space (traced base) densification
    # gradients
    m2z_w = 3 if model_cfg.use_base_tracing else 2

    def step_impl(state: TrainState, cam_state: CamOptState | None,
                  batch: Batch, K, R, T, view_idx: int, it: int,
                  mark: Callable[[str], None] | None = None,
                  grads_out: dict | None = None):
        with span("train.step"):
            base, env = state.base, state.env
            bparams, eparams, hooks, cres, leaves = step_leaves(
                state, m2z_w, cam_state)
            camera = Camera(H, W, K, R, T, znear, zfar)
            if cres is not None:
                camera = apply_residual(camera, cres, int(view_idx))
            # the forward and backward spans close where `mark` is called:
            # both time one interval
            with span("train.forward"):
                out = forward_envgs(base._replace(params=bparams),
                                    env._replace(params=eparams), camera, it,
                                    model_cfg, *hooks)
                loss, stats = compute_losses(
                    out, batch.rgb, batch.msk,
                    batch.norm if has_norm else None, camera.R, it, loss_cfg,
                    bg_brightness=model_cfg.bg_brightness, lpips_fn=lpips_fn,
                    aux_cfg=aux_cfg, gt_dpt=batch.dpt)
            if mark:
                mark("forward")

            with span("train.backward"):
                g = step_grads(loss, leaves, bparams, eparams)
            if mark:
                mark("backward")

            # one of {forward wet, gradient-lane wet} is exact zeros (the
            # kernels' paths use the lane; the ref backends and multi-bounce
            # tracing keep the forward wet)
            new_state = apply_grads(
                state, g, it, lr_base, lr_env, out.base_visibility,
                g.wet_base + out.base_wet.detach(), out.base_radii.detach(),
                out.env_visibility, g.wet_env + out.env_wet.detach())
            if cres is not None:
                cam_state, g_cam = camera_step(cam_state, g.cam, cam_opt)
                g = g._replace(cam=g_cam)
            g.write(grads_out)
            stats["num_pts"] = base.stats.active.sum()
            stats["env_num_pts"] = env.stats.active.sum()
            # capacity truncation counters: pairs past the raster budget (none
            # for a traced base pass, whose dropped slots go unreported as in
            # the JAX package), tracer slots lost to the env budget and env
            # chunks cut by the cull's per-tile cap (0 = nothing dropped)
            if out.base_num_pairs is not None:
                stats["pair_overflow"] = torch.clamp(
                    out.base_num_pairs - model_cfg.pair_cap, min=0)
            stats["trace_dropped"] = out.env_dropped_pairs
            stats["trace_cut"] = out.env_cut_chunks
            if mark:
                mark("optimizer")
            return new_state, cam_state, stats

    return step_impl if cam_opt.enabled else without_camera(step_impl)


# ---------------------------------------------------------------------------
# Maintenance events (host-dispatched, before the forward of an iteration)
# ---------------------------------------------------------------------------

EVENTS = ("oneup_base", "oneup_env", "densify_base", "densify_env",
          "reset_opacity_base", "reset_specular", "reset_opacity_env",
          "color_sabotage", "normal_prop")


def due_events(s: ScheduleConfig, it: int) -> list[str]:
    """The events of EVENTS due at iteration `it`, in the order they apply
    (the conditions of envgs_tpu's `maintain`)."""
    # the densification interval switches by phase
    if it < s.reflection_start_iter or it >= s.normal_prop_until_iter:
        dint = s.init_densification_interval
    else:
        dint = s.norm_densification_interval
    due = []
    if (0 < it < s.densify_until_iter and it % s.sh_update_iter == 0
            and it > s.sh_start_iter):
        due.append("oneup_base")
    if (s.reflection_start_iter < it < s.env_densify_until_iter
            and it % s.env_sh_update_iter == 0 and it > s.env_sh_start_iter):
        due.append("oneup_env")
    if s.densify_from_iter < it < s.densify_until_iter and it % dint == 0:
        due.append("densify_base")
    if (s.env_densify_from_iter < it < s.env_densify_until_iter
            and it > s.reflection_start_iter
            and it % s.env_densification_interval == 0):
        due.append("densify_env")
    opacity_reset = False
    if 0 < it < s.densify_until_iter and it % s.opacity_reset_interval == 0:
        due.append("reset_opacity_base")
        opacity_reset = True
        if it > s.opacity_reset_interval and it > s.reflection_start_iter:
            due.append("reset_specular")
    if (s.reflection_start_iter < it < s.env_densify_until_iter
            and it % s.env_opacity_reset_interval == 0):
        due.append("reset_opacity_env")
    # the 3DGS-DR tricks: an opacity reset at the same iteration suppresses
    # both
    if (s.reflection_start_iter < it <= s.color_sabotage_until_iter
            and it % s.color_sabotage_interval == 0 and not opacity_reset
            and it < s.densify_until_iter):
        due.append("color_sabotage")
    if (s.reflection_start_iter < it <= s.normal_prop_until_iter
            and it % s.normal_prop_interval == 0 and not opacity_reset
            and it < s.densify_until_iter):
        due.append("normal_prop")
    return due


def make_maintenance(sched: ScheduleConfig, dens_base: G.DensifyConfig,
                     dens_env: G.DensifyConfig):
    """Returns maintain(state, it, draws=None, log=None) -> state, which
    applies every event due at python-int iteration `it` (called before the
    forward of iteration it).

    draws: {"densify_base" | "densify_env": the list of split draws `eps`
    of densify_and_prune, "color_sabotage": the (cap, 1, 3) uniform draw}
    for events whose random numbers the caller supplies; the others draw
    from `state.gen`. log, a list, receives (it, event) as each fires."""

    def pool_event(state, which, fn):
        opt = getattr(state, "opt_" + which)
        pool, (mu, nu) = fn(getattr(state, which), (opt.mu, opt.nu))
        return state._replace(**{which: pool,
                                 "opt_" + which: AdamState(mu, nu, opt.step)})

    def normal_prop(pool, adam):
        return G.enlarge_scaling(*G.enlarge_opacity(pool, adam))

    def maintain(state: TrainState, it: int, draws: dict | None = None,
                 log: list | None = None) -> TrainState:
        draws = draws or {}
        gen = state.gen
        events = {
            "oneup_base": lambda st: st._replace(
                base=G.oneup_sh_degree(st.base)),
            "oneup_env": lambda st: st._replace(
                env=G.oneup_sh_degree(st.env)),
            "densify_base": lambda st: pool_event(
                st, "base", lambda p, a: G.densify_and_prune(
                    p, a, dens_base, gen, draws.get("densify_base"))),
            "densify_env": lambda st: pool_event(
                st, "env", lambda p, a: G.densify_and_prune(
                    p, a, dens_env, gen, draws.get("densify_env"))),
            "reset_opacity_base": lambda st: pool_event(
                st, "base", lambda p, a: G.reset_opacity(
                    p, a, sched.reset_opacity_value)),
            "reset_specular": lambda st: pool_event(
                st, "base", lambda p, a: G.reset_specular(
                    p, a, sched.init_specular, sched.reset_specular_all)),
            "reset_opacity_env": lambda st: pool_event(
                st, "env", lambda p, a: G.reset_opacity(
                    p, a, sched.reset_opacity_value)),
            "color_sabotage": lambda st: pool_event(
                st, "base", lambda p, a: G.distort_color(
                    p, a, gen, draws.get("color_sabotage"))),
            "normal_prop": lambda st: pool_event(st, "base", normal_prop),
        }
        for name in due_events(sched, it):
            state = events[name](state)
            if log is not None:
                log.append((it, name))
        return state

    return maintain


# ---------------------------------------------------------------------------
# Weight bridge: train states as numpy under the JAX field names
# ---------------------------------------------------------------------------

def _np(x):
    return x.detach().cpu().numpy()


def pool_state_to_numpy(pool: G.GaussianPool, opt: AdamState) -> dict:
    """{"params", "stats", "mu", "nu": {field: array}, "step": int,
    "max_sh_degree": int} of one pool and its Adam state."""
    params, stats = G.pool_to_numpy(pool)
    moments = lambda m: {k: _np(v) for k, v in m._asdict().items()  # noqa: E731
                         if v is not None}
    return dict(params=params, stats=stats, mu=moments(opt.mu),
                nu=moments(opt.nu),
                step=int(opt.step), max_sh_degree=pool.max_sh_degree)


def pool_state_from_numpy(s: dict, device=None):
    """Inverse of pool_state_to_numpy -> (pool, AdamState). A temporal
    field absent or None stays None (the static families)."""
    def params(fields):
        return G.GaussianParams(**{
            k: torch.tensor(np.asarray(fields[k]), dtype=torch.float32,
                            device=device)
            for k in G.GaussianParams._fields if fields.get(k) is not None})

    return (G.pool_from_numpy(s["params"], s["stats"], s["max_sh_degree"],
                              device),
            AdamState(params(s["mu"]), params(s["nu"]),
                      torch.tensor(int(s["step"]), dtype=torch.int32,
                                   device=device)))


def generator_to_numpy(gen: torch.Generator) -> dict:
    """{"gen_state": the state bytes (uint8), "gen_seed": the seed it
    started from, "gen_device": its device type}."""
    return {"gen_state": gen.get_state().numpy(),
            "gen_seed": np.asarray(gen.initial_seed(), np.uint64),
            "gen_device": np.asarray(gen.device.type)}


def generator_from_numpy(d: dict, device) -> torch.Generator:
    """A generator on `device` that resumes the saved stream when it was
    saved from the same device type (the state's layout differs between
    CPU and CUDA generators); otherwise one seeded with the saved seed,
    whose stream starts over."""
    gen = torch.Generator(device=device)
    if str(d["gen_device"]) == gen.device.type:
        gen.set_state(torch.tensor(np.asarray(d["gen_state"]),
                                   dtype=torch.uint8))
    else:
        gen.manual_seed(int(d["gen_seed"]))
    return gen


def state_to_numpy(state: TrainState) -> dict:
    """{"base"|"env": pool_state_to_numpy of that pool} and, when the state
    carries a generator, the entries of generator_to_numpy."""
    d = {"base": pool_state_to_numpy(state.base, state.opt_base),
         "env": pool_state_to_numpy(state.env, state.opt_env)}
    if state.gen is not None:
        d.update(generator_to_numpy(state.gen))
    return d


def state_from_numpy(d: dict, device=None) -> TrainState:
    """Inverse of state_to_numpy (see generator_from_numpy for the
    generator)."""
    (base, opt_base), (env, opt_env) = (
        pool_state_from_numpy(d[k], device) for k in ("base", "env"))
    gen = (generator_from_numpy(d, base.params.xyz.device)
           if d.get("gen_state") is not None else None)
    return TrainState(base, env, opt_base, opt_env, gen)
