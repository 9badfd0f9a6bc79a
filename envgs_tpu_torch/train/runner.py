"""Training / evaluation runner (port of envgs_tpu/train/runner.py, the
host loop of a single process).

Epoch-driven train loop with the maintenance events before every step,
checkpoint resume (latest, else the highest-numbered file), periodic save
and eval, console stat lines with ETA and smoothed losses, tensorboard
scalars (TRAIN every log step, VAL and the last eval render per test), the
cap growth that doubles a pair cap when a step dropped pairs, the test loop
that writes metrics.json and typed image dumps, and camera-path rendering
(`render_path`). Evaluation renders in the tracer's exact per-ray order by
default. The dataset moderators pick each iteration's training view: the
ratio and centre-crop schedules (train/moderators.py) and patch training,
on every iteration or, with `alternating`, on its "patch" iterations.
The step chains the aux supervisors of `aux_cfg` (on a view's `dpt` depth
prior) and the perceptual loss when VGG16 weights exist (ops/lpips.py);
`extract_mesh` fuses rendered depths into a TSDF and writes its
isosurface (utils/fusion.py).

Under several processes (torchrun, parallel/multihost.py) the services
are rank 0's: the recorder and the checkpoints; `test` renders each
rank's stride of the eval views, writes the other ranks' files under
`rank{i}/` and merges the means over the ranks.
"""
from __future__ import annotations

import collections
import contextlib
import json
import os
import shutil
import signal
import subprocess
import time
from typing import Any

import numpy as np
import torch

from envgs_tpu_torch.models import gaussians as G
from envgs_tpu_torch.models.envgs import EnvGSConfig, forward_envgs
from envgs_tpu_torch.ops.lpips import default_weight_path, lpips_fn
from envgs_tpu_torch.parallel.multihost import (
    allsum_hosts,
    is_main_process,
    process_count,
    process_index,
    shard_for_host,
)
from envgs_tpu_torch.train import checkpoints as ckpt
from envgs_tpu_torch.train.evaluator import Evaluator, Visualizer
from envgs_tpu_torch.train.moderators import (
    AlternatingSchedule,
    CenterCropSchedule,
    RatioSchedule,
    center_crop_view,
    resize_view,
)
from envgs_tpu_torch.train.optimizer import LRConfig
from envgs_tpu_torch.train.recorder import Recorder, SmoothedValue
from envgs_tpu_torch.train.supervisor import LossConfig
from envgs_tpu_torch.train.trainer import (
    Batch,
    CamOptConfig,
    ScheduleConfig,
    init_cam_opt,
    init_train_state,
    make_maintenance,
    make_train_step,
)
from envgs_tpu_torch.utils import fusion
from envgs_tpu_torch.utils.camera import (
    Camera,
    camera_path_interpolate,
    make_camera,
)
from envgs_tpu_torch.utils.timer import ProfilerSession, Timer, read_spans


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Runner:
    def __init__(
        self,
        views: list[dict],  # [{rgb, msk?, norm?, camera, name?}], numpy maps
        base: G.GaussianPool,
        env: G.GaussianPool,
        model_cfg: EnvGSConfig,
        loss_cfg: LossConfig,
        sched: ScheduleConfig,
        dens_base: G.DensifyConfig,
        dens_env: G.DensifyConfig,
        lr_base: LRConfig,
        lr_env: LRConfig,
        exp_name: str = "exp",
        out_root: str = "data",
        save_latest_every: int = 5000,
        save_every: int = 0,
        log_every: int = 50,
        eval_views: list[dict] | None = None,
        eval_every_iters: int = 0,
        seed: int = 0,
        resume: bool = True,
        cam_opt: CamOptConfig = CamOptConfig(),
        ratio_sched: RatioSchedule | None = None,
        crop_sched: CenterCropSchedule | None = None,
        patch_size: tuple[int, int] | None = None,
        alternating: AlternatingSchedule | None = None,
        aux_cfg=None,  # AuxLossConfig | None: the chained aux supervisors
        collect_timing: bool = False,
        timer_sync: bool = False,
        timer_record_to_file: str | None = None,
        profiler_trace_dir: str | None = None,
        profiler_start: int = 10,
        profiler_steps: int = 5,
        record_dir: str | None = None,
        record: bool = True,
        resolved_config: dict | None = None,
    ):
        """The pools' device is the runner's: views' cameras must live on
        it, their maps are numpy arrays uploaded per step. ratio_sched /
        crop_sched resize / centre-crop the training views by iteration;
        patch_size (H, W) trains a random crop of that size, on every
        iteration or only on the "patch" iterations of `alternating`. With
        `record`, tensorboard events go to `record_dir` (default
        `<out_root>/record/<exp_name>`) with `resolved_config` beside them
        as config.yaml."""
        self.views = views
        self.eval_views = eval_views or []
        self.model_cfg = model_cfg
        self.loss_cfg = loss_cfg
        self.sched = sched
        self.lr_base, self.lr_env = lr_base, lr_env
        self.exp_name = exp_name
        self.model_dir = os.path.join(out_root, "trained_model", exp_name)
        self.result_dir = os.path.join(out_root, "result", exp_name)
        self.save_latest_every = save_latest_every
        self.save_every = save_every
        self.log_every = log_every
        self.eval_every_iters = eval_every_iters
        self.cam_opt_cfg = cam_opt
        self.aux_cfg = aux_cfg
        self.device = base.params.xyz.device

        self.ratio_sched = ratio_sched
        self.crop_sched = crop_sched
        self.patch_size = patch_size
        self.alternating = alternating
        # the moderated views: {ratio: {view: view}}, {(crop, H, W): ...}
        self._ratio_views: dict[float, dict[int, dict]] = {}
        self._crop_views: dict[tuple, dict[int, dict]] = {}

        self.has_norm = "norm" in views[0]
        # one train step per resolution (ratio bucket, crop, patch)
        self._step_cache: dict[tuple[int, int], Any] = {}
        self.maintain = make_maintenance(sched, dens_base, dens_env)
        self.events: list = []  # (iteration, event) of every event fired
        self.state = init_train_state(base, env, seed=seed)
        self.cam_state = init_cam_opt(len(views), self.device)
        self.start_iter = 0
        if resume:
            latest = ckpt.find_latest(self.model_dir)
            if latest:
                self.state, self.start_iter, cam_state = ckpt.load_checkpoint(
                    latest, base.cap, env.cap, n_views=len(views),
                    device=self.device)
                if cam_state is not None:
                    self.cam_state = cam_state
                print(f"[resume] {latest} @ iter {self.start_iter}")

        self.timer = Timer(enabled=collect_timing, sync=timer_sync)
        self.timer_record_to_file = timer_record_to_file
        self.profiler = ProfilerSession(profiler_trace_dir, profiler_start,
                                        profiler_steps)
        # rank 0's, like every other output service
        self.recorder = Recorder(
            record_dir or os.path.join(out_root, "record", exp_name),
            enabled=record and is_main_process(),
            resolved_config=resolved_config)

    def _step_fn(self, cam: Camera):
        key = (cam.H, cam.W)
        if key not in self._step_cache:
            self._step_cache[key] = make_train_step(
                cam, self.model_cfg, self.loss_cfg, self.lr_base, self.lr_env,
                has_norm=self.has_norm, cam_opt=self.cam_opt_cfg,
                lpips_fn=self._lpips_fn(), aux_cfg=self.aux_cfg)
        return self._step_cache[key]

    def _lpips_fn(self):
        """The perceptual loss over the VGG16 weights on disk
        (ops/lpips.py::default_weight_path, loaded once); None when its
        weight is 0 or no weight file exists."""
        if self.loss_cfg.perc_loss_weight <= 0:
            return None
        return lpips_fn(default_weight_path(), self.device)

    def _batch(self, view) -> Batch:
        H, W = view["camera"].H, view["camera"].W
        t = lambda a: torch.as_tensor(  # noqa: E731
            np.asarray(a, np.float32)).to(self.device, non_blocking=True)
        dpt = view.get("dpt")
        return Batch(
            rgb=t(view["rgb"]),
            msk=t(view.get("msk", np.ones((H, W, 1), np.float32))),
            norm=t(view.get("norm", np.zeros((H, W, 3), np.float32))),
            dpt=t(dpt) if dpt is not None else None)

    def _train_view(self, view_i: int, it: int,
                    rng: np.random.Generator) -> tuple[dict, Camera, int]:
        """View `view_i` as iteration `it` trains it: resized to the ratio
        schedule's bucket, centre-cropped to the crop schedule's, then a
        patch at a position drawn from `rng` (K shifted by its origin)."""
        view = self.views[view_i]
        if self.ratio_sched is not None:
            ratio = self.ratio_sched(it)
            if abs(ratio - 1.0) > 1e-6:
                bucket = self._ratio_views.setdefault(ratio, {})
                if view_i not in bucket:
                    bucket[view_i] = resize_view(view, ratio)
                view = bucket[view_i]
        if self.crop_sched is not None:
            crop = self.crop_sched(it)
            if abs(crop - 1.0) > 1e-6:
                # keyed by the source size too: a crop of another ratio
                # bucket must not be served
                ck = (crop, view["camera"].H, view["camera"].W)
                bucket = self._crop_views.setdefault(ck, {})
                if view_i not in bucket:
                    bucket[view_i] = center_crop_view(view, crop)
                view = bucket[view_i]
        cam: Camera = view["camera"]
        use_patch = self.patch_size is not None
        if use_patch and self.alternating is not None:
            use_patch = self.alternating(it) == "patch"
        if use_patch:
            ph, pw = self.patch_size
            ph, pw = min(ph, cam.H), min(pw, cam.W)
            y0 = int(rng.integers(0, cam.H - ph + 1))
            x0 = int(rng.integers(0, cam.W - pw + 1))
            K = cam.K.clone()
            K[0, 2] -= x0
            K[1, 2] -= y0
            view = dict(view, **{k: view[k][y0:y0 + ph, x0:x0 + pw]
                                 for k in ("rgb", "msk", "norm", "dpt")
                                 if k in view})
            cam = cam._replace(H=ph, W=pw, K=K)
        return view, cam, view_i

    def train(self):
        total = self.sched.total_iters
        smoothed = collections.defaultdict(SmoothedValue)
        rng = np.random.default_rng(0)
        order = rng.permutation(len(self.views))
        oi = 0
        t_start = time.time()

        # SIGUSR1 -> status dump + checkpoint at the next loop boundary;
        # SIGUSR2 -> checkpoint only. The handlers only set flags.
        sig_flags = {"dump": False, "save": False}

        def _on_usr1(*_a):
            sig_flags["dump"] = sig_flags["save"] = True

        def _on_usr2(*_a):
            sig_flags["save"] = True

        old_handlers = {}
        try:
            for sig, fn in ((signal.SIGUSR1, _on_usr1),
                            (signal.SIGUSR2, _on_usr2)):
                old_handlers[sig] = signal.signal(sig, fn)
        except ValueError:
            pass  # not the main thread (e.g. under a test harness)

        prev_stats: dict = {}
        try:
            for it in range(self.start_iter, total):
                self.profiler.step(it)
                self.timer.tick()
                self.state = self.maintain(self.state, it, log=self.events)
                self.timer.record("maintain")

                # the next permutation is drawn before the patch position,
                # as the reference does: both come from `rng`
                vi = int(order[oi])
                oi += 1
                if oi >= len(order):
                    order = rng.permutation(len(self.views))
                    oi = 0
                view, cam, view_i = self._train_view(vi, it, rng)
                batch = self._batch(view)
                self.timer.record("data")
                if self.cam_opt_cfg.enabled:
                    self.state, self.cam_state, stats = self._step_fn(cam)(
                        self.state, self.cam_state, batch, cam.K, cam.R,
                        cam.T, view_i, it)
                else:
                    self.state, stats = self._step_fn(cam)(
                        self.state, batch, cam.K, cam.R, cam.T, it)
                self.timer.record("step")

                # cap growth, checked every step on the step before (its
                # counters are on the host's side of the queue by now, so
                # reading them does not wait for the step just queued);
                # the last step reads its own. A dropped pair doubles the
                # cap it overflowed: configs can start snug.
                check = stats if it == total - 1 else prev_stats
                prev_stats = stats
                grew = {}
                if float(check.get("pair_overflow", 0)) > 0:
                    grew["pair_cap"] = self.model_cfg.pair_cap * 2
                if float(check.get("trace_dropped", 0)) > 0:
                    grew["env_pair_cap"] = self.model_cfg.env_pair_cap * 2
                if grew:
                    self.model_cfg = self.model_cfg._replace(**grew)
                    self._step_cache.clear()
                    print("[capacity] growing " + ", ".join(
                        f"{k} -> {v}" for k, v in grew.items()), flush=True)

                if it % self.log_every == 0 or it == total - 1:
                    stats = {k: float(v) for k, v in stats.items()}
                    for k, v in stats.items():
                        smoothed[k].update(v)
                    self.recorder.record("TRAIN", stats, it=it)
                    done = it - self.start_iter + 1
                    eta = ((time.time() - t_start) / max(done, 1)
                           * (total - it - 1))
                    line = " ".join(f"{k}: {smoothed[k].median:.4f}"
                                    for k in ("loss", "img_loss", "psnr")
                                    if k in smoothed)
                    tline = ""
                    if self.timer.enabled:
                        tline = (f" data {self.timer.mean('data')*1e3:.0f}ms"
                                 f" step {self.timer.mean('step')*1e3:.0f}ms")
                    print(f"iter {it}/{total} {line} "
                          f"pts {int(stats.get('num_pts', 0))} "
                          f"env {int(stats.get('env_num_pts', 0))} "
                          f"eta {eta/60:.1f}m{tline}", flush=True)
                    self.timer.tick()  # logging is not charged to a span

                if sig_flags["dump"]:
                    sig_flags["dump"] = False
                    print(f"[SIGUSR1] iter {it}/{total} " + " ".join(
                        f"{k}: {float(v):.4f}" for k, v in stats.items()),
                        flush=True)
                if sig_flags["save"]:
                    sig_flags["save"] = False
                    self.save(it + 1, latest_only=True)
                    print(f"[signal] checkpoint saved at iter {it + 1}",
                          flush=True)

                nxt = it + 1
                if self.save_latest_every and nxt % self.save_latest_every == 0:
                    self.save(nxt, latest_only=True)
                if self.save_every and nxt % self.save_every == 0:
                    self.save(nxt)
                if (self.eval_every_iters and nxt % self.eval_every_iters == 0
                        and self.eval_views):
                    self.test(save_images=False, tag=f"it{nxt}")
        finally:
            self.profiler.close()
            for sig, old in old_handlers.items():
                signal.signal(sig, old)

        self.save(total)
        self.recorder.close()
        if self.timer_record_to_file:
            self.timer.dump(self.timer_record_to_file)
        return self.state

    def save(self, it: int, latest_only: bool = False):
        # the replicated state is the same on every rank: rank 0 saves it
        if not is_main_process():
            return
        os.makedirs(self.model_dir, exist_ok=True)
        cam_state = self.cam_state if self.cam_opt_cfg.enabled else None
        latest = os.path.join(self.model_dir, "latest.npz")
        if latest_only:
            ckpt.save_checkpoint(latest, self.state, it, cam_state=cam_state)
        else:  # compress once: the numbered file, then its copy
            numbered = os.path.join(self.model_dir, f"{it}.npz")
            ckpt.save_checkpoint(numbered, self.state, it,
                                 cam_state=cam_state)
            shutil.copyfile(numbered, latest)
        ckpt.export_ply(self.state.base,
                        os.path.join(self.model_dir, "base.ply"))
        ckpt.export_ply(self.state.env,
                        os.path.join(self.model_dir, "env.ply"))

    def render_view(self, cam: Camera, it: int | None = None,
                    exact_order: bool | None = None):
        """Render one view in render mode, without autograd. exact_order
        None follows the model config; True/False picks the tracer's blend
        order for this call (evaluation defaults to the exact per-ray
        order, see test())."""
        eo = (self.model_cfg.tracer_exact_order if exact_order is None
              else bool(exact_order))
        # the exact order is the tiled tracer's (the reference tracer is
        # exact anyway)
        eo = eo and self.model_cfg.tracer_backend == "tiled"
        cfg = self.model_cfg._replace(tracer_exact_order=eo, render_mode=True)
        with torch.no_grad():
            return forward_envgs(
                self.state.base, self.state.env, cam,
                self.sched.total_iters if it is None else it, cfg)

    def render_path(self, n_frames: int = 60, kind: str = "orbit",
                    tag: str = "path", types=("RENDER",), fps: int = 30,
                    path_dir: str | None = None) -> str:
        """Render a camera path through the scene -> the directory of its
        frames (`<result_dir>/<tag>/<TYPE>/frame0000_camera####.png`, and
        `<TYPE>.mp4` where ffmpeg is on the PATH).

        The keyframes are the training views' cameras, or with `path_dir`
        a saved camera path (intri.yml / extri.yml, read by
        utils/easycam.py; the first view's size and planes where it gives
        none), which is then interpolated as `cubic`. camera_path_interpolate
        makes n_frames cameras of `kind`; each is rendered by render_view
        (radial order unless the model config asks for the exact one)."""
        if path_dir is not None:
            from envgs_tpu_torch.utils.easycam import read_cameras

            tmpl = self.views[0]["camera"]
            cams = [make_camera(int(c.get("H", tmpl.H)),
                                int(c.get("W", tmpl.W)), c["K"], c["R"],
                                np.asarray(c["T"]).reshape(3), tmpl.znear,
                                tmpl.zfar, device=self.device)
                    for _, c in sorted(read_cameras(path_dir).items())]
            kind = "cubic"
        else:
            cams = [v["camera"] for v in self.views]
        path = camera_path_interpolate(cams, n_frames, kind=kind)
        result_dir = os.path.join(self.result_dir, tag)
        vis = Visualizer(result_dir, types=types, save_gt=False,
                         save_error=False)
        try:
            for i, cam in enumerate(path):
                vis.visualize(self.render_view(cam), None, 0, i)
        finally:
            vis.summarize()
        if shutil.which("ffmpeg"):
            for t in types:
                subprocess.run(
                    ["ffmpeg", "-y", "-loglevel", "error", "-framerate",
                     str(fps), "-pattern_type", "glob", "-i",
                     os.path.join(result_dir, t, "*.png"), "-pix_fmt",
                     "yuv420p", os.path.join(result_dir, f"{t}.mp4")],
                    check=False)
        return result_dir

    def extract_mesh(self, res: int = 256, acc_thresh: float = 0.5,
                     stride: int = 1, bounds=None, tag: str = "mesh.ply",
                     depth_max: float | None = None) -> str:
        """TSDF depth-fusion mesh export -> the ply's path
        (`<result_dir>/<tag>`).

        Renders every `stride`-th training view (render_view), keeps the
        depth of pixels whose accumulated alpha reaches `acc_thresh` (and
        whose depth is at most `depth_max`), fuses the depths into a res^3
        TSDF over `bounds` (default: the 1-99 percentile box of the active
        base surfels, padded by 5% of its longest side), extracts the zero
        level by marching tetrahedra over the observed cells and writes an
        ascii ply. Fusion and extraction run on the runner's device."""
        views = self.views[::max(1, stride)]
        depths = []
        for v in views:
            out = self.render_view(v["camera"])
            dpt, acc = out.dpt_map[..., 0], out.acc_map[..., 0]
            keep = acc >= acc_thresh
            if depth_max is not None:
                keep &= dpt <= depth_max
            depths.append(torch.where(keep, dpt, torch.zeros_like(dpt)))
        if bounds is None:
            base = self.state.base
            xyz = base.params.xyz[base.stats.active].detach().cpu().numpy()
            lo = np.percentile(xyz, 1.0, axis=0)
            hi = np.percentile(xyz, 99.0, axis=0)
            pad = 0.05 * float((hi - lo).max())
            bounds = (lo - pad, hi + pad)
        tsdf, w = fusion.tsdf_fuse(torch.stack(depths),
                                   [v["camera"] for v in views], bounds,
                                   res=res)
        verts, faces = fusion.marching_tetrahedra(tsdf, 0.0, bounds=bounds,
                                                  observed=w > 0)
        os.makedirs(self.result_dir, exist_ok=True)
        path = os.path.join(self.result_dir, tag)
        fusion.save_mesh_ply(path, verts, faces)
        print(f"[mesh] {len(verts)} verts / {len(faces)} faces -> {path}")
        return path

    def test(self, save_images: bool = True, tag: str | None = None,
             types=("RENDER", "DEPTH", "NORMAL", "SPECULAR", "DIFFUSE",
                    "REFLECTION"), exact_order: bool = True):
        """Evaluate the held-out views (the training views when there are
        none) -> the metrics.json dict.

        exact_order (default True): render with the tracer's exact per-ray
        blend order instead of the training path's per-tile radial order.
        The summary also carries `tracer_order` and `stage_ms`, the ms of
        each span of one radial-order render_view of the first view, keyed
        by span name ("render", "render.bin", "env.cull", ...; the
        spans of utils/timer.py, read by read_spans): device ms where
        CUDA events were recorded, else host ms.

        Under several processes each rank renders its stride of the views
        (rank i the views i, i + world, ...), ranks other than 0 write
        under `rank{i}/`, the means of psnr / ssim / lpips / time are
        merged over the ranks (weighted by their views' counts; the
        summary's `n_views_total`), and rank 0 alone rewrites its
        metrics.json with them, records and prints."""
        result_dir = (os.path.join(self.result_dir, tag) if tag
                      else self.result_dir)
        world = process_count()
        if world > 1 and not is_main_process():
            result_dir = os.path.join(result_dir, f"rank{process_index()}")
        ev = Evaluator(result_dir)
        vis = Visualizer(result_dir, types=types) if save_images else None
        views = self.eval_views or self.views
        first_cam = views[0]["camera"]
        views = shard_for_host(list(enumerate(views)))
        rgb = None
        try:
            for i, view in views:
                cam = view["camera"]
                _sync(self.device)
                t0 = time.time()
                out = self.render_view(cam, exact_order=exact_order)
                _sync(self.device)
                dt = time.time() - t0
                rgb = torch.clamp(out.rgb_map, 0, 1)
                ev.evaluate(rgb, view["rgb"], name=view.get("name", str(i)),
                            render_time=dt)
                if vis:
                    vis.visualize(out, view["rgb"], 0, i)
        finally:
            if vis:
                vis.summarize()
        # the stages of one radial-order render of the first view, from its
        # own spans: under a CPU-activity profiler unless one records
        # already (the train loop's window)
        prof = (contextlib.nullcontext() if torch.autograd._profiler_enabled()
                else torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CPU]))
        with prof:
            self.render_view(first_cam, exact_order=False)
        root = read_spans()[-1]
        stage_ms = root["device_ms"] or root["host_ms"]
        mc = self.model_cfg
        exact = (exact_order and mc.tracer_backend == "tiled"
                 or mc.tracer_backend == "ref")
        summary = ev.summarize(extra={
            "tracer_order": "exact" if exact else "radial",
            "stage_ms": stage_ms})
        if world > 1:
            # a fixed key list and per-key counts of finite values: every
            # rank sums a vector of one shape, an empty shard or NaN
            # metrics (lpips without weights) included
            keys = ("psnr_mean", "ssim_mean", "lpips_mean", "time_mean")
            n = len(views)
            vals, cnts = [], []
            for k in keys:
                v = summary["summary"].get(k, float("nan"))
                ok = n > 0 and np.isfinite(v)
                vals.append(float(v) * n if ok else 0.0)
                cnts.append(float(n) if ok else 0.0)
            tot = allsum_hosts(np.asarray([float(n)] + vals + cnts))
            m = len(keys)
            for j, k in enumerate(keys):
                if tot[1 + m + j] > 0:
                    summary["summary"][k] = float(tot[1 + j]
                                                  / tot[1 + m + j])
            summary["summary"]["n_views_total"] = int(tot[0])
            if not is_main_process():
                return summary
            with open(os.path.join(result_dir, "metrics.json"), "w") as f:
                json.dump(summary, f, indent=2)
        # VAL scalars and the last evaluated render
        self.recorder.record(
            "VAL", {k: v for k, v in summary["summary"].items()
                    if isinstance(v, (int, float)) and np.isfinite(v)},
            image_stats={"RENDER": rgb} if rgb is not None else None)
        print(json.dumps(summary["summary"], indent=2))
        return summary
