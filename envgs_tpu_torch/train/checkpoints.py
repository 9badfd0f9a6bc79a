"""Checkpoint IO: npz train state and 3DGS ply export/import (port of
envgs_tpu/train/checkpoints.py).

The files are the JAX package's: `data/trained_model/<exp>/{N.npz,
latest.npz}` hold both pools compacted to their active slots (re-padded on
load, so capacities may change between runs), the Adam moments and steps,
the iteration and, with camera optimisation, the camera residuals, under
the same array names; the ply is the 3DGS layout of utils/ply.py. A file
written by either package loads in the other. The one field that cannot
cross is the random state: the JAX package stores its PRNG key under
"key", the port its generator's state under "gen_state" (with "gen_seed"
and "gen_device": a state resumes only on the device type that wrote it,
elsewhere the stream starts over from the seed) and, under "key", the
seed as two uint32 words (so the JAX loader finds the array it expects);
loading a file without "gen_state" seeds the generator from "key".
"""
from __future__ import annotations

import os
import re

import numpy as np
import torch

from envgs_tpu_torch.models.camera_opt import CameraResiduals
from envgs_tpu_torch.models.gaussians import (
    GaussianParams,
    GaussianPool,
    GaussianStats,
    create_pool,
    pool_from_numpy,
    pool_to_numpy,
)
from envgs_tpu_torch.train.optimizer import AdamState
from envgs_tpu_torch.train.trainer import (
    CamOptState,
    TrainState,
    generator_from_numpy,
    generator_to_numpy,
    pool_state_from_numpy,
    pool_state_to_numpy,
)
from envgs_tpu_torch.utils.ply import load_gaussian_ply, save_gaussian_ply


# the camera optimizer's step under the JAX package's flattened tree name
_CAM_STEP = "/".join(("cam", "opt", "step"))


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy()


def save_checkpoint(path: str, state: TrainState, it: int, keep: int = 3,
                    cam_state: CamOptState | None = None):
    """Save the compacted train state; rotate old numbered files (the last
    `keep` stay)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    arrays = {"iter": np.asarray(it)}
    if cam_state is not None:
        for grp, tree in (("res", cam_state.res), ("opt/mu", cam_state.opt.mu),
                          ("opt/nu", cam_state.opt.nu)):
            for name, arr in tree._asdict().items():
                arrays[f"cam/{grp}/{name}"] = _np(arr)
        arrays[_CAM_STEP] = _np(cam_state.opt.step)
    for tag, pool, opt in (("base", state.base, state.opt_base),
                           ("env", state.env, state.opt_env)):
        d = pool_state_to_numpy(pool, opt)
        idx = np.nonzero(d["stats"]["active"])[0]
        for grp, short in (("params", "p"), ("mu", "mu"), ("nu", "nu")):
            for name, arr in d[grp].items():
                arrays[f"{tag}/{short}/{name}"] = arr[idx]
        for name, arr in d["stats"].items():
            arrays[f"{tag}/s/{name}"] = arr[idx] if arr.ndim else arr
        arrays[f"{tag}/opt_step"] = np.asarray(d["step"], np.int32)
        arrays[f"{tag}/max_sh_degree"] = np.asarray(d["max_sh_degree"])
    seed = state.gen.initial_seed() if state.gen is not None else 0
    arrays["key"] = np.asarray([(seed >> 32) & 0xFFFFFFFF,
                                seed & 0xFFFFFFFF], np.uint32)
    if state.gen is not None:
        arrays.update(generator_to_numpy(state.gen))
    np.savez_compressed(path, **arrays)

    d = os.path.dirname(os.path.abspath(path))
    numbered = sorted(
        (f for f in os.listdir(d) if re.fullmatch(r"\d+\.npz", f)),
        key=lambda f: int(f.split(".")[0]))
    for f in numbered[:-keep] if keep > 0 else []:
        os.remove(os.path.join(d, f))


def _pad(arr: np.ndarray, cap: int) -> np.ndarray:
    pad = [(0, cap - arr.shape[0])] + [(0, 0)] * (arr.ndim - 1)
    return np.pad(arr, pad)


def load_checkpoint(path: str, base_cap: int, env_cap: int,
                    n_views: int | None = None, device="cuda"):
    """Load into pools of the given capacities (>= the saved active counts)
    on `device`.

    Returns (state, iter) or, when `n_views` is given, (state, iter,
    cam_state or None): the camera state is restored only if it was saved
    with a matching view count."""
    with np.load(path) as z:
        z = {k: z[k] for k in z.files}

    def load_pool(tag, cap):
        n = z[f"{tag}/p/xyz"].shape[0]
        if n > cap:
            raise ValueError(f"checkpoint has {n} splats > capacity {cap}")
        extra = [k for k in z if k.startswith(f"{tag}/p/")
                 and k.split("/")[-1] not in GaussianParams._fields]
        if extra:
            raise NotImplementedError(
                f"{path}: parameters the port does not carry: {extra}")
        group = lambda short: {  # noqa: E731  temporal fields when saved
            k: _pad(z[f"{tag}/{short}/{k}"], cap)
            for k in GaussianParams._fields if f"{tag}/{short}/{k}" in z}
        stats = {k: (z[f"{tag}/s/{k}"] if z[f"{tag}/s/{k}"].ndim == 0
                     else _pad(z[f"{tag}/s/{k}"], cap))
                 for k in GaussianStats._fields}
        return pool_state_from_numpy(
            dict(params=group("p"), stats=stats, mu=group("mu"),
                 nu=group("nu"), step=int(z[f"{tag}/opt_step"]),
                 max_sh_degree=int(z[f"{tag}/max_sh_degree"])), device)

    base, opt_base = load_pool("base", base_cap)
    env, opt_env = load_pool("env", env_cap)
    if "gen_state" in z:
        gen = generator_from_numpy(z, base.params.xyz.device)
    else:
        key = np.asarray(z["key"], np.uint64).ravel()
        gen = torch.Generator(device=base.params.xyz.device)
        gen.manual_seed(int((key[0] << np.uint64(32)) | key[-1]))
    state = TrainState(base, env, opt_base, opt_env, gen)
    if n_views is None:
        return state, int(z["iter"])
    cam_state = None
    if "cam/res/se3" in z and z["cam/res/se3"].shape[0] == n_views:
        t = lambda k: torch.tensor(z[k], device=device)  # noqa: E731
        tree = lambda g: CameraResiduals(t(f"cam/{g}/se3"),  # noqa: E731
                                         t(f"cam/{g}/intr"))
        cam_state = CamOptState(tree("res"), AdamState(
            tree("opt/mu"), tree("opt/nu"),
            t(_CAM_STEP).to(torch.int32)))
    return state, int(z["iter"]), cam_state


def find_latest(model_dir: str) -> str | None:
    """latest.npz, else the highest-numbered N.npz, else None."""
    latest = os.path.join(model_dir, "latest.npz")
    if os.path.exists(latest):
        return latest
    if not os.path.isdir(model_dir):
        return None
    numbered = sorted(
        (f for f in os.listdir(model_dir) if re.fullmatch(r"\d+\.npz", f)),
        key=lambda f: int(f.split(".")[0]))
    return os.path.join(model_dir, numbered[-1]) if numbered else None


def export_ply(pool: GaussianPool, path: str):
    """3DGS-format ply of the active splats (raw parameter values)."""
    p, s = pool_to_numpy(pool)
    idx = np.nonzero(s["active"])[0]
    save_gaussian_ply(path, p["xyz"][idx], p["features_dc"][idx],
                      p["features_rest"][idx], p["opacity"][idx],
                      p["scaling"][idx], p["rotation"][idx])


def import_ply(path: str, cap: int, sh_degree: int = 3,
               specular_channels: int = 1, device="cuda") -> GaussianPool:
    """Load a 3DGS-format ply into a fresh padded pool on `device`: the
    ply's fields, `create_pool`'s defaults for the rest (specular,
    roughness), SH degree fully active."""
    d = load_gaussian_ply(path)
    P = d["xyz"].shape[0]
    pool = create_pool(d["xyz"], None, cap=cap, sh_degree=sh_degree,
                       specular_channels=specular_channels,
                       scale_axes=d["scaling"].shape[1], device=device)
    t = lambda a: torch.tensor(_pad(a, cap), device=device)  # noqa: E731
    params = pool.params._replace(
        xyz=t(d["xyz"]), features_dc=t(d["f_dc"]),
        features_rest=t(d["f_rest"]), opacity=t(d["opacity"]),
        scaling=t(d["scaling"]), rotation=t(d["rotation"]))
    stats = pool.stats._replace(
        active=torch.arange(cap, device=device) < P,
        sh_degree=torch.tensor(sh_degree, dtype=torch.int32, device=device))
    return pool._replace(params=params, stats=stats)
