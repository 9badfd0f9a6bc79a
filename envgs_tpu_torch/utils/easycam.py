"""easymocap-format camera IO: intri.yml / extri.yml (OpenCV FileStorage),
the port's own copy of envgs_tpu/utils/easycam.py (numpy only).

Per camera: K and dist in intri.yml, Rot (or a Rodrigues R) and T in
extri.yml, with a names list; read and written by a small self-contained
OpenCV-YAML parser and writer (no cv2). `Runner.render_path(path_dir=...)`
reads a saved camera path in this format.
"""
from __future__ import annotations

import os
import re

import numpy as np


def _parse_opencv_yaml(text: str) -> dict:
    """Minimal parser for the subset of OpenCV YAML that camera files use."""
    text = re.sub(r"^%YAML.*\n", "", text)
    text = re.sub(r"^---\n", "", text, flags=re.M)
    import yaml

    # opencv-matrix nodes use a custom tag; strip tags
    text = text.replace("!!opencv-matrix", "")
    data = yaml.safe_load(text)
    out = {}
    for k, v in (data or {}).items():
        if isinstance(v, dict) and {"rows", "cols", "data"} <= set(v):
            out[k] = np.asarray(v["data"], np.float64).reshape(
                int(v["rows"]), int(v["cols"])
            )
        else:
            out[k] = v
    return out


def _dump_opencv_yaml(data: dict) -> str:
    lines = ["%YAML:1.0", "---"]
    for k, v in data.items():
        if isinstance(v, np.ndarray):
            lines.append(f"{k}: !!opencv-matrix")
            lines.append(f"   rows: {v.shape[0]}")
            lines.append(f"   cols: {v.shape[1] if v.ndim > 1 else 1}")
            lines.append("   dt: d")
            flat = ", ".join(f"{x:.12e}" for x in np.asarray(v, np.float64).ravel())
            lines.append(f"   data: [ {flat} ]")
        elif isinstance(v, list):
            lines.append(f"{k}:")
            for item in v:
                lines.append(f'   - "{item}"')
        else:
            lines.append(f"{k}: {v}")
    return "\n".join(lines) + "\n"


def read_cameras(data_root: str) -> dict[str, dict]:
    """Read {intri,extri}.yml -> {name: {K, D, R, T, ...}}.

    R is the 3x3 world->cam rotation (from 'Rot_'/'R_' Rodrigues fallback),
    T the 3x1 translation, matching the reference camera convention.
    """
    intri = _parse_opencv_yaml(open(os.path.join(data_root, "intri.yml")).read())
    extri = _parse_opencv_yaml(open(os.path.join(data_root, "extri.yml")).read())
    names = intri.get("names", extri.get("names"))
    if names is None:
        names = sorted(
            k.split("_", 1)[1] for k in intri if k.startswith("K_")
        )
    cams = {}
    for name in names:
        cam: dict = {}
        cam["K"] = intri[f"K_{name}"].reshape(3, 3)
        cam["D"] = intri.get(f"dist_{name}", np.zeros((5, 1))).reshape(-1, 1)
        if f"Rot_{name}" in extri:
            cam["R"] = extri[f"Rot_{name}"].reshape(3, 3)
        elif f"R_{name}" in extri:
            rvec = extri[f"R_{name}"].reshape(3)
            cam["R"] = rodrigues(rvec)
        cam["T"] = extri[f"T_{name}"].reshape(3, 1)
        if f"H_{name}" in intri:
            cam["H"] = int(np.asarray(intri[f"H_{name}"]).item())
            cam["W"] = int(np.asarray(intri[f"W_{name}"]).item())
        if f"n_{name}" in extri:
            cam["n"] = float(np.asarray(extri[f"n_{name}"]).item())
        if f"f_{name}" in extri:
            cam["f"] = float(np.asarray(extri[f"f_{name}"]).item())
        if f"bounds_{name}" in extri:
            cam["bounds"] = extri[f"bounds_{name}"].reshape(2, 3)
        if f"t_{name}" in extri:  # dnerf-style per-view timestamp
            cam["t"] = float(np.asarray(extri[f"t_{name}"]).item())
        cams[name] = cam
    return cams


def write_cameras(cams: dict[str, dict], data_root: str):
    os.makedirs(data_root, exist_ok=True)
    names = list(cams.keys())
    intri: dict = {"names": names}
    extri: dict = {"names": names}
    for name, cam in cams.items():
        intri[f"K_{name}"] = np.asarray(cam["K"]).reshape(3, 3)
        intri[f"dist_{name}"] = np.asarray(cam.get("D", np.zeros((5, 1)))).reshape(-1, 1)
        if "H" in cam:
            intri[f"H_{name}"] = int(cam["H"])
            intri[f"W_{name}"] = int(cam["W"])
        R = np.asarray(cam["R"]).reshape(3, 3)
        extri[f"R_{name}"] = rodrigues_inv(R).reshape(3, 1)
        extri[f"Rot_{name}"] = R
        extri[f"T_{name}"] = np.asarray(cam["T"]).reshape(3, 1)
        if "t" in cam:  # dnerf-style per-view timestamp
            extri[f"t_{name}"] = float(cam["t"])
        if "n" in cam:  # per-view near/far (llff/mipnerf360 bounds)
            extri[f"n_{name}"] = float(cam["n"])
        if "f" in cam:
            extri[f"f_{name}"] = float(cam["f"])
    with open(os.path.join(data_root, "intri.yml"), "w") as f:
        f.write(_dump_opencv_yaml(intri))
    with open(os.path.join(data_root, "extri.yml"), "w") as f:
        f.write(_dump_opencv_yaml(extri))


def rodrigues(rvec: np.ndarray) -> np.ndarray:
    """Rodrigues vector -> rotation matrix."""
    theta = np.linalg.norm(rvec)
    if theta < 1e-12:
        return np.eye(3)
    k = rvec / theta
    K = np.array(
        [[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]]
    )
    return np.eye(3) + np.sin(theta) * K + (1 - np.cos(theta)) * (K @ K)


def rodrigues_inv(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> Rodrigues vector."""
    cos_t = np.clip((np.trace(R) - 1) / 2, -1.0, 1.0)
    theta = np.arccos(cos_t)
    if theta < 1e-12:
        return np.zeros(3)
    if np.pi - theta < 1e-6:
        # near 180deg: extract axis from R + I
        M = (R + np.eye(3)) / 2
        axis = np.sqrt(np.clip(np.diag(M), 0, None))
        # fix signs from off-diagonals
        if axis[0] > 0:
            axis[1] = np.sign(M[0, 1]) * abs(axis[1])
            axis[2] = np.sign(M[0, 2]) * abs(axis[2])
        return axis / (np.linalg.norm(axis) + 1e-12) * theta
    v = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    return v / (2 * np.sin(theta)) * theta
