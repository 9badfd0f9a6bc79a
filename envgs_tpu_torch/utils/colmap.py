"""COLMAP sparse-model readers (host-side numpy), the port's own copy of
envgs_tpu/utils/colmap.py: cameras / images / points3D in binary and text
form, plus binary writers for the three files (a capture written by a test
or a smoke run). Implemented from the COLMAP file-format spec.
"""
from __future__ import annotations

import os
import struct
from typing import NamedTuple

import numpy as np


class ColmapCamera(NamedTuple):
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray


class ColmapImage(NamedTuple):
    id: int
    qvec: np.ndarray  # (4,) wxyz world->cam rotation
    tvec: np.ndarray  # (3,)
    camera_id: int
    name: str
    xys: np.ndarray  # (N, 2)
    point3D_ids: np.ndarray  # (N,)


CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}
MODEL_IDS = {name: (mid, n) for mid, (name, n) in CAMERA_MODELS.items()}


def qvec_to_rotmat(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q / np.linalg.norm(q)
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def _read(f, n, fmt):
    return struct.unpack("<" + fmt, f.read(n))


def read_cameras_binary(path: str) -> dict[int, ColmapCamera]:
    out = {}
    with open(path, "rb") as f:
        (n,) = _read(f, 8, "Q")
        for _ in range(n):
            cid, mid, w, h = _read(f, 24, "iiQQ")
            name, np_ = CAMERA_MODELS[mid]
            params = np.array(_read(f, 8 * np_, "d" * np_))
            out[cid] = ColmapCamera(cid, name, w, h, params)
    return out


def read_images_binary(path: str) -> dict[int, ColmapImage]:
    out = {}
    with open(path, "rb") as f:
        (n,) = _read(f, 8, "Q")
        for _ in range(n):
            iid = _read(f, 4, "i")[0]
            q = np.array(_read(f, 32, "dddd"))
            t = np.array(_read(f, 24, "ddd"))
            cam_id = _read(f, 4, "i")[0]
            name = b""
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                name += c
            (npts,) = _read(f, 8, "Q")
            rec = np.frombuffer(
                f.read(24 * npts),
                dtype=np.dtype([("x", "<f8"), ("y", "<f8"), ("id", "<i8")]),
            )
            xys = np.stack([rec["x"], rec["y"]], -1) if npts else np.zeros((0, 2))
            ids = rec["id"].copy() if npts else np.zeros(0, np.int64)
            out[iid] = ColmapImage(iid, q, t, cam_id, name.decode(), xys, ids)
    return out


def read_points3D_binary(path: str):
    """-> (xyz (P,3) f64, rgb (P,3) u8, err (P,))."""
    xyzs, rgbs, errs = [], [], []
    with open(path, "rb") as f:
        (n,) = _read(f, 8, "Q")
        for _ in range(n):
            _pid = _read(f, 8, "Q")[0]
            xyz = _read(f, 24, "ddd")
            rgb = _read(f, 3, "BBB")
            err = _read(f, 8, "d")[0]
            (track_len,) = _read(f, 8, "Q")
            f.seek(8 * track_len, 1)
            xyzs.append(xyz)
            rgbs.append(rgb)
            errs.append(err)
    return (
        np.asarray(xyzs, np.float64),
        np.asarray(rgbs, np.uint8),
        np.asarray(errs, np.float64),
    )


def read_points3D_text(path: str):
    xyzs, rgbs, errs = [], [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            el = line.split()
            xyzs.append([float(x) for x in el[1:4]])
            rgbs.append([int(x) for x in el[4:7]])
            errs.append(float(el[7]))
    return (
        np.asarray(xyzs, np.float64),
        np.asarray(rgbs, np.uint8),
        np.asarray(errs, np.float64),
    )


def read_cameras_text(path: str) -> dict[int, ColmapCamera]:
    out = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            el = line.split()
            out[int(el[0])] = ColmapCamera(
                int(el[0]), el[1], int(el[2]), int(el[3]),
                np.array([float(x) for x in el[4:]]),
            )
    return out


def read_images_text(path: str) -> dict[int, ColmapImage]:
    out = {}
    with open(path) as f:
        # keep EMPTY lines: every image record is exactly two lines and the
        # points2D line is legally empty for images with no observations
        lines = [l.strip() for l in f if not l.strip().startswith("#")]
    # drop stray leading/trailing blanks so records stay two-aligned
    while lines and not lines[0]:
        lines.pop(0)
    while len(lines) % 2 and not lines[-1]:
        lines.pop()
    for i in range(0, len(lines) - len(lines) % 2, 2):
        el = lines[i].split()
        iid = int(el[0])
        q = np.array([float(x) for x in el[1:5]])
        t = np.array([float(x) for x in el[5:8]])
        cam_id = int(el[8])
        name = el[9]
        pts = lines[i + 1].split() if i + 1 < len(lines) else []
        xys = np.array(
            [[float(pts[j]), float(pts[j + 1])] for j in range(0, len(pts), 3)]
        ) if pts else np.zeros((0, 2))
        ids = np.array(
            [int(pts[j + 2]) for j in range(0, len(pts), 3)], np.int64
        ) if pts else np.zeros(0, np.int64)
        out[iid] = ColmapImage(iid, q, t, cam_id, name, xys, ids)
    return out


def camera_K(cam: ColmapCamera) -> np.ndarray:
    p = cam.params
    if cam.model == "SIMPLE_PINHOLE" or cam.model.startswith("SIMPLE_RADIAL"):
        f, cx, cy = p[0], p[1], p[2]
        fx = fy = f
    elif cam.model in ("PINHOLE", "OPENCV", "OPENCV_FISHEYE", "FULL_OPENCV"):
        fx, fy, cx, cy = p[0], p[1], p[2], p[3]
    elif cam.model == "RADIAL":
        fx = fy = p[0]
        cx, cy = p[1], p[2]
    else:
        raise ValueError(f"unsupported COLMAP camera model {cam.model}")
    return np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float64)


def camera_dist(cam: ColmapCamera) -> np.ndarray:
    """OpenCV-style (k1, k2, p1, p2, k3) distortion vector."""
    p = cam.params
    D = np.zeros(5)
    if cam.model == "SIMPLE_RADIAL":
        D[0] = p[3]
    elif cam.model == "RADIAL":
        D[0], D[1] = p[3], p[4]
    elif cam.model == "OPENCV":
        D[:4] = p[4:8]
    return D


def load_colmap_model(sparse_dir: str):
    """Read a COLMAP sparse model dir (binary preferred, text fallback).

    Returns (cameras, images, (xyz, rgb, err)).
    """
    def pick(name):
        b = os.path.join(sparse_dir, name + ".bin")
        t = os.path.join(sparse_dir, name + ".txt")
        return (b, True) if os.path.exists(b) else (t, False)

    cpath, cbin = pick("cameras")
    ipath, ibin = pick("images")
    ppath, pbin = pick("points3D")
    cams = read_cameras_binary(cpath) if cbin else read_cameras_text(cpath)
    ims = read_images_binary(ipath) if ibin else read_images_text(ipath)
    pts = read_points3D_binary(ppath) if pbin else read_points3D_text(ppath)
    return cams, ims, pts


def write_cameras_binary(path: str, cams: dict[int, ColmapCamera]):
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(cams)))
        for c in cams.values():
            mid, n = MODEL_IDS[c.model]
            f.write(struct.pack("<iiQQ", c.id, mid, c.width, c.height))
            f.write(struct.pack("<" + "d" * n, *np.asarray(c.params)[:n]))


def write_images_binary(path: str, ims: dict[int, ColmapImage]):
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(ims)))
        for im in ims.values():
            f.write(struct.pack("<i", im.id))
            f.write(struct.pack("<dddd", *np.asarray(im.qvec, np.float64)))
            f.write(struct.pack("<ddd", *np.asarray(im.tvec, np.float64)))
            f.write(struct.pack("<i", im.camera_id))
            f.write(im.name.encode() + b"\x00")
            rec = np.zeros(len(im.point3D_ids), dtype=np.dtype(
                [("x", "<f8"), ("y", "<f8"), ("id", "<i8")]))
            if len(rec):
                rec["x"], rec["y"] = im.xys[:, 0], im.xys[:, 1]
                rec["id"] = im.point3D_ids
            f.write(struct.pack("<Q", len(rec)))
            f.write(rec.tobytes())


def write_points3D_binary(path: str, xyz: np.ndarray, rgb: np.ndarray,
                          err: np.ndarray | None = None):
    """xyz (P, 3), rgb (P, 3) uint8, err (P,); empty tracks, ids from 1."""
    n = len(xyz)
    err = np.zeros(n) if err is None else err
    rec = np.zeros(n, dtype=np.dtype(
        [("id", "<u8"), ("xyz", "<f8", 3), ("rgb", "u1", 3), ("err", "<f8"),
         ("track", "<u8")]))
    rec["id"] = np.arange(1, n + 1)
    rec["xyz"], rec["rgb"], rec["err"] = xyz, rgb, err
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", n))
        f.write(rec.tobytes())


def rotmat_to_qvec(R: np.ndarray) -> np.ndarray:
    """3x3 rotation -> unit quaternion (w, x, y, z) with w >= 0."""
    R = np.asarray(R, np.float64)
    K = np.array([
        [R[0, 0] - R[1, 1] - R[2, 2], 0, 0, 0],
        [R[1, 0] + R[0, 1], R[1, 1] - R[0, 0] - R[2, 2], 0, 0],
        [R[2, 0] + R[0, 2], R[2, 1] + R[1, 2], R[2, 2] - R[0, 0] - R[1, 1],
         0],
        [R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1],
         R[0, 0] + R[1, 1] + R[2, 2]]]) / 3.0
    w, v = np.linalg.eigh(K)
    q = v[[3, 0, 1, 2], np.argmax(w)]
    return -q if q[0] < 0 else q
