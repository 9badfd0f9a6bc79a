"""PLY IO: SfM point clouds and 3DGS-format Gaussian checkpoints (the
port's own copy of envgs_tpu/utils/ply.py; numpy only).

Self-contained binary/ascii PLY reader-writer (no plyfile dependency):
- SfM ply: x/y/z + red/green/blue uint8;
- Gaussian ply: x y z nx ny nz f_dc_* f_rest_* opacity scale_* rot_*
  (2-axis scales for 2DGS surfels), the layout of the JAX package and of
  other 3DGS tooling, so files cross between them.
"""
from __future__ import annotations

import os

import numpy as np

_PLY_DTYPES = {
    "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
    "uchar": "u1", "uint8": "u1", "char": "i1", "int8": "i1",
    "short": "i2", "ushort": "u2", "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
}
_INV_DTYPES = {"f4": "float", "f8": "double", "u1": "uchar", "i4": "int"}


def read_ply(path: str) -> dict[str, np.ndarray]:
    """Read the first 'vertex' element of a PLY file into a dict of arrays."""
    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError(f"{path} is not a PLY file")
        fmt = None
        props: list[tuple[str, str]] = []
        count = 0
        in_vertex = False
        while True:
            line = f.readline().strip().decode()
            if line.startswith("format"):
                fmt = line.split()[1]
            elif line.startswith("element"):
                _, name, n = line.split()
                in_vertex = name == "vertex"
                if in_vertex:
                    count = int(n)
            elif line.startswith("property") and in_vertex:
                _, typ, name = line.split()
                props.append((name, _PLY_DTYPES[typ]))
            elif line == "end_header":
                break
        if fmt == "ascii":
            data = np.loadtxt(f, max_rows=count)
            return {
                name: data[:, i].astype(dt)
                for i, (name, dt) in enumerate(props)
            }
        endian = "<" if fmt == "binary_little_endian" else ">"
        dtype = np.dtype([(n, endian + d) for n, d in props])
        raw = np.frombuffer(f.read(count * dtype.itemsize), dtype=dtype)
        return {n: np.ascontiguousarray(raw[n]) for n, _ in props}


def write_ply(path: str, arrays: dict[str, np.ndarray]):
    """Write named per-vertex arrays (all same length) as binary PLY."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    n = len(next(iter(arrays.values())))
    dtype = np.dtype(
        [(k, "<" + v.dtype.str[1:]) for k, v in arrays.items()]
    )
    rec = np.empty(n, dtype=dtype)
    for k, v in arrays.items():
        rec[k] = v
    with open(path, "wb") as f:
        f.write(b"ply\nformat binary_little_endian 1.0\n")
        f.write(f"element vertex {n}\n".encode())
        for k, v in arrays.items():
            f.write(f"property {_INV_DTYPES[v.dtype.str[1:]]} {k}\n".encode())
        f.write(b"end_header\n")
        f.write(rec.tobytes())


def load_sfm_ply(path: str):
    """-> (xyz (P,3) f32, rgb (P,3) f32 in [0,1])."""
    d = read_ply(path)
    xyz = np.stack([d["x"], d["y"], d["z"]], -1).astype(np.float32)
    if "red" in d:
        rgb = np.stack([d["red"], d["green"], d["blue"]], -1)
        rgb = rgb.astype(np.float32)
        if rgb.max() > 1.0 + 1e-6:
            rgb = rgb / 255.0
    else:
        rgb = np.full_like(xyz, 0.5)
    return xyz, rgb


def save_sfm_ply(path: str, xyz: np.ndarray, rgb: np.ndarray):
    """rgb may be [0,1] float or [0,255]."""
    rgb = np.asarray(rgb)
    if rgb.dtype != np.uint8:
        if rgb.max() <= 1.0 + 1e-6:
            rgb = rgb * 255.0
        rgb = rgb.astype(np.uint8)
    xyz = np.asarray(xyz, np.float32)
    write_ply(
        path,
        {
            "x": xyz[:, 0], "y": xyz[:, 1], "z": xyz[:, 2],
            "red": rgb[:, 0], "green": rgb[:, 1], "blue": rgb[:, 2],
        },
    )


def save_gaussian_ply(path: str, xyz, f_dc, f_rest, opacity, scaling, rotation):
    """3DGS-format export (raw/pre-activation values).

    f_dc: (P, 1, 3), f_rest: (P, K-1, 3) — written channel-major
    (f_dc_0..2 = rgb of coeff 0; f_rest flattened as (3, K-1)).
    """
    P = len(xyz)
    arrays: dict[str, np.ndarray] = {}
    xyz = np.asarray(xyz, np.float32)
    for i, k in enumerate("xyz"):
        arrays[k] = xyz[:, i]
    for k in ("nx", "ny", "nz"):
        arrays[k] = np.zeros(P, np.float32)
    dc = np.asarray(f_dc, np.float32).transpose(0, 2, 1).reshape(P, -1)
    for i in range(dc.shape[1]):
        arrays[f"f_dc_{i}"] = dc[:, i]
    rest = np.asarray(f_rest, np.float32).transpose(0, 2, 1).reshape(P, -1)
    for i in range(rest.shape[1]):
        arrays[f"f_rest_{i}"] = rest[:, i]
    arrays["opacity"] = np.asarray(opacity, np.float32).reshape(P)
    scaling = np.asarray(scaling, np.float32)
    for i in range(scaling.shape[1]):
        arrays[f"scale_{i}"] = scaling[:, i]
    rotation = np.asarray(rotation, np.float32)
    for i in range(rotation.shape[1]):
        arrays[f"rot_{i}"] = rotation[:, i]
    write_ply(path, arrays)


def load_gaussian_ply(path: str):
    """-> dict(xyz, f_dc (P,1,3), f_rest (P,K-1,3), opacity, scaling, rotation)."""
    d = read_ply(path)
    P = len(d["x"])
    xyz = np.stack([d["x"], d["y"], d["z"]], -1).astype(np.float32)
    n_dc = sum(1 for k in d if k.startswith("f_dc_"))
    dc = np.stack([d[f"f_dc_{i}"] for i in range(n_dc)], -1).astype(np.float32)
    f_dc = dc.reshape(P, 3, n_dc // 3).transpose(0, 2, 1)
    n_rest = sum(1 for k in d if k.startswith("f_rest_"))
    if n_rest:
        rest = np.stack([d[f"f_rest_{i}"] for i in range(n_rest)], -1).astype(np.float32)
        f_rest = rest.reshape(P, 3, n_rest // 3).transpose(0, 2, 1)
    else:
        f_rest = np.zeros((P, 0, 3), np.float32)
    n_scale = sum(1 for k in d if k.startswith("scale_"))
    scaling = np.stack([d[f"scale_{i}"] for i in range(n_scale)], -1).astype(np.float32)
    n_rot = sum(1 for k in d if k.startswith("rot_"))
    rotation = np.stack([d[f"rot_{i}"] for i in range(n_rot)], -1).astype(np.float32)
    return dict(
        xyz=xyz,
        f_dc=f_dc,
        f_rest=f_rest,
        opacity=d["opacity"].astype(np.float32).reshape(P, 1),
        scaling=scaling,
        rotation=rotation,
    )
