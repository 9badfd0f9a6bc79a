"""TSDF depth fusion, mesh extraction and space carving (port of
envgs_tpu/utils/fusion.py), in PyTorch on the tensors' device.

- `tsdf_fuse`: the weighted running average of truncated signed distances
  of rendered depth maps over a voxel grid, one gather per view; voxels far
  behind a surface vote "inside".
- `marching_tetrahedra`: the isosurface of a scalar grid, each cube cut
  into 6 tetrahedra (a 16-case table, at most 2 triangles a tetrahedron),
  vertices linearly interpolated on the grid edges. The triangles come in
  the JAX package's order (tetrahedron, then triangle slot, then cell in
  row-major order: `torch.nonzero` is row-major like `np.nonzero`), each
  with its own three vertices, and the interpolation is float64 as the JAX
  package's host numpy computes it.
- `save_mesh_ply` / `load_mesh_ply`: the ascii triangle-mesh ply both
  packages write and read.
- `visual_hull`: the voxels whose projection lands in the foreground of
  every view that sees them (or of `min_votes` views).
"""
from __future__ import annotations

import numpy as np
import torch


def _grid_points(bounds, res: int, device) -> torch.Tensor:
    """(res^3, 3) voxel centres over the AABB `bounds`, x slowest."""
    lo = torch.as_tensor(np.asarray(bounds[0], np.float32), device=device)
    hi = torch.as_tensor(np.asarray(bounds[1], np.float32), device=device)
    g = (torch.arange(res, dtype=torch.float32, device=device) + 0.5) / res
    X, Y, Z = torch.meshgrid(g, g, g, indexing="ij")
    return (lo + torch.stack([X, Y, Z], -1) * (hi - lo)).reshape(-1, 3)


def _project(pts: torch.Tensor, cam):
    """-> (z, x, y, xi, yi): view depth, pixel coordinates and the nearest
    pixel (clamped into the image) of world points in camera `cam`. The
    rotation is applied as separate products and sums, not a matmul, so
    that every device rounds it alike and picks the same nearest pixel (a
    coordinate at a half pixel would otherwise round either way)."""
    R, T = cam.R, cam.T
    p = (pts[:, 0:1] * R[:, 0] + pts[:, 1:2] * R[:, 1]
         + pts[:, 2:3] * R[:, 2] + T)
    z = p[:, 2]
    zc = torch.clamp(z, min=1e-6)
    x = p[:, 0] / zc * cam.K[0, 0] + cam.K[0, 2]
    y = p[:, 1] / zc * cam.K[1, 1] + cam.K[1, 2]
    xi = torch.clamp(torch.round(x).to(torch.int64), 0, cam.W - 1)
    yi = torch.clamp(torch.round(y).to(torch.int64), 0, cam.H - 1)
    return z, x, y, xi, yi


def tsdf_fuse(depths: torch.Tensor, cams: list, bounds: tuple, res: int = 64,
              trunc: float | None = None):
    """Fuse (V, H, W) z-depth maps (0 = no measurement) seen by V cameras
    -> (tsdf (res, res, res), weights) over the world AABB `bounds`. tsdf
    in [-1, 1] in units of `trunc` (default 3 voxels of the longest side):
    +1 empty or never seen, -1 inside (voted by voxels behind the band)."""
    dev = depths.device
    if trunc is None:
        side = torch.as_tensor(np.asarray(bounds[1], np.float32)
                               - np.asarray(bounds[0], np.float32))
        trunc = float(3.0 * torch.max(side) / res)
    pts = _grid_points(bounds, res, dev)
    tsdf = torch.zeros(pts.shape[0], device=dev)
    wsum = torch.zeros(pts.shape[0], device=dev)
    behind = torch.zeros(pts.shape[0], device=dev)
    for v, cam in enumerate(cams):
        z, x, y, xi, yi = _project(pts, cam)
        d = depths[v][yi, xi]
        valid = ((z > 1e-3) & (d > 1e-6) & (x >= 0) & (x <= cam.W - 1)
                 & (y >= 0) & (y <= cam.H - 1))
        sdf = torch.clamp((d - z) / trunc, -1.0, 1.0)
        # voxels far behind the surface carry no distance, but they vote
        # "inside": without the vote the deep interior reads empty and a
        # false crossing appears at the truncation boundary
        in_band = valid & (sdf > -1.0 + 1e-6)
        behind = behind + (valid & ~in_band).to(torch.float32)
        w = in_band.to(torch.float32)
        tsdf = tsdf + w * sdf
        wsum = wsum + w
    one = torch.ones_like(tsdf)
    tsdf = torch.where(wsum > 0, tsdf / torch.clamp(wsum, min=1.0),
                       torch.where(behind > 0, -one, one))
    return tsdf.reshape(res, res, res), wsum.reshape(res, res, res)


# 6 tetrahedra per cube (corner indices into the cube's 8 corners)
_TETS = np.array([
    [0, 5, 1, 6], [0, 1, 2, 6], [0, 2, 3, 6],
    [0, 3, 7, 6], [0, 7, 4, 6], [0, 4, 5, 6],
], np.int64)
_CORNER = np.array([
    [0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
    [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1],
], np.int64)


def _tet_cases():
    """case (16) -> (2 triangles, 3 edges, 2 endpoints), -1 padded."""
    out = -np.ones((16, 2, 3, 2), np.int64)
    for case in range(1, 15):
        inside = [i for i in range(4) if case & (1 << i)]
        flip = len(inside) > 2
        if flip:
            inside = [i for i in range(4) if not case & (1 << i)]
        if len(inside) == 1:
            a = inside[0]
            others = [i for i in range(4) if i != a]
            tri = [(a, others[0]), (a, others[1]), (a, others[2])]
            out[case, 0] = tri if not flip else tri[::-1]
        elif len(inside) == 2:
            a, b = inside
            c, d = [i for i in range(4) if i not in inside]
            q = [(a, c), (a, d), (b, d), (b, c)]
            if flip:
                q = q[::-1]
            out[case, 0] = [q[0], q[1], q[2]]
            out[case, 1] = [q[0], q[2], q[3]]
    return out


_CASES = _tet_cases()


def marching_tetrahedra(grid, level: float = 0.0, bounds: tuple | None = None,
                        observed=None):
    """The `level` isosurface of a (r, r, r) scalar grid (a tensor, or an
    array put on the CPU) -> (verts (N, 3) float32, faces (N / 3, 3) int32)
    on the grid's device. With `bounds` the vertices are mapped into that
    AABB (voxel centres, as tsdf_fuse places them). `observed` (r, r, r)
    bool (e.g. fusion weights > 0) keeps the cells whose eight corners are
    all measured: the band about a real surface is several voxels wide on
    both sides, while cells at the edge of never-seen space would give
    walls."""
    g = torch.as_tensor(grid, dtype=torch.float32) - level
    dev = g.device
    r = g.shape[0]
    n = r - 1
    cell = torch.arange(n ** 3, device=dev)
    xyz = torch.stack([cell // (n * n), (cell // n) % n, cell % n], -1)
    corner = torch.as_tensor(_CORNER, device=dev)
    base = (xyz[:, 0] * r + xyz[:, 1]) * r + xyz[:, 2]
    off = (corner[:, 0] * r + corner[:, 1]) * r + corner[:, 2]
    if observed is not None:
        obs = torch.as_tensor(observed, device=dev).reshape(-1).to(torch.bool)
        keep = torch.nonzero(obs[base[:, None] + off].all(-1))[:, 0]
        xyz, base = xyz[keep], base[keep]
    vals = g.reshape(-1)[base[:, None] + off]  # (C, 8)
    cases = torch.as_tensor(_CASES, device=dev)
    bits = torch.tensor([1, 2, 4, 8], device=dev)
    verts = []
    for tet in torch.as_tensor(_TETS, device=dev):
        tv = vals[:, tet]  # (C, 4)
        case = ((tv < 0).to(torch.int64) * bits).sum(-1)
        for tri_i in range(2):
            e = cases[case, tri_i]  # (C, 3 edges, 2 ends)
            use = torch.nonzero(e[:, 0, 0] >= 0)[:, 0]
            if use.numel() == 0:
                continue
            e, tvu = e[use], tv[use]
            tc = xyz[use][:, None, :] + corner[tet][None]  # (c, 4, 3)
            va = torch.gather(tvu, 1, e[..., 0])
            vb = torch.gather(tvu, 1, e[..., 1])
            den = va - vb
            t = torch.clamp(va / torch.where(den == 0, torch.ones_like(den),
                                             den), 0.0, 1.0)[..., None]
            pa = torch.gather(tc, 1, e[..., 0, None].expand(-1, -1, 3))
            pb = torch.gather(tc, 1, e[..., 1, None].expand(-1, -1, 3))
            p = (pa.double() * (1 - t).double()
                 + pb.double() * t.double())  # (c, 3, 3)
            verts.append(p.reshape(-1, 3))
    if not verts:
        return (torch.zeros((0, 3), device=dev),
                torch.zeros((0, 3), dtype=torch.int32, device=dev))
    V = torch.cat(verts).to(torch.float32)
    F = torch.arange(V.shape[0], dtype=torch.int32, device=dev).reshape(-1, 3)
    if bounds is not None:
        lo = torch.as_tensor(np.asarray(bounds[0], np.float32), device=dev)
        hi = torch.as_tensor(np.asarray(bounds[1], np.float32), device=dev)
        V = lo + (V + 0.5) / r * (hi - lo)
    return V, F


_PLY_ROWS = 1 << 20  # rows formatted at once by save_mesh_ply


def save_mesh_ply(path: str, verts, faces):
    """Write an ascii ply triangle mesh (tensors or arrays)."""
    verts = np.asarray(torch.as_tensor(verts).detach().cpu(), np.float32)
    faces = np.asarray(torch.as_tensor(faces).detach().cpu(), np.int64)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(verts)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write(f"element face {len(faces)}\n")
        f.write("property list uchar int vertex_indices\nend_header\n")
        for rows, fmt in ((verts, "%.6f %.6f %.6f\n"),
                          (faces, "3 %d %d %d\n")):
            for i in range(0, len(rows), _PLY_ROWS):  # one format per block
                block = rows[i:i + _PLY_ROWS]
                f.write((fmt * len(block)) % tuple(block.ravel().tolist()))


def load_mesh_ply(path: str):
    """Read save_mesh_ply's format -> (verts (N, 3) float32, faces (M, 3)
    int32) numpy arrays."""
    with open(path) as f:
        if f.readline().strip() != "ply":
            raise ValueError(f"{path}: not a ply file")
        n_v = n_f = 0
        while True:
            line = f.readline()
            if not line:
                raise ValueError(f"{path}: no end_header")
            line = line.strip()
            if line.startswith("element vertex"):
                n_v = int(line.split()[-1])
            elif line.startswith("element face"):
                n_f = int(line.split()[-1])
            elif line == "end_header":
                break
        lines = f.read().splitlines()
    verts = np.array([ln.split()[:3] for ln in lines[:n_v]],
                     np.float32).reshape(n_v, 3)
    faces = np.array([ln.split()[1:4] for ln in lines[n_v:n_v + n_f]],
                     np.int32).reshape(n_f, 3)
    return verts, faces


def visual_hull(masks: torch.Tensor, cams: list, bounds: tuple, res: int = 64,
                min_votes: int | None = None) -> torch.Tensor:
    """Space carving: the centres (N, 3) of the voxels of a res^3 grid over
    `bounds` whose projection lands in the foreground (> 0.5) of every view
    that sees them (of at least `min_votes` views when given), from (V, H,
    W) masks."""
    pts = _grid_points(bounds, res, masks.device)
    votes = torch.zeros(pts.shape[0], dtype=torch.int32, device=masks.device)
    seen = torch.zeros_like(votes)
    for v, cam in enumerate(cams):
        z, x, y, xi, yi = _project(pts, cam)
        inside = ((z > 1e-3) & (x >= 0) & (x <= cam.W - 1) & (y >= 0)
                  & (y <= cam.H - 1))
        fg = masks[v][yi, xi] > 0.5
        votes = votes + (inside & fg).to(torch.int32)
        seen = seen + inside.to(torch.int32)
    if min_votes is None:
        keep = (seen > 0) & (votes == seen)
    else:
        keep = votes >= min_votes
    return pts[keep]
