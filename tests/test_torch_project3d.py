"""The 3DGS EWA projection's kernels (csrc/project3d.cu) against the plain
version (ops/project3d.py::project3d_torch) and its autograd.

On the CPU: the dispatch rule, the plain path taken (and nothing launched)
on CPU tensors, under camera optimisation too, and the kernels' per-splat
arithmetic (csrc/project3d.cuh) built with the host's C++ compiler and held
to the plain version's outputs and gradients. On the card (`-m cuda`,
skipped without one): the kernels themselves, in the four filter settings.

    python -m pytest tests/test_torch_project3d.py
    python -m pytest -m cuda tests/test_torch_project3d.py   # on the card
"""
import ctypes
import math
import shutil
import subprocess
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from envgs_tpu_torch import kernels
from envgs_tpu_torch.ops import project3d as p3
from envgs_tpu_torch.ops.raster3d_ref import prepare_splats3d
from envgs_tpu_torch.utils.camera import Camera, make_camera

# (lowpass2d, compensate2d, with filter3d): classic 3DGS, mip-splatting, and
# each of mip's two filters alone
SETTINGS = {"classic": (0.3, False, False), "mip": (0.1, True, True),
            "filter3d": (0.3, False, True), "compensate2d": (0.1, True, False)}
FLOAT_FIELDS = ("conic", "center_pix", "depth", "opacity", "rowcull")
RTOL, ATOL = 1e-5, 1e-6  # the float outputs
GRAD_RTOL = 1e-5  # per leaf, |d| / |ref| in the 2-norm
CSRC = Path(kernels.__file__).resolve().parent / "csrc"


def _scene(P, seed, H, W, scale=None):
    """A pool of P splats in front of a camera at the origin (x, y normal
    1.5, z in [2, 7)); 10% inactive, some behind the near plane, off the
    image and beyond the Jacobian's frustum clamp, 1% empty slots (zero
    mean and quaternion, unit scales). scale: axes about that size (the
    gs3d configuration's three equal ones, spread by up to 2x apart: on a
    round Gaussian the rotation's gradient is rounding noise), else up to
    16 times apart."""
    rng = np.random.default_rng(seed)
    means = np.concatenate([rng.normal(size=(P, 2)) * 1.5,
                            rng.random((P, 1)) * 5.0 + 2.0], 1)
    k = rng.permutation(P)
    n = P // 50
    means[k[:n], 2] = rng.random(n) * 1.2 - 1.0  # behind the near plane
    means[k[n:2 * n], 0] = rng.choice([-1, 1], n) * (rng.random(n) + 1.0) \
        * means[k[n:2 * n], 2]  # beyond the frustum clamp (1.3 half-FOV)
    means[k[2 * n:3 * n], 1] += rng.choice([-1, 1], n) * 30.0  # off-image
    quats = rng.normal(size=(P, 4))
    if scale is None:
        scales = rng.random((P, 3)) * 0.08 + 0.005
    else:
        scales = scale * np.exp(rng.uniform(-0.7, 0.7, (P, 3)))
    opac = rng.random(P) * 0.9 + 0.05
    empty = k[3 * n:3 * n + P // 100]
    means[empty], quats[empty], scales[empty] = 0.0, 0.0, 1.0
    active = rng.random(P) > 0.1
    active[empty] = False
    filt = rng.random(P) * 0.02 + 1e-3
    f32 = lambda a: torch.tensor(a, dtype=torch.float32)  # noqa: E731
    f = 0.9 * W
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]])
    c, s = math.cos(0.05), math.sin(0.05)
    R = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
    cam = make_camera(H, W, K, R, [0.02, -0.03, 0.1])
    return (f32(means), f32(quats), f32(scales), f32(opac),
            torch.tensor(active), f32(filt), cam)


def _kwargs(setting, filt):
    lp, comp, has_f = SETTINGS[setting]
    return dict(lowpass2d=lp, compensate2d=comp,
                filter3d=filt if has_f else None)


def _check_forward(got, want):
    """The float outputs within RTOL / ATOL, valid exactly, radius and ext
    equal but for +-1 px on at most 0.01% of splats."""
    for k in FLOAT_FIELDS:
        torch.testing.assert_close(getattr(got, k), getattr(want, k),
                                   rtol=RTOL, atol=ATOL,
                                   msg=lambda m, k=k: f"{k}: {m}")
    assert torch.equal(got.valid, want.valid)
    P = got.valid.numel()
    for k in ("radius", "ext"):
        d = (getattr(got, k) - getattr(want, k)).abs().reshape(P, -1)
        assert float(d.max()) <= 1.0, k
        assert int((d > 0).any(1).sum()) <= max(1, int(1e-4 * P)), k


def _cotangents(P, seed, with_opacity, device, conic_only=False):
    """Seeded random cotangents of conic, center, depth and (with_opacity)
    opacity; conic_only: those of the center and depth zero, so that the
    means' gradient is the Jacobian's alone."""
    gen = torch.Generator().manual_seed(seed)
    cots = [torch.randn(s, generator=gen) for s in ((P, 3), (P, 2), (P,))]
    if conic_only:
        cots[1:] = [torch.zeros_like(c) for c in cots[1:]]
    if with_opacity:
        cots.append(torch.randn(P, generator=gen))
    return [c.to(device) for c in cots]


def _plain_vjp(leaves, cam, active, kw, cots, sm=1.0):
    """Gradients of sum(cot * output) through the plain version."""
    leaves = [x.clone().requires_grad_(True) for x in leaves]
    out = p3.project3d_torch(*leaves, leaves[0].new_zeros(0), cam, sm,
                             active, **kw)
    outs = [out.conic, out.center_pix, out.depth, out.opacity][:len(cots)]
    loss = sum((o * c).sum() for o, c in zip(outs, cots))
    return torch.autograd.grad(loss, leaves, allow_unused=True)


def _check_grads(got, want, prep, want64):
    """Per leaf within GRAD_RTOL of the plain version over all splats, and
    over each kind apart: valid, invalid in front of the near plane (off
    the image, beyond the frustum clamp), behind it (gradients thousands of
    times larger: they would hide the others'). Behind the plane the
    compensation's det2 cancels to a few bits, and the plain version in
    float32 is itself up to ~1e-4 off its float64 run (want64); where a
    kind misses GRAD_RTOL the kernels must be no farther from float64 than
    twice the plain version's own distance."""
    depth = prep.depth.to(prep.valid.device)
    kinds = (prep.valid, ~prep.valid & (depth > p3.NEAR_PLANE),
             depth <= p3.NEAR_PLANE)
    for name, g, w, w64 in zip(("means", "quats", "scales", "opacities"),
                               got, want, want64):
        if w is None:
            assert g is None or not g.abs().max() > 0, name
            continue
        assert torch.isfinite(w).all(), name
        w64 = w64.float()
        rel = float((g - w).norm() / w.norm())
        assert rel <= GRAD_RTOL, f"{name}: relative 2-norm {rel:.3g}"
        for k, sel in enumerate(kinds):
            rel = float((g[sel] - w[sel]).norm() / w[sel].norm())
            if rel <= GRAD_RTOL:
                continue
            own = float((w[sel] - w64[sel]).norm() / w64[sel].norm())
            to64 = float((g[sel] - w64[sel]).norm() / w64[sel].norm())
            assert to64 <= max(GRAD_RTOL, 2 * own), (
                f"{name} (kind {k}): relative 2-norm {rel:.3g} to the plain "
                f"version, {to64:.3g} to float64 (the plain's {own:.3g})")


def _plain_vjp64(leaves, cam, active, kw, cots, sm=1.0):
    """_plain_vjp in float64."""
    d = lambda t: None if t is None else t.double()  # noqa: E731
    cam = cam._replace(K=cam.K.double(), R=cam.R.double(),
                       T=cam.T.double())
    kw = dict(kw, filter3d=d(kw["filter3d"]))
    return _plain_vjp([x.double() for x in leaves], cam, active, kw,
                      [c.double() for c in cots], sm)


# ---- the dispatch rule ----

def _fake(is_cuda=True, dtype=torch.float32, requires_grad=False):
    return SimpleNamespace(is_cuda=is_cuda, dtype=dtype,
                           requires_grad=requires_grad)


@pytest.mark.parametrize("case,want", [
    ("cuda", True), ("cpu", False), ("cpu_cam_grad", False),
    ("mixed", "raises"), ("float64", "raises"), ("cam_R_grad", "raises"),
    ("cam_T_grad", "raises"), ("cam_K_grad", "raises"),
    ("cam_grad_no_grad_mode", True), ("filter3d", True),
    ("filter3d_grad", "raises"), ("active_uint8", "raises"),
    ("means_grad", True)])
def test_dispatch_rule(case, want):
    """The plain version where every tensor is on the CPU, the kernels
    where every one is on the card; on the card a tensor that is not
    float32, a mask that is not bool, a camera tensor or filter3d that asks
    for a gradient (autograd on), or a tensor left on the CPU raises. The
    means, quaternions, scales and opacities may ask for gradients."""
    on_card = not case.startswith("cpu")
    t = {k: _fake(is_cuda=on_card) for k in ("means", "quats", "scales",
                                             "opac", "R", "T", "K")}
    active, filt = _fake(is_cuda=on_card, dtype=torch.bool), None
    if case == "mixed":
        t["scales"] = _fake(is_cuda=False)
    if case == "float64":
        t["quats"] = _fake(dtype=torch.float64)
    if case.startswith("cam_") or case == "cpu_cam_grad":
        k = "R" if case in ("cam_grad_no_grad_mode", "cpu_cam_grad") \
            else case[4]
        t[k] = _fake(is_cuda=on_card, requires_grad=True)
    if case.startswith("filter3d"):
        filt = _fake(requires_grad=case.endswith("grad"))
    if case == "active_uint8":
        active = _fake(dtype=torch.uint8)
    if case == "means_grad":
        t["means"] = _fake(requires_grad=True)
    cam = Camera(4, 4, t["K"], t["R"], t["T"])
    args = (t["means"], t["quats"], t["scales"], t["opac"], cam, active,
            filt)
    if want == "raises":
        with pytest.raises(p3.UnsupportedProjection):
            p3.use_kernel(*args)
    elif case == "cam_grad_no_grad_mode":
        with torch.no_grad():
            assert p3.use_kernel(*args) is want
    else:
        assert p3.use_kernel(*args) is want


@pytest.mark.parametrize("setting", sorted(SETTINGS))
def test_cpu_tensors_take_the_plain_path(setting):
    """On CPU tensors prepare_splats3d is the plain version to the bit,
    and no kernel launches."""
    means, quats, scales, opac, active, filt, cam = _scene(512, 1, 48, 64)
    colors = torch.rand(512, 3)
    before = dict(kernels.LAUNCHES)
    got = prepare_splats3d(means, quats, scales, opac, colors, cam, 1.0,
                           active, **_kwargs(setting, filt))
    want = p3.project3d_torch(means, quats, scales, opac, colors, cam, 1.0,
                              active, **_kwargs(setting, filt))
    assert kernels.LAUNCHES == before
    for k in want._fields:
        assert torch.equal(getattr(got, k), getattr(want, k)), k
    if setting in ("classic",):
        assert got.opacity is opac  # unchanged: the input itself


def test_camera_optimisation_takes_the_plain_path():
    """A camera tensor that asks for a gradient gets one (the plain
    version under autograd), and no kernel launches."""
    means, quats, scales, opac, active, _, cam = _scene(256, 2, 48, 64)
    R = cam.R.clone().requires_grad_(True)
    cam = cam._replace(R=R)
    before = dict(kernels.LAUNCHES)
    out = prepare_splats3d(means, quats, scales, opac, torch.rand(256, 3),
                           cam, active=active)
    (out.conic.sum() + out.center_pix.sum()).backward()
    assert kernels.LAUNCHES == before
    assert R.grad is not None and float(R.grad.abs().max()) > 0


# ---- the per-splat arithmetic, built for the host ----

_HOST_SRC = r"""
#include "project3d.cuh"
// out: conic 3, center 2, depth, radius, valid, ext 2, rowcull 6, opacity
extern "C" void fwd(const float* m, const float* q, const float* s,
                    const float* op, const unsigned char* act,
                    const float* flt, const float* cam, int P, int W, int H,
                    float sm, float lp, int comp, float* out) {
  const p3d::Cam k = p3d::load_cam(cam, W, H);
  for (int i = 0; i < P; ++i) {
    p3d::Fwd o;
    p3d::forward(k, m + 3 * i, q + 4 * i, s + 3 * i, sm, lp, flt != 0,
                 flt ? flt[i] : 0.0f, o);
    const p3d::Rest r = p3d::rest(k, o, act[i] != 0);
    float* x = out + 18 * i;
    for (int j = 0; j < 3; ++j) x[j] = o.conic[j];
    x[3] = o.center[0]; x[4] = o.center[1]; x[5] = o.t[2];
    x[6] = r.radius; x[7] = r.valid; x[8] = r.ext[0]; x[9] = r.ext[1];
    for (int j = 0; j < 6; ++j) x[10 + j] = r.rowcull[j];
    float a = op[i];
    if (flt) a = a * o.sq1;
    if (comp) a = a * p3d::compensation(o).sq2;
    x[16] = a;
  }
}
// g: conic 3, center 2, depth, opacity; out: means 3, quats 4, scales 3,
// opacity
extern "C" void bwd(const float* m, const float* q, const float* s,
                    const float* op, const float* flt, const float* cam,
                    int P, int W, int H, float sm, float lp, int comp,
                    const float* g, int has_go, float* out) {
  const p3d::Cam k = p3d::load_cam(cam, W, H);
  for (int i = 0; i < P; ++i) {
    const float* gi = g + 7 * i;
    float* x = out + 11 * i;
    p3d::backward(k, m + 3 * i, q + 4 * i, s + 3 * i, op[i], sm, lp,
                  flt != 0, flt ? flt[i] : 0.0f, comp != 0, gi, gi + 3,
                  gi[5], has_go != 0, gi[6], x, x + 3, x + 7, x + 10);
  }
}
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    d = tmp_path_factory.mktemp("project3d_host")
    src, lib = d / "project3d_host.cpp", d / "libproject3d_host.so"
    src.write_text(_HOST_SRC)
    # no contraction into fused multiply-adds, as the library's -fmad=false
    subprocess.run([cxx, "-O2", "-std=c++17", "-ffp-contract=off", "-fPIC",
                    "-shared", f"-I{CSRC}", "-o", str(lib), str(src)],
                   check=True, capture_output=True, timeout=300)
    return ctypes.CDLL(str(lib))


def _p(t):
    return None if t is None else ctypes.c_void_p(t.data_ptr())


def _host_forward(lib, means, quats, scales, opac, active, cam, sm, kw):
    P = means.shape[0]
    out = torch.empty(P, 18)
    flt, buf = kw["filter3d"], p3.camera_buffer(cam)
    lib.fwd(_p(means), _p(quats), _p(scales), _p(opac), _p(active),
            _p(flt), _p(buf), P, cam.W, cam.H,
            ctypes.c_float(sm), ctypes.c_float(kw["lowpass2d"]),
            int(kw["compensate2d"]), _p(out))
    changed = flt is not None or kw["compensate2d"]
    return p3.Prepared3DSplats(
        conic=out[:, :3], center_pix=out[:, 3:5], depth=out[:, 5],
        radius=out[:, 6], color=None,
        opacity=out[:, 16] if changed else opac, valid=out[:, 7] > 0,
        ext=out[:, 8:10], rowcull=out[:, 10:16])


@pytest.mark.parametrize("setting", sorted(SETTINGS))
def test_host_forward_matches_plain(host_lib, setting):
    means, quats, scales, opac, active, filt, cam = _scene(4096, 4, 96, 128)
    kw = _kwargs(setting, filt)
    got = _host_forward(host_lib, means, quats, scales, opac, active, cam,
                        0.9, kw)
    want = p3.project3d_torch(means, quats, scales, opac, None, cam, 0.9,
                              active, **kw)
    assert 1000 < int(want.valid.sum()) < 3900
    _check_forward(got, want)


@pytest.mark.parametrize("conic_only", [False, True])
@pytest.mark.parametrize("setting", sorted(SETTINGS))
def test_host_backward_matches_autograd(host_lib, setting, conic_only):
    """The VJP of seeded random cotangents of conic, center, depth and
    (when a filter changes it) opacity against torch.autograd.grad through
    the plain version, per leaf; conic_only: the center's and depth's
    cotangents zero."""
    P = 4096
    means, quats, scales, opac, active, filt, cam = _scene(P, 5, 96, 128)
    kw = _kwargs(setting, filt)
    changed = kw["filter3d"] is not None or kw["compensate2d"]
    cots = _cotangents(P, 6, changed, "cpu", conic_only)
    g = torch.zeros(P, 7)
    g[:, :3], g[:, 3:5], g[:, 5] = cots[0], cots[1], cots[2]
    if changed:
        g[:, 6] = cots[3]
    out, buf = torch.empty(P, 11), p3.camera_buffer(cam)
    host_lib.bwd(_p(means), _p(quats), _p(scales), _p(opac),
                 _p(kw["filter3d"]), _p(buf), P, cam.W, cam.H,
                 ctypes.c_float(0.9), ctypes.c_float(kw["lowpass2d"]),
                 int(kw["compensate2d"]), _p(g), int(changed), _p(out))
    got = (out[:, :3], out[:, 3:7], out[:, 7:10],
           out[:, 10] if changed else None)
    leaves = (means, quats, scales, opac)
    _check_grads(got, _plain_vjp(leaves, cam, active, kw, cots, 0.9),
                 p3.project3d_torch(*leaves, None, cam, 0.9, active, **kw),
                 _plain_vjp64(leaves, cam, active, kw, cots, 0.9))


# ---- on the card ----

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("setting", sorted(SETTINGS))
def test_kernels_match_plain_on_the_card(cuda, setting):
    """P = 65,536 at the gs3d configuration's statistics (1558x1038, focal
    0.9 W, scale axes about 0.0049): the forward against the plain
    version on the same CUDA inputs, the VJP of seeded random cotangents
    against autograd through it (all cotangents, then the conic's
    alone); one forward launch, one backward launch a gradient."""
    P = 65536
    scene = _scene(P, 11, 1038, 1558, scale=0.0049)
    means, quats, scales, opac, active, filt = (x.to(cuda)
                                                for x in scene[:6])
    cam = scene[6]
    cam = cam._replace(K=cam.K.to(cuda), R=cam.R.to(cuda), T=cam.T.to(cuda))
    kw = _kwargs(setting, filt)
    changed = kw["filter3d"] is not None or kw["compensate2d"]
    leaves = [x.clone().requires_grad_(True)
              for x in (means, quats, scales, opac)]
    before = dict(kernels.LAUNCHES)
    got = p3.project3d(*leaves, None, cam, 1.0, active, **kw)
    assert kernels.LAUNCHES["project3d_fwd"] == before["project3d_fwd"] + 1
    with torch.no_grad():
        want = p3.project3d_torch(means, quats, scales, opac, None, cam, 1.0,
                                  active, **kw)
    assert int(want.valid.sum()) > P // 2
    _check_forward(got, want)
    assert (got.opacity is leaves[3]) is not changed

    for conic_only in (False, True):
        cots = _cotangents(P, 12, changed, cuda, conic_only)
        outs = [got.conic, got.center_pix, got.depth, got.opacity]
        loss = sum((o * c).sum() for o, c in zip(outs, cots))
        n = kernels.LAUNCHES["project3d_bwd"]
        g = torch.autograd.grad(loss, leaves, allow_unused=True,
                                retain_graph=True)
        assert kernels.LAUNCHES["project3d_bwd"] == n + 1
        plain = (means, quats, scales, opac)
        want_g = _plain_vjp(plain, cam, active, kw, cots)
        want64 = _plain_vjp64(plain, cam, active, kw, cots)
        if not changed:
            g, want_g = g[:3] + (None,), want_g[:3] + (None,)
        _check_grads(g, want_g, want, want64)
    assert {k: v - before[k] for k, v in kernels.LAUNCHES.items()
            if v != before[k]} == {"project3d_fwd": 1, "project3d_bwd": 2}
