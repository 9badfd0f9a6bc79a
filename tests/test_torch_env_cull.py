"""The env cull's kernels (csrc/env_cull.cu) against the plain version
(ops/tracer.py::cull_and_sort_torch).

On the CPU: the dispatch rule (CPU tensors take the plain version and
launch nothing; a mix of devices raises); the kernels' arithmetic
(csrc/env_cull.cuh) built with the host's C++ compiler and held bit for bit
to the plain version's coarse radials, its refine's keep flags and its
sort keys, on the seeded scenes of tests/test_torch_tracer.py with the
probe on and off, in both key regimes (P < 2^18: quantized radial and pool
index; P >= 2^18: radial, chunk rank, lane); the 64-bit key's order equal
to torch.sort(stable=True)'s on planted ties; and the kernels' algorithm
(the radix select of the Kc nearest chunks, the chunk ranks, the keys, the
per-tile sort and the slot layout) modelled on the host arithmetic and
held integer-equal to the plain version's outputs. On the card (`-m
cuda`, skipped without one): the kernels against the plain version,
integer for integer, over probe, tile mask, slot budget, per-tile cap and
key regime, and at envgs-train's full size; no host synchronisation; the
launch counted in a training step.

    python -m pytest tests/test_torch_env_cull.py
    python -m pytest -m cuda tests/test_torch_env_cull.py   # on the card
"""
import ctypes
import shutil
import subprocess
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from envgs_tpu_torch import kernels
from envgs_tpu_torch.ops import tracer
from envgs_tpu_torch.ops.raster_blend import CHUNK
from envgs_tpu_torch.ops.tracer_ref import prepare_trace_scene

CSRC = Path(kernels.__file__).resolve().parent / "csrc"
FLOAT_P = 2 ** 18  # the least pool with the radial float keys


def _pad(arrays, P):
    """The scene's arrays with inactive splats appended up to P slots."""
    means, quats, scales, opac, colors, active = arrays
    n = P - means.shape[0]
    z = lambda a, v=0.0: np.concatenate(  # noqa: E731
        [a, np.full((n,) + a.shape[1:], v, a.dtype)])
    return (z(means), z(quats, 1.0), z(scales, 0.05), z(opac, 0.5),
            z(colors), z(active, False))


def _scene(seed=0, P=None, device="cpu"):
    """tests/test_torch_tracer.py's env-like scene and ray bundle: (scene,
    ray tiles), padded with inactive splats to P slots when given."""
    from test_torch_tracer import _rays, _scene_arrays

    arrays = _scene_arrays(seed=seed)
    if P is not None:
        arrays = _pad(arrays, P)
    *floats, active = (torch.tensor(a, device=device) for a in arrays)
    scene = prepare_trace_scene(*floats, active=active)
    o, d = (torch.tensor(a, device=device) for a in _rays(seed + 1))
    return scene, tracer.build_ray_tiles(o, d)


def _dome(seed=0, P=1280, H=32, W=48):
    """tests/test_torch_env_cut.py's dome: P surfels at radius 20, a fan of
    rays from near its centre; every tile meets more chunks than a small
    cap keeps."""
    g = torch.Generator().manual_seed(seed)
    dirs = torch.randn((P, 3), generator=g)
    xyz = 20.0 * dirs / dirs.norm(dim=-1, keepdim=True)
    scene = prepare_trace_scene(
        xyz, torch.randn((P, 4), generator=g), torch.full((P, 2), 0.5),
        torch.full((P,), 0.8), torch.rand((P, 3), generator=g))
    yy, xx = torch.meshgrid(torch.linspace(-1.2, 1.2, H),
                            torch.linspace(-1.8, 1.8, W), indexing="ij")
    d = torch.stack([xx, yy, torch.ones_like(xx)], -1)
    o = 0.1 * torch.randn((H, W, 3), generator=g)
    return scene, tracer.build_ray_tiles(o, d)


# ---- the dispatch rule ----

def test_cpu_tensors_take_the_plain_version(monkeypatch):
    scene, tiles = _scene()
    r3 = tracer.splat_radius3(scene)

    def refuse(*a, **k):
        raise AssertionError("the kernels ran on CPU tensors")

    monkeypatch.setattr(kernels, "env_cull", refuse)
    before = dict(kernels.LAUNCHES)
    got = tracer.cull_and_sort(tiles, scene, r3, per_tile_cap=1024,
                               total_pair_cap=4096)
    want = tracer.cull_and_sort_torch(tiles, scene, r3, per_tile_cap=1024,
                                      total_pair_cap=4096)
    assert kernels.LAUNCHES == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)


class _OnCard(SimpleNamespace):
    is_cuda = True


@pytest.mark.parametrize("which", ["radius3", "tile_mask", "scene.mean",
                                   "tiles.probe_ok"])
def test_a_mix_of_devices_raises(which):
    scene, tiles = _scene()
    r3 = tracer.splat_radius3(scene)
    args = dict(tiles=tiles, scene=scene, radius3=r3,
                tile_mask=torch.ones(tiles.n_tiles, dtype=torch.bool))
    if "." in which:
        obj, field = which.split(".")
        args[obj] = args[obj]._replace(**{field: _OnCard()})
    else:
        args[which] = _OnCard()
    with pytest.raises(ValueError, match="two devices"):
        tracer.use_kernel(**args)
    assert not tracer.use_kernel(tiles, scene, r3)


def test_every_tensor_on_the_card_takes_the_kernels():
    scene, tiles = _scene()
    card = lambda nt: nt._replace(  # noqa: E731
        **{k: _OnCard() for k, v in nt._asdict().items()
           if isinstance(v, torch.Tensor)})
    assert tracer.use_kernel(card(tiles), card(scene), _OnCard(), _OnCard())


# ---- the arithmetic, built for the host ----

_HOST_SRC = r"""
#include "env_cull.cuh"
extern "C" void coarse(const float* cmean, const float* crad,
                       const unsigned char* cact, const float* apex,
                       const float* axis, const float* tan_half,
                       const float* spread, int T, int NC, float* out) {
  for (int t = 0; t < T; ++t) {
    const ec::Cone k = ec::load_cone(apex, axis, tan_half, spread, t);
    for (int c = 0; c < NC; ++c)
      out[(long)t * NC + c] = cact[c] ? ec::coarse(k, cmean[3 * c],
          cmean[3 * c + 1], cmean[3 * c + 2], crad[c]) : INFINITY;
  }
}
extern "C" void refine(const float* rows, const int* cid, const int* tile,
                       int M, const float* apex, const float* axis,
                       const float* tan_half, const float* spread,
                       const float* frame, const float* box,
                       const unsigned char* ok, int P, unsigned char* keep,
                       float* radial) {
  for (int i = 0; i < M; ++i) {
    const int t = tile[i];
    const ec::Cone k = ec::load_cone(apex, axis, tan_half, spread, t);
    ec::Probe q;
    if (ok) q = ec::load_probe(frame, box, ok, t);
    keep[i] = ec::refine(k, ok ? &q : nullptr, rows + 8 * i, cid[i], P,
                         radial + i);
  }
}
extern "C" void keys(const float* radial, const float* rmax, const int* rank,
                     const int* lane, const int* cid, int M, int quant,
                     int bits, unsigned long long* out) {
  for (int i = 0; i < M; ++i)
    out[i] = quant ? ec::quant_key(radial[i], rmax[i], cid[i], bits)
                   : ec::float_key(radial[i], rank[i], lane[i], bits);
}
extern "C" void chunk_keys(const float* radial, const int* c, int M,
                           int bits, unsigned long long* out) {
  for (int i = 0; i < M; ++i) out[i] = ec::chunk_key(radial[i], c[i], bits);
}
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    d = tmp_path_factory.mktemp("env_cull_host")
    src, lib = d / "env_cull_host.cpp", d / "libenv_cull_host.so"
    src.write_text(_HOST_SRC)
    # no contraction into fused multiply-adds, as the library's -fmad=false
    subprocess.run([cxx, "-O2", "-std=c++17", "-ffp-contract=off", "-fPIC",
                    "-shared", f"-I{CSRC}", "-o", str(lib), str(src)],
                   check=True, capture_output=True, timeout=300)
    return ctypes.CDLL(str(lib))


@pytest.fixture
def ieee_sqrt(monkeypatch):
    """torch.sqrt on CPU float32 tensors correctly rounded, as sqrtf is on
    the card and on the host: torch's CPU sqrt goes through a vector math
    library that can miss by an ulp (sqrt(62.82291) gives 7.9260902, not
    7.9260907), while its CUDA sqrt is IEEE. The plain version then
    computes here what it computes on the card."""
    real = torch.sqrt

    def sqrt(x):
        if x.dtype != torch.float32 or x.is_cuda:
            return real(x)
        return torch.from_numpy(np.sqrt(x.detach().contiguous().numpy()))

    monkeypatch.setattr(torch, "sqrt", sqrt)
    assert float(torch.sqrt(torch.tensor([62.82291030883789]))) == float(
        np.float32(7.9260907))


def _p(t):
    return None if t is None else ctypes.c_void_p(t.data_ptr())


def _call(fn, *args):
    """fn(*args) with each input tensor passed as a pointer to a contiguous
    copy of it in the shim's dtype, kept alive through the call: float32
    for floats, int32 for ints, uint8 for bools. Outputs come as pointers
    (_p) to tensors the caller holds."""
    held = []
    for a in args:
        if isinstance(a, torch.Tensor):
            dtype = (torch.float32 if a.is_floating_point() else torch.uint8
                     if a.dtype == torch.bool else torch.int32)
            a = a.to(dtype).contiguous()
        held.append(a)
    return fn(*(_p(a) if isinstance(a, torch.Tensor) else a for a in held))


def _bits(t):
    return t.contiguous().view(torch.int32)


def _host_coarse(lib, idx, tiles, tmask):
    T, NC = tiles.n_tiles, idx.cmean.shape[0]
    out = torch.empty(T, NC)
    _call(lib.coarse, idx.cmean, idx.crad, idx.cact, tiles.apex, tiles.axis,
          tiles.tan_half, tiles.spread, T, NC, _p(out))
    return torch.where(tmask[:, None], out, float("inf"))


def _host_refine(lib, tiles, rows, cid, tile, P, probe):
    M = rows.shape[0]
    keep = torch.empty(M, dtype=torch.uint8)
    radial = torch.empty(M)
    _call(lib.refine, rows, cid, tile, M, tiles.apex, tiles.axis,
          tiles.tan_half, tiles.spread, tiles.probe_frame, tiles.probe_box,
          tiles.probe_ok if probe else None, P, _p(keep), _p(radial))
    return keep.bool(), radial


def _host_keys(lib, radial, rmax, rank, lane, cid, quant, bits):
    out = torch.empty(radial.numel(), dtype=torch.int64)
    _call(lib.keys, radial, rmax, rank, lane, cid, radial.numel(),
          int(quant), bits, _p(out))
    return out.numpy().view(np.uint64)


def _host_chunk_keys(lib, radial, c, bits):
    out = torch.empty(radial.numel(), dtype=torch.int64)
    _call(lib.chunk_keys, radial, c, radial.numel(), bits, _p(out))
    return out.numpy().view(np.uint64)


def _bit_length(x: int) -> int:
    return int(x).bit_length()


def _checker(T):
    return torch.arange(T) % 3 != 1


SCENES = {"quantized": None, "float": FLOAT_P + 512}


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("regime", sorted(SCENES))
def test_host_coarse_is_the_plain_coarse_to_the_bit(host_lib, ieee_sqrt,
                                                    regime, masked):
    scene, tiles = _scene(P=SCENES[regime])
    idx = tracer.build_chunk_index(scene, tracer.splat_radius3(scene))
    tmask = (_checker(tiles.n_tiles) if masked
             else torch.ones(tiles.n_tiles, dtype=torch.bool))
    want = tracer.coarse_radial(idx, tiles.apex, tiles.axis, tiles.tan_half,
                                tiles.spread, tmask)
    got = _host_coarse(host_lib, idx, tiles, tmask)
    met = want < float("inf")
    assert int(met.sum()) > 5 * tiles.n_tiles // 2
    assert torch.equal(_bits(got), _bits(want))


def _plain_block(scene, tiles, cap, probe, tmask):
    """The plain version's per-tile pieces over all tiles in one block:
    (idx, table, Kc, the coarse order's chunks (T, Kc), their validity,
    keep (T, Kc*CHUNK), cid_sorted (T, Kc*CHUNK), cut, met)."""
    r3 = tracer.splat_radius3(scene)
    idx, table = tracer._cull_tables(scene, r3)
    NC = idx.cmean.shape[0]
    Kc = max(min(cap // CHUNK, NC), 1)
    P = scene.mean.shape[0]
    radial = tracer.coarse_radial(idx, tiles.apex, tiles.axis,
                                  tiles.tan_half, tiles.spread, tmask)
    srt = torch.sort(radial, dim=-1, stable=True)
    cs, ks, ct, mt = tracer._block_cull(
        idx, table, idx.order.reshape(NC, CHUNK), Kc, P, tiles.apex,
        tiles.axis, tiles.tan_half, tiles.spread, tmask, tiles.probe_frame,
        tiles.probe_box, tiles.probe_ok if probe else None)
    return (idx, table, Kc, srt.indices[:, :Kc],
            srt.values[:, :Kc] < float("inf"), ks, cs, ct, mt)


@pytest.mark.parametrize("probe", [True, False])
@pytest.mark.parametrize("regime", sorted(SCENES))
def test_host_refine_and_keys_are_the_plain_refine_and_order(
        host_lib, ieee_sqrt, regime, probe):
    """Over the chunks the plain version keeps (its coarse order), the
    host refine's keep flags equal its own, and each tile's kept
    candidates ordered by the host keys are its sorted slots; in the
    quantized regime the keys' radial part is its quantization, bit for
    bit."""
    scene, tiles = _scene(P=SCENES[regime])
    T, P = tiles.n_tiles, scene.mean.shape[0]
    tmask = torch.ones(T, dtype=torch.bool)
    idx, table, Kc, idc, cvalid, ks, cs, _, _ = _plain_block(
        scene, tiles, 1024, probe, tmask)
    rows = table[idc].permute(0, 1, 3, 2).reshape(T, Kc * CHUNK, 8)
    cid = torch.where(cvalid[:, :, None],
                      idx.order.reshape(-1, CHUNK)[idc], P).reshape(T, -1)
    tile = torch.arange(T)[:, None].expand(T, Kc * CHUNK)
    # the plain version zeroes the radius of the candidates of chunks past
    # those that met; the kernels never refine them
    rows = torch.where(cvalid.repeat_interleave(CHUNK, 1)[..., None], rows,
                       torch.zeros(()))
    keep, radial = _host_refine(host_lib, tiles, rows.reshape(-1, 8),
                                cid.reshape(-1).to(torch.int32),
                                tile.reshape(-1).to(torch.int32), P, probe)
    keep, radial = keep.reshape(T, -1), radial.reshape(T, -1)
    assert torch.equal(keep, ks)
    assert int(keep.sum()) > T * 64
    quant = 32 - _bit_length(P) >= 14
    assert quant == (regime == "quantized")
    rmax = torch.where(keep, radial, 0.0).amax(-1, keepdim=True)
    pos = torch.arange(Kc * CHUNK)
    key = _host_keys(host_lib, radial.reshape(-1),
                     rmax.expand(T, Kc * CHUNK).reshape(-1),
                     (pos // CHUNK).repeat(T), (pos % CHUNK).repeat(T),
                     cid.reshape(-1), quant,
                     _bit_length(P) if quant
                     else _bit_length(max(Kc - 1, 1))).reshape(T, -1)
    for t in range(T):
        kept = keep[t].numpy()
        order = np.argsort(key[t][kept], kind="stable")
        got = cid[t][torch.from_numpy(kept)][torch.from_numpy(order)]
        n = int(kept.sum())
        assert torch.equal(got, cs[t, :n]), t
        assert bool((cs[t, n:] == P).all())
    if quant:  # the plain version's quantization, as it writes it
        qmax = (1 << (32 - _bit_length(P))) - 1
        rq = torch.clamp(radial / torch.clamp(rmax, min=1e-12) * (qmax - 1),
                         0, qmax - 1).to(torch.int64)
        got_rq = torch.from_numpy(
            (key >> np.uint64(_bit_length(P))).astype(np.int64))
        assert torch.equal(got_rq[keep], rq[keep])


@pytest.mark.parametrize("quant", [False, True])
def test_the_keys_order_planted_ties_as_the_stable_sort(host_lib, quant):
    """Kept radials with ties planted within and across chunks: the keys'
    ascending order is torch.sort(stable=True)'s of the plain layout (rank
    * 64 + lane) by radial (P >= 2^18), or by (quantized radial, pool
    index) (P < 2^18)."""
    g = torch.Generator().manual_seed(7)
    n_chunks, M = 37, 37 * CHUNK
    radial = torch.rand(M, generator=g) * 10.0
    tie = torch.randint(0, M, (M // 3,), generator=g)
    radial[tie] = radial[torch.randint(0, M, (M // 3,), generator=g)]
    radial[torch.randint(0, M, (200,), generator=g)] = 4.0  # a wide tie
    radial[:5] = 0.0
    pos = torch.arange(M)
    rank, lane = pos // CHUNK, pos % CHUNK
    cid = torch.randperm(M, generator=g)
    rmax = torch.full((M,), float(radial.max()))
    bits = 16 if quant else _bit_length(n_chunks - 1)
    key = _host_keys(host_lib, radial, rmax, rank, lane, cid, quant, bits)
    got = torch.from_numpy(np.argsort(key, kind="stable"))
    if quant:
        qmax = (1 << (32 - bits)) - 1
        rq = torch.clamp(radial / torch.clamp(rmax, min=1e-12) * (qmax - 1),
                         0, qmax - 1).to(torch.int64)
        want = torch.sort((rq << bits) | cid).indices
        assert len(torch.unique(rq)) < M - 200  # tied quantized radials
    else:
        want = torch.sort(radial, stable=True).indices
        assert len(torch.unique(radial)) < M - 200
    assert len(set(key.tolist())) == M  # unique: any sort gives this order
    assert torch.equal(got, want)


# ---- the kernels' algorithm on the host arithmetic ----

def _radix_select(keys: np.ndarray, k: int, key_bits: int) -> int:
    """The k-th smallest of unique keys as coarse_kernel finds it: 8-bit
    digits from the top, a histogram of the keys under the prefix each."""
    prefix, rem = 0, k
    for shift in range(((key_bits - 1) // 8) * 8, -1, -8):
        under = keys[(keys >> np.uint64(shift + 8)) == (prefix >> (shift + 8))
                     ] if shift + 8 < 64 else keys
        hist = np.bincount(((under >> np.uint64(shift)) & np.uint64(255))
                           .astype(np.int64), minlength=256)
        acc = np.concatenate([[0], np.cumsum(hist)])
        sel = int(np.argmax(acc[1:] >= rem))
        rem -= int(acc[sel])
        prefix |= sel << shift
    return prefix


def model_cull(lib, tiles, scene, r3, per_tile_cap, total_pair_cap,
               tile_mask, probe):
    """cull_and_sort as csrc/env_cull.cu computes it, on the host
    arithmetic: -> (gauss_idx, tile_bounds, dropped, cut, met)."""
    P, T = scene.mean.shape[0], tiles.n_tiles
    idx, table = tracer._cull_tables(scene, r3)
    NC = idx.cmean.shape[0]
    Kc = max(min(per_tile_cap // CHUNK, NC), 1)
    Kcap = max(min(Kc, NC), 1)
    idx_bits = _bit_length(max(NC - 1, 1))
    rank_bits = _bit_length(max(Kcap - 1, 1))
    cid_bits = _bit_length(P)
    quant = 32 - cid_bits >= 14
    tmask = (torch.ones(T, dtype=torch.bool) if tile_mask is None
             else tile_mask)
    radial = _host_coarse(lib, idx, tiles, tmask)
    order = idx.order.reshape(NC, CHUNK)
    cut = met_total = 0
    lists, cnt = [], []
    for t in range(T):
        c = torch.nonzero(radial[t] < float("inf"))[:, 0]
        ck = _host_chunk_keys(lib, radial[t, c], c, idx_bits)
        met_total += len(ck)
        if len(ck) > Kc:
            cut += len(ck) - Kc
            ck = ck[ck <= np.uint64(_radix_select(ck, Kc, 31 + idx_bits))]
            assert len(ck) == Kc
        chunks = torch.from_numpy(
            (np.sort(ck) & np.uint64((1 << idx_bits) - 1)).astype(np.int64))
        n = chunks.numel()
        rows = table[chunks].permute(0, 2, 1).reshape(-1, 8)
        cid = order[chunks].reshape(-1)
        keep, rad = _host_refine(lib, tiles, rows, cid,
                                 torch.full((n * CHUNK,), t,
                                            dtype=torch.int32), P, probe)
        pos = torch.arange(n * CHUNK)
        rmax = torch.where(keep, rad, 0.0).max() if n else torch.zeros(())
        key = _host_keys(lib, rad, rmax.expand(n * CHUNK), pos // CHUNK,
                         pos % CHUNK, cid, quant,
                         cid_bits if quant else rank_bits)
        key = np.sort(key[keep.numpy()])
        if quant:
            slots = (key & np.uint64((1 << cid_bits) - 1)).astype(np.int64)
        else:
            r = ((key >> np.uint64(6)) & np.uint64((1 << rank_bits) - 1)
                 ).astype(np.int64)
            slots = order[chunks[r], torch.from_numpy(
                (key & np.uint64(63)).astype(np.int64))].numpy()
        lists.append(slots)
        cnt.append(len(slots))
    cnt = np.array(cnt, np.int64)
    so = np.concatenate([[0], np.cumsum(-(-cnt // CHUNK) * CHUNK)])
    cap = tracer._slot_budget(T, Kc * CHUNK, total_pair_cap)
    gauss = np.full(cap, P, np.int32)
    for t in range(T):
        end = min(so[t] + cnt[t], cap)
        if so[t] < end:
            gauss[so[t]:end] = lists[t][:end - so[t]]
    return (torch.from_numpy(gauss),
            torch.from_numpy(np.minimum(so, cap).astype(np.int32)),
            int(max(so[-1] - cap, 0)), cut, met_total)


MODEL_CASES = {
    # (scene, per_tile_cap, total_pair_cap, mask, probe); the tracer scene
    # meets more than 16 chunks in some tiles (cut at 1024 a tile) and
    # keeps 1344 slots, so a budget of 1024 truncates
    "quantized": ("tracer", 1024, None, False, True),
    "quantized_no_probe": ("tracer", 1024, None, False, False),
    "quantized_masked": ("tracer", 1024, None, True, True),
    "quantized_truncated": ("tracer", 1024, 1024, False, True),
    "float": ("tracer_float", 1024, None, False, True),
    "float_no_probe_masked": ("tracer_float", 1024, None, True, False),
    "float_truncated": ("tracer_float", 2048, 1024, False, True),
    "dome_cut": ("dome", 128, None, False, True),
    "dome_cut_masked": ("dome", 256, None, True, False),
    "dome_uncut": ("dome", 2 ** 14, None, False, True),
}


@pytest.mark.parametrize("case", sorted(MODEL_CASES))
def test_the_kernels_algorithm_equals_the_plain_version(host_lib, ieee_sqrt,
                                                        case):
    name, cap, total, masked, probe = MODEL_CASES[case]
    scene, tiles = {"tracer": _scene, "dome": _dome,
                    "tracer_float": lambda: _scene(P=FLOAT_P + 512)}[name]()
    r3 = tracer.splat_radius3(scene)
    mask = _checker(tiles.n_tiles) if masked else None
    got = model_cull(host_lib, tiles, scene, r3, cap, total, mask, probe)
    want = tracer.cull_and_sort_torch(tiles, scene, r3, per_tile_cap=cap,
                                      total_pair_cap=total, tile_mask=mask,
                                      probe=probe)
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1], want[1])
    assert got[2] == int(want[2]) and got[3] == int(want[3])
    assert (got[2] > 0) == (total is not None)  # the budget truncates
    if name == "dome":  # the radix select, or nothing cut
        assert (got[3] > 0) == (cap < 2 ** 14)
    assert got[4] >= got[3] and int(want[1][-1]) > 0


# ---- on the card ----

@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def bench_env_inputs(device, P=None):
    """The render bench scene's env set (bench.make_render_scene: 32,768
    surfels of random orientation on a dome) and its reflected ray tiles;
    with P, padded with inactive surfels to P slots."""
    from envgs_tpu_torch import bench
    from envgs_tpu_torch.models import envgs

    base, env, cam, cfg = bench.make_render_scene(device)
    with torch.no_grad():
        ref_o, ref_d = envgs.reflect_rays(cam, envgs.render_base(base, cam,
                                                                 cfg))
        fields = [env.params.xyz, env.params.rotation, env.get_scaling,
                  env.get_opacity[:, 0], envgs._pool_colors_at(env, ref_o),
                  env.stats.active]
    if P is not None:  # copies of the first surfel, inactive
        n = P - fields[0].shape[0]
        fields = [torch.cat([f, f[:1].expand(n, *f.shape[1:])])
                  for f in fields]
        fields[5][-n:] = False
    scene = prepare_trace_scene(*fields[:5], active=fields[5])
    return scene, tracer.build_ray_tiles(ref_o, ref_d), cfg.env_pair_cap


@pytest.fixture(scope="module")
def bench_scenes(cuda):
    return {"quantized": bench_env_inputs(cuda),
            "float": bench_env_inputs(cuda, P=FLOAT_P + 4096)}


def _held(tiles, scene, **kw):
    """cull_and_sort (the kernels) and cull_and_sort_torch on the same
    CUDA inputs, integer for integer; -> the kernels' outputs."""
    r3 = tracer.splat_radius3(scene)
    n = kernels.LAUNCHES["env_cull"]
    got = tracer.cull_and_sort(tiles, scene, r3, **kw)
    assert kernels.LAUNCHES["env_cull"] == n + 1
    want = tracer.cull_and_sort_torch(tiles, scene, r3, **kw)
    for name, g, w in zip(("gauss_idx", "tile_bounds", "dropped", "cut"),
                          got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert torch.equal(g, w), (name, int((g != w).sum()))
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("truncated", [False, True])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("probe", [True, False])
@pytest.mark.parametrize("regime", ["quantized", "float"])
def test_kernels_equal_the_plain_version_at_the_render_default(
        bench_scenes, regime, probe, masked, truncated):
    """The render default, 2048 candidates a tile, which cuts most tiles
    on the random-orientation scene (the radix select), with the probe on
    and off, a tile mask, a slot budget that truncates."""
    scene, tiles, _ = bench_scenes[regime]
    total = 2 ** 16 if truncated else 2 ** 24
    mask = (torch.arange(tiles.n_tiles, device=scene.mean.device) % 3 != 1
            if masked else None)
    _, bounds, dropped, cut = _held(tiles, scene, per_tile_cap=2048,
                                    total_pair_cap=total, tile_mask=mask,
                                    probe=probe)
    assert int(cut) > 0
    assert (int(dropped) > 0) == truncated


@pytest.mark.cuda
@pytest.mark.parametrize("regime", ["quantized", "float"])
def test_kernels_equal_the_plain_version_uncut(bench_scenes, regime):
    """A per-tile cap at the scene's every chunk: nothing cut."""
    scene, tiles, _ = bench_scenes[regime]
    _, bounds, dropped, cut = _held(tiles, scene, per_tile_cap=2 ** 15,
                                    total_pair_cap=2 ** 24)
    assert int(cut) == 0 and int(dropped) == 0 and int(bounds[-1]) > 0


def cell_env_inputs(device):
    """envgs-train's scene (benchmark/configs/envgs-sedan-refl.json) at
    full size, one view's reflected rays: (scene, tiles, per-tile cap,
    slot budget)."""
    import json

    from benchmark.families.envgs_refl import make_inputs
    from benchmark.families.envgs_train import make_pool
    from envgs_tpu_torch.models import envgs, gaussians
    from envgs_tpu_torch.utils.camera import Camera

    root = Path(__file__).resolve().parents[1] / "benchmark"
    cfg = json.loads((root / "configs" / "envgs-sedan-refl.json").read_text())
    traffic = json.loads((root / "traffic" / "train-from-10k.json")
                         .read_text())
    inputs = make_inputs(cfg, traffic, 2 ** 31 + 22, device)
    base = make_pool(gaussians, inputs.scene["base"], cfg["sh_degree"])
    env = make_pool(gaussians, inputs.scene["env"], cfg["sh_degree"])
    model = envgs.EnvGSConfig(
        specular_channels=cfg["specular_channels"], pair_cap=cfg["pair_cap"],
        env_pair_cap=cfg["env_pair_cap"],
        env_per_tile_cap=cfg["env_per_tile_cap"], render_mode=True)
    K, R, T = inputs.views[0]
    cam = Camera(cfg["height"], cfg["width"], K, R, T, cfg["znear"],
                 cfg["zfar"])
    with torch.no_grad():
        ref_o, ref_d = envgs.reflect_rays(cam, envgs.render_base(base, cam,
                                                                 model))
        scene = prepare_trace_scene(
            env.params.xyz, env.params.rotation, env.get_scaling,
            env.get_opacity[:, 0], envgs._pool_colors_at(env, ref_o))
    return (scene, tracer.build_ray_tiles(ref_o, ref_d),
            model.env_per_tile_cap, model.env_pair_cap)


@pytest.mark.cuda
def test_kernels_equal_the_plain_version_at_the_cells_size(cuda):
    """envgs-train's scene and caps (2^19 a tile, 2^26 slots): the same
    integer outputs; the plain version holds a (tiles, 2^19) plane."""
    scene, tiles, cap, total = cell_env_inputs(cuda)
    assert scene.mean.shape[0] >= FLOAT_P
    _, bounds, dropped, cut = _held(tiles, scene, per_tile_cap=cap,
                                    total_pair_cap=total)
    assert int(cut) == 0 and int(dropped) == 0 and int(bounds[-1]) > 0


@pytest.mark.cuda
def test_the_kernels_wait_for_nothing(bench_scenes):
    """cull_and_sort on CUDA tensors under set_sync_debug_mode("error"):
    no host synchronisation, in the chunk index or the kernels."""
    scene, tiles, pair_cap = bench_scenes["float"]
    r3 = tracer.splat_radius3(scene)
    tracer.cull_and_sort(tiles, scene, r3, per_tile_cap=2048,
                         total_pair_cap=pair_cap)  # built and loaded
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = tracer.cull_and_sort(tiles, scene, r3, per_tile_cap=2048,
                                   total_pair_cap=pair_cap)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert int(out[1][-1]) > 0


@pytest.mark.cuda
def test_a_training_step_launches_the_cull(cuda):
    """bench's train scene, one step with the reflection on and the
    profiler's spans recording: the cull's kernels launched, `env.met`
    counted in the env.cull span."""
    from envgs_tpu_torch import bench
    from envgs_tpu_torch.train.trainer import init_train_state
    from envgs_tpu_torch.utils import timer

    base, env, cam, cfg, batch = bench.make_train_scene(cuda)
    step = bench.make_bench_step(cam, cfg)
    state = init_train_state(base, env)
    step(state, batch, cam.K, cam.R, cam.T, bench.TRAIN_IT)
    n = kernels.LAUNCHES["env_cull"]
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        step(state, batch, cam.K, cam.R, cam.T, bench.TRAIN_IT)
    assert kernels.LAUNCHES["env_cull"] > n
    root = timer.read_spans()[-1]
    assert root["name"] == "train.step"
    assert root["counts"]["env.met"] >= root["counts"]["env.cut"]
    assert root["counts"]["env.met"] > 0
