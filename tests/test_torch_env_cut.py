"""The env cull's per-tile cap, configured and counted (`ops/tracer.py::
cull_and_sort`'s `cut`, TraceOutput.cut_chunks, EnvGSOutput.env_cut_chunks,
the train step's `trace_cut`), on tiny scenes on the CPU.

- by default (`EnvGSConfig()`, env_per_tile_cap None) the env pass traces
  with the JAX package's cap, 2048;
- the count equals a brute-force count of the chunks whose bounding
  sphere meets a tile's cone past the nearest the cap keeps, and reads 0
  with a cap at or above every tile's need;
- the count reaches the model's output and the step's stats;
- on the card (`-m cuda`), envgs-train's configured cap on its own scene
  at full size."""
import math

import pytest
import torch

from envgs_tpu_torch import bench
from envgs_tpu_torch.models import envgs
from envgs_tpu_torch.ops import tracer
from envgs_tpu_torch.ops.raster_blend import CHUNK
from envgs_tpu_torch.ops.tracer_ref import prepare_trace_scene
from envgs_tpu_torch.train.trainer import init_train_state
from torch_threads import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

H, W = 32, 48


def _dome_rays(P=1280, seed=0):
    """An env set of P surfels on a dome of radius 20 and a fan of rays
    from near its centre, each 16x16 tile's rays spread over ~0.4 rad."""
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
    return scene, o, d


def _met(tiles, scene) -> list:
    """Per tile, the chunks whose bounding sphere meets its cone, by the
    coarse test written out one (tile, chunk) at a time."""
    idx = tracer.build_chunk_index(scene, tracer.splat_radius3(scene))
    out = []
    for t in range(tiles.n_tiles):
        apex, axis = tiles.apex[t].tolist(), tiles.axis[t].tolist()
        tan, spread = float(tiles.tan_half[t]), float(tiles.spread[t])
        n = 0
        for c in range(idx.cmean.shape[0]):
            if not bool(idx.cact[c]):
                continue
            v = [float(idx.cmean[c, i]) - apex[i] for i in range(3)]
            proj = sum(v[i] * axis[i] for i in range(3))
            d2 = sum(x * x for x in v)
            off = math.sqrt(max(d2 - proj * proj, 0.0))
            r = float(idx.crad[c])
            slack = spread + r * (1.0 + tan)
            hit = off <= proj * tan + slack or d2 <= slack * slack
            n += bool(hit and proj + r > 0)
        out.append(n)
    return out


@pytest.mark.parametrize("cap", [64, 128, 256])
def test_the_cut_count_is_the_brute_force_count(cap):
    scene, o, d = _dome_rays()
    tiles = tracer.build_ray_tiles(o, d)
    met = _met(tiles, scene)
    want = sum(max(m - cap // CHUNK, 0) for m in met)
    assert want > 0  # the fan meets more chunks than the cap keeps
    *_, cut = tracer.cull_and_sort(tiles, scene, tracer.splat_radius3(scene),
                                   per_tile_cap=cap, tile_block=5)
    assert int(cut) == want
    full = max(met) * CHUNK
    *_, cut = tracer.cull_and_sort(tiles, scene, tracer.splat_radius3(scene),
                                   per_tile_cap=full)
    assert int(cut) == 0


def test_a_cap_at_the_need_keeps_the_uncut_outputs():
    """Outputs at a cap that cuts nothing equal those at twice that cap; a
    cap that cuts changes them and says so."""
    scene, o, d = _dome_rays()
    bg = torch.zeros(3)
    need = max(_met(tracer.build_ray_tiles(o, d), scene)) * CHUNK
    a = tracer.trace_rays(scene, o, d, bg, per_tile_cap=need,
                          total_pair_cap=None)
    b = tracer.trace_rays(scene, o, d, bg, per_tile_cap=2 * need,
                          total_pair_cap=None)
    c = tracer.trace_rays(scene, o, d, bg, per_tile_cap=CHUNK,
                          total_pair_cap=None)
    assert int(a.cut_chunks) == int(b.cut_chunks) == 0 < int(c.cut_chunks)
    for k in ("rgb", "acc", "dpt", "trans"):
        assert torch.equal(getattr(a, k), getattr(b, k)), k
    assert not torch.equal(a.rgb, c.rgb)


def _scene(Pe):
    base, env, cam, cfg, batch = bench.make_train_scene(
        "cpu", P=200, Pe=Pe, Ht=H, Wt=W, base_scale=0.05)
    return base, env, cam, cfg._replace(pair_cap=2 ** 12,
                                        env_pair_cap=2 ** 16), batch


def test_the_default_cap_is_the_jax_packages(monkeypatch):
    """EnvGSConfig() leaves the cap to trace_rays, which takes
    default_per_tile_cap: 2048 for an env set of more than 2048 surfels;
    the render equals one with the cap set to 2048, bit for bit."""
    assert envgs.EnvGSConfig().env_per_tile_cap is None
    base, env, cam, cfg, _ = _scene(Pe=2560)
    assert tracer.default_per_tile_cap(2560) == 2048
    seen = []
    real = tracer.cull_and_sort

    def spy(*a, **kw):
        seen.append(kw["per_tile_cap"])
        return real(*a, **kw)

    monkeypatch.setattr(tracer, "cull_and_sort", spy)
    cfg = cfg._replace(render_mode=True)
    with torch.no_grad():
        a = envgs.forward_envgs(base, env, cam, bench.TRAIN_IT, cfg)
        b = envgs.forward_envgs(base, env, cam, bench.TRAIN_IT,
                                cfg._replace(env_per_tile_cap=2048))
    assert seen == [2048, 2048]
    for k in ("rgb_map", "env_rgb_map", "env_acc_map", "env_num_pairs",
              "env_cut_chunks"):
        assert torch.equal(getattr(a, k), getattr(b, k)), k


def test_the_count_reaches_the_output_and_the_step():
    """A one-chunk cap on a 1280-surfel env set: the model's
    env_cut_chunks is the cull's own count on the same rays, and the
    train step reports it as trace_cut."""
    base, env, cam, cfg, batch = _scene(Pe=1280)
    cfg = cfg._replace(env_per_tile_cap=CHUNK)
    with torch.no_grad():
        out = envgs.forward_envgs(base, env, cam, bench.TRAIN_IT, cfg)
        scene = prepare_trace_scene(
            env.params.xyz, env.params.rotation, env.get_scaling,
            env.get_opacity[:, 0],
            envgs._pool_colors_at(env, out.ref_o), active=env.stats.active)
        *_, cut = tracer.cull_and_sort(
            tracer.build_ray_tiles(out.ref_o, out.ref_d), scene,
            tracer.splat_radius3(scene), per_tile_cap=CHUNK,
            total_pair_cap=cfg.env_pair_cap)
    assert int(out.env_cut_chunks) == int(cut) > 0
    step = bench.make_bench_step(cam, cfg)
    _, stats = step(init_train_state(base, env), batch, cam.K, cam.R, cam.T,
                    bench.TRAIN_IT)
    assert int(stats["trace_cut"]) == int(cut)
    _, stats = bench.make_bench_step(cam, cfg._replace(
        env_per_tile_cap=None))(init_train_state(base, env), batch, cam.K,
                                cam.R, cam.T, bench.TRAIN_IT)
    assert int(stats["trace_cut"]) == 0


# ---- on the card ----

@pytest.mark.cuda
def test_the_cells_cap_on_its_scene_at_full_size():
    """envgs-train's scene (benchmark/configs/envgs-sedan-refl.json) at
    full size, one view's reflected rays: at the configured cap nothing is
    cut or dropped; at the JAX package's 2048 chunks are cut; at the least
    power of two that cuts nothing the outputs equal those at twice it
    (kept at or under the configured cap)."""
    if not torch.cuda.is_available():
        pytest.skip("the cell's scene at full size needs the card")
    import json
    from pathlib import Path

    from benchmark.families.envgs_refl import make_inputs
    from benchmark.families.envgs_train import make_pool
    from envgs_tpu_torch.models import gaussians
    from envgs_tpu_torch.utils.camera import Camera

    root = Path(__file__).resolve().parents[1] / "benchmark"
    cfg = json.loads((root / "configs" / "envgs-sedan-refl.json").read_text())
    traffic = json.loads((root / "traffic" / "train-from-10k.json")
                         .read_text())
    inputs = make_inputs(cfg, traffic, 2 ** 31 + 21, "cuda")
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
        bg = torch.zeros(3, device="cuda")

        def trace(cap):
            return tracer.trace_rays(scene, ref_o, ref_d, bg,
                                     per_tile_cap=cap,
                                     total_pair_cap=model.env_pair_cap,
                                     needs=(True, False, True))

        cut = {cap: int(trace(cap).cut_chunks)
               for cap in (None, model.env_per_tile_cap)}
        assert cut[None] > 0 and cut[model.env_per_tile_cap] == 0
        need = model.env_per_tile_cap
        while int(trace(need // 2).cut_chunks) == 0:
            need //= 2
        if need == model.env_per_tile_cap:
            need //= 2  # this view needs the whole cap: compare below it
        a, b = trace(need), trace(2 * need)
        assert int(a.dropped_pairs) == int(b.dropped_pairs) == 0
        if int(a.cut_chunks) == 0:
            for k in ("rgb", "acc", "dpt", "norm", "trans"):
                assert torch.equal(getattr(a, k), getattr(b, k)), k
        else:  # a cut changes what the tiles blend
            assert int(b.cut_chunks) == 0 and not torch.equal(a.rgb, b.rgb)
