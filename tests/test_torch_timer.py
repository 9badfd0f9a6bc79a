"""The program's spans and counters (`utils/timer.py`) on tiny 3DGS and
EnvGS train steps on the CPU: nothing is recorded without a profiler; under
`torch.profiler.profile` a step records train.step > train.forward >
render > {render.project, render.bin} (EnvGS: then render.reflect and,
with the reflection on, render.env > {env.tiles, env.cull, env.blend}),
then train.backward, one root a step, with the binning's counters (and the
env cull's); each span is a user annotation of the profiler's own trace,
the step's ops inside it; and the spans and counters add no aten op to the
step."""
import collections
import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils._python_dispatch import TorchDispatchMode

from envgs_tpu_torch import bench
from envgs_tpu_torch.models import gaussiant
from envgs_tpu_torch.models.envgs import forward_envgs
from envgs_tpu_torch.models.gaussians import create_pool
from envgs_tpu_torch.train.trainer import init_train_state
from envgs_tpu_torch.utils import timer
from envgs_tpu_torch.utils.camera import make_camera
from torch_threads import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

H, W = 32, 48
# each family's render spans, in the order they open
RENDER = {"gs3d": ["render", "render.project", "render.bin"]}
RENDER["envgs"] = RENDER["gs3d"] + ["render.reflect"]
RENDER["envgs_refl"] = RENDER["envgs"] + ["render.env", "env.tiles",
                                          "env.cull", "env.blend"]
STEP = {f: ["train.step", "train.forward", *r, "train.backward"]
        for f, r in RENDER.items()}
# each span's parent within a step
PARENT = {"train.forward": "train.step", "render": "train.forward",
          "render.project": "render", "render.bin": "render",
          "render.reflect": "render", "render.env": "render",
          "env.tiles": "render.env", "env.cull": "render.env",
          "env.blend": "render.env", "train.backward": "train.step"}
COUNTS = {"gs3d": {"bin.pairs", "bin.kept", "bin.slots"}}
COUNTS["envgs"] = COUNTS["gs3d"]
COUNTS["envgs_refl"] = COUNTS["gs3d"] | {"env.met", "env.pairs",
                                         "env.slots", "env.cut"}
FAMILIES = ("gs3d", "envgs", "envgs_refl")


def _gs3d():
    """(step(), render()) of a tiny 3DGS scene: 200 Gaussians at 48x32."""
    rng = np.random.default_rng(0)
    P = 200
    xyz = np.concatenate([rng.normal(size=(P, 2)) * 0.5,
                          rng.normal(size=(P, 1)) * 0.3 + 3.0],
                         -1).astype(np.float32)
    pool = create_pool(xyz, rng.random((P, 3)).astype(np.float32), cap=256,
                       sh_degree=1, init_opacity=0.5, scale_axes=3,
                       device="cpu")
    K = np.array([[40.0, 0, W / 2], [0, 40.0, H / 2], [0, 0, 1]], np.float32)
    cam = make_camera(H, W, K, np.eye(3, dtype=np.float32),
                      np.zeros(3, np.float32), 0.02, 100.0, device="cpu")
    cfg = gaussiant.GaussianTConfig(sh_degree=1, pair_cap=2 ** 12)
    state = gaussiant.init_gaussiant_state(pool)
    target = torch.tensor(rng.random((H, W, 3)).astype(np.float32))
    step = gaussiant.make_gaussiant_train_step(cfg, cam)

    def render():
        with torch.no_grad():
            return gaussiant.render_gaussiant(pool, cam, cfg)

    return lambda: step(state, cam.K, cam.R, cam.T, target), render


def _envgs(reflection_start_iter=10 ** 6):
    """(step(), render()) of a tiny EnvGS scene at 48x32, by default before
    the reflection starts (the base pass alone, as envgs-train-early runs
    it)."""
    base, env, cam, cfg, batch = bench.make_train_scene(
        "cpu", P=200, Pe=64, Ht=H, Wt=W, base_scale=0.05)
    cfg = cfg._replace(pair_cap=2 ** 12, env_pair_cap=2 ** 12,
                       reflection_start_iter=reflection_start_iter)
    state = init_train_state(base, env)
    step = bench.make_bench_step(cam, cfg)

    def render():
        with torch.no_grad():
            return forward_envgs(base, env, cam, bench.TRAIN_IT,
                                 cfg._replace(render_mode=True))

    return (lambda: step(state, batch, cam.K, cam.R, cam.T, bench.TRAIN_IT),
            render)


MAKE = {"gs3d": _gs3d, "envgs": _envgs,
        "envgs_refl": lambda: _envgs(reflection_start_iter=0)}


@pytest.fixture(autouse=True)
def empty_record():
    timer.RECORD.clear()
    yield
    timer.RECORD.clear()


def _profiled(fn, n=1):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(n):
            fn()
    return prof


def test_off_a_span_is_one_shared_object_and_a_count_nothing():
    assert not torch.autograd._profiler_enabled()
    assert timer.span("a") is timer.span("b")
    with timer.span("a"):
        timer.count("n", torch.ones(()))
    assert not timer.RECORD and timer.read_spans() == []


@pytest.mark.parametrize("family", FAMILIES)
def test_without_a_profiler_a_step_records_nothing(family):
    step, render = MAKE[family]()
    step()
    render()
    assert not timer.RECORD and timer.read_spans() == []


@pytest.mark.parametrize("family", FAMILIES)
def test_a_profiled_step_records_its_tree_and_counters(family):
    step, _ = MAKE[family]()
    _profiled(step, n=2)
    assert len(timer.RECORD) == 2
    roots = set()
    for spans in timer.RECORD:
        root = spans[0]
        assert root.name == "train.step" and root.parent is None
        assert [s.name for s in spans] == STEP[family]
        for s in spans[1:]:
            assert s.root == root.root and s.parent is not None
            assert s.parent.name == PARENT[s.name]
            assert s.t0 <= s.t1 and s.parent.t0 <= s.t0 <= s.parent.t1
        forward, backward = spans[1], spans[-1]
        assert forward.t1 <= backward.t0
        roots.add(root.root)
    assert len(roots) == 2
    for r in timer.read_spans():
        assert r["name"] == "train.step"
        assert set(r["host_ms"]) == set(STEP[family])
        assert r["device_ms"] == {}  # no CUDA event on the CPU
        c = r["counts"]
        assert set(c) == COUNTS[family]
        assert 0 < c["bin.kept"] <= min(c["bin.pairs"], c["bin.slots"])
        assert c["bin.slots"] == 32768  # the cap rounded to the layout's
        if "env.cut" in c:  # the 64-surfel env set is one chunk: none cut
            assert 0 < c["env.pairs"] <= c["env.slots"]
            assert c["env.cut"] == 0 < c["env.met"]


@pytest.mark.parametrize("family", FAMILIES)
def test_a_render_alone_is_a_root(family):
    _, render = MAKE[family]()
    _profiled(render)
    (spans,) = timer.RECORD
    assert [s.name for s in spans] == RENDER[family]
    assert spans[0].parent is None
    assert all(s.parent.name == PARENT[s.name] for s in spans[1:])


@pytest.mark.parametrize("family", FAMILIES)
def test_spans_are_annotations_of_the_profilers_trace(family, tmp_path):
    step, _ = MAKE[family]()
    prof = _profiled(step)
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    ann = collections.defaultdict(list)
    for e in events:
        if e.get("cat") == "user_annotation" and e.get("ph") == "X":
            ann[e["name"]].append((e["ts"], e["ts"] + e["dur"]))
    (spans,) = timer.RECORD
    for name in STEP[family]:
        assert len(ann[name]) == sum(s.name == name for s in spans)

    def inside(a, b):
        return b[0] <= a[0] and a[1] <= b[1]

    (bin_,), (fwd,) = ann["render.bin"], ann["train.forward"]
    cummax = [(e["ts"], e["ts"] + e["dur"]) for e in events
              if e.get("cat") == "cpu_op" and e["name"] == "aten::cummax"]
    assert cummax and all(inside(c, bin_) for c in cummax)
    assert inside(bin_, fwd)
    if "render.env" in STEP[family]:
        (env,), (cull,) = ann["render.env"], ann["env.cull"]
        assert inside(cull, env) and inside(env, fwd)
    (bwd,) = ann["train.backward"]
    assert fwd[1] <= bwd[0]


class AtenOps(TorchDispatchMode):
    """Counts the aten ops dispatched under it, by overload."""

    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.name()
        if name.startswith("aten::"):
            self.ops[name] += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("family", FAMILIES)
def test_the_spans_add_no_op_to_a_step(family):
    step, _ = MAKE[family]()
    with AtenOps() as off:
        step()
    with profile(activities=[ProfilerActivity.CPU]):
        with AtenOps() as on:
            step()
    assert len(timer.RECORD) == 1
    assert off.ops and on.ops == off.ops
