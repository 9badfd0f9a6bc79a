"""The port's `render`, `mesh`, `dist` and `sig` modes, `--debug-nans` and the
runner's recorder, on the CPU: `Runner.render_path` writes one frame per
camera of the JAX package's path, each the port's own render of that
camera; `render` resumes the checkpoint `smoke` left and writes its frames;
`dist` trains; `sig` signals the python processes the JAX package's `sig`
signals and no other."""
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from envgs_tpu import cli as jcli
from envgs_tpu.utils import camera as jcam
from envgs_tpu_torch import cli
from envgs_tpu_torch.train.evaluator import _to_u8
from envgs_tpu_torch.utils.easycam import write_cameras
from torch_threads import one_thread  # noqa: F401

# the smoke run cut down to the CPU (4 views of 32x32, 4 iterations)
SMALL = ["dataset_cfg.H=32", "dataset_cfg.W=32", "dataset_cfg.n_views=4",
         "runner_cfg.ep_iter=4", "runner_cfg.log_interval=2",
         "model_cfg.sampler_cfg.reflection_start_iter=2"]


pytestmark = pytest.mark.usefixtures("one_thread")


def _frames(d, kind="RENDER"):
    return sorted(os.listdir(os.path.join(d, kind)))


def _small_runner(tmp_path, **rcfg):
    from envgs_tpu_torch.engine import Config, merge_dotted

    cfg = cli.smoke_config().to_dict()
    cfg["out_root"] = str(tmp_path / "data")
    cfg["runner_cfg"].update(rcfg)
    return cli.make_runner(Config.wrap(merge_dotted(cfg, SMALL)), "cpu")


@pytest.mark.parametrize("kind", ["orbit", "linear"])
def test_render_path_renders_the_jax_path(tmp_path, kind):
    """Each frame is the port's render_view of the camera the JAX package's
    camera_path_interpolate makes from the same views, as a PNG; DEPTH
    frames beside RENDER; no ground truth or error panels."""
    runner = _small_runner(tmp_path, record=False)
    out = runner.render_path(n_frames=3, kind=kind, tag="p",
                             types=("RENDER", "DEPTH"))
    assert out == os.path.join(runner.result_dir, "p")
    names = [f"frame0000_camera{i:04d}.png" for i in range(3)]
    assert _frames(out) == _frames(out, "DEPTH") == names
    jviews = [jcam.make_camera(c.H, c.W, c.K.numpy(), c.R.numpy(),
                               c.T.numpy(), c.znear, c.zfar)
              for c in (v["camera"] for v in runner.views)]
    want = jcam.camera_path_interpolate(jviews, 3, kind=kind)
    from envgs_tpu_torch.utils.camera import camera_path_interpolate

    path = camera_path_interpolate([v["camera"] for v in runner.views], 3,
                                   kind=kind)
    for i, (cam, w) in enumerate(zip(path, want)):
        for name in ("K", "R", "T"):
            np.testing.assert_allclose(getattr(cam, name).numpy(),
                                       np.asarray(getattr(w, name)),
                                       atol=1e-5)
        img = np.asarray(Image.open(os.path.join(out, "RENDER", names[i])))
        rgb = runner.render_view(cam).rgb_map.numpy()
        np.testing.assert_array_equal(img, _to_u8(rgb))
        assert img.std() > 1.0  # the scene is in view
    assert not os.path.exists(os.path.join(runner.result_dir,
                                           "metrics.json"))


def test_render_path_reads_a_saved_camera_path(tmp_path):
    """With path_dir, the keyframes are the cameras of intri.yml /
    extri.yml (interpolated as cubic) and the frames go where `render`
    puts them."""
    runner = _small_runner(tmp_path, record=False)
    cams = {f"{i}": {"K": v["camera"].K.numpy(), "R": v["camera"].R.numpy(),
                     "T": v["camera"].T.numpy()}
            for i, v in enumerate(runner.views[:2])}
    write_cameras(cams, str(tmp_path / "path"))
    out = runner.render_path(n_frames=2, tag="file",
                             path_dir=str(tmp_path / "path"))
    first = np.asarray(Image.open(os.path.join(out, "RENDER",
                                               _frames(out)[0])))
    np.testing.assert_array_equal(
        first, _to_u8(runner.render_view(runner.views[0]["camera"])
                      .rgb_map.numpy()))


def test_smoke_then_render_and_dist(tmp_path, monkeypatch, capsys):
    """`smoke`, then `render -c <config>` resumes its checkpoint and writes
    one frame per path camera, and `mesh -c <config> --mesh-res 32` from
    the same checkpoint writes a non-empty mesh ply; the recorder left its
    config and events; `dist` trains and evaluates as `train` does."""
    from envgs_tpu_torch.utils.fusion import load_mesh_ply

    monkeypatch.chdir(tmp_path)
    cli.main(["smoke", *SMALL], device="cpu")
    record = tmp_path / "data" / "record" / "smoke"
    with open(record / "config.yaml") as f:
        assert yaml.safe_load(f)["runner_cfg"]["ep_iter"] == 4
    assert list(record.glob("events.out.tfevents.*"))
    cfg = cli.smoke_config().to_dict()
    cfg["runner_cfg"]["resume"] = True
    with open(tmp_path / "smoke.yaml", "w") as f:
        yaml.safe_dump(cfg, f)
    capsys.readouterr()
    out = cli.main(["render", "-c", "smoke.yaml", "--path-kind", "spiral",
                    "--path-frames", "4", *SMALL], device="cpu")
    printed = capsys.readouterr().out
    assert "[resume]" in printed and "@ iter 4" in printed
    assert out == os.path.join("data", "result", "smoke", "spiral")
    assert _frames(out) == [f"frame0000_camera{i:04d}.png" for i in range(4)]
    mesh = cli.main(["mesh", "-c", "smoke.yaml", "--mesh-res", "32", *SMALL],
                    device="cpu")
    assert mesh == os.path.join("data", "result", "smoke", "mesh.ply")
    verts, faces = load_mesh_ply(mesh)
    assert len(faces) > 0 and len(verts) == 3 * len(faces)
    assert np.isfinite(verts).all()
    cfg.update(exp_name="dist")
    cfg["runner_cfg"].update(resume=False, record=False)
    with open(tmp_path / "dist.yaml", "w") as f:
        yaml.safe_dump(cfg, f)
    summary = cli.main(["dist", "-c", "dist.yaml", *SMALL], device="cpu")
    assert np.isfinite(summary["summary"]["psnr_mean"])
    assert (tmp_path / "data" / "trained_model" / "dist" / "4.npz").exists()
    assert not (tmp_path / "data" / "record" / "dist").exists()


def _child(tmp_path, tag, *argv):
    """A python process that counts the SIGUSR1 / SIGUSR2 it receives into
    files and lives until killed; its command line holds argv."""
    code = ("import os,signal,sys,time\n"
            "def on(s, _f):\n"
            "    open(sys.argv[1] + '.' + str(s), 'a').write('x')\n"
            "signal.signal(signal.SIGUSR1, on)\n"
            "signal.signal(signal.SIGUSR2, on)\n"
            "open(sys.argv[1] + '.ready', 'w').close()\n"
            "time.sleep(120)\n")
    stem = str(tmp_path / tag)
    proc = subprocess.Popen([sys.executable, "-c", code, stem, *argv])
    return proc, stem


def _received(stem, sig):
    path = f"{stem}.{int(sig)}"
    return len(open(path).read()) if os.path.exists(path) else 0


@pytest.mark.parametrize("which", ["usr1", "usr2"])
def test_sig_signals_what_the_jax_package_signals(tmp_path, which):
    import signal

    name = f"run-{os.getpid()}-{which}"
    sig = signal.SIGUSR1 if which == "usr1" else signal.SIGUSR2
    match, m_stem = _child(tmp_path, "match", "envgs_tpu_torch", "-c", name)
    other, o_stem = _child(tmp_path, "other", "envgs_tpu_torch", "-c",
                           "another-run")
    shell = subprocess.Popen(["sh", "-c", "sleep 120", "envgs_tpu", name])
    try:
        deadline = time.time() + 30
        while not all(os.path.exists(f"{s}.ready") for s in (m_stem,
                                                              o_stem)):
            assert time.time() < deadline
            time.sleep(0.05)
        hits = cli.main(["sig", "--name", name, "--signal", which],
                        device="cpu")
        assert [pid for pid, _ in hits] == [match.pid]
        for n in (1, 2):  # the port's, then (once it landed) JAX's
            while _received(m_stem, sig) < n:
                assert time.time() < deadline
                time.sleep(0.05)
            if n == 1:
                jcli.main(["sig", "--name", name, "--signal", which])
        assert _received(o_stem, sig) == 0 and other.poll() is None
        assert shell.poll() is None  # not python: left alone
        assert match.poll() is None
        other_sig = signal.SIGUSR2 if which == "usr1" else signal.SIGUSR1
        assert _received(m_stem, other_sig) == 0
        assert cli.main(["sig", "--name", "no-such-run-anywhere"]) == []
    finally:
        for p in (match, other, shell):
            p.kill()
            p.wait()


def test_debug_nans_turns_on_anomaly_detection():
    assert not torch.is_anomaly_enabled()
    try:
        cli.main(["sig", "--name", "no-such-run-anywhere", "--debug-nans"],
                 device="cpu")
        assert torch.is_anomaly_enabled()
        x = torch.tensor([0.0], requires_grad=True)
        with pytest.raises(RuntimeError, match="nan"):
            (torch.sqrt(x) * 0.0).sum().backward()  # 0 * inf in the backward
    finally:
        torch.autograd.set_detect_anomaly(False)


def test_sig_without_a_name_is_a_usage_error():
    with pytest.raises(SystemExit):
        cli.main(["sig"], device="cpu")
