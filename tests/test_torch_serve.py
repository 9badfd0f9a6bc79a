"""The port's websocket render server (serve/websocket_server.py) against
the JAX package's: the CAM0 protocol bytes, the JPEG bytes, the 8 render
types' maps, the hello frame, the browser viewer's page; then a real
loopback websocket (127.0.0.1, a free port) in front of the port's Runner
on a 2-view 16x16 scene: frames against render_view, a render-type switch,
the overlays against JAX's payloads, a camera path saved by the port and
read by JAX's read_cameras, `watch` attaching to a checkpoint JAX's Runner
wrote, and `cli.main(["ws", ...])` serving a frame from a thread."""
import asyncio
import io
import json
import os
import threading
import types

import numpy as np
import pytest
import torch

from envgs_tpu.serve import websocket_server as jws
from envgs_tpu_torch import cli
from envgs_tpu_torch.serve import websocket_server as tws
from torch_threads import one_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

pytestmark = pytest.mark.usefixtures("one_thread")


def _cam_bytes(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(3, 3)).astype(np.float32),
            rng.normal(size=(3, 3)).astype(np.float32),
            rng.normal(size=3).astype(np.float32))


def test_protocol_bytes_equal_jax():
    K, R, T = _cam_bytes()
    msg = tws.encode_camera(K, R, T)
    assert msg == jws.encode_camera(K, R, T) and len(msg) == 88
    for got, want in zip(tws.decode_camera(msg), jws.decode_camera(msg)):
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype
    with pytest.raises(AssertionError):
        tws.decode_camera(b"CAM1" + msg[4:])


def test_jpeg_bytes_equal_jax():
    rgb = np.random.default_rng(1).uniform(-0.1, 1.1, (20, 30, 3)).astype(
        np.float32)
    rgb[0, 0] = np.nan
    assert tws.encode_jpeg(rgb) == jws.encode_jpeg(rgb)
    assert tws.encode_jpeg(rgb, 50) == jws.encode_jpeg(rgb, 50)


def _fake_output(seed=2, H=12, W=10):
    rng = np.random.default_rng(seed)
    f = {k: rng.normal(size=(H, W, c)).astype(np.float32) for k, c in (
        ("rgb_map", 3), ("dif_rgb_map", 3), ("ref_rgb_map", 3),
        ("spec_map", 1), ("acc_map", 1), ("dpt_map", 1), ("norm_map", 3),
        ("surf_norm_map", 3))}
    return f


@pytest.mark.parametrize("kind", tws.RENDER_TYPES)
def test_typed_map_equals_jax(kind):
    assert tws.RENDER_TYPES == jws.RENDER_TYPES
    f = _fake_output()
    want = jws.typed_map(types.SimpleNamespace(**f), kind)
    got = tws.typed_map(types.SimpleNamespace(
        **{k: torch.tensor(v) for k, v in f.items()}), kind)
    assert got.shape == want.shape == (12, 10, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)


def test_viewer_page_is_jax_viewer():
    req = types.SimpleNamespace(headers={"Connection": "keep-alive"})
    resp = tws.viewer_page(None, req)
    with open(os.path.join(ROOT, "envgs_tpu", "serve", "viewer.html"),
              "rb") as fh:
        want = fh.read()
    assert resp.body == want and resp.status_code == 200
    assert resp.headers["Content-Length"] == str(len(want))
    up = types.SimpleNamespace(headers={"Connection": "Upgrade"})
    assert tws.viewer_page(None, up) is None


class _Conn:
    """An in-process connection: `send` collects, iteration yields the
    queued messages."""

    def __init__(self, msgs=()):
        self.sent, self.msgs = [], list(msgs)

    async def send(self, m):
        self.sent.append(m)

    def __aiter__(self):
        return self

    async def __anext__(self):
        if not self.msgs:
            raise StopAsyncIteration
        return self.msgs.pop(0)


def test_hello_frame_equals_jax():
    from envgs_tpu.utils.camera import make_camera as jcam
    from envgs_tpu_torch.utils.camera import make_camera as tcam

    K, R, T = _cam_bytes(3)
    views = lambda make: [{"camera": make(16, 24, K, R, T)}]  # noqa: E731
    sent = []
    for mod, make in ((tws, tcam), (jws, jcam)):
        conn = _Conn()
        srv = mod.RenderServer(types.SimpleNamespace(views=views(make)))
        asyncio.run(srv.handle(conn))
        sent.append(conn.sent)
    assert len(sent[0]) == len(sent[1]) == 1
    assert json.loads(sent[0][0]) == json.loads(sent[1][0])


def _cfg(out_root):
    cfg = cli.smoke_config()
    cfg["out_root"] = str(out_root)
    cfg["dataset_cfg"].update(H=16, W=16, n_views=2, eval_every=0)
    cfg["runner_cfg"]["record"] = False
    return cfg


def _serve(srv):
    """Serve `srv` on a free loopback port from a thread -> the thread."""
    t = threading.Thread(target=lambda: asyncio.run(srv.serve(
        host="127.0.0.1", port=0)), daemon=True)
    t.start()
    assert srv.ready.wait(60)
    return t


async def _session(port, steps):
    """steps: messages to send (bytes or a dict sent as JSON); after each,
    its reply: (JPEG, stats), a refusal's bytes or a control reply."""
    import websockets

    out = []
    async with websockets.connect(f"ws://127.0.0.1:{port}",
                                  max_size=2 ** 24) as ws:
        async def recv():
            return await asyncio.wait_for(ws.recv(), 120)

        out.append(json.loads(await recv()))  # hello
        for m in steps:
            await ws.send(m if isinstance(m, bytes) else json.dumps(m))
            r = await recv()
            if isinstance(r, str):
                out.append(json.loads(r))
            elif r.startswith(b"ERR"):
                out.append(r)
            else:
                out.append((r, json.loads(await recv())["stats"]))
    return out


def test_loopback_frames_overlays_paths(tmp_path):
    from envgs_tpu.utils.easycam import read_cameras as jread
    from envgs_tpu_torch.utils.fusion import save_mesh_ply

    runner = cli.make_runner(_cfg(tmp_path), device="cpu")
    cam = runner.views[1]["camera"]
    K, R, T = (x.numpy() for x in (cam.K, cam.R, cam.T))
    runner.save(0)  # base.ply / env.ply for the points overlay
    os.makedirs(runner.result_dir, exist_ok=True)
    rng = np.random.default_rng(4)
    save_mesh_ply(os.path.join(runner.result_dir, "mesh.ply"),
                  rng.normal(size=(30, 3)).astype(np.float32),
                  rng.integers(0, 30, (40, 3)))
    frames = [{"R": np.eye(3).ravel().tolist(), "T": [0.0, 0.1, 2.0]},
              {"R": R.ravel().tolist(), "T": T.ravel().tolist()}]
    srv = tws.RenderServer(runner)
    t = _serve(srv)
    try:
        out = asyncio.run(_session(srv.port, [
            tws.encode_camera(K, R, T), {"render_type": "DEPTH"},
            tws.encode_camera(K, R, T), b"CAMX", {"overlay": "points"},
            {"overlay": "mesh"}, {"overlay": "bogus"},
            {"save_path": frames}, {"load_path": None}]))
    finally:
        srv.stop()
        t.join(30)
    assert not t.is_alive()
    hello = out[0]
    assert (hello["H"], hello["W"]) == (16, 16) and not hello["watch"]
    assert hello["types"] == list(tws.RENDER_TYPES)
    ref = runner.render_view(cam)
    (jpeg, stats), switched, (jpeg2, stats2) = out[1], out[2], out[3]
    assert jpeg == tws.encode_jpeg(tws.typed_map(ref, "RENDER"))
    assert stats["type"] == "RENDER" and "iter" not in stats
    assert stats["jpeg_kb"] == round(len(jpeg) / 1024, 1)
    assert switched == {"render_type": "DEPTH"}
    assert jpeg2 == tws.encode_jpeg(tws.typed_map(ref, "DEPTH"))
    assert stats2["type"] == "DEPTH"
    assert out[4] == b"ERR bad camera"
    # the overlays: JAX's payloads from the same files
    jsrv = jws.RenderServer(types.SimpleNamespace(
        model_dir=runner.model_dir, result_dir=runner.result_dir))
    for got, kind in zip(out[5:8], ("points", "mesh", "bogus")):
        assert got == {"overlay": json.loads(json.dumps(
            jsrv._overlay_payload(kind)))}
    assert out[5]["overlay"]["kind"] == "points"
    # a camera path the port saved, read by JAX
    saved = out[8]["saved_path"]
    cams = jread(saved)
    assert sorted(cams) == ["0000", "0001"]
    for name, fr in zip(sorted(cams), frames):
        np.testing.assert_allclose(np.asarray(cams[name]["K"]), K,
                                   rtol=1e-6)
        np.testing.assert_allclose(np.asarray(cams[name]["R"]).ravel(),
                                   fr["R"], atol=1e-6)
        np.testing.assert_allclose(np.asarray(cams[name]["T"]).ravel(),
                                   fr["T"], atol=1e-6)
    loaded = out[9]["loaded_path"]
    assert loaded["name"] == os.path.basename(saved)
    assert np.allclose(loaded["frames"][1]["R"], frames[1]["R"], atol=1e-6)


def _frame(port, K, R, T):
    from PIL import Image

    out = asyncio.run(_session(port, [tws.encode_camera(K, R, T)]))
    jpeg, stats = out[1]
    return jpeg, stats, np.asarray(Image.open(io.BytesIO(jpeg)))


def test_watch_attaches_to_a_jax_checkpoint(tmp_path):
    """`watch`: the server loads the checkpoint JAX's Runner saved in the
    run's model_dir before the frame, reports its iteration, and renders
    its state."""
    from envgs_tpu import cli as jcli
    from envgs_tpu_torch.train import checkpoints as ckpt

    jcfg = jcli.Config.wrap(dict(_cfg(tmp_path).to_dict()))
    jcfg["model_cfg"]["sampler_cfg"]["raster_backend"] = "ref"
    jrunner = jcli.make_runner(jcfg)
    jrunner.save(77)
    runner = cli.make_runner(_cfg(tmp_path / "port"), device="cpu")
    runner.model_dir = jrunner.model_dir  # attach to JAX's run
    srv = tws.RenderServer(runner, watch=True)
    t = _serve(srv)
    cam = runner.views[0]["camera"]
    try:
        jpeg, stats, _ = _frame(srv.port, *(x.numpy() for x in (
            cam.K, cam.R, cam.T)))
    finally:
        srv.stop()
        t.join(30)
    assert stats["iter"] == 77 and srv.attached_iter == 77
    want, it = ckpt.load_checkpoint(ckpt.find_latest(jrunner.model_dir),
                                    runner.state.base.cap,
                                    runner.state.env.cap, device="cpu")
    assert it == 77
    np.testing.assert_array_equal(runner.state.base.params.xyz.numpy(),
                                  want.base.params.xyz.numpy())
    assert jpeg == tws.encode_jpeg(tws.typed_map(runner.render_view(cam),
                                                 "RENDER"))


def test_cli_ws_serves_a_frame(tmp_path, monkeypatch):
    import yaml

    made = []

    class Recorded(tws.RenderServer):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    monkeypatch.setattr(tws, "RenderServer", Recorded)
    path = tmp_path / "ws.yaml"
    path.write_text(yaml.safe_dump(_cfg(tmp_path).to_dict()))
    t = threading.Thread(target=cli.main, args=(
        ["ws", "-c", str(path), "--port", "0"],), kwargs=dict(device="cpu"),
        daemon=True)
    t.start()
    for _ in range(600):
        if made and made[0].ready.is_set():
            break
        t.join(0.1)
    srv = made[0]
    try:
        cam = srv.runner.views[0]["camera"]
        K, R, T = (x.numpy() for x in (cam.K, cam.R, cam.T))
        img = asyncio.run(tws.request_frame(
            f"ws://127.0.0.1:{srv.port}", K, R, T))
    finally:
        srv.stop()
        t.join(30)
    assert not t.is_alive()
    from PIL import Image

    want = tws.encode_jpeg(tws.typed_map(srv.runner.render_view(cam),
                                         "RENDER"))
    np.testing.assert_array_equal(
        (img * 255).round().astype(np.uint8),
        np.asarray(Image.open(io.BytesIO(want))))
