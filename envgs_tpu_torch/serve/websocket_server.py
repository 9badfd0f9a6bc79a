"""WebSocket remote-render server and client (port of
envgs_tpu/serve/websocket_server.py): the client streams camera poses, the
server renders each with the current model state (`Runner.render_view`:
K1 and K3 once a frame on the card), JPEG-encodes it and streams it back.

Protocol:
  server -> client on connect: one text frame, JSON {"H", "W", "K": [9],
      "R": [9], "T": [3], "types", "watch"}: the first training view, so
      that a client can seed its camera.
  client -> server: b"CAM0" + float32 K (3x3) + R (3x3) + T (3), little-
      endian, C order, binary (`encode_camera`); or a text frame of JSON
      control messages: {"render_type": one of RENDER_TYPES}, {"overlay":
      "points" | "mesh" | "off"}, {"save_path": [{"R", "T"}, ...]},
      {"load_path": name or null}.
  server -> client: the JPEG of the render, binary, then a text frame
      {"stats": {"render_ms", "encode_ms", "jpeg_kb", "type"[, "iter"]}}.

A plain HTTP GET on the same port serves the browser viewer
(`viewer.html`). The render runs off the event loop, in an executor.
`websockets` and PIL are imported where they are used.

    python -m envgs_tpu_torch.serve.websocket_server -c <config> \
        [--port 8765] [--watch]
"""
from __future__ import annotations

import argparse
import asyncio
import io
import json
import os
import struct
import threading
import time

import numpy as np


def encode_jpeg(rgb: np.ndarray, quality: int = 85) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(
        np.clip(np.nan_to_num(rgb) * 255, 0, 255).astype(np.uint8)
    ).save(buf, format="JPEG", quality=quality)
    return buf.getvalue()


def decode_camera(payload: bytes):
    """A CAM0 frame -> (K (3, 3), R (3, 3), T (3,)) float32 arrays."""
    assert payload[:4] == b"CAM0", "bad camera frame"
    vals = struct.unpack("<21f", payload[4:4 + 84])
    K = np.asarray(vals[:9], np.float32).reshape(3, 3)
    R = np.asarray(vals[9:18], np.float32).reshape(3, 3)
    T = np.asarray(vals[18:21], np.float32)
    return K, R, T


def encode_camera(K, R, T) -> bytes:
    vals = [np.asarray(a, np.float32).ravel() for a in (K, R, T)]
    return b"CAM0" + struct.pack("<21f", *np.concatenate(vals))


RENDER_TYPES = ("RENDER", "DEPTH", "ALPHA", "NORMAL", "SURFACE_NORMAL",
                "SPECULAR", "DIFFUSE", "REFLECTION")


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)


def typed_map(out, render_type: str) -> np.ndarray:
    """EnvGSOutput -> the (H, W, 3) display image of a render type (the
    offline Visualizer's mapping, train/evaluator.py)."""
    from envgs_tpu_torch.train.evaluator import (
        colorize_depth,
        colorize_normal,
    )

    if render_type == "DEPTH":
        return colorize_depth(_np(out.dpt_map)[..., 0])
    if render_type == "ALPHA":
        return np.repeat(_np(out.acc_map), 3, -1)
    if render_type == "NORMAL":
        return colorize_normal(_np(out.norm_map))
    if render_type == "SURFACE_NORMAL":
        return colorize_normal(_np(out.surf_norm_map))
    if render_type == "SPECULAR":
        return np.repeat(_np(out.spec_map)[..., :1], 3, -1)
    if render_type == "DIFFUSE":
        return _np(out.dif_rgb_map)
    if render_type == "REFLECTION":
        return _np(out.ref_rgb_map)
    return _np(out.rgb_map)


class RenderServer:
    """Serves renders of a Runner's state over websockets.

    With `watch` the server attaches read-only to a live training run:
    before each frame it looks for the run's newest checkpoint and loads it
    when it changed (the pools' capacities stay the runner's). `serve`
    runs until `stop()`; `ready` is set once it listens, `port` is then
    the bound port (give 0 for any free one)."""

    def __init__(self, runner, watch: bool = False):
        self.runner = runner  # envgs_tpu_torch.train.runner.Runner
        self.watch = watch
        self._ckpt_sig = None  # (path, mtime in ms) of the loaded checkpoint
        self.attached_iter = None
        self.ready = threading.Event()
        self.port = None
        self._loop = self._stopped = None

    def maybe_reload(self) -> None:
        """Load runner.state from the newest checkpoint (watch mode)."""
        if not self.watch:
            return
        from envgs_tpu_torch.train import checkpoints as ckpt

        latest = ckpt.find_latest(self.runner.model_dir)
        if not latest:
            return
        try:
            sig = (latest, int(os.path.getmtime(latest) * 1e3))
            if sig == self._ckpt_sig:
                return
            state, it, _cam = ckpt.load_checkpoint(
                latest, self.runner.state.base.cap,
                self.runner.state.env.cap, n_views=len(self.runner.views),
                device=self.runner.device)
        except Exception as exc:  # a checkpoint being written: keep serving
            print(f"[watch] reload skipped: {exc}")
            return
        self.runner.state = state
        self._ckpt_sig = sig
        self.attached_iter = int(it)
        print(f"[watch] attached to {latest} @ iter {it}")

    def _overlay_payload(self, kind: str) -> dict:
        """Geometry for the client's overlay layer: the saved Gaussian
        ply's centres (decimated to about 20000) or the mesh export's
        vertices and faces (about 15000)."""
        if kind == "off":
            return {"kind": "off"}
        mdl = getattr(self.runner, "model_dir", "")
        res = getattr(self.runner, "result_dir", "")
        if kind == "points":
            from envgs_tpu_torch.utils.ply import load_gaussian_ply

            for name in ("base.ply", "point_cloud.ply", "env.ply"):
                p = os.path.join(mdl, name)
                if os.path.exists(p):
                    xyz = np.asarray(load_gaussian_ply(p)["xyz"], np.float32)
                    step = max(1, len(xyz) // 20000)
                    return {"kind": "points", "name": name,
                            "verts": xyz[::step].round(4).tolist()}
            return {"kind": "off", "error": "no gaussian ply saved yet"}
        if kind == "mesh":
            from envgs_tpu_torch.utils.fusion import load_mesh_ply

            for root in (res, mdl):
                p = os.path.join(root, "mesh.ply")
                if os.path.exists(p):
                    verts, faces = load_mesh_ply(p)
                    step = max(1, len(faces) // 15000)
                    return {"kind": "mesh", "name": p,
                            "verts": verts.round(4).tolist(),
                            "faces": faces[::step].tolist()}
            return {"kind": "off",
                    "error": "no mesh.ply (run the mesh CLI mode first)"}
        return {"kind": "off", "error": f"unknown overlay {kind!r}"}

    def _paths_dir(self) -> str:
        return os.path.join(getattr(self.runner, "result_dir", "."),
                            "camera_paths")

    def _save_camera_path(self, frames: list, K) -> str:
        """The viewer's keyframes as an easymocap camera path (intri.yml /
        extri.yml under result_dir/camera_paths/<time stamp>), which
        `render --path-dir` reads."""
        from envgs_tpu_torch.utils.easycam import write_cameras

        out = os.path.join(self._paths_dir(),
                           time.strftime("path_%Y%m%d_%H%M%S"))
        cams = {f"{i:04d}": dict(
            K=np.asarray(K, np.float32).reshape(3, 3),
            R=np.asarray(fr["R"], np.float32).reshape(3, 3),
            T=np.asarray(fr["T"], np.float32).reshape(3, 1))
            for i, fr in enumerate(frames)}
        write_cameras(cams, out)
        return out

    def _load_camera_path(self, name: str | None) -> dict:
        from envgs_tpu_torch.utils.easycam import read_cameras

        root = self._paths_dir()
        names = sorted(os.listdir(root)) if os.path.isdir(root) else []
        if not names:
            return {"error": "no saved camera paths"}
        pick = name if name in names else names[-1]
        cams = read_cameras(os.path.join(root, pick))
        frames = [{"R": np.asarray(c["R"], np.float32).ravel().tolist(),
                   "T": np.asarray(c["T"], np.float32).ravel().tolist()}
                  for _k, c in sorted(cams.items())]
        return {"name": pick, "frames": frames, "available": names}

    def _render(self, cam, render_type: str) -> np.ndarray:
        self.maybe_reload()
        return typed_map(self.runner.render_view(cam), render_type)

    async def handle(self, ws):
        from envgs_tpu_torch.utils.camera import make_camera

        cam0 = self.runner.views[0]["camera"]
        K0 = _np(cam0.K)
        render_type = "RENDER"  # per connection
        await ws.send(json.dumps({
            "H": int(cam0.H), "W": int(cam0.W),
            "K": K0.astype(np.float32).ravel().tolist(),
            "R": _np(cam0.R).astype(np.float32).ravel().tolist(),
            "T": _np(cam0.T).astype(np.float32).ravel().tolist(),
            "types": list(RENDER_TYPES), "watch": bool(self.watch)}))
        async for msg in ws:
            if isinstance(msg, str):  # text frames: control messages
                try:
                    obj = json.loads(msg)
                except Exception:
                    continue
                t = obj.get("render_type")
                if t in RENDER_TYPES:
                    render_type = t
                    await ws.send(json.dumps({"render_type": render_type}))
                if "overlay" in obj:
                    await ws.send(json.dumps(
                        {"overlay": self._overlay_payload(obj["overlay"])}))
                if "save_path" in obj:
                    try:
                        out = self._save_camera_path(obj["save_path"], K0)
                        await ws.send(json.dumps({"saved_path": out}))
                    except Exception as e:  # reported, the socket kept
                        await ws.send(json.dumps(
                            {"saved_path": None, "error": str(e)}))
                if "load_path" in obj:
                    await ws.send(json.dumps({"loaded_path":
                                              self._load_camera_path(
                                                  obj.get("load_path"))}))
                continue
            try:
                K, R, T = decode_camera(msg)
            except Exception:
                await ws.send(b"ERR bad camera")
                continue
            cam = make_camera(cam0.H, cam0.W, K, R, T, cam0.znear, cam0.zfar,
                              device=cam0.K.device)
            # off the event loop: a long render would block the keepalive
            # pings and the client would see the connection drop
            t0 = time.perf_counter()
            rgb = await asyncio.get_running_loop().run_in_executor(
                None, self._render, cam, render_type)
            t1 = time.perf_counter()
            jpeg = encode_jpeg(rgb)
            t2 = time.perf_counter()
            await ws.send(jpeg)
            stats = {"render_ms": round((t1 - t0) * 1e3, 1),
                     "encode_ms": round((t2 - t1) * 1e3, 1),
                     "jpeg_kb": round(len(jpeg) / 1024, 1),
                     "type": render_type}
            if self.attached_iter is not None:
                stats["iter"] = self.attached_iter
            await ws.send(json.dumps({"stats": stats}))

    async def serve(self, host: str = "0.0.0.0", port: int = 8765):
        import websockets

        self._loop = asyncio.get_running_loop()
        self._stopped = self._loop.create_future()
        async with websockets.serve(self.handle, host, port,
                                    max_size=2 ** 24,
                                    process_request=viewer_page) as server:
            self.port = server.sockets[0].getsockname()[1]
            print(f"render server listening on ws://{host}:{self.port} "
                  f"(browser viewer: http://{host}:{self.port}/)", flush=True)
            self.ready.set()
            await self._stopped

    def stop(self):
        """End `serve` (from any thread)."""
        if self._loop is not None:
            self._loop.call_soon_threadsafe(
                lambda: self._stopped.done() or self._stopped.set_result(None))


def viewer_page(connection, request):
    """`process_request` hook: a plain HTTP GET (no Upgrade header) gets
    the browser viewer; None continues the websocket handshake."""
    if "upgrade" in (request.headers.get("Connection") or "").lower():
        return None
    import http

    from websockets.datastructures import Headers
    from websockets.http11 import Response

    with open(os.path.join(os.path.dirname(__file__), "viewer.html"),
              "rb") as fh:
        body = fh.read()
    return Response(http.HTTPStatus.OK, "OK", Headers(
        [("Content-Type", "text/html; charset=utf-8"),
         ("Content-Length", str(len(body)))]), body)


async def request_frame(uri: str, K, R, T) -> np.ndarray:
    """Client helper: send one camera, receive one frame (H, W, 3) in
    [0, 1]."""
    import websockets
    from PIL import Image

    async with websockets.connect(uri, max_size=2 ** 24) as ws:
        await ws.send(encode_camera(K, R, T))
        data = await ws.recv()
        while isinstance(data, str):  # the hello frame
            data = await ws.recv()
        return np.asarray(Image.open(io.BytesIO(data)), np.float32) / 255.0


def serve_config(config: str, overrides=(), host: str = "0.0.0.0",
                 port: int = 8765, watch: bool = False, device="cuda"):
    """Build the runner of a config chain (cli.make_runner, resuming its
    latest checkpoint) and serve it until stopped."""
    from envgs_tpu_torch.cli import make_runner
    from envgs_tpu_torch.engine import load_config

    runner = make_runner(load_config(config, overrides=list(overrides),
                                     root=os.getcwd()), device)
    asyncio.run(RenderServer(runner, watch=watch).serve(host=host,
                                                        port=port))


def main(argv=None, device="cuda"):
    p = argparse.ArgumentParser()
    p.add_argument("-c", "--config", required=True)
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8765)
    p.add_argument("--watch", action="store_true",
                   help="attach read-only to a live training: load the "
                   "run's newest checkpoint before each frame")
    a = p.parse_args(argv)
    serve_config(a.config, host=a.host, port=a.port, watch=a.watch,
                 device=device)


if __name__ == "__main__":
    main()
