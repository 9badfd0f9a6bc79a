"""Multi-view dataset on disk in easyvolcap layout (the port's own copy of
envgs_tpu/data/dataset.py, host-side numpy).

    <data_root>/intri.yml, extri.yml     cameras (utils/easycam.py)
    <data_root>/images/<cam>/<frame>     rgb (jpg / png)
    <data_root>/masks/<cam>/<frame>      optional masks
    <data_root>/normals/<cam>/<frame>    optional monocular normals
    <data_root>/depths/<cam>/<frame>     optional depths (.npy/.npz/.png)
    <data_root>/sparse/0/                COLMAP model, or a points3D.ply

View and frame selection with the every-8th-view eval split, ratio
resizing with the intrinsics rescaled, optional undistortion, masks,
normals and depths, the camera-sphere spatial scale, and the SfM point
cloud for the initial pool. Images decode on demand into a cache. The
decoders are tried in the reference's order: the native C++ loader
(data/native_loader.py), then cv2, then PIL, so that both packages read
the same bits on one machine. Items hold numpy maps and the port's Camera
on the dataset's device.
"""
from __future__ import annotations

import collections
import json
import os
from dataclasses import dataclass
from typing import Optional

import numpy as np

from envgs_tpu_torch.engine import DATASETS
from envgs_tpu_torch.utils.camera import Camera, make_camera
from envgs_tpu_torch.utils.easycam import read_cameras
from envgs_tpu_torch.utils.ply import load_sfm_ply


def _imread(path: str) -> np.ndarray:
    """-> float32 HWC in [0, 1] (3 channels for rgb, 1 for masks)."""
    try:
        import cv2

        im = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        if im is None:
            raise FileNotFoundError(path)
        if im.ndim == 3:
            im = cv2.cvtColor(im, cv2.COLOR_BGR2RGB)
    except ImportError:
        from PIL import Image

        im = np.asarray(Image.open(path))
    im = im.astype(np.float32)
    if im.max() > 1.5:
        im = im / 255.0
    if im.ndim == 2:
        im = im[..., None]
    return im


def _resize(im: np.ndarray, H: int, W: int) -> np.ndarray:
    try:
        import cv2

        out = cv2.resize(im, (W, H), interpolation=cv2.INTER_AREA)
        return out[..., None] if out.ndim == 2 else out
    except ImportError:
        from PIL import Image

        chans = [np.asarray(Image.fromarray(
            (im[..., c] * 255).astype(np.uint8)).resize(
                (W, H), Image.BILINEAR), np.float32) / 255.0
            for c in range(im.shape[-1])]
        return np.stack(chans, -1)


def _undistort(im, K, D):
    if np.abs(D).max() < 1e-12:
        return im
    try:
        import cv2

        return cv2.undistort(im, K.astype(np.float64), D.astype(np.float64))
    except ImportError:
        return im  # without cv2 the distortion is ignored, as in the reference


@dataclass
class View:
    name: str
    camera: Camera
    image_path: str
    mask_path: Optional[str] = None
    normal_path: Optional[str] = None
    K_orig: np.ndarray = None
    D: np.ndarray = None
    H: int = 0
    W: int = 0
    depth_path: Optional[str] = None


def _load_depth(path: str, H: int, W: int) -> np.ndarray:
    """Metric depth map -> (H, W, 1) f32: .npy / .npz in meters, 16-bit png
    in millimeters."""
    if path.endswith(".npy"):
        d = np.load(path).astype(np.float32)
    elif path.endswith(".npz"):
        z = np.load(path)
        d = z[list(z.keys())[0]].astype(np.float32)
    else:
        try:
            import cv2

            d = cv2.imread(path, cv2.IMREAD_UNCHANGED)
            if d is None:
                raise FileNotFoundError(path)
            d = d.astype(np.float32)
            if d.max() > 1000:  # uint16 mm -> m
                d = d / 1000.0
        except ImportError:
            from PIL import Image

            d = np.asarray(Image.open(path), np.float32) / 1000.0
    if d.ndim == 3:
        d = d[..., 0]
    if d.shape[:2] != (H, W):
        d = _resize(d[..., None], H, W)[..., 0]
    return d[..., None]


@DATASETS.register
class MultiViewDataset:
    """A static multi-view scene (one frame, many views).

    view_sample: [begin, end, step], or any other length as an explicit
    index list; split 'train' keeps the views outside the every-`eval_every`
    eval set, 'val' / 'test' the views in it (all views when the set is
    empty). `ratio` scales the image size and K; cameras live on `device`.
    """

    def __init__(
        self,
        data_root: str,
        images_dir: str = "images",
        masks_dir: str = "masks",
        normals_dir: str = "normals",
        depths_dir: str = "depths",
        split: str = "train",
        ratio: float = 1.0,
        view_sample: list | None = None,
        eval_every: int = 8,
        use_masks: bool = False,
        use_normals: bool = False,
        use_depths: bool = False,
        near: float = 0.02,
        far: float = 20.0,
        frame: int = 0,
        cache_images: bool = True,
        device="cuda",
    ):
        self.data_root = data_root
        self.split = split
        self.use_masks = use_masks
        self.use_normals = use_normals
        self.near, self.far = near, far
        self.cache: dict[int, dict] = {}
        self.cache_images = cache_images
        # rgb loads per decoder ("native", "cv2", "PIL")
        self.decoders: collections.Counter = collections.Counter()

        cams = read_cameras(data_root)
        names = list(cams.keys())
        if view_sample:
            if len(view_sample) == 3:
                b, e, s = view_sample
                e = len(names) if e in (None, -1) else e
                names = names[b or 0:e:s or 1]
            else:
                names = [names[i] for i in view_sample]

        if eval_every and eval_every > 0 and len(names) > eval_every:
            eval_names = set(names[::eval_every])
        else:
            eval_names = set()
        if split == "train":
            names = [n for n in names if n not in eval_names]
        elif split in ("val", "test") and eval_names:
            names = [n for n in names if n in eval_names]

        self.views: list[View] = []
        for n in names:
            c = cams[n]
            img_dir = os.path.join(data_root, images_dir, n)
            if not os.path.isdir(img_dir):
                continue
            frames = sorted(os.listdir(img_dir))
            if not frames:
                continue
            fidx = min(frame, len(frames) - 1)
            ipath = os.path.join(img_dir, frames[fidx])
            mpath = os.path.join(data_root, masks_dir, n, frames[fidx])
            mpath = self._fuzzy(mpath) if use_masks else None
            npath = os.path.join(data_root, normals_dir, n, frames[fidx])
            npath = self._fuzzy(npath) if use_normals else None
            dpath = None
            if use_depths:
                stem = os.path.splitext(
                    os.path.join(data_root, depths_dir, n, frames[fidx]))[0]
                for ext in (".npy", ".npz", ".png", ".jpg"):
                    if os.path.exists(stem + ext):
                        dpath = stem + ext
                        break

            H = c.get("H") or self._probe_hw(ipath)[0]
            W = c.get("W") or self._probe_hw(ipath)[1]
            Hs, Ws = int(H * ratio), int(W * ratio)
            K = c["K"].copy().astype(np.float32)
            K[:2] *= ratio
            cam = make_camera(
                Hs, Ws, K, c["R"].astype(np.float32),
                c["T"].reshape(3).astype(np.float32),
                znear=c.get("n", near), zfar=c.get("f", far), device=device)
            self.views.append(View(n, cam, ipath, mpath, npath, c["K"],
                                   c.get("D"), Hs, Ws, depth_path=dpath))

        # scene extent: the radius of the camera centres' bounding sphere
        centers = np.stack([v.camera.center.cpu().numpy()
                            for v in self.views])
        self.center = centers.mean(0)
        self.spatial_scale = float(
            np.linalg.norm(centers - self.center, axis=-1).max()) or 1.0

    @staticmethod
    def _fuzzy(path: str) -> Optional[str]:
        """Accept sibling extensions (masks / normals are often png)."""
        if os.path.exists(path):
            return path
        stem = os.path.splitext(path)[0]
        for ext in (".png", ".jpg", ".jpeg", ".webp"):
            if os.path.exists(stem + ext):
                return stem + ext
        return None

    @staticmethod
    def _probe_hw(path: str):
        from PIL import Image

        with Image.open(path) as im:
            return im.height, im.width

    def __len__(self):
        return len(self.views)

    def load_sfm(self, ply_path: str | None = None):
        """The initial point cloud -> (xyz, rgb in [0, 1]), both float32:
        the given ply, else a ply under the root, else a COLMAP model,
        else `metadata.json`'s bounds filled with random points."""
        cands = [ply_path] if ply_path else []
        cands += [os.path.join(self.data_root, "sparse", "0", "points3D.ply"),
                  os.path.join(self.data_root, "points3D.ply"),
                  os.path.join(self.data_root, "sparse.ply")]
        for c in cands:
            if c and os.path.exists(c):
                return load_sfm_ply(c)
        from envgs_tpu_torch.utils.colmap import load_colmap_model

        for sp in ("sparse/0", "sparse", "colmap/sparse/0"):
            d = os.path.join(self.data_root, sp)
            if os.path.isdir(d):
                _, _, (xyz, rgb, _) = load_colmap_model(d)
                return xyz.astype(np.float32), rgb.astype(np.float32) / 255.0
        md = os.path.join(self.data_root, "metadata.json")
        if os.path.exists(md):
            with open(md) as f:
                meta = json.load(f)
            lo, hi = np.asarray(meta["bounds"], np.float32)
            rng = np.random.default_rng(0)
            n = int(os.environ.get("ENVGS_RANDOM_INIT_PTS", 4096))
            xyz = rng.random((n, 3), np.float32) * (hi - lo) + lo
            return xyz.astype(np.float32), rng.random(
                (n, 3), np.float32) * 0.5 + 0.25
        raise FileNotFoundError(
            f"no SfM point cloud found under {self.data_root}")

    _native = None

    def _load_rgb(self, v: View) -> np.ndarray:
        """The native loader's decode + undistort + resize where it is
        built, else the python decoders."""
        from envgs_tpu_torch.data import native_loader

        if native_loader.available():
            if MultiViewDataset._native is None:
                MultiViewDataset._native = native_loader.NativeLoader(4)
            try:
                im = MultiViewDataset._native.load(v.image_path, v.H, v.W,
                                                   v.K_orig, v.D)
                self.decoders["native"] += 1
                return im
            except IOError:
                pass
        im = _imread(v.image_path)[..., :3]
        if v.D is not None and v.K_orig is not None:
            im = _undistort(im, v.K_orig, v.D)
        try:
            import cv2  # noqa: F401

            self.decoders["cv2"] += 1
        except ImportError:
            self.decoders["PIL"] += 1
        return _resize(im, v.H, v.W)

    def __getitem__(self, i: int) -> dict:
        if self.cache_images and i in self.cache:
            return self.cache[i]
        v = self.views[i]
        item = dict(rgb=self._load_rgb(v), camera=v.camera, name=v.name,
                    index=i)
        if v.mask_path:
            m = _resize(_imread(v.mask_path)[..., :1], v.H, v.W)
            item["msk"] = (m > 0.5).astype(np.float32)[..., :1]
        else:
            item["msk"] = np.ones((v.H, v.W, 1), np.float32)
        if v.normal_path:
            item["norm"] = _resize(_imread(v.normal_path)[..., :3], v.H, v.W)
        if v.depth_path:
            item["dpt"] = _load_depth(v.depth_path, v.H, v.W)
        if self.cache_images:
            self.cache[i] = item
        return item
