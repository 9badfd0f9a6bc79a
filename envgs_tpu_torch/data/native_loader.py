"""ctypes bindings for the native C++ threaded image loader (the port's own
copy of envgs_tpu/data/native_loader.py).

native/loader.cpp decodes JPEG/PNG, undistorts (OpenCV 5-term model) and
resizes on a C++ thread pool, off the GIL, into float32 HWC arrays in
[0, 1]. The port compiles that source (read only) with the flags and
libraries of native/Makefile into `envgs_tpu_torch/_build/`, under a name
keyed by a hash of the source and the command, at the first call of
`available()`; it never runs `make` in `native/`. The library is written
under a temporary name and moved into place, so processes that build at
the same moment do not read each other's half-written file. When the build
or the load fails, `available()` is False and callers take the python
decoders.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_ROOT = Path(__file__).resolve().parents[2]
_SOURCE = _ROOT / "native" / "loader.cpp"
_BUILD = Path(__file__).resolve().parents[1] / "_build"
# native/Makefile: CXXFLAGS and LIBS
CXXFLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-Wall")
LIBS = ("-ljpeg", "-lpng", "-lz", "-lpthread")

_lib = None
_lib_lock = threading.Lock()
_build_attempted = False


def _cxx() -> str:
    return os.environ.get("CXX", "g++")


def library_path() -> Path:
    h = hashlib.sha256(" ".join((_cxx(), *CXXFLAGS, *LIBS)).encode())
    h.update(_SOURCE.read_bytes())
    return _BUILD / f"libenvgs_loader_{h.hexdigest()[:16]}.so"


def build() -> Path | None:
    """Compile native/loader.cpp unless this exact build exists -> the
    library's path, or None when the compiler or a library is missing."""
    lib = library_path()
    if lib.exists():
        return lib
    _BUILD.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    try:
        subprocess.run([_cxx(), *CXXFLAGS, "-o", str(tmp), str(_SOURCE),
                        *LIBS], check=True, capture_output=True, timeout=120)
        os.replace(tmp, lib)
    except (OSError, subprocess.SubprocessError):
        return None
    finally:
        if tmp.exists():
            tmp.unlink()
    return lib


def _load_lib():
    global _lib, _build_attempted
    with _lib_lock:
        if _lib is not None or _build_attempted:
            return _lib
        _build_attempted = True
        path = build()
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError:
            return None
        lib.loader_create.restype = ctypes.c_void_p
        lib.loader_create.argtypes = [ctypes.c_int]
        lib.loader_destroy.restype = None
        lib.loader_destroy.argtypes = [ctypes.c_void_p]
        lib.loader_submit.restype = ctypes.c_int64
        lib.loader_submit.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double)]
        lib.loader_fetch.restype = ctypes.c_int
        lib.loader_fetch.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                     ctypes.POINTER(ctypes.c_float)]
        _lib = lib
        return _lib


def available() -> bool:
    """True when the native library is built (or builds now) and loads."""
    return _load_lib() is not None


def _kd_ptrs(K, D):
    """Pack optional intrinsics / distortion into C double arrays (and the
    numpy arrays, which must outlive the call)."""
    if K is None or D is None:
        return None, None, None
    Ka = np.ascontiguousarray(np.asarray(K, np.float64).reshape(9))
    Da = np.zeros(5, np.float64)
    Dv = np.asarray(D, np.float64).reshape(-1)[:5]
    Da[: Dv.size] = Dv
    return (Ka.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            Da.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), (Ka, Da))


class NativeLoader:
    """Thread-pooled decode + undistort + resize.

    load(path, H, W, K=None, D=None)   -> (H, W, 3) float32, blocking
    submit(path, H, W, K=None, D=None) -> ticket
    fetch(ticket)                      -> (H, W, 3) float32, blocking
    """

    def __init__(self, n_threads: int = 4):
        lib = _load_lib()
        if lib is None:
            raise RuntimeError("native loader library unavailable")
        self._lib = lib
        self._pool = lib.loader_create(int(n_threads))
        self._shapes: dict[int, tuple[int, int]] = {}
        self._mu = threading.Lock()

    def __del__(self):
        pool = getattr(self, "_pool", None)
        if pool:
            self._lib.loader_destroy(pool)
            self._pool = None

    def submit(self, path: str, H: int, W: int, K=None, D=None) -> int:
        kp, dp, _keep = _kd_ptrs(K, D)
        ticket = self._lib.loader_submit(self._pool, os.fsencode(path),
                                         int(H), int(W), kp, dp)
        with self._mu:
            self._shapes[ticket] = (int(H), int(W))
        return ticket

    def fetch(self, ticket: int) -> np.ndarray:
        with self._mu:
            H, W = self._shapes.pop(ticket)
        out = np.empty((H, W, 3), np.float32)
        rc = self._lib.loader_fetch(
            self._pool, ticket,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        if rc != 0:
            raise IOError(f"native loader failed (rc={rc}) for ticket "
                          f"{ticket}")
        return out

    def load(self, path: str, H: int, W: int, K=None, D=None) -> np.ndarray:
        return self.fetch(self.submit(path, H, W, K, D))
