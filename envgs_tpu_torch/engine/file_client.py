"""Storage backends for file IO (port of envgs_tpu/engine/file_client.py,
the reference's FileClient): one `get` / `get_text` / `exists` / `put`
interface over

- `DiskBackend`: the local file system (paths, `file://`; the default);
- `HTTPBackend`: a urllib GET (`http://`, `https://`; read-only);
- `MemoryBackend`: an in-process dict (`memory://`).

`FileClient` picks the backend whose prefix is the longest to match a
path, or the one it was built with; more backends register in
`FILE_BACKENDS`.
"""
from __future__ import annotations

from envgs_tpu_torch.engine.registry import Registry

FILE_BACKENDS = Registry("file_backends")


@FILE_BACKENDS.register
class DiskBackend:
    """Local filesystem backend."""

    prefixes = ("", "file://")

    def get(self, path: str) -> bytes:
        if path.startswith("file://"):
            path = path[len("file://"):]
        with open(path, "rb") as f:
            return f.read()

    def get_text(self, path: str, encoding: str = "utf-8") -> str:
        return self.get(path).decode(encoding)

    def exists(self, path: str) -> bool:
        import os

        if path.startswith("file://"):
            path = path[len("file://"):]
        return os.path.exists(path)

    def put(self, path: str, data: bytes):
        import os

        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "wb") as f:
            f.write(data)


@FILE_BACKENDS.register
class HTTPBackend:
    """urllib GET backend (read-only)."""

    prefixes = ("http://", "https://")

    def get(self, url: str) -> bytes:
        from urllib.request import urlopen

        with urlopen(url, timeout=30) as r:
            return r.read()

    def get_text(self, url: str, encoding: str = "utf-8") -> str:
        return self.get(url).decode(encoding)

    def exists(self, url: str) -> bool:
        from urllib.error import URLError
        from urllib.request import Request, urlopen

        try:
            with urlopen(Request(url, method="HEAD"), timeout=10) as r:
                return r.status < 400
        except (URLError, OSError):
            return False


@FILE_BACKENDS.register
class MemoryBackend:
    """In-process dict store (tests / caching)."""

    prefixes = ("memory://",)

    def __init__(self):
        self.store: dict[str, bytes] = {}

    def get(self, path: str) -> bytes:
        return self.store[path]

    def get_text(self, path: str, encoding: str = "utf-8") -> str:
        return self.get(path).decode(encoding)

    def exists(self, path: str) -> bool:
        return path in self.store

    def put(self, path: str, data: bytes):
        self.store[path] = data


class FileClient:
    """Prefix dispatch: `FileClient().get("http://...")` goes to the
    backend of the longest matching prefix; `FileClient("MemoryBackend")`
    to that backend for every path."""

    def __init__(self, backend: str | None = None, **kwargs):
        self._instances: dict[type, object] = {}
        self._forced = (
            FILE_BACKENDS.build(dict(type=backend, **kwargs))
            if backend else None
        )

    def _backend_for(self, path: str):
        if self._forced is not None:
            return self._forced
        best = None
        best_len = -1
        for name in ("DiskBackend", "HTTPBackend", "MemoryBackend"):
            cls = FILE_BACKENDS.get(name)
            for p in cls.prefixes:
                if path.startswith(p) and len(p) > best_len:
                    best, best_len = cls, len(p)
        if best not in self._instances:
            self._instances[best] = best()
        return self._instances[best]

    def get(self, path: str) -> bytes:
        return self._backend_for(path).get(path)

    def get_text(self, path: str, encoding: str = "utf-8") -> str:
        return self._backend_for(path).get_text(path, encoding)

    def exists(self, path: str) -> bool:
        return self._backend_for(path).exists(path)

    def put(self, path: str, data: bytes):
        return self._backend_for(path).put(path, data)
