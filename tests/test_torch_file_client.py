"""The port's file backends (engine/file_client.py) against the JAX
package's: the same bytes, text and existence from the disk, an HTTP
server on the loopback (`http.server` on 127.0.0.1, no network) and the
in-memory store, prefix dispatch by the longest match, a forced backend,
and the registry of backends."""
import http.server
import threading

import pytest

from envgs_tpu.engine import file_client as jfc
from envgs_tpu_torch.engine import file_client as tfc


@pytest.fixture
def http_root(tmp_path):
    (tmp_path / "a.txt").write_bytes("héllo\n".encode())
    (tmp_path / "b.bin").write_bytes(bytes(range(256)) * 3)

    class Quiet(http.server.SimpleHTTPRequestHandler):
        def __init__(self, *a, **kw):
            super().__init__(*a, directory=str(tmp_path), **kw)

        def log_message(self, *a):
            pass

    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Quiet)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield tmp_path, f"http://127.0.0.1:{srv.server_address[1]}"
    srv.shutdown()
    srv.server_close()
    t.join()


def test_backends_registered():
    assert set(tfc.FILE_BACKENDS._modules) == set(jfc.FILE_BACKENDS._modules)
    for name in jfc.FILE_BACKENDS._modules:
        assert tfc.FILE_BACKENDS.get(name).prefixes == jfc.FILE_BACKENDS.get(
            name).prefixes


def test_disk_and_http_against_jax(http_root):
    root, url = http_root
    port, jax_ = tfc.FileClient(), jfc.FileClient()
    for path in (str(root / "a.txt"), f"file://{root / 'b.bin'}",
                 f"{url}/a.txt", f"{url}/b.bin"):
        assert port.get(path) == jax_.get(path)
        assert port.exists(path) and jax_.exists(path)
    assert port.get_text(f"{url}/a.txt") == jax_.get_text(
        f"{url}/a.txt") == "héllo\n"
    assert port.get_text(str(root / "a.txt")) == "héllo\n"
    for missing in (f"{url}/none.txt", str(root / "none.txt")):
        assert port.exists(missing) == jax_.exists(missing) is False
    assert type(port._backend_for(f"{url}/a.txt")).__name__ == "HTTPBackend"
    assert type(port._backend_for("memory://k")).__name__ == "MemoryBackend"
    assert type(port._backend_for("/x")).__name__ == "DiskBackend"
    out = root / "sub" / "c.bin"
    port.put(str(out), b"\x00\x01")
    assert jax_.get(str(out)) == b"\x00\x01"


def test_memory_backend_and_forced():
    port = tfc.FileClient("MemoryBackend")
    jax_ = jfc.FileClient("MemoryBackend")
    for c in (port, jax_):
        assert not c.exists("k")
        c.put("k", "ü".encode())
        assert c.get("k") == "ü".encode() and c.get_text("k") == "ü"
        assert c.exists("k")
        with pytest.raises(KeyError):
            c.get("other")
    # a forced backend takes every path, prefixes aside
    assert port._backend_for("/some/disk/path") is port._forced
    auto = tfc.FileClient()
    auto.put("memory://x", b"1")
    assert auto.get("memory://x") == b"1" and auto.exists("memory://x")
