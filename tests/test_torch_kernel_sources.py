"""The CUDA sources against their ctypes bindings, without a compiler.

Nothing compiles on a machine without nvcc, and a ctypes mismatch (a missing
argument, a pointer passed as a 32-bit int) shows only as a crash on the
card. So: every `extern "C"` signature under kernels/csrc is parsed and held
against `kernels._ARGTYPES`, every source of `_SOURCES` exists, every
`LAUNCHES` key is counted by some wrapper, the build keeps `-fmad=false`,
and the functions that report a kernel's resources count nothing.

    python -m pytest tests/test_torch_kernel_sources.py
"""
import contextlib
import ctypes
import re
from pathlib import Path

import pytest
import torch

from envgs_tpu_torch import kernels

CSRC = Path(kernels.__file__).resolve().parent / "csrc"
_EXTERN = re.compile(r'extern\s+"C"\s+(\w+)\s+(\w+)\s*\(([^)]*)\)', re.S)


def _exported():
    """{function: (return type, [parameter declarations], file name)}."""
    out = {}
    for path in sorted(CSRC.glob("*.cu")):
        for ret, name, params in _EXTERN.findall(path.read_text()):
            decls = [" ".join(p.split()) for p in params.split(",")]
            assert name not in out, f"{name} exported twice"
            out[name] = (ret, decls, path.name)
    return out


EXPORTED = _exported()


def _ctype(decl: str):
    """The ctypes type a C parameter declaration must be bound to."""
    if "*" in decl:
        return ctypes.c_void_p  # data pointers and the stream
    base = decl.rsplit(" ", 1)[0].replace("const", "").strip()
    assert base == "int", f"unbound parameter type in {decl!r}"
    return ctypes.c_int


def test_sources_exist_and_are_all_built():
    on_disk = {p.name for p in CSRC.glob("*.cu")}
    assert set(kernels._SOURCES) == on_disk
    assert len(set(kernels._SOURCES)) == len(kernels._SOURCES)


def test_included_headers_exist_and_are_hashed_with_the_sources():
    """An edit of a header must rebuild the library: every file a source
    includes from its own directory is listed in `_HEADERS`."""
    included = set()
    for path in CSRC.glob("*.cu"):
        included |= set(re.findall(r'#include "([^"]+)"', path.read_text()))
    assert included == set(kernels._HEADERS)
    assert all((CSRC / name).is_file() for name in kernels._HEADERS)
    assert {p.name for p in CSRC.iterdir()} == (set(kernels._SOURCES)
                                                | set(kernels._HEADERS))


def test_every_exported_function_is_bound_and_nothing_else():
    assert set(EXPORTED) == set(kernels._ARGTYPES)


@pytest.mark.parametrize("name", sorted(EXPORTED))
def test_signature_matches_argtypes(name):
    ret, decls, src = EXPORTED[name]
    assert ret == "int", f"{src}: {name} must return the CUDA error code"
    want = [_ctype(d) for d in decls]
    got = kernels._ARGTYPES[name]
    assert len(got) == len(want), (
        f"{src}: {name} takes {len(want)} arguments, _ARGTYPES binds "
        f"{len(got)}")
    for i, (g, w, d) in enumerate(zip(got, want, decls)):
        assert g is w, f"{src}: {name} argument {i} ({d}) bound as {g}"


def _record_launches(monkeypatch):
    """Patch the wrappers' checks away and record what they would count."""
    seen = []
    monkeypatch.setattr(kernels, "_check", lambda *a, **k: None)
    monkeypatch.setattr(kernels, "_check_table", lambda *a, **k: None)
    monkeypatch.setattr(kernels, "_stream", lambda t: 0)
    monkeypatch.setattr(
        kernels, "_launch",
        lambda name, device, *args, count=None: seen.append(count or name))
    return seen


def test_every_launch_count_is_reachable_from_a_wrapper(monkeypatch):
    seen = _record_launches(monkeypatch)
    packed = torch.zeros(3, 32)
    idx = torch.zeros(64, dtype=torch.int32)
    bounds = torch.tensor([0, 64], dtype=torch.int32)
    rays = torch.zeros(1, 8, 256)
    for mode in kernels.MODES:
        planes = kernels.raster_blend_fwd(packed, idx, bounds, 3, 1, 1,
                                          train=True, mode=mode)
        kernels.raster_blend_bwd(packed, idx, bounds, planes, planes, 3, 1,
                                 1, mode=mode)
    out = kernels.trace_blend_fwd(packed, idx, rays, bounds, 1, 1, train=True)
    kernels.trace_blend_bwd(packed, idx, rays, bounds, out, out, 1, 1)
    kernels.fill_forward(torch.zeros((2, 8), dtype=torch.int32),
                         torch.zeros(8, dtype=torch.int32))
    kernels.segscan(torch.zeros(1024, 128),
                    torch.zeros(1024, dtype=torch.int32))
    table = torch.zeros(8, 128)
    kernels.gather_rows(table, idx)
    kernels.gather_rows_win8(table, idx)
    assert sorted(seen) == sorted(kernels.LAUNCHES)


def test_launch_counts_once_and_only_when_launched(monkeypatch):
    class Lib:
        code = 0

        def segscan(self, *args):
            return self.code

    lib = Lib()
    monkeypatch.setattr(kernels, "_load", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    before = dict(kernels.LAUNCHES)
    kernels._launch("segscan", torch.device("cpu"))
    assert kernels.LAUNCHES["segscan"] == before["segscan"] + 1
    lib.code = 9  # a refused launch raises and is not counted
    with pytest.raises(RuntimeError, match="segscan"):
        kernels._launch("segscan", torch.device("cpu"))
    assert kernels.LAUNCHES["segscan"] == before["segscan"] + 1
    kernels.LAUNCHES.update(before)


def test_build_flags_keep_every_product_and_sum_apart():
    """The blends equal their plain versions to the last bits only without
    fused multiply-adds; sm_90a is the target."""
    assert "-fmad=false" in kernels.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in kernels.NVCC_FLAGS
    assert not any("fast" in f for f in kernels.NVCC_FLAGS)


@pytest.mark.parametrize("name", sorted(n for n in EXPORTED
                                        if n.endswith("_resources")))
def test_resource_queries_write_ints_and_launch_nothing(name, monkeypatch):
    """Each `<kernel>_resources` export belongs to an exported kernel, ends
    in the int array it fills, and its wrapper counts no launch."""
    assert name.removesuffix("_resources") in EXPORTED
    assert "int* out" in EXPORTED[name][1][-1]

    class Lib:
        def __getattr__(self, attr):
            assert attr == name
            return lambda *args: 0

    monkeypatch.setattr(kernels, "_load", lambda: Lib())
    before = dict(kernels.LAUNCHES)
    res = getattr(kernels, name)()
    assert set(res) >= {"registers", "shared_bytes", "blocks_per_sm"}
    assert kernels.LAUNCHES == before


def test_trace_resource_queries_reject_a_bad_aux_count():
    with pytest.raises(ValueError, match="aux"):
        kernels.trace_blend_fwd_resources(True, 3)
    with pytest.raises(ValueError, match="aux"):
        kernels.trace_blend_bwd_resources(-1)


@pytest.mark.parametrize("name", sorted(kernels.LAUNCHES))
def test_launch_key_names_an_exported_kernel(name):
    base = name
    for mode in kernels.MODES:
        base = base.removesuffix(f"_{mode}")
    assert base in EXPORTED
