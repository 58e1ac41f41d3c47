"""The ctypes boundary of the port's four CUDA kernels, checked on the CPU.

Each wrapper binds its kernel's plain C entry point with ctypes and declares
the parameter types itself (``_ARGTYPES``).  A mismatch with the source's
``extern "C"`` signature shows only on the card, and there as a crash or a
silently cut pointer.  Here each signature is parsed from ``csrc/<name>.cu``
and held against the wrapper's declaration, and ``_entry`` is run against a
stand-in library to see the types it sets.
"""
import ctypes
import re
from types import SimpleNamespace

import pytest

pytest.importorskip("torch")

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    kernel as fa_kernel)
from repro_torch.kernels.matmul import kernel as mm_kernel  # noqa: E402
from repro_torch.kernels.rmsnorm import kernel as rms_kernel  # noqa: E402
from repro_torch.kernels.ssd import kernel as ssd_kernel  # noqa: E402

# kernel source name -> (wrapper module, C entry point)
KERNELS = {
    "flash_attention": (fa_kernel, "flash_attention_fwd"),
    "matmul": (mm_kernel, "matmul_fwd"),
    "rmsnorm": (rms_kernel, "rmsnorm_fwd"),
    "ssd": (ssd_kernel, "ssd_scan_fwd"),
}

# The C parameter types the wrappers pass, and the ctypes type of each.
C_TYPES = {"pointer": ctypes.c_void_p, "int": ctypes.c_int,
           "long long": ctypes.c_longlong, "float": ctypes.c_float}


def c_param_kind(decl: str) -> str:
    """'const void* q' -> 'pointer', 'long long q_sb' -> 'long long'."""
    decl = " ".join(decl.split())
    if "*" in decl:
        return "pointer"
    words = decl.replace("const ", "").split()[:-1]      # drop the name
    kind = " ".join(words)
    if kind not in C_TYPES:
        raise AssertionError(f"parameter {decl!r} has a type the wrappers "
                             f"do not bind")
    return kind


def c_signature(name: str, fn: str):
    """(return type, [parameter kinds]) of ``extern "C" <ret> fn(...)``."""
    src = (_build.CSRC / f"{name}.cu").read_text()
    found = re.findall(r'extern\s+"C"\s+(\w+)\s+' + fn + r'\s*\(([^)]*)\)',
                       src)
    assert len(found) == 1, f"{name}.cu: {len(found)} extern \"C\" {fn}"
    ret, params = found[0]
    return ret, [c_param_kind(p) for p in params.split(",")]


@pytest.mark.parametrize("name", sorted(KERNELS))
def test_argtypes_match_the_c_signature(name):
    module, fn = KERNELS[name]
    ret, kinds = c_signature(name, fn)
    assert ret == "int"
    assert [C_TYPES[k] for k in kinds] == list(module._ARGTYPES)


@pytest.mark.parametrize("name", sorted(KERNELS))
def test_entry_sets_argtypes_and_int_restype(monkeypatch, name):
    module, fn = KERNELS[name]
    entry = SimpleNamespace()
    loaded = []

    def fake_load(lib):
        loaded.append(lib)
        return SimpleNamespace(**{fn: entry})
    monkeypatch.setattr(_build, "load", fake_load)
    assert module._entry() is entry
    assert loaded == [name]
    assert list(entry.argtypes) == list(module._ARGTYPES)
    assert entry.restype is ctypes.c_int


def test_parser_reads_every_kind():
    assert c_param_kind("const void* q") == "pointer"
    assert c_param_kind("void *stream") == "pointer"
    assert c_param_kind(" long long\n q_sb") == "long long"
    assert c_param_kind("int causal") == "int"
    assert c_param_kind("float sm_scale") == "float"
    with pytest.raises(AssertionError, match="double"):
        c_param_kind("double x")
