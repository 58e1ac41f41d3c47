"""The port's tiled matmul (``repro_torch.kernels.matmul``) against the
reference's (``repro.kernels.matmul``) on the same numpy inputs: the Pallas
kernel run in interpret mode, as tests/test_kernels.py runs it, and the
plain versions.

On the CPU the port's wrapper takes its plain version (``ref.matmul``); the
CUDA kernel itself is held against that plain version, and across its tiles
bit for bit, by tests/test_torch_gpu.py (skipped without a card) and by
chip_smoke.py.
"""
import importlib.util
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.matmul import kernel as jax_kernel  # noqa: E402
from repro.kernels.matmul import ref as jax_ref  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.matmul import kernel, matmul, ref  # noqa: E402

# tests/test_kernels.py:22 and :112-114: atol tol * sqrt(k), rtol tol.
TOL = {"float32": 5e-5, "bfloat16": 5e-2}
JAX_DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(seed, m, n, k):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((m, k), dtype=np.float32),
            rng.standard_normal((k, n), dtype=np.float32))


def _both(a, dtype):
    """The same values in both frameworks; bf16 rounds to nearest even on
    both sides, so the bits agree."""
    return (jnp.asarray(a).astype(JAX_DTYPES[dtype]),
            torch.from_numpy(a).to(TORCH_DTYPES[dtype]))


def _close(got, want, dtype, k):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=TOL[dtype] * k ** 0.5, rtol=TOL[dtype])


@pytest.mark.parametrize("m,n,k", [
    (128, 128, 128), (256, 512, 384), (512, 256, 1024), (64, 64, 64),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matches_pallas_kernel_interpret(m, n, k, dtype):
    a, b = _inputs(0, m, n, k)
    (ja, ta), (jb, tb) = _both(a, dtype), _both(b, dtype)
    want = jax_kernel.matmul_tiled(ja, jb, bm=128, bn=128, bk=128)
    got = kernel.matmul_tiled(ta, tb, bm=128, bn=128, bk=128)
    assert got.dtype == TORCH_DTYPES[dtype] and tuple(got.shape) == (m, n)
    _close(got, want, dtype, k)


@pytest.mark.parametrize("m,n,k", [(8, 8, 8), (100, 257, 1000), (33, 17, 9)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ops_matches_reference_plain_version_on_ragged_shapes(m, n, k, dtype):
    """Held against the reference's plain version: its Pallas kernel sums
    the padding of a ragged last K block (k % bk != 0), which interpret
    mode fills with NaN (ROADMAP.md, Queue C).  The port masks it."""
    a, b = _inputs(1, m, n, k)
    (ja, ta), (jb, tb) = _both(a, dtype), _both(b, dtype)
    want = jax_ref.matmul(ja, jb)
    _close(matmul(ta, tb), want, dtype, k)


@pytest.mark.parametrize("out", ["float32", "bfloat16"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ref_matches_reference_ref_with_out_dtype(dtype, out):
    a, b = _inputs(2, 48, 40, 72)
    (ja, ta), (jb, tb) = _both(a, dtype), _both(b, dtype)
    want = jax_ref.matmul(ja, jb, out_dtype=JAX_DTYPES[out])
    got = ref.matmul(ta, tb, out_dtype=TORCH_DTYPES[out])
    assert got.dtype == TORCH_DTYPES[out]
    _close(got, want, out, 72)


@pytest.mark.parametrize("m,n,k,kernel_called", [
    (4, 512, 512, False),          # min(m, n, k) < 8: the plain version
    (512, 7, 64, False),
    (64, 64, 7, False),
    (8, 8, 8, True),
    (100, 257, 1000, True),
])
def test_ops_dispatch_is_the_reference(monkeypatch, m, n, k, kernel_called):
    """``ops.matmul`` sends a product with a dimension under 8 to the plain
    version and everything else to the kernel (matmul/ops.py:22)."""
    calls = []

    def spy(*args, **kw):
        calls.append(args)
        return ref.matmul(args[0], args[1], out_dtype=kw.get("out_dtype"))
    monkeypatch.setattr(kernel, "matmul_tiled", spy)
    a, b = _inputs(3, m, n, k)
    got = matmul(torch.from_numpy(a), torch.from_numpy(b))
    assert bool(calls) == kernel_called
    want = jax_ref.matmul(jnp.asarray(a), jnp.asarray(b))
    _close(got, want, "float32", k)


@pytest.mark.parametrize("m,n,bm,bn,dtype,tile", [
    # the reference's defaults -> 128 x 128, for both input types
    (4096, 4096, 256, 256, torch.float32, (128, 128)),
    (4096, 4096, 256, 256, torch.bfloat16, (128, 128)),
    (4096, 4096, 128, 128, torch.float32, (128, 128)),
    (4096, 4096, 64, 64, torch.float32, (64, 64)),
    # an instantiated tile is launched as given
    (4096, 4096, 128, 64, torch.float32, (128, 64)),
    (100, 4096, 64, 128, torch.float32, (64, 128)),
    (4096, 4096, 128, 256, torch.bfloat16, (128, 256)),
    (4096, 4096, 256, 128, torch.bfloat16, (256, 128)),
    # bf16-only tiles are not instantiated for fp32: the square rule
    (4096, 4096, 128, 256, torch.float32, (128, 128)),
    (4096, 4096, 32, 512, torch.float32, (64, 64)),  # the tile fits in both
    (100, 4096, 256, 256, torch.float32, (64, 64)),  # clamped to m, as the
    #                                                  reference clamps
    (4096, 8, 256, 256, torch.bfloat16, (64, 64)),   # narrower than any tile
])
def test_hopper_tile_maps_the_reference_blocks(m, n, bm, bn, dtype, tile):
    assert kernel.hopper_tile(m, n, bm, bn, dtype) == tile
    assert tile in kernel.TILES[dtype]


def _ok():
    return torch.zeros(16, 32), torch.zeros(32, 8)


@pytest.mark.parametrize("change,error,match", [
    (lambda a, b: (a[0], b), ValueError, "2-D"),
    (lambda a, b: (a.half(), b.half()), TypeError, "dtype"),
    (lambda a, b: (a.t().contiguous().t(), b), ValueError, "row-major"),
    (lambda a, b: (a, b.bfloat16()), ValueError, "share dtype"),
    (lambda a, b: (a, torch.zeros(31, 8)), ValueError, "inner dims"),
    (lambda a, b: (a[:0], b), ValueError, "empty"),
])
def test_check_inputs_raises_on_what_the_kernel_does_not_take(change, error,
                                                              match):
    a, b = change(*_ok())
    with pytest.raises(error, match=match):
        kernel.check_inputs(a, b, torch.float32)


def test_check_inputs_raises_on_out_dtype():
    with pytest.raises(TypeError, match="out_dtype"):
        kernel.check_inputs(*_ok(), torch.float16)


def test_bad_blocks_and_devices_raise():
    a, b = _ok()
    with pytest.raises(ValueError, match="bk"):
        kernel.matmul_tiled(a, b, bk=0)
    with pytest.raises(ValueError, match="bm"):
        kernel.hopper_tile(64, 64, 0, 64)
    with pytest.raises(ValueError, match="cpu or cuda"):
        kernel.matmul_tiled(a.to("meta"), b.to("meta"))


@pytest.mark.parametrize("variant", ["kept", "warps_2x4", "stage_unroll4",
                                     "kstep_unroll4"])
def test_tile_variants_fit_the_kernel_source(variant):
    """scripts/kernel_variants.py measures the matmul against copies with
    another 64x128 warp layout or less unrolled loops; its edits must still
    fit the kernel's source, and the kept one is the source itself."""
    path = Path(__file__).resolve().parents[1] / "scripts" / \
        "kernel_variants.py"
    spec = importlib.util.spec_from_file_location("kernel_variants", path)
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    src = (_build.CSRC / "matmul.cu").read_text()
    got = script.variant_source(src, script.MATMUL_EDITS[variant])
    assert (got == src) == (variant == "kept")
    assert ("launch_types<64, 128, 2, 4>" in got) == (variant == "warps_2x4")
    assert got.count("#pragma unroll 4\n") == src.count(
        "#pragma unroll 4\n") + (variant.endswith("unroll4"))


def test_cpu_never_counts_a_launch():
    kernel.launches = 0
    a, b = _inputs(5, 64, 64, 64)
    kernel.matmul_tiled(torch.from_numpy(a), torch.from_numpy(b))
    assert kernel.launches == 0


def test_kernel_source_is_found_and_hashed():
    lib = _build.library_path("matmul")
    assert lib.name == "libmatmul.so" and lib.parent.parent == \
        _build.BUILD_ROOT
    src = (_build.CSRC / "matmul.cu").read_text()
    assert 'extern "C" int matmul_fwd' in src
    assert "src/repro/kernels/matmul/kernel.py" in src
    for bm, bn in set(kernel.TILES[torch.float32]) | set(
            kernel.TILES[torch.bfloat16]):
        assert f"launch_types<{bm}, {bn}," in src
        assert f"bm == {bm} && bn == {bn}" in src
    # the bf16-only tiles are instantiated without fp32 inputs
    for bm, bn in set(kernel.TILES[torch.bfloat16]) - set(
            kernel.TILES[torch.float32]):
        assert re.search(rf"launch_types<{bm}, {bn}, \d+, \d+, false>", src)
