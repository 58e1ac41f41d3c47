"""The port's SSD scan (``repro_torch.kernels.ssd``) against the reference's
(``repro.kernels.ssd``) on the same numpy inputs: the Pallas kernel run in
interpret mode, as tests/test_kernels.py runs it, and the two plain
versions.

On the CPU the port's wrapper takes its plain version (``ssd_chunked``); the
CUDA kernel itself is held against that plain version by
tests/test_torch_gpu.py (skipped without a card) and by chip_smoke.py.
Interpret-mode grids stay small (B * H * chunks <= 16).
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.ssd import kernel as jax_kernel  # noqa: E402
from repro.kernels.ssd import ops as jax_ops  # noqa: E402
from repro.kernels.ssd import ref as jax_ref  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.ssd import kernel, ref, ssd_scan  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
KERNEL_TOL = 1e-5   # fp32, port's chunked version vs the interpret kernel
REF_TOL = {"atol": 5e-4, "rtol": 5e-3}   # chunked vs exact scan
                                         # (tests/test_kernels.py:181)


def _inputs(seed, b, s, h, p, n):
    """The reference tests' distributions: dt = softplus(N(0,1)) > 0,
    a_log ~ 0.5 N(0,1), B and C ~ N(0,1)/sqrt(N)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p), dtype=np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    a_log = (0.5 * rng.standard_normal(h)).astype(np.float32)
    bm = (rng.standard_normal((b, s, n)) / np.sqrt(n)).astype(np.float32)
    cm = (rng.standard_normal((b, s, n)) / np.sqrt(n)).astype(np.float32)
    return x, dt, a_log, bm, cm


def _jax(arrays):
    return [jnp.asarray(a) for a in arrays]


def _torch(arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("b,s,h,p,n,chunk", [
    (1, 64, 2, 16, 16, 32),        # mamba2-smoke's P and N, two chunks
    (2, 128, 2, 16, 32, 64),       # B=2, N=32
    (1, 64, 1, 64, 128, 64),       # mamba2-1.3b's P and N, one chunk
    (1, 48, 2, 8, 16, 128),        # chunk > S: the chunk becomes S
], ids=["smoke_dims", "batch2", "full_dims", "chunk_is_seq"])
def test_matches_pallas_kernel_interpret(b, s, h, p, n, chunk):
    arrays = _inputs(0, b, s, h, p, n)
    want = jax_kernel.ssd(*_jax(arrays), chunk=chunk, interpret=True)
    got = kernel.ssd(*_torch(arrays), chunk=chunk)
    assert got.dtype == torch.float32 and tuple(got.shape) == (b, s, h, p)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=KERNEL_TOL, rtol=KERNEL_TOL)


@pytest.mark.parametrize("b,s,h,p,n", [(1, 40, 2, 8, 16), (2, 33, 3, 4, 8)])
def test_scan_ref_matches_reference(b, s, h, p, n):
    arrays = _inputs(1, b, s, h, p, n)
    want = jax_ref.ssd_scan_ref(*_jax(arrays))
    got = ref.ssd_scan_ref(*_torch(arrays))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("chunk", [16, 32, 64])
def test_chunked_matches_reference_chunked(chunk):
    arrays = _inputs(2, 2, 128, 3, 8, 16)
    want = jax_ref.ssd_chunked_jnp(*_jax(arrays), chunk=chunk)
    got = ref.ssd_chunked(*_torch(arrays), chunk=chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=KERNEL_TOL, rtol=KERNEL_TOL)
    exact = ref.ssd_scan_ref(*_torch(arrays))
    np.testing.assert_allclose(got.numpy(), exact.numpy(), **REF_TOL)


def test_chunked_keeps_input_dtype():
    arrays = [torch.from_numpy(a) for a in _inputs(3, 1, 32, 2, 8, 16)]
    x16 = arrays[0].to(torch.bfloat16)
    out = ref.ssd_chunked(x16, *arrays[1:], chunk=16)
    assert out.dtype == torch.bfloat16
    with pytest.raises(ValueError, match="multiple of the chunk"):
        ref.ssd_chunked(*arrays, chunk=24)


@pytest.mark.parametrize("s,chunk,use_kernel", [
    (100, 16, True),      # 100 % 16 != 0: the exact scan
    (100, 16, False),
    (96, 16, True),       # the kernel (its plain version here)
    (96, 16, False),      # the plain chunked version
    (40, 128, True),      # chunk > S: chunk = S
])
def test_ops_dispatch_matches_reference(s, chunk, use_kernel):
    arrays = _inputs(4, 1, s, 2, 8, 16)
    want = jax_ops.ssd_scan(*_jax(arrays), chunk=chunk,
                            use_kernel=use_kernel, interpret=True)
    got = ssd_scan(*_torch(arrays), chunk=chunk, use_kernel=use_kernel)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=KERNEL_TOL, rtol=KERNEL_TOL)


def test_ops_odd_length_takes_exact_scan(monkeypatch):
    """s % chunk != 0 never reaches the kernel wrapper."""
    arrays = _torch(_inputs(5, 1, 100, 2, 8, 16))

    def refuse(*args, **kwargs):
        raise AssertionError("kernel wrapper reached")
    monkeypatch.setattr(kernel, "ssd", refuse)
    got = ssd_scan(*arrays, chunk=16, use_kernel=True)
    torch.testing.assert_close(got, ref.ssd_scan_ref(*arrays))


def test_decay_stability():
    """dt = 10, a_log = 2 (A = -7.4): every exponent the chunked form takes
    is far below 0 and the masked ones would overflow if exp came before
    the mask; outputs must stay finite and match the reference kernel
    (tests/test_kernels.py:200-210)."""
    b, s, h, p, n = 1, 128, 1, 8, 16
    rng = np.random.default_rng(6)
    x = rng.standard_normal((b, s, h, p), dtype=np.float32)
    dt = np.full((b, s, h), 10.0, np.float32)
    a_log = np.full((h,), 2.0, np.float32)
    bm = rng.standard_normal((b, s, n), dtype=np.float32)
    cm = rng.standard_normal((b, s, n), dtype=np.float32)
    arrays = (x, dt, a_log, bm, cm)
    got = kernel.ssd(*_torch(arrays), chunk=64)
    assert bool(torch.isfinite(got).all())
    want = jax_kernel.ssd(*_jax(arrays), chunk=64, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=KERNEL_TOL, rtol=KERNEL_TOL)


def _cpu_args(b=1, s=64, h=2, p=16, n=16):
    return [torch.zeros(shape) for shape in
            ((b, s, h, p), (b, s, h), (h,), (b, s, n), (b, s, n))]


@pytest.mark.parametrize("change,error,match", [
    (lambda a: a.__setitem__(0, a[0].to(torch.bfloat16)), TypeError,
     "float32 only"),
    (lambda a: a.__setitem__(4, torch.zeros(1, 64, 32)), ValueError,
     r"c must be \(1, 64, 16\)"),
    (lambda a: a.__setitem__(0, torch.zeros(1, 64, 2, 8)), ValueError,
     "P=8"),
    (lambda a: a.__setitem__(1, torch.zeros(1, 2, 64).transpose(1, 2)),
     ValueError, "dt must be contiguous"),
    (lambda a: a.__setitem__(3, torch.zeros(1025)[1:].view(1, 64, 16)),
     ValueError, "b must start on a 16-byte boundary"),
], ids=["bf16", "c_shape", "head_dim_8", "strided_dt", "unaligned_b"])
def test_check_inputs_raises_on_what_the_kernel_does_not_take(change, error,
                                                              match):
    args = _cpu_args()
    change(args)
    with pytest.raises(error, match=match):
        kernel.check_inputs(*args, chunk=16)


@pytest.mark.parametrize("s,chunk,match", [
    (512, 512, "chunk 512"), (96, 64, "multiple of the chunk 64")])
def test_check_inputs_raises_on_chunks(s, chunk, match):
    with pytest.raises(ValueError, match=match):
        kernel.check_inputs(*_cpu_args(s=s), chunk=chunk)


def test_instantiated_dims_cover_the_configs():
    from repro_torch.configs import get_config
    for smoke in (False, True):
        cfg = get_config("mamba2-1.3b", smoke=smoke)
        assert (cfg.ssm_state, cfg.ssm_headdim) in kernel.STATE_HEAD_DIMS
        assert cfg.ssm_chunk <= kernel.MAX_CHUNK
    kernel.check_inputs(*_cpu_args(b=2, s=256, h=3), chunk=256)


def test_kernel_source_is_found_and_hashed():
    lib = _build.library_path("ssd")
    assert lib.name == "libssd.so" and lib.parent.parent == _build.BUILD_ROOT
    src = (_build.CSRC / "ssd.cu").read_text()
    assert 'extern "C" int ssd_scan_fwd' in src
    assert "src/repro/kernels/ssd/kernel.py" in src


def test_plain_tf32_variant_fits_the_kernel_source():
    """scripts/ssd_variants.py measures the kernel against a copy of it in
    plain TF32; its edits must still fit the kernel's source and leave the
    hi.hi product alone."""
    spec = importlib.util.spec_from_file_location(
        "ssd_variants", ROOT / "scripts" / "ssd_variants.py")
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    src = (_build.CSRC / "ssd.cu").read_text()
    tf32 = script.tf32_source(src)
    assert "mma_tf32(c, a_lo, b_hi);" in src
    assert "mma_tf32(c, a_hi, b_hi);" in tf32
    assert "a_lo, b_hi" not in tf32 and "a_hi, b_lo" not in tf32


def test_wrapper_refuses_autograd_as_the_reference_does():
    """The kernel is forward-only; recording gradients through it raises on
    the CPU too (the model's plain path, ``use_kernel=False``, trains)."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(1, 32, 2, 16, generator=g, requires_grad=True)
    dt = torch.rand(1, 32, 2, generator=g) + 0.1
    a_log = torch.zeros(2, requires_grad=True)
    b, c = torch.randn(2, 1, 32, 16, generator=g)
    for args in ((x, dt, a_log.detach(), b, c),
                 (x.detach(), dt, a_log, b, c)):
        with pytest.raises(RuntimeError, match="forward-only"):
            kernel.ssd(*args, chunk=16)
        with pytest.raises(RuntimeError, match="forward-only"):
            ssd_scan(*args, chunk=16)
    plain = ssd_scan(x, dt, a_log, b, c, chunk=16, use_kernel=False)
    plain.sum().backward()
    assert x.grad is not None and a_log.grad is not None
    with torch.inference_mode():
        kernel.ssd(x, dt, a_log, b, c, chunk=16)
