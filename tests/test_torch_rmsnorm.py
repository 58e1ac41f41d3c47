"""The port's RMSNorm (``repro_torch.kernels.rmsnorm``) against the
reference's (``repro.kernels.rmsnorm``) on the same numpy inputs: the Pallas
kernel run in interpret mode, as tests/test_kernels.py runs it, and the
plain versions.

On the CPU the port's wrapper takes its plain version (``ref.rmsnorm``); the
CUDA kernel itself is held against that plain version by
tests/test_torch_gpu.py (skipped without a card) and by chip_smoke.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.rmsnorm import kernel as jax_kernel  # noqa: E402
from repro.kernels.rmsnorm import ops as jax_ops  # noqa: E402
from repro.kernels.rmsnorm import ref as jax_ref  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.rmsnorm import kernel, ref, rmsnorm  # noqa: E402

TOL = {"float32": 5e-5, "bfloat16": 5e-2}      # tests/test_kernels.py:22
JAX_DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _both(a, dtype):
    return (jnp.asarray(a).astype(JAX_DTYPES[dtype]),
            torch.from_numpy(a).to(TORCH_DTYPES[dtype]))


def _inputs(seed, shape, scale=1.0):
    rng = np.random.default_rng(seed)
    x = (scale * rng.standard_normal(shape)).astype(np.float32)
    w = rng.standard_normal(shape[-1]).astype(np.float32)
    return x, w


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("r,d", [(8, 64), (256, 512), (1024, 128),
                                 (100, 256)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matches_pallas_kernel_interpret(r, d, dtype):
    x, w = _inputs(0, (r, d))
    (jx, tx), (jw, tw) = _both(x, dtype), _both(w, dtype)
    want = jax_kernel.rmsnorm_2d(jx, jw, block_rows=64)
    got = kernel.rmsnorm_2d(tx, tw)
    assert got.dtype == TORCH_DTYPES[dtype] and tuple(got.shape) == (r, d)
    _close(got, want, TOL[dtype])


def test_leading_dims_flatten():
    x, _ = _inputs(1, (2, 3, 16, 64))
    w = np.ones(64, np.float32)
    want = jax_ops.rmsnorm(jnp.asarray(x), jnp.asarray(w))
    got = rmsnorm(torch.from_numpy(x), torch.from_numpy(w))
    assert tuple(got.shape) == (2, 3, 16, 64)
    _close(got, want, 1e-5)


@pytest.mark.parametrize("eps", [1e-6, 1e-2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ref_matches_reference_ref(dtype, eps):
    x, w = _inputs(2, (37, 24), scale=0.1)
    (jx, tx), (jw, tw) = _both(x, dtype), _both(w, dtype)
    want = jax_ref.rmsnorm(jx, jw, eps=eps)
    got = ref.rmsnorm(tx, tw, eps=eps)
    assert got.dtype == TORCH_DTYPES[dtype]
    _close(got, want, TOL[dtype])


@pytest.mark.parametrize("shape,kernel_called", [
    ((4, 12), False),              # d % 8 != 0: the plain version
    ((64,), False),                # ndim < 2
    ((4, 8), True),
    ((2, 5, 2560), True),          # leading dims flattened to (10, 2560)
])
def test_ops_dispatch_is_the_reference(monkeypatch, shape, kernel_called):
    """``ops.rmsnorm`` sends rows the kernel does not take to the plain
    version (rmsnorm/ops.py:17-22)."""
    calls = []

    def spy(x2, w, eps):
        calls.append(tuple(x2.shape))
        return ref.rmsnorm(x2, w, eps=eps)
    monkeypatch.setattr(kernel, "rmsnorm_2d", spy)
    x, w = _inputs(3, shape)
    got = rmsnorm(torch.from_numpy(x), torch.from_numpy(w))
    assert bool(calls) == kernel_called
    if kernel_called:
        assert calls == [(int(np.prod(shape[:-1])), shape[-1])]
    want = jax_ops.rmsnorm(jnp.asarray(x), jnp.asarray(w))
    _close(got, want, 1e-5)


def test_unit_weight_normalizes():
    x, _ = _inputs(4, (64, 128), scale=3.0)
    out = rmsnorm(torch.from_numpy(x), torch.ones(128)).numpy()
    np.testing.assert_allclose(np.sqrt(np.mean(out ** 2, axis=-1)), 1.0,
                               atol=1e-3)


def _ok():
    return torch.zeros(16, 64), torch.ones(64)


@pytest.mark.parametrize("change,error,match", [
    (lambda x, w: (x[0], w), ValueError, "2-D"),
    (lambda x, w: (x, torch.ones(32)), ValueError, "w must be"),
    (lambda x, w: (x.half(), w), TypeError, "dtype"),
    (lambda x, w: (torch.zeros(64, 16).t(), torch.ones(64)), ValueError,
     "contiguous"),
    (lambda x, w: (torch.zeros(16 * 64 + 1)[1:].view(16, 64), w), ValueError,
     "aligned"),
    (lambda x, w: (torch.zeros(16, 12), torch.ones(12)), ValueError,
     "multiple of 8"),
    (lambda x, w: (x[:0], w), ValueError, "empty"),
])
def test_check_inputs_raises_on_what_the_kernel_does_not_take(change, error,
                                                              match):
    x, w = change(*_ok())
    with pytest.raises(error, match=match):
        kernel.check_inputs(x, w)


def test_bad_block_rows_and_devices_raise():
    x, w = _ok()
    with pytest.raises(TypeError, match="block_rows"):
        kernel.rmsnorm_2d(x, w, block_rows=64)    # no Hopper counterpart
    with pytest.raises(ValueError, match="cpu or cuda"):
        kernel.rmsnorm_2d(x.to("meta"), w.to("meta"))


def test_cpu_never_counts_a_launch():
    kernel.launches = 0
    rmsnorm(*_ok())
    assert kernel.launches == 0


def test_kernel_source_is_found_and_hashed():
    lib = _build.library_path("rmsnorm")
    assert lib.name == "librmsnorm.so" and lib.parent.parent == \
        _build.BUILD_ROOT
    src = (_build.CSRC / "rmsnorm.cu").read_text()
    assert 'extern "C" int rmsnorm_fwd' in src
    assert "src/repro/kernels/rmsnorm/kernel.py" in src
