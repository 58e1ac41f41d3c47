"""The port's CUDA kernels on the card: each against its plain PyTorch
version (the matmul also bit for bit across its tiles), danube-smoke's and
mamba2-smoke's prefill on the card against the same model on the CPU, and
the paper's loop (calibrate_device and the quick validation suite) on the
card.  Every test here is marked ``gpu`` and skips
without a card; on a card machine run them with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

This file imports neither JAX nor the reference package, so it runs on a card
machine that has only PyTorch.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.device import generator  # noqa: E402
from repro_torch.core import microbench  # noqa: E402
from repro_torch.kernels.flash_attention import kernel, ref  # noqa: E402
from repro_torch.kernels.matmul import kernel as mm_kernel  # noqa: E402
from repro_torch.kernels.matmul import matmul  # noqa: E402
from repro_torch.kernels.matmul import ref as mm_ref  # noqa: E402
from repro_torch.kernels.rmsnorm import kernel as rms_kernel  # noqa: E402
from repro_torch.kernels.rmsnorm import ref as rms_ref  # noqa: E402
from repro_torch.kernels.rmsnorm import rmsnorm  # noqa: E402
from repro_torch.kernels.ssd import kernel as ssd_kernel  # noqa: E402
from repro_torch.kernels.ssd import ref as ssd_ref  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.train import serve_step  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# bf16: both sides round one fp32 result, so they differ by at most one bf16
# unit (under 2^-7 of the value, inside rtol); chip_smoke.py says more.
@pytest.mark.parametrize("dtype,tol", [
    (torch.float32, {"atol": 5e-5, "rtol": 5e-5}),
    (torch.bfloat16, {"atol": 1e-3, "rtol": 1e-2})], ids=["fp32", "bf16"])
@pytest.mark.parametrize("s,d,hq,hkv,causal,window", [
    (1000, 80, 32, 8, True, 4096),      # ragged tail, window wider than S
    (512, 80, 32, 8, True, 64),         # the window bites
    (256, 64, 8, 8, False, 0),          # non-causal, group 1
    (256, 128, 8, 2, True, 0),          # group 4
])
def test_kernel_matches_plain_version(cuda_device, dtype, tol, s, d, hq,
                                      hkv, causal, window):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    q, k, v = (torch.randn((2, h, s, d), generator=gen,
                           device=cuda_device).to(dtype)
               for h in (hq, hkv, hkv))
    kernel.launches = 0
    got = kernel.mha(q, k, v, sm_scale=d ** -0.5, causal=causal,
                     window=window)
    torch.cuda.synchronize()
    assert kernel.launches == 1
    want = ref.attention(q, k, v, sm_scale=d ** -0.5, causal=causal,
                         window=window)
    torch.testing.assert_close(got.float(), want.float(), **tol)


def test_unsupported_head_dim_raises_on_card(cuda_device):
    q = torch.zeros((1, 2, 64, 96), device=cuda_device)
    with pytest.raises(ValueError, match="head dim 96"):
        kernel.mha(q, q, q, sm_scale=1.0)


def test_smoke_forward_on_card_matches_cpu(cuda_device):
    cfg = get_config("h2o-danube-1.8b", smoke=True).replace(
        use_flash_kernel=True)
    on_cpu = build(cfg, "cpu").init(generator(0, "cpu"))
    on_card = build(cfg, cuda_device)
    on_card.load_state_dict(on_cpu.state_dict())
    tokens = torch.randint(0, cfg.vocab, (2, 256),
                           generator=generator(1, "cpu"))
    kernel.launches = 0
    got = serve_step.make_prefill(on_card)(tokens.to(cuda_device))
    torch.cuda.synchronize()
    assert kernel.launches == cfg.n_layers
    want = serve_step.make_prefill(on_cpu)(tokens)
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)


# The SSD kernel against the plain chunked version at the same chunk: the
# same algorithm with sums in another order, fp32 throughout.
SSD_TOL = {"atol": 1e-4, "rtol": 1e-4}


@pytest.mark.parametrize("b,s,h,p,n,chunk", [
    (1, 1024, 8, 64, 128, 256),         # mamba2-1.3b's dims, 4 chunks
    (2, 384, 4, 64, 128, 128),          # B=2, chunk 128
    (2, 200, 3, 16, 16, 256),           # mamba2-smoke's dims, s < chunk
])
def test_ssd_kernel_matches_plain_version(cuda_device, b, s, h, p, n,
                                          chunk):
    gen = torch.Generator(device=cuda_device).manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=cuda_device)
    x = randn(b, s, h, p)
    dt = torch.nn.functional.softplus(randn(b, s, h))
    a_log = 0.5 * randn(h)
    bm, cm = randn(b, s, n) / n ** 0.5, randn(b, s, n) / n ** 0.5
    ssd_kernel.launches = 0
    got = ssd_kernel.ssd(x, dt, a_log, bm, cm, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd_kernel.launches == 1
    want = ssd_ref.ssd_chunked(x, dt, a_log, bm, cm, chunk=min(chunk, s))
    torch.testing.assert_close(got, want, **SSD_TOL)


def test_ssd_unsupported_dims_raise_on_card(cuda_device):
    x = torch.zeros((1, 64, 2, 32), device=cuda_device)
    bm = torch.zeros((1, 64, 16), device=cuda_device)
    dt = torch.zeros((1, 64, 2), device=cuda_device)
    with pytest.raises(ValueError, match="P=32"):
        ssd_kernel.ssd(x, dt, torch.zeros(2, device=cuda_device), bm, bm,
                       chunk=64)


def test_mamba2_smoke_prefill_on_card_matches_cpu(cuda_device):
    cfg = get_config("mamba2-1.3b", smoke=True).replace(
        use_flash_kernel=True)
    on_cpu = build(cfg, "cpu").init(generator(0, "cpu"))
    on_card = build(cfg, cuda_device)
    on_card.load_state_dict(on_cpu.state_dict())
    tokens = torch.randint(0, cfg.vocab, (2, 256),
                           generator=generator(1, "cpu"))
    ssd_kernel.launches = 0
    got = serve_step.make_prefill(on_card)(tokens.to(cuda_device))
    torch.cuda.synchronize()
    assert ssd_kernel.launches == cfg.n_layers
    want = serve_step.make_prefill(on_cpu)(tokens)
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)


# The reference's kernel tolerances (tests/test_kernels.py:22, 112-114,
# 139-150): matmul atol tol * sqrt(k), rtol tol; rmsnorm atol = rtol = tol.
KERNEL_TOL = {torch.float32: 5e-5, torch.bfloat16: 5e-2}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("m,n,k", [
    (8, 8, 8), (100, 257, 1000), (64, 64, 200), (1024, 1024, 1024),
    (4095, 257, 129),
])
def test_matmul_kernel_matches_plain_version(cuda_device, dtype, m, n, k):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    a = torch.randn((m, k), generator=gen, device=cuda_device).to(dtype)
    b = torch.randn((k, n), generator=gen, device=cuda_device).to(dtype)
    mm_kernel.launches = 0
    outs = [mm_kernel.matmul_tiled(a, b, bm=t, bn=t)
            for t in mm_kernel.TILES]
    torch.cuda.synchronize()
    assert mm_kernel.launches == len(mm_kernel.TILES)
    as_int = torch.int16 if dtype == torch.bfloat16 else torch.int32
    for out in outs[1:]:                    # the same bits from every tile
        assert torch.equal(out.view(as_int), outs[0].view(as_int))
    want = mm_ref.matmul(a, b)
    tol = KERNEL_TOL[dtype]
    torch.testing.assert_close(outs[0].float(), want.float(),
                               atol=tol * k ** 0.5, rtol=tol)


def test_matmul_out_dtype_and_dispatch_on_card(cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    a = torch.randn((96, 40), generator=gen, device=cuda_device)
    b = torch.randn((40, 72), generator=gen, device=cuda_device)
    mm_kernel.launches = 0
    got = matmul(a, b, out_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16 and mm_kernel.launches == 1
    torch.testing.assert_close(got, mm_ref.matmul(a, b,
                                                  out_dtype=torch.bfloat16))
    matmul(a[:4].contiguous(), b)          # min(m, n, k) < 8: plain version
    assert mm_kernel.launches == 1
    with pytest.raises(ValueError, match="row-major"):
        mm_kernel.matmul_tiled(a.t(), a)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape", [
    (1, 8), (100, 64), (2, 3, 16, 64),      # one warp a row
    (33, 1024), (4096, 2560), (7, 8192),    # one block a row, in registers
    (3, 16384),                             # fp32: one warp, read twice
])
def test_rmsnorm_kernel_matches_plain_version(cuda_device, dtype, shape):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randn(shape, generator=gen, device=cuda_device).to(dtype)
    w = torch.randn(shape[-1], generator=gen, device=cuda_device).to(dtype)
    rms_kernel.launches = 0
    got = rmsnorm(x, w)
    torch.cuda.synchronize()
    assert rms_kernel.launches == 1
    assert got.dtype == dtype and got.shape == x.shape
    tol = KERNEL_TOL[dtype]
    torch.testing.assert_close(got.float(), rms_ref.rmsnorm(x, w).float(),
                               atol=tol, rtol=tol)


def test_rmsnorm_eps_and_mixed_weight_on_card(cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    x = 1e-2 * torch.randn((33, 128), generator=gen, device=cuda_device)
    w = torch.randn(128, generator=gen, device=cuda_device)
    got = rms_kernel.rmsnorm_2d(x.bfloat16(), w, eps=1e-3)
    want = rms_ref.rmsnorm(x.bfloat16(), w, eps=1e-3)
    torch.testing.assert_close(got.float(), want.float(), atol=5e-2,
                               rtol=5e-2)


def test_calibrate_and_quick_suite_on_card(cuda_device):
    if torch.cuda.get_device_name(cuda_device) != microbench.H100_SXM_NAME:
        with pytest.raises(RuntimeError, match="H100"):
            microbench.calibrate_device(quick=True)
        return
    hw = microbench.calibrate_device(quick=True)
    assert hw.name == "h100_measured" and hw.model_family == "blackwell"
    assert hw.hbm_sustained_bw > 0 and hw.launch_latency_s > 0
    mm_kernel.launches = rms_kernel.launches = 0
    suite = microbench.device_suite_result(quick=True)
    sz = microbench.QUICK
    runs = 1 + sz.warmups + sz.repeats
    assert mm_kernel.launches == len(sz.gemm_kernels) * runs
    assert rms_kernel.launches == runs
    assert len(suite) == 10 and all(t > 0 for t in suite.measured_s)
