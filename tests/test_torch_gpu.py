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


# bf16: the kernel rounds P to bf16 (split as p_hi + p_lo, ~16 bits) and the
# output once; the plain version rounds only the output.  They differ by at
# most one bf16 unit of the output (under 2^-7 of the value, inside rtol)
# plus ~2^-16 of |v|; chip_smoke.py says more.
FLASH_TOL = [(torch.float32, {"atol": 5e-5, "rtol": 5e-5}),
             (torch.bfloat16, {"atol": 1e-3, "rtol": 1e-2})]


@pytest.mark.parametrize("dtype,tol", FLASH_TOL, ids=["fp32", "bf16"])
@pytest.mark.parametrize("s,d,hq,hkv,causal,window", [
    (1000, 80, 32, 8, True, 4096),      # ragged tail, window wider than S
    (512, 80, 32, 8, True, 64),         # the window bites
    (256, 64, 8, 8, False, 0),          # non-causal, group 1
    (256, 128, 8, 2, True, 0),          # group 4
    (1024, 256, 16, 1, True, 256),      # recurrentgemma-9b: D=256, MQA, window
    (300, 256, 4, 2, True, 0),          # D=256, causal, a ragged last tile
    (256, 256, 4, 4, False, 0),         # D=256, non-causal
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


@pytest.mark.parametrize("dtype,tol", FLASH_TOL, ids=["fp32", "bf16"])
@pytest.mark.parametrize("b,s,d,hq,hkv,window,strided", [
    (2, 512, 80, 32, 8, 1, False),      # two live keys a row
    (2, 512, 80, 32, 8, 16, False),     # 17 live keys a row
    (1, 4096, 80, 32, 8, 4096, True),   # the main path's (B,S,H,D) views
    (2, 8, 64, 8, 2, 0, False),         # shorter than one key tile
    (2, 72, 128, 8, 2, 0, True),        # one tile and a ragged second
    (1, 300, 256, 16, 1, 64, True),     # D=256: strided, ragged, windowed
], ids=["window1", "window16", "s4096_strided", "s8", "s72_strided",
        "d256_s300_strided"])
def test_kernel_matches_plain_version_at_edges(cuda_device, dtype, tol, b, s,
                                               d, hq, hkv, window, strided):
    gen = torch.Generator(device=cuda_device).manual_seed(1)

    def make(h):
        if strided:
            return torch.randn((b, s, h, d), generator=gen,
                               device=cuda_device).to(dtype).transpose(1, 2)
        return torch.randn((b, h, s, d), generator=gen,
                           device=cuda_device).to(dtype)
    q, k, v = make(hq), make(hkv), make(hkv)
    kernel.launches = 0
    got = kernel.mha(q, k, v, sm_scale=d ** -0.5, causal=True,
                     window=window)
    torch.cuda.synchronize()
    assert kernel.launches == 1
    want = ref.attention(q, k, v, sm_scale=d ** -0.5, causal=True,
                         window=window)
    torch.testing.assert_close(got.float(), want.float(), **tol)


@pytest.mark.parametrize("dtype,tol", FLASH_TOL, ids=["fp32", "bf16"])
def test_kernel_takes_views_without_16_byte_rows(cuda_device, dtype, tol):
    """Rows 81 elements apart: the bf16 kernel stages such tiles with
    element loads instead of 16-byte copies."""
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    q, k, v = (torch.randn((1, h, 300, 81), generator=gen,
                           device=cuda_device).to(dtype)[..., :80]
               for h in (8, 2, 2))
    got = kernel.mha(q, k, v, sm_scale=80 ** -0.5, causal=True, window=64)
    want = ref.attention(q, k, v, sm_scale=80 ** -0.5, causal=True,
                         window=64)
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
# same algorithm with sums in another order, fp32 throughout; and against
# the exact scan at the reference's tolerance (tests/test_kernels.py:181).
SSD_TOL = {"atol": 1e-4, "rtol": 1e-4}
SSD_EXACT_TOL = {"atol": 5e-4, "rtol": 5e-3}


@pytest.mark.parametrize("b,s,h,p,n,chunk", [
    (1, 1024, 8, 64, 128, 256),         # mamba2-1.3b's dims, 4 chunks
    (2, 384, 4, 64, 128, 128),          # B=2, chunk 128
    (2, 200, 3, 16, 16, 256),           # mamba2-smoke's dims, s < chunk
    (1, 512, 3, 64, 128, 256),          # fewer heads than a group of 16
    (1, 512, 17, 64, 128, 128),         # a last group of one head
    (1, 300, 5, 64, 128, 100),          # ragged chunk 100
    (1, 200, 8, 64, 128, 200),          # chunk 200, s = 200
    (2, 256, 9, 16, 16, 64),            # B=2, mamba2-smoke's dims, odd H
    (1, 1024, 64, 64, 128, 256),        # mamba2-1.3b's dims and heads
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
    torch.testing.assert_close(
        got, ssd_ref.ssd_scan_ref(x, dt, a_log, bm, cm), **SSD_EXACT_TOL)


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
    (256, 256, 8192),                   # deep: 3xTF32 against 5e-5 sqrt(k)
    (129, 4097, 257),                   # no row a whole 16-byte chunk
    (64, 64, 8),                        # the least k the op sends the kernel
])
def test_matmul_kernel_matches_plain_version(cuda_device, dtype, m, n, k):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    a = torch.randn((m, k), generator=gen, device=cuda_device).to(dtype)
    b = torch.randn((k, n), generator=gen, device=cuda_device).to(dtype)
    mm_kernel.launches = 0
    tiles = mm_kernel.TILES[dtype]
    outs = [mm_kernel.matmul_tiled(a, b, bm=bm, bn=bn) for bm, bn in tiles]
    torch.cuda.synchronize()
    assert mm_kernel.launches == len(tiles) >= 4
    as_int = torch.int16 if dtype == torch.bfloat16 else torch.int32
    for out in outs[1:]:                    # the same bits from every tile
        assert torch.equal(out.view(as_int), outs[0].view(as_int))
    want = mm_ref.matmul(a, b)
    tol = KERNEL_TOL[dtype]
    torch.testing.assert_close(outs[0].float(), want.float(),
                               atol=tol * k ** 0.5, rtol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_selected_blocks_launch_an_instantiated_tile(cuda_device, dtype):
    """``select_blocks``' pick, passed to the op as the reference's callers
    pass (bm, bn, bk), launches that tile, with the bits of every other."""
    from repro_torch.core import hardware
    from repro_torch.kernels.matmul import ops
    m, n, k = 1000, 640, 520
    precision = {torch.float32: "fp32", torch.bfloat16: "bf16"}[dtype]
    (bm, bn, bk), costs = ops.select_blocks(m, n, k, precision=precision,
                                            hw=hardware.get("h100"))
    assert (bm, bn) in mm_kernel.TILES[dtype] and bk == mm_kernel.BK
    assert mm_kernel.hopper_tile(m, n, bm, bn, dtype) == (bm, bn)
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    a = torch.randn((m, k), generator=gen, device=cuda_device).to(dtype)
    b = torch.randn((k, n), generator=gen, device=cuda_device).to(dtype)
    mm_kernel.launches = 0
    got = matmul(a, b, bm=bm, bn=bn, bk=bk)
    other = mm_kernel.matmul_tiled(a, b)            # the default tile
    torch.cuda.synchronize()
    assert mm_kernel.launches == 2
    as_int = torch.int16 if dtype == torch.bfloat16 else torch.int32
    assert torch.equal(got.view(as_int), other.view(as_int))
    tol = KERNEL_TOL[dtype]
    torch.testing.assert_close(got.float(), mm_ref.matmul(a, b).float(),
                               atol=tol * k ** 0.5, rtol=tol)


def test_fp32_refuses_a_bf16_only_tile_on_card(cuda_device):
    """128 x 256 is instantiated for bf16 inputs only: fp32 maps it to the
    square tile; the C entry point refuses it outright (-1)."""
    assert mm_kernel.hopper_tile(512, 512, 128, 256, torch.float32) == \
        (128, 128)
    a = torch.ones((64, 64), device=cuda_device)
    out = torch.empty_like(a)
    err = mm_kernel._entry()(a.data_ptr(), a.data_ptr(), out.data_ptr(), 64,
                             64, 64, 0, 0, 128, 256,
                             torch.cuda.current_stream().cuda_stream)
    assert err == -1


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
