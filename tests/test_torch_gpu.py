"""The port's CUDA kernels on the card: each against its plain PyTorch
version (the matmul also bit for bit across its tiles), danube-smoke's,
mamba2-smoke's, qwen3moe-smoke's, dsv3-smoke's, rg-smoke's, whisper-smoke's
and vlm-smoke's forward on the card against the same model on the CPU, and the paper's loop (calibrate_device
and the quick validation suite) on the card; minicpm-, deepseek67b- and
llama405b-smoke's kernel path against the plain path; the expert-parallel
MoE layer on two ranks that share the card over gloo.  Every test here is
marked ``gpu`` and skips without a card; on a card machine run them with

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


def _takes_wgmma(q, k, v) -> int:
    """1 where the wrapper's rule sends these inputs to the wgmma + TMA
    kernel, else 0."""
    d = kernel.padded_head_dim(q.shape[-1])
    return int(kernel.select_design(q.dtype, d, kernel.tma_aligned(q, k, v))
               == "wgmma")


@pytest.mark.parametrize("dtype,tol", FLASH_TOL, ids=["fp32", "bf16"])
@pytest.mark.parametrize("s,d,hq,hkv,causal,window", [
    (1000, 80, 32, 8, True, 4096),      # ragged tail, window wider than S
    (512, 80, 32, 8, True, 64),         # the window bites
    (256, 64, 8, 8, False, 0),          # non-causal, group 1
    (256, 128, 8, 2, True, 0),          # group 4
    (1024, 256, 16, 1, True, 256),      # recurrentgemma-9b: D=256, MQA, window
    (300, 256, 4, 2, True, 0),          # D=256, causal, a ragged last tile
    (256, 256, 4, 4, False, 0),         # D=256, non-causal
    (1536, 64, 6, 6, False, 0),         # whisper-tiny's encoder
    (2048, 128, 64, 8, True, 0),        # llama-3.2-vision: GQA group 8
    # danube's shape at lengths off the 128 grid and mostly off the 8 one:
    # one row, a tail in the first Q tile, either side of a Q tile, and
    # chat prompts, each a ragged last key tile the kernel masks
    (1, 80, 32, 8, True, 4096),
    (7, 80, 32, 8, True, 4096),
    (9, 80, 32, 8, True, 4096),
    (127, 80, 32, 8, True, 4096),
    (129, 80, 32, 8, True, 4096),
    (299, 80, 32, 8, True, 4096),
    (1007, 80, 32, 8, True, 4096),
    (1181, 80, 32, 8, True, 4096),
    (3181, 80, 32, 8, True, 4096),
    (3669, 80, 32, 8, True, 4096),
    # non-causal off both grids, where only the key mask hides the tail:
    # whisper-tiny's 1500 frames, and D=128
    (1500, 64, 6, 6, False, 0),
    (999, 128, 8, 2, False, 0),
])
def test_kernel_matches_plain_version(cuda_device, dtype, tol, s, d, hq,
                                      hkv, causal, window):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    q, k, v = (torch.randn((2, h, s, d), generator=gen,
                           device=cuda_device).to(dtype)
               for h in (hq, hkv, hkv))
    kernel.launches = kernel.wgmma_launches = 0
    got = kernel.mha(q, k, v, sm_scale=d ** -0.5, causal=causal,
                     window=window)
    torch.cuda.synchronize()
    assert kernel.launches == 1
    assert kernel.wgmma_launches == _takes_wgmma(q, k, v)
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
    kernel.launches = kernel.wgmma_launches = 0
    got = kernel.mha(q, k, v, sm_scale=d ** -0.5, causal=True,
                     window=window)
    torch.cuda.synchronize()
    assert kernel.launches == 1
    assert kernel.wgmma_launches == _takes_wgmma(q, k, v)
    want = ref.attention(q, k, v, sm_scale=d ** -0.5, causal=True,
                         window=window)
    torch.testing.assert_close(got.float(), want.float(), **tol)


@pytest.mark.parametrize("dtype,tol", FLASH_TOL, ids=["fp32", "bf16"])
def test_kernel_takes_views_without_16_byte_rows(cuda_device, dtype, tol):
    """Rows 81 elements apart: TMA cannot describe them, so bf16 stays on
    the mma.sync kernel, which stages such tiles with element loads
    instead of 16-byte copies."""
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    q, k, v = (torch.randn((1, h, 300, 81), generator=gen,
                           device=cuda_device).to(dtype)[..., :80]
               for h in (8, 2, 2))
    kernel.launches = kernel.wgmma_launches = 0
    got = kernel.mha(q, k, v, sm_scale=80 ** -0.5, causal=True, window=64)
    torch.cuda.synchronize()
    assert (kernel.launches, kernel.wgmma_launches) == (1, 0)
    want = ref.attention(q, k, v, sm_scale=80 ** -0.5, causal=True,
                         window=64)
    torch.testing.assert_close(got.float(), want.float(), **tol)


def _bshd_views(b, s, hq, hkv, d, dtype, seed):
    """q, k, v as the model hands them over: (B, H, S, D) views of
    (B, S, H, D) tensors."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn((b, s, h, d), generator=gen,
                        device="cuda").to(dtype).transpose(1, 2)
            for h in (hq, hkv, hkv)]


@pytest.mark.parametrize("s,hq,hkv,window", [
    (8192, 32, 8, 4096),                # danube's prefill at full length
    (299, 32, 8, 4096),                 # chat's ragged lengths
    (1007, 32, 8, 4096),
    (3669, 32, 8, 4096),
    (1024, 8, 8, 4096),                 # GQA group 1
    (1024, 32, 8, 256),                 # group 4, the window bites
    (1024, 64, 8, 4096),                # group 8
], ids=["s8192_w4096", "s299", "s1007", "s3669", "group1", "group4_w256",
        "group8"])
def test_wgmma_kernel_at_danube_shapes(cuda_device, s, hq, hkv, window):
    """bf16 at head dim 80 through strided (B, S, H, D) views takes the
    wgmma + TMA kernel, within FLASH_TOL of the plain version."""
    q, k, v = _bshd_views(1, s, hq, hkv, 80, torch.bfloat16, 5)
    kernel.launches = kernel.wgmma_launches = 0
    got = kernel.mha(q, k, v, sm_scale=80 ** -0.5, causal=True,
                     window=window)
    torch.cuda.synchronize()
    assert (kernel.launches, kernel.wgmma_launches) == (1, 1)
    want = ref.attention(q, k, v, sm_scale=80 ** -0.5, causal=True,
                         window=window)
    torch.testing.assert_close(got.float(), want.float(),
                               **dict(FLASH_TOL)[torch.bfloat16])


@pytest.mark.parametrize("dtype,d,hq,hkv,window", [
    (torch.float32, 80, 32, 8, 4096),   # fp32: the CUDA-core kernel
    (torch.bfloat16, 256, 16, 1, 2048),  # D 256: mma.sync
    (torch.bfloat16, 16, 4, 1, 8),       # D 16: mma.sync
], ids=["fp32_d80", "bf16_d256", "bf16_d16"])
def test_fallbacks_leave_the_wgmma_kernel(cuda_device, dtype, d, hq, hkv,
                                          window):
    q, k, v = _bshd_views(1, 1000, hq, hkv, d, dtype, 6)
    kernel.launches = kernel.wgmma_launches = 0
    got = kernel.mha(q, k, v, sm_scale=d ** -0.5, causal=True, window=window)
    torch.cuda.synchronize()
    assert (kernel.launches, kernel.wgmma_launches) == (1, 0)
    want = ref.attention(q, k, v, sm_scale=d ** -0.5, causal=True,
                         window=window)
    torch.testing.assert_close(got.float(), want.float(),
                               **dict(FLASH_TOL)[dtype])


def test_unsupported_head_dim_raises_on_card(cuda_device):
    """Head dims up to 256 run (padded where not instantiated); above 256
    the reference's kernel cannot tile either, and the wrapper raises."""
    q = torch.zeros((1, 2, 64, 288), device=cuda_device)
    with pytest.raises(ValueError, match="head dim 288"):
        kernel.mha(q, q, q, sm_scale=1.0)


@pytest.mark.parametrize("dtype,tol", FLASH_TOL, ids=["fp32", "bf16"])
@pytest.mark.parametrize("b,s,d,hq,hkv,window,strided", [
    (1, 1024, 16, 4, 1, 8, False),      # recurrentgemma-9b smoke: D=16
    (2, 300, 16, 4, 2, 0, True),        # D=16: strided, ragged, causal
    (1, 1024, 40, 4, 1, 8, False),      # d=40, padded to 64
    (2, 300, 40, 8, 2, 64, True),       # d=40 from strided views
], ids=["d16", "d16_s300_strided", "d40", "d40_s300_strided"])
def test_small_and_padded_head_dims_match_plain_version(
        cuda_device, dtype, tol, b, s, d, hq, hkv, window, strided):
    gen = torch.Generator(device=cuda_device).manual_seed(3)

    def make(h):
        if strided:
            return torch.randn((b, s, h, d), generator=gen,
                               device=cuda_device).to(dtype).transpose(1, 2)
        return torch.randn((b, h, s, d), generator=gen,
                           device=cuda_device).to(dtype)
    q, k, v = make(hq), make(hkv), make(hkv)
    kernel.launches = kernel.wgmma_launches = 0
    got = kernel.mha(q, k, v, sm_scale=d ** -0.5, causal=True,
                     window=window)
    torch.cuda.synchronize()
    assert kernel.launches == 1
    # d = 40 runs padded, in fresh contiguous tensors, at 64
    assert kernel.wgmma_launches == (dtype == torch.bfloat16 and d == 40)
    assert got.shape == q.shape and got.is_contiguous()
    want = ref.attention(q, k, v, sm_scale=d ** -0.5, causal=True,
                         window=window)
    torch.testing.assert_close(got.float(), want.float(), **tol)


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


@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b", "deepseek-v3-671b"])
def test_moe_smoke_forward_on_card_matches_cpu(cuda_device, arch):
    """qwen3moe-smoke (GQA + MoE: a flash launch per layer) and dsv3-smoke
    (MLA, which launches none, + the MHA dense prefix: one): logits and the
    aux loss on the card against the CPU."""
    cfg = get_config(arch, smoke=True).replace(use_flash_kernel=True)
    on_cpu = build(cfg, "cpu").init(generator(0, "cpu"))
    on_card = build(cfg, cuda_device)
    on_card.load_state_dict(on_cpu.state_dict())
    tokens = torch.randint(0, cfg.vocab, (2, 256),
                           generator=generator(1, "cpu"))
    kernel.launches = 0
    with torch.inference_mode():
        got, got_aux = on_card.forward(tokens.to(cuda_device))
        torch.cuda.synchronize()
        assert kernel.launches == (cfg.first_dense if cfg.use_mla
                                   else cfg.n_layers)
        want, want_aux = on_cpu.forward(tokens)
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(got_aux.cpu(), want_aux, atol=1e-6,
                               rtol=1e-5)


@pytest.mark.parametrize("arch,launches", [
    ("recurrentgemma-9b", 1),           # one local_attn block
    ("whisper-tiny", 4),                # 2 encoder (non-causal) + 2 decoder
    ("llama-3.2-vision-90b", 5),        # 4 attn + the cross block's self
])
def test_memory_and_hybrid_smoke_forward_on_card_matches_cpu(
        cuda_device, arch, launches):
    """rg-smoke, whisper-smoke and vlm-smoke with every xgate at 0.5 (0 at
    init would hide the cross-attention): logits on the card against the
    CPU, and the kernel's launches (cross-attention reaches none)."""
    from repro_torch.configs import memory_len
    from repro_torch.models.blocks import CrossAttnBlock
    cfg = get_config(arch, smoke=True).replace(use_flash_kernel=True)
    on_cpu = build(cfg, "cpu").init(generator(0, "cpu"))
    with torch.no_grad():
        for m in on_cpu.modules():
            if isinstance(m, CrossAttnBlock):
                m.xgate.fill_(0.5)
    on_card = build(cfg, cuda_device)
    on_card.load_state_dict(on_cpu.state_dict())
    tokens = torch.randint(0, cfg.vocab, (2, 256),
                           generator=generator(1, "cpu"))
    mlen = memory_len(cfg, 256)
    mem = None if mlen is None else torch.randn(
        (2, mlen, cfg.d_model), generator=generator(2, "cpu"))
    kernel.launches = 0
    got = serve_step.make_prefill(on_card)(
        tokens.to(cuda_device), None if mem is None else mem.to(cuda_device))
    torch.cuda.synchronize()
    assert kernel.launches == launches
    want = serve_step.make_prefill(on_cpu)(tokens, mem)
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("s", [299, 1007])
def test_ragged_prefill_kernel_path_matches_plain_on_card(cuda_device, s):
    """danube-smoke through make_prefill at prompt lengths that are
    multiples of neither 128 nor 8: every layer's attention launches the
    kernel once, and the logits match the plain path's on the card.  In
    fp32, at the tolerance of the other make_prefill checks here; the bf16
    paths are held by the next test."""
    cfg = get_config("h2o-danube-1.8b", smoke=True).replace(
        use_flash_kernel=True)
    model = build(cfg, cuda_device).init(generator(0, cuda_device))
    tokens = torch.randint(0, cfg.vocab, (2, s),
                           generator=generator(1, "cpu")).to(cuda_device)
    kernel.launches = 0
    got = serve_step.make_prefill(model)(tokens)
    torch.cuda.synchronize()
    assert kernel.launches == cfg.n_layers
    model.cfg = cfg.replace(use_flash_kernel=False)
    want = serve_step.make_prefill(model)(tokens)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("s", [256, 299, 1007])
def test_ragged_prefill_bf16_kernel_path_as_close_as_plain_on_card(
        cuda_device, s):
    """danube-smoke in bf16, the served dtype, through make_prefill: the
    kernel path (one launch a layer) and the plain path, each held against
    the fp32 plain path's logits.  The two bf16 paths part by the residual
    stream's rounding, so neither is the other's yardstick; the kernel path
    passes if its gap is at most 1.5 times the plain path's, plus 1e-3.  On
    an H100 the gaps read 0.0056 / 0.0098 / 0.0045 (kernel) and 0.0056 /
    0.0108 / 0.0041 (plain) at S 256 / 299 / 1007."""
    base = get_config("h2o-danube-1.8b", smoke=True)
    m32 = build(base, cuda_device).init(generator(0, cuda_device))
    m16 = build(base.replace(dtype="bfloat16", param_dtype="bfloat16"),
                cuda_device)
    m16.load_state_dict({k: v.bfloat16()
                         for k, v in m32.state_dict().items()})
    tokens = torch.randint(0, base.vocab, (2, s),
                           generator=generator(1, "cpu")).to(cuda_device)
    want = serve_step.make_prefill(m32)(tokens)
    m16.cfg = m16.cfg.replace(use_flash_kernel=True)
    kernel.launches = 0
    got = serve_step.make_prefill(m16)(tokens).float()
    torch.cuda.synchronize()
    assert kernel.launches == base.n_layers
    m16.cfg = m16.cfg.replace(use_flash_kernel=False)
    plain16 = serve_step.make_prefill(m16)(tokens).float()
    kernel_gap = (got - want).abs().max().item()
    plain_gap = (plain16 - want).abs().max().item()
    assert kernel_gap <= 1.5 * plain_gap + 1e-3, (kernel_gap, plain_gap)


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


def _device_files_open(pid: int) -> int:
    """Open files of the process on /dev/nvidia*: held by any process with
    a CUDA context, by none that has only imported torch."""
    import os
    from pathlib import Path
    n = 0
    for fd in Path(f"/proc/{pid}/fd").iterdir():
        try:
            n += os.readlink(fd).startswith("/dev/nvidia")
        except OSError:
            continue
    return n


def test_prediction_server_holds_no_cuda_context(cuda_device):
    """The port's prediction server prices with numpy: started by
    ``subproc`` beside a process that holds a context, and asked for an
    argmin, it holds none of the card's device files open (this process
    does), and nvidia-smi does not list it."""
    import os
    import subprocess

    from repro_torch.core.workload import (TileConfig, WorkloadTable,
                                           gemm_workload)
    from repro_torch.serve import subproc
    from repro_torch.serve.client import PredictionClient
    torch.zeros(1, device=cuda_device)          # this process: a context
    torch.cuda.synchronize()
    proc, host, port = subproc.start_server_subprocess()
    try:
        with PredictionClient(host, port) as client:
            table = WorkloadTable.tile_lattice(
                gemm_workload("g", 4096, 4096, 4096, precision="bf16"),
                [TileConfig(128, 128, 64), TileConfig(128, 256, 64)])
            assert client.argmin(table, "h100", deadline_s=60.0).index in (
                0, 1)
        out = subprocess.run(
            ["nvidia-smi", "--query-compute-apps=pid",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60).stdout
        assert proc.pid not in {int(w) for w in out.split() if w.isdigit()}
        assert _device_files_open(os.getpid()) > 0
        assert _device_files_open(proc.pid) == 0
    finally:
        subproc.stop_server_subprocess(proc)


def test_kernel_wrappers_refuse_autograd_on_card(cuda_device):
    """A ctypes launch would return an output without a grad_fn and drop
    the gradients; each wrapper raises instead, before any launch."""
    def t(*shape, grad=False):
        return torch.randn(*shape, device=cuda_device, requires_grad=grad)
    calls = {
        "flash_attention": lambda: kernel.mha(
            t(1, 4, 128, 64, grad=True), t(1, 2, 128, 64),
            t(1, 2, 128, 64), sm_scale=0.125),
        "ssd": lambda: ssd_kernel.ssd(
            t(1, 64, 2, 16, grad=True), torch.rand(1, 64, 2,
                                                   device=cuda_device),
            torch.zeros(2, device=cuda_device), t(1, 64, 16), t(1, 64, 16),
            chunk=16),
        "matmul": lambda: mm_kernel.matmul_tiled(t(64, 64),
                                                 t(64, 64, grad=True)),
        "rmsnorm": lambda: rms_kernel.rmsnorm_2d(t(8, 64, grad=True),
                                                 torch.ones(64,
                                                            device=cuda_device)),
    }
    mods = {"flash_attention": kernel, "ssd": ssd_kernel,
            "matmul": mm_kernel, "rmsnorm": rms_kernel}
    for name, call in calls.items():
        mods[name].launches = 0
        with pytest.raises(RuntimeError, match="forward-only"):
            call()
        with torch.no_grad():
            out = call()
        torch.cuda.synchronize()
        assert out.grad_fn is None and mods[name].launches == 1, name


@pytest.mark.parametrize("remat,microbatches",
                         [("none", 1), ("block", 2), ("full", 1)])
def test_smoke_train_steps_on_card_match_cpu(cuda_device, remat,
                                             microbatches):
    """danube-smoke trained 3 steps on the card and on the CPU from the same
    weights and batches, at the reference's grad-accumulation tolerance
    (tests/test_substrate.py:213-215); no kernel is launched."""
    from repro_torch.data import SyntheticLMData
    from repro_torch.models.convert import params_from_jax, params_to_jax
    from repro_torch.train import train_step
    cfg = get_config("h2o-danube-1.8b", smoke=True).replace(remat=remat)
    tree = params_to_jax(build(cfg, "cpu").init(generator(0, "cpu")))
    data = SyntheticLMData(cfg, batch=4, seq_len=64, seed=1)
    runs = {}
    kernel.launches = 0
    for dev in ("cpu", cuda_device):
        model = params_from_jax(tree, cfg, device=dev)
        state = train_step.init_state(model)
        step = train_step.make_train_step(model, lr=1e-3,
                                          microbatches=microbatches)
        losses = []
        for i in range(3):
            batch = {k: torch.from_numpy(v).to(dev)
                     for k, v in data.batch_at(i).items()}
            state, metrics = step(state, batch)
            losses.append(float(metrics["loss"]))
        runs[str(dev)] = (losses, params_to_jax(model))
    assert kernel.launches == 0
    cpu, card = runs["cpu"], runs[str(cuda_device)]
    torch.testing.assert_close(torch.tensor(card[0]), torch.tensor(cpu[0]),
                               atol=2e-5, rtol=2e-4)

    def leaves(tree, prefix=""):
        for k, v in sorted(tree.items()):
            if isinstance(v, dict):
                yield from leaves(v, f"{prefix}{k}/")
            else:
                yield f"{prefix}{k}", torch.from_numpy(v)
    got, want = dict(leaves(card[1])), dict(leaves(cpu[1]))
    assert got.keys() == want.keys()
    for name in want:
        torch.testing.assert_close(got[name], want[name], atol=2e-5,
                                   rtol=2e-4, msg=name)


def test_int8_moment_updates_on_card_match_cpu(cuda_device):
    """danube-smoke: three chained ``q8nd_adamw_update`` steps on the CPU,
    each also run on the card from the CPU's state, and a free-running
    chain on the card, from the same weights, zero state and gradients.
    Given the same state, codes differ only where the card's log / exp and
    the CPU's differ by an ulp at a rounding boundary: by at most 1, in at
    most 1e-4 of them, params within a tenth of lr.  Run free, a code that
    parted carries its difference on: at most 1e-4 of the codes differ and
    the params stay within three steps of a tenth of lr (chip_smoke.py's
    [train_q8] gates)."""
    import numpy as np
    from repro_torch.models.convert import (params_from_jax, params_to_jax,
                                            state_from_jax, state_to_jax)
    from repro_torch.optim.quantized_moments import q8nd_adamw_update
    from repro_torch.train import train_step
    cfg = get_config("h2o-danube-1.8b", smoke=True)
    model = build(cfg, "cpu").init(generator(0, "cpu"))
    tree = params_to_jax(model)
    rng = np.random.default_rng(3)
    grads = [{k: np.asarray(rng.standard_normal(p.shape) * 0.1, np.float32)
              for k, p in model.named_parameters()} for _ in range(3)]
    devices = {"cpu": "cpu", "card": cuda_device, "free": cuda_device}
    states = {k: train_step.init_state(params_from_jax(tree, cfg, device=d),
                                       moment_dtype="int8")
              for k, d in devices.items()}

    def leaves(tree, prefix=""):
        for k, v in sorted(tree.items()):
            if isinstance(v, dict):
                yield from leaves(v, f"{prefix}{k}/")
            else:
                yield f"{prefix}{k}", v

    def compare(got_state, want_state, max_diff, atol):
        got, want = state_to_jax(got_state), state_to_jax(want_state)
        g_opt, w_opt = dict(leaves(got["opt"])), dict(leaves(want["opt"]))
        assert g_opt.keys() == w_opt.keys()
        n = differ = 0
        for name, w in w_opt.items():
            if w.dtype == torch.int8:
                d = (g_opt[name].int() - w.int()).abs()
                assert max_diff is None or int(d.max()) <= max_diff, name
                n, differ = n + d.numel(), differ + int((d > 0).sum())
        assert differ <= 1e-4 * n, (differ, n)
        g_p, w_p = dict(leaves(got["params"])), dict(leaves(want["params"]))
        for name in w_p:
            torch.testing.assert_close(g_p[name], w_p[name], atol=atol,
                                       rtol=0, msg=name)

    for g in grads:
        state_from_jax(state_to_jax(states["cpu"]), states["card"])
        for k, st in states.items():
            q8nd_adamw_update(st["params"],
                              {n: torch.from_numpy(v).to(devices[k])
                               for n, v in g.items()},
                              st["opt"], lr=1e-3)
        compare(states["card"], states["cpu"], 1, 1e-4)
    compare(states["free"], states["cpu"], None, 3e-4)


@pytest.mark.parametrize("arch", ["minicpm-2b", "deepseek-67b",
                                  "llama3-405b"])
def test_dense_smoke_kernel_path_matches_plain_on_card(cuda_device, arch):
    """minicpm-smoke (MHA, the tied head, the logit scale), deepseek67b-
    and llama405b-smoke (GQA 8): make_prefill's logits through the flash
    kernel (one launch a layer; their head dims 12, 8 and 16 run padded or
    as they are) against the plain path on the card."""
    cfg = get_config(arch, smoke=True).replace(use_flash_kernel=True)
    model = build(cfg, cuda_device).init(generator(0, cuda_device))
    tokens = torch.randint(0, cfg.vocab, (2, 256),
                           generator=generator(1, "cpu")).to(cuda_device)
    kernel.launches = 0
    got = serve_step.make_prefill(model)(tokens)
    torch.cuda.synchronize()
    assert kernel.launches == cfg.n_layers
    model.cfg = cfg.replace(use_flash_kernel=False)
    want = serve_step.make_prefill(model)(tokens)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


SHARDED_MOE_FIELDS = dict(name="m", family="moe", n_layers=1, d_model=64,
                          n_heads=2, n_kv_heads=2, d_ff=64, vocab=64,
                          pattern=("moe",), n_experts=8, top_k=2,
                          d_expert=48, capacity_factor=4.0)


def _sharded_moe_rank(rank: int, world: int, run_dir: str) -> None:
    """One of two ranks on the card over gloo: the MoE layer with its
    experts split over "model"."""
    import datetime
    import os
    from torch import distributed as dist
    from repro_torch.configs.base import ModelConfig
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import moe
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{run_dir}/store",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    try:
        cfg = ModelConfig(**SHARDED_MOE_FIELDS)
        inputs = torch.load(os.path.join(run_dir, "inputs.pt"))
        mesh = make_test_mesh(model=world)
        layer = moe.MoE(cfg, "cuda")
        layer.load_state_dict(inputs["params"])
        shd.distribute_params(layer, moe.expert_shardings(layer, mesh))
        with shd.use_mesh(mesh):
            out, aux = moe.moe_apply(layer, inputs["x"].cuda(), cfg)
        torch.save({"out": out.cpu(), "aux": aux.cpu()},
                   os.path.join(run_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def test_two_rank_sharded_moe_layer_on_card(cuda_device, tmp_path):
    """Two ranks share the card over gloo (a (1 x 2) mesh, 4 experts a
    rank): the expert-parallel layer against the one-device layer on the
    card, at capacity E/k (tests/test_moe.py's tolerance)."""
    import multiprocessing
    from repro_torch.configs.base import ModelConfig
    from repro_torch.models import moe
    cfg = ModelConfig(**SHARDED_MOE_FIELDS)
    layer = moe.MoE(cfg, "cpu")
    layer.init(generator(0, "cpu"), cfg)
    x = torch.randn(4, 128, cfg.d_model, generator=generator(1, "cpu"))
    torch.save({"params": layer.state_dict(), "x": x}, tmp_path / "inputs.pt")
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_sharded_moe_rank, args=(r, 2, str(tmp_path)))
             for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=180)
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.kill()
    assert not hung and all(p.exitcode == 0 for p in procs), \
        [p.exitcode for p in procs]
    want, want_aux = moe.moe_apply(layer.to(cuda_device), x.to(cuda_device),
                                   cfg)
    for r in range(2):
        got = torch.load(tmp_path / f"rank{r}.pt")
        torch.testing.assert_close(got["out"], want.cpu(), atol=2e-5,
                                   rtol=2e-4)
        torch.testing.assert_close(got["aux"], want_aux.cpu(), atol=1e-6,
                                   rtol=1e-5)


def test_dry_run_peak_of_a_smoke_step_matches_the_card(cuda_device):
    """danube-smoke, one training step at batch 16 x 1024, where attention's
    fp32 scores make most of the memory: the dry run's peak on a one-rank
    world (arguments and temporaries, ``launch.dryrun``) within x1.5 of
    what the step allocates on the card, both ways."""
    from repro_torch.configs.registry import ShapeSpec
    from repro_torch.data import SyntheticLMData
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import fake_world, make_test_mesh
    from repro_torch.train import train_step
    cfg = get_config("h2o-danube-1.8b", smoke=True)
    b, s = 16, 1024
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    model = build(cfg, cuda_device).init(generator(0, cuda_device))
    state = train_step.init_state(model)
    step = train_step.make_train_step(model, lr=1e-3)
    data = SyntheticLMData(cfg, batch=b, seq_len=s, seed=1)
    batch = {k: torch.from_numpy(v).to(cuda_device)
             for k, v in data.batch_at(0).items()}
    step(state, batch)
    torch.cuda.synchronize()
    measured = torch.cuda.max_memory_allocated() - base
    plan = {"rules": {}, "microbatches": 1, "moment_dtype": None,
            "accum_dtype": "float32"}
    with fake_world(1):
        art = dryrun.lower_cell(
            cfg.name, "train_4k", multi_pod=False, plan_override=plan,
            accounting=False, cfg=cfg, shape=ShapeSpec("card", "train", s, b),
            mesh=make_test_mesh(devices=1, model=1, device="cpu"))
    mem = art["memory_analysis"]
    ratio = (mem["argument_bytes"] + mem["temp_bytes"]) / measured
    print(f"dry run {mem} against {measured} allocated: x{ratio:.4f}")
    assert 1 / 1.5 <= ratio <= 1.5
