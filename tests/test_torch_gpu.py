"""The port's CUDA kernels on the card: each against its plain PyTorch
version, and danube-smoke's and mamba2-smoke's prefill on the card against
the same model on the CPU.  Every test here is marked ``gpu`` and skips
without a card; on a card machine run them with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

This file imports neither JAX nor the reference package, so it runs on a card
machine that has only PyTorch.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.device import generator  # noqa: E402
from repro_torch.kernels.flash_attention import kernel, ref  # noqa: E402
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
