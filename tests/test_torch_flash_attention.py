"""The port's flash attention (``repro_torch.kernels.flash_attention``)
against the reference's Pallas kernel run in interpret mode, as
tests/test_kernels.py runs it, on the same numpy inputs.

On the CPU the port's wrapper takes its plain version; the CUDA kernel itself
is held against that plain version by tests/test_torch_gpu.py (skipped
without a card) and by chip_smoke.py.
"""
import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention import kernel as jax_kernel  # noqa: E402
from repro.kernels.flash_attention import ref as jax_ref  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention, kernel, \
    ref  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TOL = 5e-5          # fp32, the reference's kernel tolerance


def _inputs(seed, b, hq, hkv, s, d):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape, dtype=np.float32)
            for shape in ((b, hq, s, d), (b, hkv, s, d), (b, hkv, s, d))]


@pytest.mark.parametrize("b,hq,hkv,s,d,causal,window,block", [
    (1, 8, 2, 128, 80, True, 0, 64),      # GQA group 4, head dim 80
    (1, 2, 2, 256, 80, True, 32, 64),     # sliding window 32 at S=256
    (1, 2, 2, 384, 80, True, 0, 128),     # S=384 in 128 blocks
    (1, 2, 2, 128, 80, False, 0, 64),     # non-causal
], ids=["gqa4_hd80", "window32_s256", "s384_block128", "non_causal"])
def test_matches_pallas_kernel_interpret(b, hq, hkv, s, d, causal, window,
                                         block):
    q, k, v = _inputs(0, b, hq, hkv, s, d)
    want = jax_kernel.mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          sm_scale=d ** -0.5, causal=causal, window=window,
                          block_q=block, block_kv=block, interpret=True)
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), sm_scale=d ** -0.5,
                          causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 16),
                                           (False, 0), (False, 16)])
def test_plain_version_matches_reference_oracle(causal, window):
    q, k, v = _inputs(1, 2, 4, 2, 64, 64)
    want = jax_ref.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             sm_scale=0.125, causal=causal, window=window)
    got = ref.attention(torch.from_numpy(q), torch.from_numpy(k),
                        torch.from_numpy(v), sm_scale=0.125, causal=causal,
                        window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)


def test_plain_version_keeps_bf16_out_dtype():
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _inputs(2, 1, 2, 1, 32, 80))
    out = ref.attention(q, k, v, sm_scale=80 ** -0.5)
    assert out.dtype == torch.bfloat16 and out.shape == q.shape


@pytest.mark.parametrize("s", [128, 100])
def test_cpu_tensors_take_plain_path_without_launching(s):
    """S % 8 == 0 reaches the wrapper, which takes the plain version on CPU
    tensors; S = 100 is sent to the plain version by the op itself."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(3, 1, 4, 2, s, 80))
    kernel.launches = 0
    got = flash_attention(q, k, v, causal=True, window=8)
    want = ref.attention(q, k, v, sm_scale=80 ** -0.5, causal=True, window=8)
    assert torch.equal(got, want)
    assert kernel.launches == 0


def test_single_rounding_variant_fits_the_kernel_source():
    """scripts/flash_p_rounding.py measures the bf16 kernel against a copy
    with P rounded once; its edits must still fit the kernel's source, and
    leave no product with p_lo and no p_lo from the rounding residue."""
    spec = importlib.util.spec_from_file_location(
        "flash_p_rounding", ROOT / "scripts" / "flash_p_rounding.py")
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    src = (ROOT / "src/repro_torch/csrc/flash_attention.cu").read_text()
    once = script.once_source(src)
    assert "pl, b[" in src and "pl, b[" not in once
    assert "- __bfloat162float(h" not in once
    assert [c[0] for c in script.CASES] == ["window 1", "window 16",
                                           "main path S=8192 w=4096"]


def _kernel_variants():
    spec = importlib.util.spec_from_file_location(
        "kernel_variants", ROOT / "scripts" / "kernel_variants.py")
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    return script


@pytest.mark.parametrize("variant", ["kept", "unrolled", "keys32",
                                     "keys32_unrolled"])
def test_d256_variants_fit_the_kernel_source(variant):
    """scripts/kernel_variants.py measures the D = 256 bf16 kernel against
    copies with 32-key tiles and an unrolled copy loop; its edits must still
    fit the kernel's source and change only what the variant names."""
    script = _kernel_variants()
    src = (ROOT / "src/repro_torch/csrc/flash_attention.cu").read_text()
    got = script.variant_source(src, script.FLASH_EDITS[variant])
    assert ("? 32 : 64;" in got) == variant.startswith("keys32")
    assert ("#pragma unroll (D > 128 ? 1 : 8)" not in got) == \
        variant.endswith("unrolled")
    assert (got == src) == (variant == "kept")


def test_ptxas_usage_reads_registers_and_spills():
    log = """ptxas info    : Compiling entry function '_Z10attn_fwd_tcILi256EEvv' for 'sm_90a'
ptxas info    : Function properties for _Z10attn_fwd_tcILi256EEvv
    24 bytes stack frame, 40 bytes spill stores, 44 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers, 24 bytes cumulative stack size
ptxas info    : Compiling entry function '_Z10attn_fwd_tcILi80EEvv' for 'sm_90a'
ptxas info    : Function properties for _Z10attn_fwd_tcILi80EEvv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers
"""
    got = _kernel_variants().ptxas_usage(log, r"attn_fwd_tcILi256E")
    assert got == {"_Z10attn_fwd_tcILi256EEvv": {
        "registers": 255, "spill_stores": 40, "spill_loads": 44}}


def test_strided_views_match_contiguous():
    """The model hands (B,S,H,D) -> (B,H,S,D) transposed views to the op."""
    rng = np.random.default_rng(4)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 128, h, 80),
                                                    dtype=np.float32))
               .transpose(1, 2) for h in (4, 2, 2))
    got = flash_attention(q, k, v, window=16)
    want = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                           window=16)
    assert torch.equal(got, want)


def _bad_inputs(kind):
    q = torch.zeros(1, 4, 64, 80)
    k = torch.zeros(1, 2, 64, 80)
    v = torch.zeros(1, 2, 64, 80)
    if kind == "head_dim_96":
        return torch.zeros(1, 4, 64, 96), torch.zeros(1, 2, 64, 96), \
            torch.zeros(1, 2, 64, 96)
    if kind == "float16":
        return q.half(), k.half(), v.half()
    if kind == "mixed_dtypes":
        return q, k.to(torch.bfloat16), v
    if kind == "3d":
        return q[0], k[0], v[0]
    if kind == "strided_head_dim":
        return torch.zeros(1, 4, 64, 160)[..., ::2], k, v
    if kind == "heads_not_multiple":
        return torch.zeros(1, 3, 64, 80), k, v
    if kind == "kv_shape":
        return q, k, torch.zeros(1, 2, 32, 80)
    raise AssertionError(kind)


@pytest.mark.parametrize("kind", ["head_dim_96", "float16", "mixed_dtypes",
                                  "3d", "strided_head_dim",
                                  "heads_not_multiple", "kv_shape"])
def test_check_inputs_rejects_what_the_kernel_does_not_take(kind):
    with pytest.raises((ValueError, TypeError)):
        kernel.check_inputs(*_bad_inputs(kind))


def test_check_inputs_accepts_the_model_layout():
    q = torch.zeros(1, 128, 32, 80, dtype=torch.bfloat16).transpose(1, 2)
    k = torch.zeros(1, 128, 8, 80, dtype=torch.bfloat16).transpose(1, 2)
    kernel.check_inputs(q, k, k)


def test_other_devices_raise():
    q = torch.zeros(1, 2, 64, 80, device="meta")
    with pytest.raises(ValueError):
        kernel.mha(q, q, q, sm_scale=1.0)


def test_import_and_cpu_call_need_no_nvcc(tmp_path):
    """Importing the wrapper and calling it on CPU tensors builds nothing."""
    env = dict(os.environ, PATH=str(tmp_path), CUDA_HOME=str(tmp_path),
               PYTHONPATH=str(ROOT / "src"))
    code = (
        "import torch\n"
        "from repro_torch.kernels import _build\n"
        "from repro_torch.kernels.flash_attention import kernel\n"
        "x = torch.ones(1, 2, 16, 80)\n"
        "kernel.mha(x, x, x, sm_scale=1.0)\n"
        "assert kernel.launches == 0 and not _build._loaded\n")
    subprocess.run([sys.executable, "-c", code], env=env, check=True,
                   timeout=120)


def test_nvcc_missing_is_a_clear_error(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc_path()


def test_library_path_is_keyed_by_source():
    path = _build.library_path("flash_attention")
    assert path.name == "libflash_attention.so"
    assert path.parent.parent == _build.BUILD_ROOT
    assert path == _build.library_path("flash_attention")


def _attention_reaches_the_kernel(cfg) -> bool:
    """Whether some block of ``cfg`` runs ``attn_apply``'s self-attention,
    the call that reaches the flash kernel with ``use_flash_kernel``
    (``repro/models/attention.py:124``): the attention blocks, the
    self-attention half of a cross-attention block, a MoE block without
    MLA, the dense ``attn`` prefix (``repro/models/model.py:125``) and the
    encoder."""
    attn_blocks = {"attn", "local_attn", "cross_attn", "enc_attn"}
    return cfg.n_heads > 0 and (
        bool(attn_blocks & set(cfg.pattern))
        or ("moe" in cfg.pattern and not cfg.use_mla)
        or cfg.first_dense > 0 or cfg.enc_layers > 0)


def test_every_full_width_head_dim_is_instantiated():
    """Every full-width config whose attention reaches the kernel has a head
    dim the kernel is instantiated for (recurrentgemma-9b's is 256)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.registry import ARCH_IDS
    reached = {}
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        if _attention_reaches_the_kernel(cfg):
            reached[arch] = cfg.head_dim
    assert set(ARCH_IDS) - set(reached) == {"mamba2-1.3b"}
    assert reached["recurrentgemma-9b"] == 256
    assert reached["h2o-danube-1.8b"] == 80
    missing = {a: d for a, d in reached.items() if d not in kernel.HEAD_DIMS}
    assert not missing, missing
