"""The port's SSM serving slice (``repro_torch``: the ``ssm`` block, the
Mamba2 mixer, the SSD scan, serve_step) against the JAX reference on the
CPU, on mamba2-smoke with the same weights (carried across by
``params_from_jax``) and the same numpy tokens.

mamba2-smoke (2 layers, d_model 64, 8 SSD heads of P=16, N=16, chunk 16,
fp32) keeps mamba2-1.3b's block structure, conv width and tied embeddings.
The reference's kernel path runs the Pallas SSD kernel in interpret mode.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import build as jax_build  # noqa: E402
from repro.train import serve_step as jax_serve_step  # noqa: E402
from repro_torch import device as port_device  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fa_kernel  # noqa: E402,E501
from repro_torch.kernels.ssd import kernel as ssd_kernel  # noqa: E402
from repro_torch.launch import serve as port_serve  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.train import serve_step  # noqa: E402

ARCH = "mamba2-1.3b"
TOL = 1e-4            # fp32 logits, port against reference
FP32_LEAVES = ("a_log", "dt_bias", "d_skip")


@pytest.fixture(scope="module")
def ref_params():
    params = jax_build(jax_get_config(ARCH, smoke=True)).init(
        jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, params)


def _pair(ref_params, **overrides):
    """(reference model, port model) of mamba2-smoke on the same weights."""
    jax_cfg = jax_get_config(ARCH, smoke=True).replace(**overrides)
    cfg = get_config(ARCH, smoke=True).replace(**overrides)
    return jax_build(jax_cfg), params_from_jax(ref_params, cfg,
                                               device="cpu")


def _tokens(b, s, seed=0):
    return np.random.default_rng(seed).integers(0, 128, (b, s),
                                                dtype=np.int32)


def test_smoke_config_keeps_the_block_structure():
    cfg = get_config(ARCH, smoke=True)
    assert (cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state, cfg.ssm_chunk,
            cfg.conv_width) == (8, 16, 16, 16, 4)
    full = get_config(ARCH)
    assert (full.n_layers, full.d_model, full.d_inner, full.ssm_heads,
            full.ssm_headdim, full.ssm_state, full.ssm_chunk,
            full.conv_width, full.vocab, full.tie_embeddings,
            full.dtype) == (48, 2048, 4096, 64, 64, 128, 256, 4, 50280,
                            True, "bfloat16")


@pytest.mark.parametrize("flash,s", [
    (True, 64),        # SSD kernel path (Pallas interpret in JAX), 4 chunks
    (False, 64),       # plain chunked path
    (True, 8),         # s < chunk: the chunk becomes s
    (True, 40),        # 40 % 16 != 0: the exact sequential scan
], ids=["kernel_s64", "chunked_s64", "kernel_s8", "odd_s40"])
def test_forward_matches_reference(ref_params, flash, s):
    jax_model, model = _pair(ref_params, use_flash_kernel=flash)
    tokens = _tokens(2, s)
    want, _ = jax_model.forward(ref_params, jnp.asarray(tokens))
    with torch.inference_mode():
        got, aux = model.forward(torch.from_numpy(tokens))
    assert float(aux) == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)


def test_prefill_and_greedy_generate_match_reference(ref_params):
    jax_model, model = _pair(ref_params, use_flash_kernel=True)
    prompt = _tokens(2, 32, seed=1)
    want_last = jax_serve_step.make_prefill(jax_model)(ref_params,
                                                       jnp.asarray(prompt))
    got_last = serve_step.make_prefill(model)(torch.from_numpy(prompt))
    np.testing.assert_allclose(got_last.numpy(), np.asarray(want_last),
                               atol=TOL, rtol=TOL)

    want = jax_serve_step.greedy_generate(jax_model, ref_params,
                                          jnp.asarray(prompt), max_new=8)
    got = serve_step.greedy_generate(model, torch.from_numpy(prompt),
                                     max_new=8)
    assert got.dtype == torch.int32 and tuple(got.shape) == (2, 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_decode_steps_and_caches_match_reference(ref_params):
    """20 one-token steps: logits, and both caches (the conv history in the
    compute dtype, the fp32 SSM state) after the last."""
    jax_model, model = _pair(ref_params)
    tokens = _tokens(2, 20, seed=2)
    jax_cache = jax_model.init_cache(2, 20)
    cache = model.init_cache(2, 20)
    first = cache["groups"][0]["b0"]["ssm"]
    assert tuple(first["conv"].shape) == (2, 3, 128 + 2 * 16)
    assert tuple(first["ssm"].shape) == (2, 8, 16, 16)
    assert first["ssm"].dtype == torch.float32
    step = serve_step.make_serve_step(model)
    jax_step = jax.jit(jax_model.decode_step)
    for t in range(20):
        want, jax_cache = jax_step(
            ref_params, jax_cache, jnp.asarray(tokens[:, t:t + 1]), t)
        got, cache = step(cache, torch.from_numpy(tokens[:, t:t + 1]), t)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                                   rtol=TOL)
    for g, gcache in enumerate(cache["groups"]):
        for name in ("conv", "ssm"):
            np.testing.assert_allclose(
                gcache["b0"]["ssm"][name].numpy(),
                np.asarray(jax_cache["groups"]["b0"]["ssm"][name][g]),
                atol=TOL, rtol=TOL)


def test_sequential_prefill_matches_forward_last_logits(ref_params):
    _, model = _pair(ref_params, use_flash_kernel=True)
    prompt = torch.from_numpy(_tokens(2, 64, seed=3))
    with torch.inference_mode():
        seq, _ = model.prefill(prompt, model.init_cache(2, 64))
    fast = serve_step.make_prefill(model)(prompt)
    torch.testing.assert_close(seq, fast, atol=TOL, rtol=TOL)


def test_params_from_jax_copies_every_leaf(ref_params):
    _, model = _pair(ref_params)
    state = model.state_dict()
    leaves = 0
    for path, a in jax.tree_util.tree_flatten_with_path(ref_params)[0]:
        keys = [k.key for k in path]
        if keys[0] == "groups":
            for g in range(a.shape[0]):
                port = ".".join(["groups", str(g)] + keys[1:])
                np.testing.assert_array_equal(state[port].numpy(), a[g])
                leaves += 1
        else:
            np.testing.assert_array_equal(state[".".join(keys)].numpy(), a)
            leaves += 1
    assert leaves == len(state)
    n_ref = sum(a.size for a in jax.tree.leaves(ref_params))
    assert model.param_count() == n_ref


def test_param_count_matches_reference_config_count():
    cfg = get_config(ARCH, smoke=True)
    model = build(cfg, "cpu")
    assert model.param_count() == jax_get_config(ARCH, smoke=True) \
        .param_count()
    assert not hasattr(model, "lm_head")          # tied embeddings


def test_params_from_jax_keeps_fp32_leaves_under_bf16(ref_params):
    cfg = get_config(ARCH, smoke=True)
    model = params_from_jax(ref_params, cfg, device="cpu",
                            dtype=torch.bfloat16)
    mixer = ref_params["groups"]["b0"]["ssm"]
    for g in range(cfg.n_groups):
        ssm = model.groups[g]["b0"].ssm
        assert ssm.w_xs.dtype == torch.bfloat16
        assert ssm.conv_w.dtype == torch.bfloat16
        for name in FP32_LEAVES:
            leaf = getattr(ssm, name)
            assert leaf.dtype == torch.float32, name
            np.testing.assert_array_equal(leaf.numpy(), mixer[name][g])
    assert model.tok_embed.dtype == torch.bfloat16


def test_params_from_jax_raises_on_unmapped_leaf(ref_params):
    cfg = get_config(ARCH, smoke=True)
    extra = dict(ref_params, stray=np.zeros(3, np.float32))
    with pytest.raises(KeyError, match="stray"):
        params_from_jax(extra, cfg, device="cpu")


def test_init_follows_reference_distributions():
    cfg = get_config(ARCH, smoke=True).replace(param_dtype="bfloat16")
    model = build(cfg, "cpu").init(port_device.generator(0, "cpu"))
    block = model.groups[0]["b0"]
    ssm = block.ssm
    assert torch.equal(block.ln1, torch.ones(64, dtype=torch.bfloat16))
    torch.testing.assert_close(
        ssm.a_log, torch.log(torch.linspace(1.0, 16.0, cfg.ssm_heads)))
    assert ssm.a_log.dtype == ssm.dt_bias.dtype == ssm.d_skip.dtype \
        == torch.float32
    assert torch.equal(ssm.dt_bias, torch.zeros(cfg.ssm_heads))
    assert torch.equal(ssm.d_skip, torch.ones(cfg.ssm_heads))
    assert torch.equal(ssm.conv_b.float(), torch.zeros(160))
    assert abs(float(ssm.conv_w.float().std()) - 0.1) < 0.02
    assert abs(float(ssm.w_xs.float().std()) - 64 ** -0.5) < 0.01
    again = build(cfg, "cpu").init(port_device.generator(0, "cpu"))
    assert torch.equal(ssm.w_out, again.groups[0]["b0"].ssm.w_out)


def test_generation_reaches_no_kernel(monkeypatch):
    """As in the reference, greedy decoding runs the sequential cache prefill
    and ssm_decode, never the SSD scan; make_prefill reaches the kernel's
    wrapper once per layer (on CPU tensors it runs the plain version and
    counts no launch)."""
    calls = []
    real = ssd_kernel.ssd

    def counted(*args, **kwargs):
        calls.append(args[0].shape)
        return real(*args, **kwargs)
    monkeypatch.setattr(ssd_kernel, "ssd", counted)
    ssd_kernel.launches = fa_kernel.launches = 0
    out = port_serve.serve(ARCH, smoke=True, batch=2, prompt_len=32,
                           max_new=4, device="cpu")
    assert (len(calls), ssd_kernel.launches, fa_kernel.launches) == (0, 0, 0)
    assert out.dtype == torch.int32 and tuple(out.shape) == (2, 4)
    assert bool(((out >= 0) & (out < 128)).all())

    model, prompt, _ = port_serve.setup(ARCH, smoke=True, batch=1,
                                        prompt_len=32, seed=0, device="cpu")
    model.cfg = model.cfg.replace(use_flash_kernel=True)
    serve_step.make_prefill(model)(prompt)
    assert calls == [(1, 32, 8, 16)] * model.cfg.n_layers
    assert ssd_kernel.launches == 0
