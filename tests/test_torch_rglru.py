"""The port's RG-LRU mixer (``repro_torch.models.rglru``) and the hybrid
family it serves (recurrentgemma-9b's ``rglru`` + ``local_attn`` blocks)
against the JAX reference on the CPU, on the same numpy parameters and
inputs.

rg-smoke (3 layers: rglru, rglru, local_attn; d_model 64, lru width 64, 4
query heads on 1 kv head of 16, window 8, softcap 30, tied embeddings, fp32)
keeps recurrentgemma-9b's block structure.  The reference's kernel path runs
the Pallas flash kernel in interpret mode; both packages drop the softcap
there.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.models import build as ref_build  # noqa: E402
from repro.models import rglru as ref_rglru  # noqa: E402
from repro.train import serve_step as ref_serve_step  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.device import generator  # noqa: E402
from repro_torch.models import build, rglru  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.train import serve_step  # noqa: E402

ARCH = "recurrentgemma-9b"
MIXER_TOL = 1e-5      # rglru_apply, fp32
TOL = 1e-4            # fp32 logits, port against reference
DECODE_TOL = 5e-3     # decode against forward (tests/test_smoke_archs.py:72)


def _mixer(cfg, seed=0):
    """(reference params as numpy, the port's RGLRU holding them)."""
    p = jax.tree.map(np.asarray, ref_rglru.rglru_init(
        jax.random.PRNGKey(seed), cfg))
    m = rglru.RGLRU(get_config(ARCH, smoke=True).replace(
        d_model=cfg.d_model, lru_width=cfg.lru_width), "cpu")
    m.load_state_dict({k: torch.tensor(v) for k, v in p.items()})
    return p, m


def _x(b, s, d, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (b, s, d)).astype(np.float32)


@pytest.mark.parametrize("d,w,s", [(64, 64, 16), (64, 64, 256),
                                   (64, 128, 64)],
                         ids=["smoke_s16", "w64_s256", "w128_d64_s64"])
def test_rglru_apply_matches_reference(d, w, s):
    cfg = ref_get_config(ARCH, smoke=True).replace(d_model=d, lru_width=w)
    p, m = _mixer(cfg)
    x = _x(2, s, d)
    want = ref_rglru.rglru_apply(p, jnp.asarray(x), cfg)
    got = rglru.rglru_apply(m, torch.from_numpy(x),
                            get_config(ARCH, smoke=True).replace(
                                d_model=d, lru_width=w))
    assert got.shape == (2, s, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=MIXER_TOL, rtol=MIXER_TOL)


@pytest.mark.parametrize("s", [1, 2, 7, 100, 256])
def test_scan_matches_a_step_loop(s):
    gen = torch.Generator().manual_seed(s)
    a = torch.rand((2, s, 5), generator=gen, dtype=torch.float64)
    u = torch.randn((2, s, 5), generator=gen, dtype=torch.float64)
    h, want = torch.zeros(2, 5, dtype=torch.float64), []
    for t in range(s):
        h = a[:, t] * h + u[:, t]
        want.append(h)
    torch.testing.assert_close(rglru._scan(a, u), torch.stack(want, 1),
                               atol=1e-12, rtol=1e-12)


def test_scan_keeps_gradients():
    a = torch.rand((1, 9, 3), dtype=torch.float64, requires_grad=True)
    u = torch.randn((1, 9, 3), dtype=torch.float64, requires_grad=True)
    torch.autograd.gradcheck(rglru._scan, (a, u))


def test_rglru_decode_steps_match_apply_and_reference_caches():
    cfg = ref_get_config(ARCH, smoke=True)
    p, m = _mixer(cfg, seed=2)
    port_cfg = get_config(ARCH, smoke=True)
    x = _x(2, 12, cfg.d_model, seed=3)
    full = rglru.rglru_apply(m, torch.from_numpy(x), port_cfg)
    cache = rglru.init_rglru_cache(port_cfg, 2, "cpu")
    ref_cache = ref_rglru.init_rglru_cache(cfg, 2)
    assert cache["h"].dtype == torch.float32
    assert tuple(cache["conv"].shape) == (2, 3, 64)
    for t in range(12):
        xt = x[:, t:t + 1]
        out, cache = rglru.rglru_decode(m, torch.from_numpy(xt), cache, t,
                                        port_cfg)
        want, ref_cache = ref_rglru.rglru_decode(p, jnp.asarray(xt),
                                                 ref_cache, t, cfg)
        np.testing.assert_allclose(out.numpy(), np.asarray(want),
                                   atol=MIXER_TOL, rtol=MIXER_TOL)
        torch.testing.assert_close(out[:, 0], full[:, t], atol=MIXER_TOL,
                                   rtol=MIXER_TOL)
        for key in ("h", "conv"):
            np.testing.assert_allclose(cache[key].numpy(),
                                       np.asarray(ref_cache[key]),
                                       atol=MIXER_TOL, rtol=MIXER_TOL,
                                       err_msg=key)


def test_lam_stays_fp32_under_bf16_params():
    cfg = get_config(ARCH, smoke=True).replace(param_dtype="bfloat16",
                                               dtype="bfloat16")
    model = build(cfg, "cpu")
    lru = model.groups[0]["b0"].lru
    assert lru.lam.dtype == torch.float32 and lru.wx.dtype == torch.bfloat16
    ref_cfg = ref_get_config(ARCH, smoke=True).replace(
        param_dtype="bfloat16", dtype="bfloat16")
    tree = jax.tree.map(np.asarray, ref_build(ref_cfg).init(
        jax.random.PRNGKey(0)))
    lam = tree["groups"]["b0"]["lru"]["lam"]
    assert lam.dtype == np.float32
    loaded = params_from_jax(tree, cfg, device="cpu")
    got = loaded.groups[0]["b0"].lru.lam
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), lam[0])
    assert not np.array_equal(lam[0].astype(jnp.bfloat16).astype(np.float32),
                              lam[0])


@pytest.mark.parametrize("lo,hi", [(0, 64), (16, 48), (0, 8), (24, 28),
                                   (60, 64)])
def test_gates_of_a_channel_range_are_the_whole_gates_sliced(lo, hi):
    """A rank's channels (whole blocks of 8, or inside one block, as when
    the blocks are fewer than the ranks) equal the whole gates there."""
    rng = np.random.default_rng(0)
    w_gates = torch.tensor(rng.standard_normal((2, 8, 8, 8)),
                           dtype=torch.float32)
    b_gates = torch.tensor(rng.standard_normal((2, 64)), dtype=torch.float32)
    x = torch.tensor(rng.standard_normal((2, 5, 64)), dtype=torch.float32)
    whole = rglru._gates(w_gates, b_gates, x)
    part = rglru._gates(w_gates, b_gates, x, lo, hi)
    for a, b in zip(part, whole):
        torch.testing.assert_close(a, b[..., lo:hi], atol=1e-6, rtol=1e-6)
    with pytest.raises(ValueError, match="cut gate blocks"):
        rglru._gates(w_gates, b_gates, x, 4, 12)


def test_gate_branch_is_the_tanh_gelu():
    """jax.nn.gelu defaults to the tanh approximation; the erf form would
    be off by up to ~5e-4, far outside the mixer's tolerance."""
    x = np.linspace(-4.0, 4.0, 801, dtype=np.float32)
    want = np.asarray(jax.nn.gelu(jnp.asarray(x)))
    cfg = get_config(ARCH, smoke=True).replace(d_model=1, lru_width=8)
    m = rglru.RGLRU(cfg, "cpu")
    with torch.no_grad():
        m.wy.fill_(1.0)
    got = rglru._gate_branch(m, torch.from_numpy(x)[:, None],
                             torch.float32)[:, 0]
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-6)
    erf = torch.nn.functional.gelu(torch.from_numpy(x)).numpy()
    assert np.abs(erf - want).max() > 1e-4


def test_init_follows_reference_distributions():
    cfg = get_config(ARCH, smoke=True)
    lru = build(cfg, "cpu").init(generator(0, "cpu")).groups[0]["b0"].lru
    assert 2.0 <= float(lru.lam.min()) and float(lru.lam.max()) <= 6.0
    assert not lru.conv_b.any() and not lru.b_gates.any()
    assert abs(float(lru.w_gates.std()) - 8 ** -0.5) < 0.05
    assert abs(float(lru.conv_w.std()) - 0.1) < 0.02


# ---------------------------------------------------------------- rg-smoke

@pytest.fixture(scope="module")
def ref_params():
    params = ref_build(ref_get_config(ARCH, smoke=True)).init(
        jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, params)


def _pair(ref_params, **overrides):
    ref_cfg = ref_get_config(ARCH, smoke=True).replace(**overrides)
    cfg = get_config(ARCH, smoke=True).replace(**overrides)
    return ref_build(ref_cfg), params_from_jax(ref_params, cfg, device="cpu")


def _tokens(b, s, seed=0):
    return np.random.default_rng(seed).integers(0, 128, (b, s),
                                                dtype=np.int32)


def test_smoke_config_keeps_the_block_structure():
    cfg = get_config(ARCH, smoke=True)
    assert cfg.pattern == ("rglru", "rglru", "local_attn")
    assert (cfg.n_kv_heads, cfg.window, cfg.attn_logit_softcap,
            cfg.tie_embeddings) == (1, 8, 30.0, True)
    full = get_config(ARCH)
    assert (full.n_layers, full.n_groups, full.d_model, full.lru_width,
            full.n_heads, full.n_kv_heads, full.head_dim, full.window,
            full.vocab) == (38, 2, 4096, 4096, 16, 1, 256, 2048, 256000)
    assert full.pattern.count("local_attn") == 6


@pytest.mark.parametrize("flash,chunk,s", [
    (False, 0, 32),        # _sdpa, softcap 30
    (False, 16, 64),       # _sdpa_chunked, softcap 30
    (True, 0, 256),        # flash path (interpret mode in JAX), no softcap
], ids=["sdpa_s32", "chunked_s64", "flash_s256"])
def test_forward_matches_reference(ref_params, flash, chunk, s):
    ref_model, model = _pair(ref_params, use_flash_kernel=flash,
                             attn_chunk=chunk)
    tokens = _tokens(2, s)
    want, _ = ref_model.forward(ref_params, jnp.asarray(tokens))
    with torch.inference_mode():
        got, aux = model.forward(torch.from_numpy(tokens))
    assert float(aux) == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)


def test_flash_path_drops_softcap_as_the_reference_does(ref_params):
    """The kernel path equals the plain path with softcap 0, not the one
    with softcap 30 (wq scaled up so that scores reach the cap)."""
    _, model = _pair(ref_params)
    with torch.no_grad():
        model.groups[0]["b2"].attn.wq.mul_(10.0)
    tokens = torch.from_numpy(_tokens(1, 128, seed=4))
    out = {}
    for name, over in {"flash": dict(use_flash_kernel=True),
                       "plain0": dict(attn_logit_softcap=0.0),
                       "plain30": {}}.items():
        model.cfg = get_config(ARCH, smoke=True).replace(**over)
        out[name] = serve_step.make_prefill(model)(tokens)
    torch.testing.assert_close(out["flash"], out["plain0"], atol=TOL,
                               rtol=TOL)
    assert (out["flash"] - out["plain30"]).abs().max() > 10 * TOL


def test_decode_wraps_the_ring_cache_as_the_reference(ref_params):
    """20 decode steps past the window wrap local attention's ring cache
    (window + 1 = 9 slots); logits and every cache follow the
    reference's."""
    ref_model, model = _pair(ref_params)
    tokens = _tokens(2, 20, seed=2)
    ref_cache = ref_model.init_cache(2, 20)
    cache = model.init_cache(2, 20)
    assert cache["groups"][0]["b2"]["kv"]["k"].shape == (2, 9, 1, 16)
    step = serve_step.make_serve_step(model)
    ref_step = jax.jit(ref_model.decode_step)
    for t in range(20):
        want, ref_cache = ref_step(ref_params, ref_cache,
                                   jnp.asarray(tokens[:, t:t + 1]), t)
        got, cache = step(cache, torch.from_numpy(tokens[:, t:t + 1]), t)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                                   rtol=TOL)
    gc, rc = cache["groups"][0], ref_cache["groups"]
    for name, path in (("b0", ("lru", "h")), ("b1", ("lru", "conv")),
                       ("b2", ("kv", "k")), ("b2", ("kv", "v"))):
        np.testing.assert_allclose(
            gc[name][path[0]][path[1]].numpy(),
            np.asarray(rc[name][path[0]][path[1]][0]), atol=TOL, rtol=TOL,
            err_msg=f"{name}.{'.'.join(path)}")


def test_sequential_prefill_matches_forward(ref_params):
    _, model = _pair(ref_params)
    prompt = torch.from_numpy(_tokens(2, 16, seed=5))
    with torch.inference_mode():
        seq, _ = model.prefill(prompt, model.init_cache(2, 16))
    fast = serve_step.make_prefill(model)(prompt)
    assert (seq - fast).abs().max() < DECODE_TOL


def test_greedy_generate_matches_reference(ref_params):
    ref_model, model = _pair(ref_params)
    prompt = _tokens(2, 12, seed=6)
    want = ref_serve_step.greedy_generate(ref_model, ref_params,
                                          jnp.asarray(prompt), max_new=8)
    got = serve_step.greedy_generate(model, torch.from_numpy(prompt),
                                     max_new=8)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
