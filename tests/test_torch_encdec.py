"""The port's encoder and cross-attention families (``repro_torch``:
``attn_apply``'s ``causal`` and ``kv_override``, the ``cross_attn`` and
``enc_attn`` blocks, the encoder, ``memory_embeds`` through the model and
serve_step) against the JAX reference on the CPU, on the same numpy
parameters, tokens and memory embeddings.

whisper-smoke (2 encoder and 2 decoder ``cross_attn`` layers, d_model 64, 4
heads of 64) and vlm-smoke (``attn`` x 4 + ``cross_attn``, GQA 4 on 2 heads
of 128, 8 image embeddings) keep their families' structure and their full
configs' head dims.  Every cross-attention gate ``xgate`` is set to 0.5 in
the numpy params: at the reference's init it is 0, and tanh(0) = 0 would
hide the cross-attention from every check.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import memory_len  # noqa: E402
from repro.models import attention as ref_attention  # noqa: E402
from repro.models import blocks as ref_blocks  # noqa: E402
from repro.models import build as ref_build  # noqa: E402
from repro.train import serve_step as ref_serve_step  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import serve as port_serve  # noqa: E402
from repro_torch.models import attention, blocks  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.train import serve_step  # noqa: E402

WHISPER, VLM = "whisper-tiny", "llama-3.2-vision-90b"
ARCHS = [WHISPER, VLM]
XGATE = 0.5
TOL = 1e-4            # fp32 logits, port against reference
ATTN_TOL = 1e-5       # one attention or block, fp32
DECODE_TOL = 5e-3     # decode against forward (tests/test_smoke_archs.py:72)


def _live_gates(tree):
    """The reference's params with every ``xgate`` (stacked over groups)
    set to XGATE."""
    def fill(path, a):
        if getattr(path[-1], "key", None) == "xgate":
            return np.full_like(a, XGATE)
        return a
    return jax.tree_util.tree_map_with_path(fill, tree)


@pytest.fixture(scope="module", params=ARCHS)
def arch_params(request):
    arch = request.param
    params = ref_build(ref_get_config(arch, smoke=True)).init(
        jax.random.PRNGKey(0))
    return arch, _live_gates(jax.tree.map(np.asarray, params))


def _pair(arch, params, **overrides):
    ref_cfg = ref_get_config(arch, smoke=True).replace(**overrides)
    cfg = get_config(arch, smoke=True).replace(**overrides)
    return ref_build(ref_cfg), convert.params_from_jax(params, cfg,
                                                       device="cpu")


def _inputs(arch, b, s, seed=0):
    """Tokens (B, S) and memory embeddings (B, memory_len, d), numpy."""
    rng = np.random.default_rng(seed)
    cfg = get_config(arch, smoke=True)
    tokens = rng.integers(0, cfg.vocab, (b, s), dtype=np.int32)
    mem = rng.standard_normal((b, memory_len(cfg, s), cfg.d_model)).astype(
        np.float32)
    return tokens, mem


def _forward_ref(ref_model, params, tokens, mem):
    return np.asarray(ref_model.forward(params, jnp.asarray(tokens),
                                        memory_embeds=jnp.asarray(mem))[0])


def _forward(model, tokens, mem):
    with torch.inference_mode():
        return model.forward(torch.from_numpy(tokens),
                             memory_embeds=torch.from_numpy(mem))[0].numpy()


# ------------------------------------------------------------ attn_apply

def _attn(cfg, seed=0):
    p = jax.tree.map(np.asarray, ref_attention.attn_init(
        jax.random.PRNGKey(seed), cfg))
    m = attention.Attention(get_config(VLM, smoke=True), "cpu")
    m.load_state_dict({k: torch.tensor(v) for k, v in p.items()})
    return p, m


@pytest.mark.parametrize("chunk,softcap", [(0, 0.0), (16, 0.0), (0, 5.0),
                                           (16, 5.0)],
                         ids=["plain", "chunked", "plain_cap", "chunked_cap"])
@pytest.mark.parametrize("override", [False, True],
                         ids=["bidirectional", "kv_override"])
def test_attn_apply_matches_reference(chunk, softcap, override):
    """causal=False over the stream itself, and cross-attention from 32
    queries to a memory of 24 (no rope, K/V from the memory)."""
    over = dict(attn_chunk=chunk, attn_logit_softcap=softcap)
    ref_cfg = ref_get_config(VLM, smoke=True).replace(**over)
    cfg = get_config(VLM, smoke=True).replace(**over)
    p, m = _attn(ref_cfg)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 32, 64)).astype(np.float32)
    mem = rng.standard_normal((2, 24, 64)).astype(np.float32)
    kv = (mem, torch.from_numpy(mem)) if override else (None, None)
    want = ref_attention.attn_apply(
        p, jnp.asarray(x), ref_cfg, causal=False,
        kv_override=None if kv[0] is None else jnp.asarray(kv[0]))
    got = attention.attn_apply(m, torch.from_numpy(x), cfg, causal=False,
                               kv_override=kv[1])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATTN_TOL,
                               rtol=ATTN_TOL)


def test_kv_override_never_reaches_the_kernel(monkeypatch):
    """With use_flash_kernel and S % 128 == 0, self-attention goes to the
    kernel and cross-attention does not, as in the reference."""
    from repro_torch.kernels import flash_attention as fa
    calls = []
    real = fa.flash_attention

    def counted(q, k, v, **kw):
        calls.append(kw["causal"])
        return real(q, k, v, **kw)
    monkeypatch.setattr(fa, "flash_attention", counted)
    cfg = get_config(VLM, smoke=True).replace(use_flash_kernel=True)
    _, m = _attn(ref_get_config(VLM, smoke=True))
    x = torch.randn(1, 128, 64)
    attention.attn_apply(m, x, cfg, causal=False)
    attention.attn_apply(m, x, cfg, causal=False, kv_override=x)
    assert calls == [False]


# ----------------------------------------------------------------- blocks

@pytest.mark.parametrize("kind", ["cross_attn", "enc_attn"])
def test_blocks_match_reference(kind):
    ref_cfg = ref_get_config(WHISPER, smoke=True)
    cfg = get_config(WHISPER, smoke=True)
    p = jax.tree.map(np.asarray, ref_blocks.REGISTRY[kind].init(
        jax.random.PRNGKey(3), ref_cfg))
    if kind == "cross_attn":
        p["xgate"] = np.float32(XGATE)
    block = blocks.make_block(kind, cfg, "cpu")
    block.load_state_dict({name: torch.tensor(a) for name, a in
                           convert._leaves(p)})
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 16, 64)).astype(np.float32)
    mem = rng.standard_normal((2, 12, 64)).astype(np.float32)
    want, want_aux = ref_blocks.REGISTRY[kind].apply(
        p, jnp.asarray(x), ref_cfg, memory=jnp.asarray(mem))
    got, aux = block(torch.from_numpy(x), cfg, memory=torch.from_numpy(mem))
    assert float(aux) == float(want_aux) == 0.0
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATTN_TOL, rtol=ATTN_TOL)
    if kind == "enc_attn":
        with pytest.raises(TypeError, match="no one-token decode"):
            block.decode(torch.from_numpy(x[:, :1]), {}, 0, cfg)
        return
    with pytest.raises(ValueError, match="needs memory"):
        block(torch.from_numpy(x), cfg)
    cache = block.init_cache(cfg, 2, 16, "cpu")
    ref_cache = ref_blocks.REGISTRY[kind].cache(ref_cfg, 2, 16)
    for t in range(4):
        xt = x[:, t:t + 1]
        want, ref_cache = ref_blocks.REGISTRY[kind].decode(
            p, jnp.asarray(xt), ref_cache, t, ref_cfg,
            memory=jnp.asarray(mem))
        got, cache = block.decode(torch.from_numpy(xt), cache, t, cfg,
                                  memory=torch.from_numpy(mem))
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   atol=ATTN_TOL, rtol=ATTN_TOL)
    np.testing.assert_allclose(cache["kv"]["k"].numpy(),
                               np.asarray(ref_cache["kv"]["k"]),
                               atol=ATTN_TOL, rtol=ATTN_TOL)


# ----------------------------------------------------------------- models

def test_smoke_configs_keep_the_family_structure():
    w = get_config(WHISPER, smoke=True)
    assert (w.pattern, w.enc_layers, w.n_layers, w.head_dim) == \
        (("cross_attn",), 2, 2, 64)
    full = get_config(WHISPER)
    assert (full.enc_layers, full.n_layers, full.d_model, full.n_heads,
            full.n_kv_heads, full.head_dim, full.vocab,
            memory_len(full, 1536)) == (4, 4, 384, 6, 6, 64, 51865, 1536)
    v = get_config(VLM, smoke=True)
    assert v.pattern == ("attn",) * 4 + ("cross_attn",)
    assert (v.n_kv_heads, v.head_dim, v.n_image_tokens) == (2, 128, 8)
    full = get_config(VLM)
    assert (full.n_layers, full.d_model, full.n_heads, full.n_kv_heads,
            full.head_dim, full.vocab, memory_len(full, 8192)) == \
        (100, 8192, 64, 8, 128, 128256, 1601)


@pytest.mark.parametrize("flash,s", [(False, 32), (True, 256)],
                         ids=["plain_s32", "flash_s256"])
def test_forward_matches_reference(arch_params, flash, s):
    arch, params = arch_params
    ref_model, model = _pair(arch, params, use_flash_kernel=flash)
    tokens, mem = _inputs(arch, 2, s)
    np.testing.assert_allclose(_forward(model, tokens, mem),
                               _forward_ref(ref_model, params, tokens, mem),
                               atol=TOL, rtol=TOL)


def test_logits_move_with_xgate(arch_params):
    """Cross-attention is live: a gate of 0 and one of 0.5 give logits far
    apart (and the port follows the reference at both)."""
    arch, params = arch_params
    shut = jax.tree_util.tree_map_with_path(
        lambda path, a: (np.zeros_like(a)
                         if getattr(path[-1], "key", None) == "xgate" else a),
        params)
    tokens, mem = _inputs(arch, 2, 16, seed=1)
    out = {}
    for name, tree in (("live", params), ("shut", shut)):
        ref_model, model = _pair(arch, tree)
        out[name] = _forward(model, tokens, mem)
        np.testing.assert_allclose(
            out[name], _forward_ref(ref_model, tree, tokens, mem), atol=TOL,
            rtol=TOL)
    assert np.abs(out["live"] - out["shut"]).max() > 100 * TOL
    # and the memory matters only through a live gate
    other = mem[::-1].copy()
    _, model = _pair(arch, shut)
    np.testing.assert_allclose(_forward(model, tokens, other), out["shut"],
                               atol=0, rtol=0)


def test_decode_matches_forward_and_reference(arch_params):
    """The sequential prefill (one decode step a token, the encoder run
    again at every step for whisper) against the forward's last logits at
    the reference's 5e-3, and against the reference's own prefill."""
    arch, params = arch_params
    ref_model, model = _pair(arch, params)
    tokens, mem = _inputs(arch, 2, 16, seed=2)
    with torch.inference_mode():
        last, cache = model.prefill(torch.from_numpy(tokens),
                                    model.init_cache(2, 16),
                                    memory_embeds=torch.from_numpy(mem))
    full = _forward(model, tokens, mem)
    assert np.abs(last.numpy() - full[:, -1]).max() < DECODE_TOL
    want, ref_cache = ref_model.prefill(params, jnp.asarray(tokens),
                                        ref_model.init_cache(2, 16),
                                        memory_embeds=jnp.asarray(mem))
    np.testing.assert_allclose(last.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)
    b = f"b{len(model.cfg.pattern) - 1}"      # the cross_attn block
    np.testing.assert_allclose(
        cache["groups"][0][b]["kv"]["v"].numpy(),
        np.asarray(ref_cache["groups"][b]["kv"]["v"][0]), atol=TOL, rtol=TOL)


def test_greedy_generate_matches_reference(arch_params):
    arch, params = arch_params
    ref_model, model = _pair(arch, params)
    tokens, mem = _inputs(arch, 2, 12, seed=3)
    want = ref_serve_step.greedy_generate(ref_model, params,
                                          jnp.asarray(tokens), max_new=8,
                                          memory_embeds=jnp.asarray(mem))
    got = serve_step.greedy_generate(model, torch.from_numpy(tokens),
                                     max_new=8,
                                     memory_embeds=torch.from_numpy(mem))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_serve_step_takes_memory(arch_params):
    arch, params = arch_params
    _, model = _pair(arch, params)
    tokens, mem = _inputs(arch, 2, 4, seed=5)
    step = serve_step.make_serve_step(model)
    cache = model.init_cache(2, 4)
    with torch.inference_mode():
        for t in range(4):
            got, cache = step(cache, torch.from_numpy(tokens[:, t:t + 1]), t,
                              memory_embeds=torch.from_numpy(mem))
    fresh = model.init_cache(2, 4)
    with torch.inference_mode():
        want, _ = model.prefill(torch.from_numpy(tokens), fresh,
                                memory_embeds=torch.from_numpy(mem))
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    with pytest.raises(ValueError, match="memory"):
        model.forward(torch.from_numpy(tokens))


def test_encoder_leaves_cross_both_ways(arch_params):
    """Every leaf, the encoder's stacked over enc_layers one level down and
    ``xgate`` stacked to (n_groups,), back to the same numpy tree."""
    arch, params = arch_params
    cfg = get_config(arch, smoke=True)
    model = convert.params_from_jax(params, cfg, device="cpu")
    back = convert.params_to_jax(model)
    assert jax.tree.structure(back) == jax.tree.structure(params)
    jax.tree.map(np.testing.assert_array_equal, back, params)
    b = f"b{len(cfg.pattern) - 1}"
    assert params["groups"][b]["xgate"].shape == (cfg.n_groups,)
    assert model.groups[0][b].xgate.shape == ()
    if cfg.enc_layers:
        assert params["encoder"]["blocks"]["attn"]["wq"].shape[0] == 2
        assert convert.split_stacked("encoder.blocks.1.attn.wq") == \
            ("encoder.blocks.attn.wq", 1)
        assert convert.split_stacked("encoder.final_norm") is None
        np.testing.assert_array_equal(
            model.encoder.blocks[1].attn.wq.numpy(),
            params["encoder"]["blocks"]["attn"]["wq"][1])
        short = dict(params, encoder=dict(params["encoder"], blocks=jax.tree
                                          .map(lambda a: a[:1],
                                               params["encoder"]["blocks"])))
        with pytest.raises(ValueError, match="enc_layers"):
            convert.params_from_jax(short, cfg, device="cpu")
    assert model.param_count() == sum(
        a.size for a in jax.tree.leaves(params))


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_runs_on_cpu_with_memory(arch, capsys):
    out = port_serve.serve(arch, smoke=True, batch=2, prompt_len=8,
                           max_new=3, device="cpu")
    assert out.dtype == torch.int32 and tuple(out.shape) == (2, 3)
    cfg = get_config(arch, smoke=True)
    _, prompt, mem = port_serve.setup(arch, smoke=True, batch=2,
                                      prompt_len=8, seed=0, device="cpu")
    assert mem.dtype == torch.float32
    assert tuple(mem.shape) == (2, max(memory_len(cfg, 8), 4), cfg.d_model)
    again = port_serve.setup(arch, smoke=True, batch=2, prompt_len=8,
                             seed=0, device="cpu")
    assert torch.equal(again[1], prompt) and torch.equal(again[2], mem)
    assert "[serve]" in capsys.readouterr().out


def test_vision_bf16_kernel_gap_is_no_wider_than_the_reference_s():
    """vlm-smoke in bf16, every xgate at 0.5: the logits of the kernel path
    (``use_flash_kernel``; the reference's Pallas kernel in interpret mode,
    the port's kernel wrapper on its plain version) against the plain
    path, in each package, over three seeds.  The gap is bf16 rounding if
    the port's is no wider than the reference's own; both are printed."""
    over = dict(dtype="bfloat16", param_dtype="bfloat16")
    gaps = {"reference": [], "port": []}
    for seed in range(3):
        params = _live_gates(jax.tree.map(np.asarray, ref_build(
            ref_get_config(VLM, smoke=True)).init(jax.random.PRNGKey(seed))))
        tokens, mem = _inputs(VLM, 2, 128, seed)
        ref_p = jax.tree.map(
            lambda a: jnp.asarray(a, jnp.bfloat16)
            if a.dtype == np.float32 else jnp.asarray(a), params)
        out = {}
        for flash in (True, False):
            ref_model, model = _pair(VLM, params, use_flash_kernel=flash,
                                     **over)
            out["reference", flash] = np.asarray(ref_model.forward(
                ref_p, jnp.asarray(tokens),
                memory_embeds=jnp.asarray(mem))[0], np.float32)
            with torch.inference_mode():
                out["port", flash] = model.forward(
                    torch.from_numpy(tokens),
                    memory_embeds=torch.from_numpy(mem))[0].float().numpy()
        for pkg in gaps:
            gaps[pkg].append(float(np.abs(out[pkg, True]
                                          - out[pkg, False]).max()))
    print(f"[vision bf16 gap] reference {gaps['reference']} port "
          f"{gaps['port']}")
    assert max(gaps["port"]) <= max(gaps["reference"])
