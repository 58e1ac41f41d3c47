"""The port's serving slice (``repro_torch``: configs, models, serve_step,
launch.serve) against the JAX reference on the CPU, on the same weights
(carried across by ``params_from_jax``) and the same numpy tokens.

danube-smoke keeps h2o-danube-1.8b's head dim 80 (``SMOKE = CONFIG.replace
(...)``), GQA group 4 and sliding window 8, so the ring-buffer SWA cache and
the windowed flash path are both exercised at a small size.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import build as jax_build  # noqa: E402
from repro.train import serve_step as jax_serve_step  # noqa: E402
from repro_torch import device as port_device  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config, memory_len  # noqa: E402,E501
from repro_torch.launch import serve as port_serve  # noqa: E402
from repro_torch.models import LanguageModel, build  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.kernels.flash_attention import kernel  # noqa: E402
from repro_torch.train import serve_step  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARCH = "h2o-danube-1.8b"
TOL = 1e-4            # fp32 logits, port against reference


@pytest.fixture(scope="module")
def ref_params():
    params = jax_build(jax_get_config(ARCH, smoke=True)).init(
        jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, params)


def _pair(ref_params, **overrides):
    """(reference model, port model) of danube-smoke on the same weights."""
    jax_cfg = jax_get_config(ARCH, smoke=True).replace(**overrides)
    cfg = get_config(ARCH, smoke=True).replace(**overrides)
    return jax_build(jax_cfg), params_from_jax(ref_params, cfg,
                                               device="cpu")


def _tokens(b, s, seed=0):
    return np.random.default_rng(seed).integers(0, 128, (b, s),
                                                dtype=np.int32)


def test_smoke_config_keeps_full_head_dim():
    cfg = get_config(ARCH, smoke=True)
    assert (cfg.head_dim, cfg.d_model, cfg.n_heads) == (80, 64, 4)
    assert cfg == get_config(ARCH, smoke=True).replace()
    full = get_config(ARCH)
    assert (full.n_layers, full.d_model, full.n_heads, full.n_kv_heads,
            full.head_dim, full.d_ff, full.vocab, full.window) == \
        (24, 2560, 32, 8, 80, 6912, 32000, 4096)


@pytest.mark.parametrize("flash,chunk,s", [
    (True, 0, 128),        # flash kernel path (interpret mode in JAX)
    (True, 0, 256),
    (False, 64, 128),      # _sdpa_chunked
    (False, 0, 96),        # _sdpa
    (True, 0, 96),         # s % 128 != 0: flash falls through to _sdpa
], ids=["flash_s128", "flash_s256", "chunked_s128", "sdpa_s96",
        "flash_off_grid_s96"])
def test_forward_matches_reference(ref_params, flash, chunk, s):
    jax_model, model = _pair(ref_params, use_flash_kernel=flash,
                             attn_chunk=chunk)
    tokens = _tokens(2, s)
    want, _ = jax_model.forward(ref_params, jnp.asarray(tokens))
    with torch.inference_mode():
        got, aux = model.forward(torch.from_numpy(tokens))
    assert float(aux) == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)


def test_prefill_and_greedy_generate_match_reference(ref_params):
    jax_model, model = _pair(ref_params, use_flash_kernel=True)
    prompt = _tokens(2, 128, seed=1)
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


def test_serve_step_matches_reference_decode(ref_params):
    """Decode steps past the window wrap the ring cache (window + 1 = 9
    slots); logits and the cache contents must follow the reference."""
    jax_model, model = _pair(ref_params)
    tokens = _tokens(2, 20, seed=2)
    jax_cache = jax_model.init_cache(2, 20)
    cache = model.init_cache(2, 20)
    assert cache["groups"][0]["b0"]["kv"]["k"].shape == (2, 9, 1, 80)
    step = serve_step.make_serve_step(model)
    jax_step = jax.jit(jax_model.decode_step)
    for t in range(20):
        want, jax_cache = jax_step(
            ref_params, jax_cache, jnp.asarray(tokens[:, t:t + 1]), t)
        got, cache = step(cache, torch.from_numpy(tokens[:, t:t + 1]), t)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                                   rtol=TOL)
    for g, gcache in enumerate(cache["groups"]):
        np.testing.assert_allclose(
            gcache["b0"]["kv"]["k"].numpy(),
            np.asarray(jax_cache["groups"]["b0"]["kv"]["k"][g]),
            atol=TOL, rtol=TOL)


def test_sequential_prefill_matches_forward_last_logits(ref_params):
    _, model = _pair(ref_params, use_flash_kernel=True)
    prompt = torch.from_numpy(_tokens(2, 128, seed=3))
    with torch.inference_mode():
        seq, _ = model.prefill(prompt, model.init_cache(2, 128))
    fast = serve_step.make_prefill(model)(prompt)
    torch.testing.assert_close(seq, fast, atol=TOL, rtol=TOL)


def test_params_from_jax_copies_every_leaf(ref_params):
    _, model = _pair(ref_params)
    state = model.state_dict()
    np.testing.assert_array_equal(state["tok_embed"].numpy(),
                                  ref_params["tok_embed"])
    np.testing.assert_array_equal(state["lm_head"].numpy(),
                                  ref_params["lm_head"])
    groups = ref_params["groups"]["b0"]
    for g in range(2):
        np.testing.assert_array_equal(state[f"groups.{g}.b0.attn.wq"].numpy(),
                                      groups["attn"]["wq"][g])
        np.testing.assert_array_equal(state[f"groups.{g}.b0.mlp.wd"].numpy(),
                                      groups["mlp"]["wd"][g])
        np.testing.assert_array_equal(state[f"groups.{g}.b0.ln2"].numpy(),
                                      groups["ln2"][g])
    n_ref = sum(a.size for a in jax.tree.leaves(ref_params))
    assert model.param_count() == n_ref


def test_params_from_jax_casts_and_checks_group_dim(ref_params):
    cfg = get_config(ARCH, smoke=True)
    model = params_from_jax(ref_params, cfg, device="cpu",
                            dtype=torch.bfloat16)
    assert model.tok_embed.dtype == torch.bfloat16
    short = dict(ref_params, groups=jax.tree.map(lambda a: a[:1],
                                                 ref_params["groups"]))
    with pytest.raises(ValueError, match="n_groups"):
        params_from_jax(short, cfg, device="cpu")


def test_init_follows_reference_distributions():
    cfg = get_config(ARCH, smoke=True)
    model = build(cfg, "cpu").init(port_device.generator(0, "cpu"))
    block = model.groups[0]["b0"]
    assert torch.equal(block.ln1, torch.ones(64))
    assert abs(float(block.attn.wq.std()) - 64 ** -0.5) < 0.01
    assert abs(float(model.tok_embed.std()) - 0.02) < 0.002
    again = build(cfg, "cpu").init(port_device.generator(0, "cpu"))
    assert torch.equal(model.lm_head, again.lm_head)


DENSE_ARCHS = ["minicpm-2b", "deepseek-67b", "llama3-405b"]


@pytest.fixture(scope="module", params=DENSE_ARCHS)
def dense_pair(request):
    """(arch, reference model, its numpy params, the port model on them)
    for the smoke configs of the three dense configs served last."""
    arch = request.param
    jax_cfg = jax_get_config(arch, smoke=True).replace(use_flash_kernel=True)
    jax_model = jax_build(jax_cfg)
    params = jax.tree.map(np.asarray, jax_model.init(jax.random.PRNGKey(0)))
    cfg = get_config(arch, smoke=True).replace(use_flash_kernel=True)
    return arch, jax_model, params, params_from_jax(params, cfg,
                                                    device="cpu")


def test_dense_configs_prefill_and_generate_match_reference(dense_pair):
    """minicpm-smoke (MHA, its head tied to the embedding, logits scaled by
    256/d_model), deepseek67b- and llama405b-smoke (GQA 8): the forward on
    the flash path (S=128) and the plain path, make_prefill's last logits
    and greedy_generate's tokens, from the reference's weights."""
    arch, jax_model, params, model = dense_pair
    tokens = _tokens(2, 128, seed=4)
    want, _ = jax_model.forward(params, jnp.asarray(tokens))
    with torch.inference_mode():
        got, _ = model.forward(torch.from_numpy(tokens))
        model.cfg = model.cfg.replace(use_flash_kernel=False)
        plain, _ = model.forward(torch.from_numpy(tokens))
        model.cfg = model.cfg.replace(use_flash_kernel=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)
    np.testing.assert_allclose(plain.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)
    want_last = jax_serve_step.make_prefill(jax_model)(params,
                                                       jnp.asarray(tokens))
    got_last = serve_step.make_prefill(model)(torch.from_numpy(tokens))
    np.testing.assert_allclose(got_last.numpy(), np.asarray(want_last),
                               atol=TOL, rtol=TOL)
    want_toks = jax_serve_step.greedy_generate(jax_model, params,
                                               jnp.asarray(tokens), max_new=6)
    got_toks = serve_step.greedy_generate(model, torch.from_numpy(tokens),
                                          max_new=6)
    np.testing.assert_array_equal(got_toks.numpy(), np.asarray(want_toks))


def test_dense_configs_decode_matches_reference(dense_pair):
    """One-token decode steps through the port's cache against the
    reference's decode_step."""
    arch, jax_model, params, model = dense_pair
    tokens = _tokens(2, 12, seed=5)
    jax_cache = jax_model.init_cache(2, 12)
    cache = model.init_cache(2, 12)
    step = serve_step.make_serve_step(model)
    jax_step = jax.jit(jax_model.decode_step)
    for t in range(12):
        want, jax_cache = jax_step(params, jax_cache,
                                   jnp.asarray(tokens[:, t:t + 1]), t)
        got, cache = step(cache, torch.from_numpy(tokens[:, t:t + 1]), t)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                                   rtol=TOL)


def test_minicpm_head_is_the_embedding_and_scales_apply():
    """minicpm's tied head: params_from_jax loads ``tok_embed`` once and the
    logits are x @ tok_embed^T * 256/d_model; its residual scale
    1.4/sqrt(L) scales the init of the output projections, as the
    reference's init does (the only place either package applies it)."""
    cfg = get_config("minicpm-2b", smoke=True)
    params = jax.tree.map(np.asarray, jax_build(jax_get_config(
        "minicpm-2b", smoke=True)).init(jax.random.PRNGKey(0)))
    assert "lm_head" not in params
    model = params_from_jax(params, cfg, device="cpu")
    assert "lm_head" not in model.state_dict()
    assert model.param_count() == sum(a.size for a in
                                      jax.tree.leaves(params))
    x = torch.randn(3, cfg.d_model, generator=port_device.generator(0, "cpu"))
    torch.testing.assert_close(model._logits(x),
                               (x @ model.tok_embed.T) * (256.0 / 72.0))
    assert cfg.logit_scale == 256.0 / 72.0
    assert cfg.residual_scale == 1.4 / 2 ** 0.5
    full = get_config("minicpm-2b")
    assert (full.vocab, full.logit_scale, full.residual_scale) == \
        (122753, 256.0 / 2304.0, 1.4 / 40 ** 0.5)
    model = build(cfg, "cpu").init(port_device.generator(0, "cpu"))
    block = model.groups[0]["b0"]
    want = cfg.residual_scale * (cfg.n_heads * cfg.head_dim) ** -0.5
    assert abs(float(block.attn.wo.std()) / want - 1) < 0.1
    assert abs(float(block.mlp.wd.std())
               / (cfg.residual_scale * cfg.d_ff ** -0.5) - 1) < 0.1


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_config_builds_in_the_port(arch):
    """The full config on the meta device (no memory) holds exactly the
    parameters the config counts; the smoke config builds on the CPU and
    serves finite logits, with the stub frontend's memory where the family
    takes one."""
    full = get_config(arch)
    assert LanguageModel(full, device="meta").param_count() == \
        full.param_count()
    cfg = get_config(arch, smoke=True)
    model = build(cfg, "cpu").init(port_device.generator(0, "cpu"))
    assert model.param_count() == cfg.param_count()
    mlen = memory_len(cfg, 16)
    memory = None if mlen is None else torch.randn(2, max(mlen, 4),
                                                   cfg.d_model)
    last = serve_step.make_prefill(model)(torch.from_numpy(_tokens(2, 16)),
                                          memory)
    assert tuple(last.shape) == (2, cfg.vocab)
    assert bool(torch.isfinite(last).all())


def test_serve_runs_on_cpu_when_asked(capsys):
    out = port_serve.serve(ARCH, smoke=True, batch=2, prompt_len=16,
                           max_new=4, device="cpu")
    assert out.dtype == torch.int32 and tuple(out.shape) == (2, 4)
    assert bool(((out >= 0) & (out < 128)).all())
    port_serve.main(["--arch", ARCH, "--device", "cpu", "--batch", "1",
                     "--prompt-len", "8", "--max-new", "2"])
    assert capsys.readouterr().out.count("[serve]") == 2


def test_generation_reaches_no_kernel():
    """As in the reference, greedy decoding never calls flash attention."""
    kernel.launches = 0
    port_serve.serve(ARCH, smoke=True, batch=1, prompt_len=128, max_new=2,
                     device="cpu")
    assert kernel.launches == 0


@pytest.mark.parametrize("entry", ["resolve_device", "generator", "build",
                                   "setup", "serve", "init_kv_cache",
                                   "init_ssm_cache"])
def test_entry_points_raise_without_cuda(monkeypatch, entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config(ARCH, smoke=True)
    from repro_torch.models.attention import init_kv_cache
    from repro_torch.models.ssm import init_ssm_cache
    calls = {
        "resolve_device": lambda dev: port_device.resolve_device(dev),
        "generator": lambda dev: port_device.generator(0, dev),
        "build": lambda dev: build(cfg, dev),
        "setup": lambda dev: port_serve.setup(ARCH, smoke=True, batch=1,
                                              prompt_len=4, seed=0,
                                              device=dev),
        "serve": lambda dev: port_serve.serve(ARCH, batch=1, prompt_len=4,
                                              max_new=1, device=dev),
        "init_kv_cache": lambda dev: init_kv_cache(
            cfg, 1, 4, device=port_device.resolve_device(dev)),
        "init_ssm_cache": lambda dev: init_ssm_cache(
            get_config("mamba2-1.3b", smoke=True), 1, device=dev),
    }
    with pytest.raises(RuntimeError, match="device='cpu'"):
        calls[entry](None)
    calls[entry]("cpu")


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_sources_import_no_jax_and_no_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    files += sorted((ROOT / "examples_torch").glob("*.py"))
    assert len(files) > 20
    bad = [(f.name, m) for f in files for m in _imports(f)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad


def test_importing_the_port_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,"
        " 'repro_torch.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "import chip_smoke\n"
        "import repro_torch.core, repro_torch.core.microbench\n"
        "import repro_torch.launch.validate\n"
        "for m in ('repro_torch.core', 'repro_torch.core.microbench',\n"
        "          'repro_torch.launch.validate', 'repro_torch.obs.metrics',\n"
        "          'repro_torch.kernels.matmul.kernel',\n"
        "          'repro_torch.kernels.rmsnorm.kernel'):\n"
        "    assert m in mods, m\n"
        "bad = sorted(n for n in sys.modules\n"
        "             if n.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "assert len(mods) >= 40, mods\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                   check=True, timeout=300)
