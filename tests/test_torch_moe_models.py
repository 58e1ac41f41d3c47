"""The port's MoE / MLA families (``repro_torch``: the ``moe`` block, MLA,
the dense prefix, the MTP head, serve_step) against the JAX reference on
the CPU, on the same weights (carried across by ``params_from_jax``) and the
same numpy tokens.

Three smoke configs: qwen3moe-smoke (GQA attention + 8 experts top-2),
dsv3-smoke (MLA with the ``wq`` query branch, a shared expert, one dense
prefix block, MTP) and dsv3-smoke with ``q_lora_rank=24`` (the ``w_qa`` /
``w_qb`` branch of the full deepseek-v3 config).  Their capacity factor of 4
gives cap = T at these sizes, so no assignment is dropped.  The reference's
flash path runs the Pallas kernel in interpret mode.
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
from repro_torch.models import build  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.mla import init_mla_cache  # noqa: E402
from repro_torch.train import serve_step  # noqa: E402

TOL = 1e-4            # fp32 logits, port against reference
QWEN3, DSV3 = "qwen3-moe-235b-a22b", "deepseek-v3-671b"
CASES = {"qwen3moe": (QWEN3, {}), "dsv3": (DSV3, {}),
         "dsv3_qlora": (DSV3, {"q_lora_rank": 24})}


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    """(arch, config overrides, the reference's params as numpy)."""
    arch, overrides = CASES[request.param]
    cfg = jax_get_config(arch, smoke=True).replace(**overrides)
    params = jax_build(cfg).init(jax.random.PRNGKey(0))
    return arch, overrides, jax.tree.map(np.asarray, params)


def _pair(case, **more):
    """(reference model, port model) on the same weights."""
    arch, overrides, params = case
    kw = dict(overrides, **more)
    jax_cfg = jax_get_config(arch, smoke=True).replace(**kw)
    cfg = get_config(arch, smoke=True).replace(**kw)
    return jax_build(jax_cfg), params_from_jax(params, cfg, device="cpu")


def _tokens(b, s, seed=0):
    return np.random.default_rng(seed).integers(0, 128, (b, s),
                                                dtype=np.int32)


def test_smoke_configs_keep_the_families_structure():
    q = get_config(QWEN3, smoke=True)
    assert (q.pattern, q.use_mla, q.first_dense, q.mtp_depth,
            q.n_shared_experts) == (("moe",), False, 0, 0, 0)
    d = get_config(DSV3, smoke=True)
    assert (d.use_mla, d.first_dense, d.mtp_depth, d.n_shared_experts,
            d.q_lora_rank, d.n_groups) == (True, 1, 1, 1, 0, 2)
    full = get_config(DSV3)
    assert (full.d_model, full.n_heads, full.head_dim, full.kv_lora_rank,
            full.q_lora_rank, full.rope_head_dim, full.n_experts,
            full.top_k, full.expert_ff, full.vocab, full.first_dense) == \
        (7168, 128, 128, 512, 1536, 64, 256, 8, 2048, 129280, 3)
    full = get_config(QWEN3)
    assert (full.d_model, full.n_heads, full.n_kv_heads, full.head_dim,
            full.n_experts, full.top_k, full.expert_ff, full.vocab) == \
        (4096, 64, 4, 128, 128, 8, 1536, 151936)


@pytest.mark.parametrize("flash,s", [(True, 128), (False, 96)],
                         ids=["flash_s128", "plain_s96"])
def test_forward_matches_reference(case, flash, s):
    jax_model, model = _pair(case, use_flash_kernel=flash)
    tokens = _tokens(2, s)
    want, want_aux = jax.jit(jax_model.forward)(case[2], jnp.asarray(tokens))
    with torch.inference_mode():
        got, aux = model.forward(torch.from_numpy(tokens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), atol=TOL,
                               rtol=TOL)
    assert float(aux) > 0


def test_prefill_and_greedy_generate_match_reference(case):
    jax_model, model = _pair(case, use_flash_kernel=True)
    prompt = _tokens(2, 128, seed=1)
    want_last = jax_serve_step.make_prefill(jax_model)(case[2],
                                                       jnp.asarray(prompt))
    got_last = serve_step.make_prefill(model)(torch.from_numpy(prompt))
    np.testing.assert_allclose(got_last.numpy(), np.asarray(want_last),
                               atol=TOL, rtol=TOL)

    prompt = prompt[:, :24]
    want = jax_serve_step.greedy_generate(jax_model, case[2],
                                          jnp.asarray(prompt), max_new=6)
    got = serve_step.greedy_generate(model, torch.from_numpy(prompt),
                                     max_new=6)
    assert got.dtype == torch.int32 and tuple(got.shape) == (2, 6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _block_caches(cache, jax_cache, n_groups):
    """(name, port tensor, reference tensor) for every cache leaf: the
    groups' (MLA latent and rope key, or K/V) and the prefix blocks'."""
    for g in range(n_groups):
        for kind, leaves in jax_cache["groups"]["b0"].items():
            for leaf, a in leaves.items():
                yield (f"groups.{g}.{kind}.{leaf}",
                       cache["groups"][g]["b0"][kind][leaf], a[g])
    for i, pcache in enumerate(cache.get("prefix", [])):
        for leaf, a in jax_cache["prefix"]["kv"].items():
            yield f"prefix.{i}.kv.{leaf}", pcache["kv"][leaf], a[i]


def test_decode_steps_and_caches_match_reference(case):
    jax_model, model = _pair(case)
    cfg = model.cfg
    tokens = _tokens(2, 12, seed=2)
    jax_cache = jax_model.init_cache(2, 12)
    cache = model.init_cache(2, 12)
    first = cache["groups"][0]["b0"]
    if cfg.use_mla:
        assert tuple(first["mla"]["latent"].shape) == (2, 12, 32)
        assert tuple(first["mla"]["k_rope"].shape) == (2, 12, 16)
        assert tuple(cache["prefix"][0]["kv"]["k"].shape) == (2, 12, 4, 16)
    else:
        assert tuple(first["kv"]["k"].shape) == (2, 12, 2, 16)
        assert "prefix" not in cache
    step = serve_step.make_serve_step(model)
    jax_step = jax.jit(jax_model.decode_step)
    for t in range(12):
        want, jax_cache = jax_step(
            case[2], jax_cache, jnp.asarray(tokens[:, t:t + 1]), t)
        got, cache = step(cache, torch.from_numpy(tokens[:, t:t + 1]), t)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                                   rtol=TOL)
    leaves = list(_block_caches(cache, jax_cache, cfg.n_groups))
    assert len(leaves) == 2 * cfg.n_groups + 2 * cfg.first_dense
    for name, got_c, want_c in leaves:
        np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c),
                                   atol=TOL, rtol=TOL, err_msg=name)


def test_sequential_prefill_matches_forward_last_logits(case):
    _, model = _pair(case, use_flash_kernel=True)
    prompt = torch.from_numpy(_tokens(2, 128, seed=3))
    with torch.no_grad():
        r = moe.route(model.groups[0]["b0"].moe,
                      torch.zeros(256, model.cfg.d_model), model.cfg)
    assert r.cap == 256 and bool(r.keep.all())       # cap = T: no drops
    with torch.inference_mode():
        seq, _ = model.prefill(prompt, model.init_cache(2, 128))
    fast = serve_step.make_prefill(model)(prompt)
    torch.testing.assert_close(seq, fast, atol=TOL, rtol=TOL)


def test_params_from_jax_copies_every_leaf(case):
    _, model = _pair(case)
    cfg = model.cfg
    state = model.state_dict()
    leaves = 0
    for path, a in jax.tree_util.tree_flatten_with_path(case[2])[0]:
        keys = [k.key for k in path]
        if keys[0] in ("groups", "prefix"):
            assert a.shape[0] == (cfg.n_groups if keys[0] == "groups"
                                  else cfg.first_dense)
            for i in range(a.shape[0]):
                port = ".".join([keys[0], str(i)] + keys[1:])
                np.testing.assert_array_equal(state[port].numpy(), a[i])
                leaves += 1
        else:
            np.testing.assert_array_equal(state[".".join(keys)].numpy(), a)
            leaves += 1
    assert leaves == len(state)
    names = set(state)
    if cfg.use_mla:
        assert {"prefix.0.attn.wq", "mtp.proj", "mtp.block.mlp.wd",
                "groups.1.b0.moe.shared.wg"} <= names
        assert ("groups.0.b0.attn.w_qa" in names) == (cfg.q_lora_rank > 0)
        assert ("groups.0.b0.attn.wq" in names) == (cfg.q_lora_rank == 0)
    else:
        assert not any(n.startswith(("prefix", "mtp")) for n in names)


def test_param_count_matches_reference(case):
    arch, overrides, params = case
    model = build(get_config(arch, smoke=True).replace(**overrides), "cpu")
    n_ref = sum(a.size for a in jax.tree.leaves(params))
    assert model.param_count() == n_ref == jax_get_config(
        arch, smoke=True).replace(**overrides).param_count()


def test_params_from_jax_keeps_the_router_fp32_under_bf16(case):
    arch, overrides, params = case
    cfg = get_config(arch, smoke=True).replace(**overrides)
    model = params_from_jax(params, cfg, device="cpu", dtype=torch.bfloat16)
    for g in range(cfg.n_groups):
        block = model.groups[g]["b0"]
        assert block.moe.w_router.dtype == torch.float32
        np.testing.assert_array_equal(
            block.moe.w_router.numpy(),
            params["groups"]["b0"]["moe"]["w_router"][g])
        assert block.moe.we_g.dtype == torch.bfloat16
        assert block.attn.wo.dtype == torch.bfloat16
    if cfg.first_dense:
        assert model.prefix[0].attn.wq.dtype == torch.bfloat16
        assert model.mtp.proj.dtype == torch.bfloat16


def test_params_from_jax_checks_the_prefix_depth(case):
    """A prefix leaf must be stacked over first_dense blocks: one fewer
    (or, in a model without a prefix, any) raises."""
    arch, overrides, params = case
    cfg = get_config(arch, smoke=True).replace(**overrides)
    if cfg.first_dense:
        bad = jax.tree.map(lambda a: a[:-1], params["prefix"])
    else:
        bad = {"ln1": np.ones((1, cfg.d_model), np.float32)}
    with pytest.raises(ValueError, match=f"first_dense={cfg.first_dense}"):
        params_from_jax(dict(params, prefix=bad), cfg, device="cpu")


def test_init_follows_reference_distributions():
    cfg = get_config(DSV3, smoke=True).replace(param_dtype="bfloat16",
                                               q_lora_rank=24)
    model = build(cfg, "cpu").init(port_device.generator(0, "cpu"))
    block = model.groups[0]["b0"]
    d = cfg.d_model
    assert torch.equal(block.ln2, torch.ones(d, dtype=torch.bfloat16))
    assert block.moe.w_router.dtype == torch.float32
    for w, want in ((block.attn.w_dkv, d ** -0.5), (block.attn.w_qa,
                                                    d ** -0.5),
                    (block.attn.w_qb, 24 ** -0.5),
                    (block.attn.w_uk, cfg.kv_lora_rank ** -0.5),
                    (block.moe.we_g, d ** -0.5),
                    (block.moe.we_d, d ** -0.5),
                    (model.mtp.proj, (2 * d) ** -0.5),
                    (model.prefix[0].attn.wq, d ** -0.5)):
        assert abs(float(w.float().std()) / want - 1) < 0.1
    assert torch.equal(model.mtp.norm_h, torch.ones(d, dtype=torch.bfloat16))
    again = build(cfg, "cpu").init(port_device.generator(0, "cpu"))
    assert torch.equal(model.mtp.proj, again.mtp.proj)


@pytest.mark.parametrize("share_trunk", [False, True],
                         ids=["rerun_trunk", "share_trunk"])
def test_loss_fn_matches_reference(case, share_trunk):
    """loss = xent + aux + 0.3 mtp in both of the reference's trunk
    branches, and its gradients (1e-5)."""
    jax_model, model = _pair(case, mtp_share_trunk=share_trunk)
    tokens = _tokens(2, 32, seed=4)
    labels = np.roll(tokens, -1, axis=1)
    labels[0, :5] = -100
    (want, want_m), want_g = jax.jit(jax.value_and_grad(
        jax_model.loss_fn, has_aux=True))(
        case[2], {"tokens": jnp.asarray(tokens),
                  "labels": jnp.asarray(labels)})
    model.requires_grad_(True)
    loss, metrics = model.loss_fn({"tokens": torch.from_numpy(tokens),
                                   "labels": torch.from_numpy(labels)})
    loss.backward()
    loss = loss.detach()
    assert set(metrics) == set(want_m)
    assert ("mtp" in metrics) == (model.cfg.mtp_depth > 0)
    np.testing.assert_allclose(float(loss), float(want), atol=1e-5,
                               rtol=1e-5)
    for key in want_m:
        np.testing.assert_allclose(float(metrics[key]), float(want_m[key]),
                                   atol=1e-5, rtol=1e-5, err_msg=key)
    grads = {k: p.grad for k, p in model.named_parameters()}
    for path, g in jax.tree_util.tree_flatten_with_path(want_g)[0]:
        keys = [k.key for k in path]
        if keys[0] in ("groups", "prefix"):
            got = np.stack([grads[".".join([keys[0], str(i)] + keys[1:])]
                            .numpy() for i in range(g.shape[0])])
        else:
            got = grads[".".join(keys)].numpy()
        np.testing.assert_allclose(got, np.asarray(g), atol=1e-5, rtol=1e-5,
                                   err_msg=".".join(keys))


def test_init_mla_cache_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config(DSV3, smoke=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_mla_cache(cfg, 1, 4)
    cache = init_mla_cache(cfg, 1, 4, device="cpu")
    assert cache["latent"].dtype == torch.float32
