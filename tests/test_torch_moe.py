"""The port's MoE FFN (``repro_torch/models/moe.py``) against the JAX
reference's (``repro/models/moe.py``) on the CPU: the same numpy parameters
(from the reference's ``moe_init``) and the same numpy inputs.

Tolerances: ``tests/test_moe.py``'s atol 2e-5 / rtol 2e-4 in fp32; in bf16
the port sums a token's k contributions with one rounding where XLA's
scatter-add may round after each, so outputs are held at a bf16 tolerance.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import ModelConfig as RefConfig  # noqa: E402
from repro.models import moe as ref_moe  # noqa: E402
from repro_torch import device as port_device  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.models import moe  # noqa: E402

FIELDS = dict(name="m", family="moe", n_layers=1, d_model=32, n_heads=2,
              n_kv_heads=2, d_ff=64, vocab=64, pattern=("moe",),
              n_experts=8, top_k=2, d_expert=48, capacity_factor=8.0)
TOL = {"atol": 2e-5, "rtol": 2e-4}              # tests/test_moe.py
BF16_TOL = {"atol": 2e-2, "rtol": 2e-2}


def _cfgs(**overrides):
    return (RefConfig(**FIELDS).replace(**overrides),
            ModelConfig(**FIELDS).replace(**overrides))


def _ref_params(ref_cfg, seed=0):
    return jax.tree.map(np.asarray,
                        ref_moe.moe_init(jax.random.PRNGKey(seed), ref_cfg))


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def _port_moe(params, cfg):
    """A port MoE module holding the reference's numpy parameters, each
    leaf at the dtype of the parameter it fills."""
    mod = moe.MoE(cfg, "cpu")
    want = mod.state_dict()
    mod.load_state_dict({
        k: torch.tensor(np.asarray(v, np.float32), dtype=want[k].dtype)
        for k, v in _flat(params)}, strict=True)
    return mod


def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _both(params, x, ref_cfg, cfg):
    want, want_aux = jax.jit(lambda p, x: ref_moe.moe_apply(p, x, ref_cfg))(
        params, jnp.asarray(x, ref_cfg.dtype))
    with torch.no_grad():
        got, aux = moe.moe_apply(_port_moe(params, cfg),
                                 torch.from_numpy(x).to(
                                     getattr(torch, cfg.dtype)), cfg)
    return (got.float().numpy(), float(aux),
            np.asarray(want, np.float32), float(want_aux))


@pytest.mark.parametrize("overrides,shape", [
    ({}, (2, 16, 32)),
    ({"n_shared_experts": 1}, (2, 16, 32)),
    ({"n_shared_experts": 2, "residual_scale": 0.5}, (2, 16, 32)),
    ({"capacity_factor": 0.01}, (4, 64, 32)),        # cap 8: drops
    ({"capacity_factor": 1.0}, (4, 64, 32)),         # cap 32 at a mean of 32
    ({"n_experts": 16, "top_k": 4}, (1, 40, 32)),
], ids=["plain", "shared", "shared2_scaled", "drops", "cap_at_mean",
        "e16_k4"])
def test_moe_apply_matches_reference(overrides, shape):
    ref_cfg, cfg = _cfgs(**overrides)
    params = _ref_params(ref_cfg)
    got, aux, want, want_aux = _both(params, _x(shape), ref_cfg, cfg)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(aux, want_aux, rtol=1e-6)
    assert aux > 0


def test_capacity_drops_the_same_assignments():
    """cap = 8 slots for 512 assignments over 8 experts: most are dropped;
    the output equals the reference's, and the kept set is the first 8
    assignments of each expert in token order."""
    ref_cfg, cfg = _cfgs(capacity_factor=0.01)
    params = _ref_params(ref_cfg)
    x = _x((4, 64, 32))
    got, _, want, _ = _both(params, x, ref_cfg, cfg)
    np.testing.assert_allclose(got, want, **TOL)
    with torch.no_grad():
        r = moe.route(_port_moe(params, cfg),
                      torch.from_numpy(x.reshape(-1, 32)), cfg)
    assert r.cap == moe.capacity(cfg, 256) == 8
    experts = r.experts.numpy()
    seen = np.zeros(cfg.n_experts, np.int64)
    for i, e in enumerate(experts):             # rank = earlier same-expert
        assert r.rank[i] == seen[e]
        seen[e] += 1
    np.testing.assert_array_equal(r.keep.numpy(), r.rank.numpy() < 8)
    assert int(r.keep.sum()) == int(np.minimum(seen, 8).sum()) < 512
    oracle = ref_moe.moe_apply_reference(params, jnp.asarray(x), ref_cfg)
    assert np.linalg.norm(got) < np.linalg.norm(np.asarray(oracle))


@pytest.mark.parametrize("capacity_factor", [0.5, 8.0])
def test_witness_probe_reads_the_reference_kept_set(capacity_factor):
    """``tests/moe_route_witness.py`` reads which assignments the reference
    keeps from its dispatch's output with probe experts; on the same input
    and router the set equals the one the port's ``route`` keeps, with
    drops (cap 8 for a mean load of 12) and without."""
    from moe_route_witness import port_kept, reference_kept
    ref_cfg, cfg = _cfgs(capacity_factor=capacity_factor)
    params = _ref_params(ref_cfg)
    x = _x((1, 48, 32))[0]
    with torch.no_grad():
        r = moe.route(_port_moe(params, cfg), torch.from_numpy(x), cfg)
    assert (int((~r.keep).sum()) > 0) == (capacity_factor < 1)
    np.testing.assert_array_equal(
        reference_kept(x, params["w_router"], ref_cfg),
        port_kept(r, 48, cfg.n_experts))


def test_capacity_formula():
    _, cfg = _cfgs(capacity_factor=1.25, n_experts=128, top_k=8)
    assert moe.capacity(cfg, 8192) == 640       # qwen3-moe's prefill
    assert moe.capacity(cfg, 4) == 8            # a decode step: no drops
    assert moe.capacity(cfg, 1) == 8            # t * k
    _, cfg = _cfgs(capacity_factor=1.25, n_experts=256, top_k=8)
    assert moe.capacity(cfg, 1024) == 40


def test_collapsed_router_breaks_ties_as_the_reference():
    """All router mass on expert 0: the other seven experts tie exactly;
    ``jax.lax.top_k`` takes the lowest index among them, and so does the
    port's stable sort."""
    ref_cfg, cfg = _cfgs()
    params = _ref_params(ref_cfg)
    params["w_router"] = np.zeros_like(params["w_router"])
    params["w_router"][:, 0] = 10.0
    x = _x((4, 64, 32))
    got, aux, want, want_aux = _both(params, x, ref_cfg, cfg)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(aux, want_aux, rtol=1e-6)
    xt = x.reshape(-1, 32)
    probs = jax.nn.softmax(jnp.asarray(xt) @ params["w_router"], axis=-1)
    _, want_ids = jax.lax.top_k(probs, cfg.top_k)
    with torch.no_grad():
        r = moe.route(_port_moe(params, cfg), torch.from_numpy(xt), cfg)
    ids = r.experts.numpy().reshape(-1, cfg.top_k)
    np.testing.assert_array_equal(ids, np.asarray(want_ids))
    # expert 0 first, or (its logit below the tied zeros) last: either way
    # the ties go to the lowest indices
    assert {tuple(row) for row in ids} == {(0, 1), (1, 2)}


def test_top_k_is_stable_on_ties():
    probs = torch.tensor([[0.1, 0.3, 0.3, 0.3], [0.25, 0.25, 0.25, 0.25]])
    vals, ids = moe.top_k(probs, 3)
    assert ids.tolist() == [[1, 2, 3], [0, 1, 2]]
    want_vals, want_ids = jax.lax.top_k(jnp.asarray(probs.numpy()), 3)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(want_ids))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(want_vals))


def test_bf16_matches_reference_and_keeps_router_fp32():
    ref_cfg, cfg = _cfgs(n_shared_experts=1, dtype="bfloat16",
                         param_dtype="bfloat16")
    params = _ref_params(ref_cfg)
    assert params["w_router"].dtype == np.float32
    mod = _port_moe(params, cfg)
    assert mod.w_router.dtype == torch.float32
    assert mod.we_g.dtype == mod.shared.wd.dtype == torch.bfloat16
    got, aux, want, want_aux = _both(params, _x((2, 16, 32)), ref_cfg, cfg)
    np.testing.assert_allclose(got, want, **BF16_TOL)
    np.testing.assert_allclose(aux, want_aux, rtol=1e-5)


@pytest.mark.parametrize("overrides", [{}, {"n_shared_experts": 1},
                                       {"capacity_factor": 0.5}],
                         ids=["plain", "shared", "drops"])
def test_gradients_match_reference(overrides):
    """d/d(params, x) of sum(out^2) + aux, against ``jax.grad``: through the
    gates, the scatter and gather, the expert products and the aux loss's
    mean probabilities."""
    ref_cfg, cfg = _cfgs(**overrides)
    params = _ref_params(ref_cfg)
    x = _x((2, 16, 32))

    def loss(p, xx):
        out, aux = ref_moe.moe_apply(p, xx, ref_cfg)
        return jnp.sum(out.astype(jnp.float32) ** 2) + aux
    want_p, want_x = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(x))

    mod = _port_moe(params, cfg).requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    out, aux = moe.moe_apply(mod, xt, cfg)
    (torch.sum(out.float() ** 2) + aux).backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_x), **TOL)
    grads = dict(mod.named_parameters())
    for name, want in _flat(want_p):
        np.testing.assert_allclose(grads[name].grad.numpy(),
                                   np.asarray(want), err_msg=name, **TOL)
    assert float(grads["we_g"].grad.norm()) > 0
    assert float(grads["w_router"].grad.norm()) > 0


@pytest.mark.parametrize("shared", [0, 1])
def test_dense_oracle_matches_reference(shared):
    ref_cfg, cfg = _cfgs(n_shared_experts=shared)
    params = _ref_params(ref_cfg)
    x = _x((2, 16, 32))
    want = ref_moe.moe_apply_reference(params, jnp.asarray(x), ref_cfg)
    mod = _port_moe(params, cfg)
    with torch.no_grad():
        got = moe.moe_apply_reference(mod, torch.from_numpy(x), cfg)
        out, _ = moe.moe_apply(mod, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(out.numpy(), got.numpy(), **TOL)   # cf 8


def test_init_follows_reference_distributions():
    _, cfg = _cfgs(d_model=64, n_experts=16, d_expert=96, n_shared_experts=1,
                   residual_scale=0.5, param_dtype="bfloat16")
    mod = moe.MoE(cfg, "cpu")
    mod.init(port_device.generator(0, "cpu"), cfg)
    assert mod.w_router.dtype == torch.float32
    assert tuple(mod.we_d.shape) == (16, 96, 64)
    assert tuple(mod.shared.wg.shape) == (64, 96)
    std = 64 ** -0.5
    for w, want in ((mod.w_router, std), (mod.we_g, std), (mod.we_u, std),
                    (mod.we_d, std * 0.5), (mod.shared.wg, std),
                    (mod.shared.wd, 0.5 * 96 ** -0.5)):
        # the router's 1024 draws give a sample std within ~2% (1 sigma)
        assert abs(float(w.float().std()) / want - 1) < 0.08
    again = moe.MoE(cfg, "cpu")
    again.init(port_device.generator(0, "cpu"), cfg)
    assert torch.equal(mod.we_d, again.we_d)
    assert not torch.equal(mod.we_g[0], mod.we_g[1])
