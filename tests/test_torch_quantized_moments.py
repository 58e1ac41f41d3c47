"""The port's block-quantized int8 Adam moments
(``repro_torch.optim.quantized_moments``) against the reference's on the
CPU, on the same numpy inputs, and the reference's own properties of the
module run against the port.

Codes are held equal; scales to rtol 1e-6 (the log-space scales come from
``torch.log`` and ``jnp.log``, which may differ by one ulp); parameters
after chained updates to atol/rtol 1e-6.  The per-leaf slicing and the
per-leaf clip are held bit for bit to the unsliced update and to a clipped
copy of the gradients.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.models import build as ref_build  # noqa: E402
from repro.optim import quantized_moments as ref_qm  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.optim import adamw_init, adamw_update  # noqa: E402
from repro_torch.optim import clip_by_global_norm  # noqa: E402
from repro_torch.optim import quantized_moments as qm  # noqa: E402
from repro_torch.train import train_step  # noqa: E402

SCALE_TOL = {"rtol": 1e-6, "atol": 0}
PARAM_TOL = {"rtol": 1e-6, "atol": 1e-6}
# ragged last dims, 0-d, 1-D shorter than a block, a stacked 3-D leaf
SHAPES = [(1,), (255,), (257,), (1000,), (), (100,), (3, 5, 300)]
QUANTIZERS = ["quantize_signed", "quantize_nonneg", "quantize_signed_nd",
              "quantize_nonneg_nd"]


def _decades(shape, seed, lo=-12, hi=1):
    """Normal values whose magnitudes span ``lo``..``hi`` decades."""
    rng = np.random.default_rng(seed)
    return np.asarray(rng.standard_normal(shape)
                      * 10.0 ** rng.uniform(lo, hi, shape), np.float32)


def _input(fn, shape, seed):
    x = _decades(shape, seed)
    return np.square(x) if "nonneg" in fn else x


def _same_codes(got_q, got_s, want_q, want_s):
    assert got_q.dtype == torch.int8
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s),
                               **SCALE_TOL)


def _cases():
    for fn in QUANTIZERS:
        for shape in SHAPES:
            if not (fn.endswith("_nd") and shape == ()):
                yield fn, shape


@pytest.mark.parametrize("fn,shape", list(_cases()))
def test_quantizers_give_the_reference_codes(fn, shape):
    x = _input(fn, shape, seed=len(shape) * 7 + shape[-1] if shape else 1)
    want_q, want_s = getattr(ref_qm, fn)(jnp.asarray(x))
    got_q, got_s = getattr(qm, fn)(torch.tensor(x))
    assert tuple(got_q.shape) == want_q.shape
    assert tuple(got_s.shape) == want_s.shape
    _same_codes(got_q, got_s, want_q, want_s)
    # the dequantizers, given the same codes and scales
    deq = fn.replace("quantize", "dequantize")
    want = getattr(ref_qm, deq)(want_q, want_s, shape)
    got = getattr(qm, deq)(torch.tensor(np.asarray(want_q)),
                           torch.tensor(np.asarray(want_s)), shape)
    assert tuple(got.shape) == tuple(shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=0)


@pytest.mark.parametrize("nd", [False, True], ids=["flat", "nd"])
def test_all_zero_v_reads_back_zero(nd):
    """Zero v quantizes to codes of -128 with lmin = log(1e-30); anything at
    or below 2 * V_FLOOR reads back as exactly 0."""
    quant = qm.quantize_nonneg_nd if nd else qm.quantize_nonneg
    deq = qm.dequantize_nonneg_nd if nd else qm.dequantize_nonneg
    ref_quant = ref_qm.quantize_nonneg_nd if nd else ref_qm.quantize_nonneg
    x = np.zeros((3, 300), np.float32)
    q, s = quant(torch.tensor(x))
    _same_codes(q, s, *ref_quant(jnp.asarray(x)))
    assert bool((q == -128).all())
    np.testing.assert_allclose(s[..., 0].numpy(), np.log(np.float32(1e-30)),
                               rtol=1e-6)
    assert torch.equal(deq(q, s, x.shape), torch.zeros(x.shape))


@pytest.mark.parametrize("nd", [False, True], ids=["flat", "nd"])
def test_init_is_the_reference_state(nd):
    shapes = {"w": (8, 300), "b": (257,), "s": ()}
    params = {k: np.zeros(s, np.float32) for k, s in shapes.items()}
    want = (ref_qm.q8nd_init if nd else ref_qm.q8_init)(
        {k: jnp.asarray(v) for k, v in params.items()})
    got = (qm.q8nd_init if nd else qm.q8_init)(
        {k: torch.tensor(v) for k, v in params.items()})
    assert got["step"].dtype == torch.int32 and int(got["step"]) == 0
    for mom in ("mu", "nu"):
        for k in shapes:
            assert got[mom][k].keys() == want[mom][k].keys()
            for part, t in got[mom][k].items():
                assert str(t.dtype).removeprefix("torch.") == \
                    str(want[mom][k][part].dtype)
                np.testing.assert_array_equal(
                    t.numpy(), np.asarray(want[mom][k][part]))


@pytest.mark.parametrize("nd", [False, True], ids=["flat", "nd"])
def test_chained_updates_match_reference(nd):
    """5 steps with the same gradients (magnitudes over many decades, the
    clip engaged, weight decay on): equal codes, params at 1e-6."""
    shapes = {"w": (8, 300), "b": (257,), "e": (3, 4, 5), "s": ()}
    ps = {k: _decades(s, i, -1, 0) for i, (k, s) in enumerate(shapes.items())}
    ref_p = {k: jnp.asarray(v) for k, v in ps.items()}
    port_p = {k: torch.tensor(v) for k, v in ps.items()}
    ref_s = (ref_qm.q8nd_init if nd else ref_qm.q8_init)(ref_p)
    port_s = (qm.q8nd_init if nd else qm.q8_init)(port_p)
    ref_upd = ref_qm.q8nd_adamw_update if nd else ref_qm.q8_adamw_update
    port_upd = qm.q8nd_adamw_update if nd else qm.q8_adamw_update
    for i in range(5):
        g = {k: _decades(s, 100 + 10 * i + j, -8, 1)
             for j, (k, s) in enumerate(shapes.items())}
        ref_p, ref_s, want = ref_upd(
            ref_p, {k: jnp.asarray(v) for k, v in g.items()}, ref_s, lr=1e-2)
        port_p, port_s, got = port_upd(
            port_p, {k: torch.tensor(v) for k, v in g.items()}, port_s,
            lr=1e-2)
        np.testing.assert_allclose(float(got["grad_norm"]),
                                   float(want["grad_norm"]), rtol=1e-6)
        assert float(got["grad_norm"]) > 1.0        # the clip is engaged
    assert int(port_s["step"]) == 5
    for k in shapes:
        np.testing.assert_allclose(port_p[k].numpy(), np.asarray(ref_p[k]),
                                   err_msg=k, **PARAM_TOL)
        for mom in ("mu", "nu"):
            got, want = port_s[mom][k], ref_s[mom][k]
            if "scale" in want:
                _same_codes(got["q"], got["scale"], want["q"], want["scale"])
            else:                                   # 0-d: fp32 moments
                np.testing.assert_allclose(got["q"].numpy(),
                                           np.asarray(want["q"]), rtol=1e-6)


def _bf16_problem(seed=0):
    rng = np.random.default_rng(seed)
    shapes = {"w": (64, 300), "v": (1000,), "s": ()}
    params = {k: torch.tensor(rng.standard_normal(s), dtype=torch.bfloat16)
              for k, s in shapes.items()}
    grads = [{k: torch.tensor(rng.standard_normal(s) * 3,
                              dtype=torch.bfloat16)
              for k, s in shapes.items()} for _ in range(3)]
    return params, grads


def _run(nd, params, grads, max_grad_norm=1.0, pre_clip=False):
    params = {k: p.clone() for k, p in params.items()}
    state = (qm.q8nd_init if nd else qm.q8_init)(params)
    upd = qm.q8nd_adamw_update if nd else qm.q8_adamw_update
    for g in grads:
        if pre_clip:
            g, _ = clip_by_global_norm(g, 1.0)
        upd(params, g, state, lr=1e-2, max_grad_norm=max_grad_norm)
    return params, state


def _flat_state(params, state):
    out = dict(params)
    for mom in ("mu", "nu"):
        for k, leaf in state[mom].items():
            out.update({f"{mom}.{k}.{part}": t for part, t in leaf.items()})
    return out


@pytest.mark.parametrize("nd", [False, True], ids=["flat", "nd"])
def test_slicing_and_the_per_leaf_clip_keep_the_bits(nd, monkeypatch):
    """bf16 parameters and gradients: the update in slices (rows of 300 for
    the nd layout, 512 elements for the flat one) gives the bits of the
    unsliced update, and clipping each leaf in the loop gives the bits of
    updating with ``clip_by_global_norm``'s clipped copy."""
    params, grads = _bf16_problem()
    whole = _flat_state(*_run(nd, params, grads))
    pre = _flat_state(*_run(nd, params, grads, max_grad_norm=0.0,
                            pre_clip=True))
    monkeypatch.setattr(qm, "SPLIT_ELEMS", 3 * 300 if nd else 600)
    sliced = _flat_state(*_run(nd, params, grads))
    assert whole.keys() == pre.keys() == sliced.keys()
    for k, t in whole.items():
        assert torch.equal(sliced[k], t), k
        assert torch.equal(pre[k], t), k
    assert any(not torch.equal(params[k], whole[k]) for k in params)


def _vlm_params():
    """vlm-smoke's reference params (numpy) with every xgate at 0.5."""
    arch = "llama-3.2-vision-90b"
    params = jax.tree.map(np.asarray, jax.jit(ref_build(ref_get_config(
        arch, smoke=True)).init)(jax.random.PRNGKey(0)))

    def fill(path, a):
        return np.full_like(a, 0.5) \
            if getattr(path[-1], "key", None) == "xgate" else a
    return arch, jax.tree_util.tree_map_with_path(fill, params)


def test_stacked_xgate_moments_are_the_reference_s():
    """The reference stacks each per-group 0-d ``xgate`` to a (n_groups,)
    leaf and quantizes its moments as one block over the groups; the
    port's train state does the same (its names say which leaf), and every
    other leaf, quantized group by group, gives the stacked leaf's codes.
    One update with the same gradients, every leaf compared."""
    arch, params = _vlm_params()
    cfg = get_config(arch, smoke=True)
    model = convert.params_from_jax(params, cfg, device="cpu")
    state = train_step.init_state(model, moment_dtype="int8")
    gate = next(n for n in state["params"] if n.endswith("xgate"))
    leaf = convert.split_stacked(gate)[0]
    assert state["params"][gate].dim() == 0
    assert gate not in state["opt"]["mu"] and leaf in state["opt"]["mu"]
    assert tuple(state["opt"]["mu"][leaf]["q"].shape) == (1, qm.BLOCK)
    rng = np.random.default_rng(5)
    ref_grads = jax.tree.map(
        lambda a: np.asarray(rng.standard_normal(a.shape) * 0.01, a.dtype),
        params)
    flat_g = convert._unstack(ref_grads)
    grads = {k: torch.tensor(np.asarray(flat_g[k]), dtype=p.dtype)
             for k, p in state["params"].items()}
    qm.q8nd_adamw_update(state["params"], grads, state["opt"], lr=1e-3)
    ref_params, ref_opt, _ = jax.jit(functools.partial(
        ref_qm.q8nd_adamw_update, lr=1e-3))(
        jax.tree.map(jnp.asarray, params),
        jax.tree.map(jnp.asarray, ref_grads),
        jax.jit(ref_qm.q8nd_init)(jax.tree.map(jnp.asarray, params)))
    tree = convert.state_to_jax(state)
    want = dict(jax.tree_util.tree_flatten_with_path(ref_opt)[0])
    got = dict(jax.tree_util.tree_flatten_with_path(
        jax.tree.map(lambda t: t.numpy(), tree["opt"]))[0])
    assert got.keys() == want.keys()
    n_gates = sum("xgate" in jax.tree_util.keystr(p) for p, _ in
                  jax.tree_util.tree_flatten_with_path(params)[0])
    gates = [p for p in want if "xgate" in jax.tree_util.keystr(p)]
    assert n_gates and len(gates) == 4 * n_gates   # mu, nu: q and scale
    for path, w in want.items():
        w = np.asarray(w)
        if w.dtype == np.int8:
            np.testing.assert_array_equal(got[path], w,
                                          jax.tree_util.keystr(path))
        else:
            np.testing.assert_allclose(got[path], w, rtol=1e-6,
                                       err_msg=jax.tree_util.keystr(path))
    got = dict(jax.tree_util.tree_flatten_with_path(tree["params"])[0])
    for path, w in jax.tree_util.tree_flatten_with_path(ref_params)[0]:
        np.testing.assert_allclose(got[path].numpy(), np.asarray(w),
                                   err_msg=jax.tree_util.keystr(path),
                                   **PARAM_TOL)


# ----------------------------------------- the reference's module properties

def _normal(shape, seed, scale=1.0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g) * scale


@pytest.mark.parametrize("n", [10, 256, 1000, 4096])
def test_signed_roundtrip(n):
    x = _normal((n,), 0, 0.1)
    q, s = qm.quantize_signed(x)
    y = qm.dequantize_signed(q, s, (n,))
    assert float(torch.linalg.norm(y - x) / torch.linalg.norm(x)) < 0.01


def test_nonneg_roundtrip():
    """Log-space quantization: bounded RELATIVE error per element, the
    small ones included (none flushes to zero)."""
    x = torch.rand((1000,), generator=torch.Generator().manual_seed(0)) ** 2
    q, s = qm.quantize_nonneg(x)
    y = qm.dequantize_nonneg(q, s, (1000,))
    assert float(((y - x).abs() / x.clamp(min=1e-12)).max()) < 0.08
    assert bool((y >= 0).all())
    small = x < torch.quantile(x, 0.1)
    assert bool((y[small] > 0).all())


def test_blockwise_handles_scale_variation():
    """Per-block scales keep relative error bounded when magnitudes vary
    1e6x across blocks."""
    b = _normal((256,), 1, 1e-6)
    x = torch.cat([_normal((256,), 0), b])
    q, s = qm.quantize_signed(x)
    y = qm.dequantize_signed(q, s, (512,))
    assert float(torch.linalg.norm(y[256:] - b) / torch.linalg.norm(b)) \
        < 0.01


def test_quadratic_convergence():
    params = {"w": torch.tensor([3.0, -2.0, 1.5, -0.5])}
    state = qm.q8_init(params)
    for _ in range(300):
        qm.q8_adamw_update(params, {"w": 2 * params["w"]}, state, lr=0.05,
                           weight_decay=0.0)
    assert float(params["w"].abs().max()) < 0.25


@pytest.mark.parametrize("nd", [False, True], ids=["flat", "nd"])
def test_tracks_fp32_adamw(nd):
    """Over 30 steps on a (noisy) quadratic, int8-moment parameters stay
    within 5% of the fp32-AdamW trajectory."""
    w0 = _normal((8, 320) if nd else (512,), 0)
    p_fp, p_q8 = {"w": w0.clone()}, {"w": w0.clone()}
    s_fp = adamw_init(p_fp)
    s_q8 = (qm.q8nd_init if nd else qm.q8_init)(p_q8)
    upd = qm.q8nd_adamw_update if nd else qm.q8_adamw_update
    for i in range(30):
        noise = 0.0 if nd else 0.01 * _normal(w0.shape, i + 1)
        adamw_update(p_fp, {"w": 2 * p_fp["w"] + noise}, s_fp, lr=0.01,
                     weight_decay=0.0)
        upd(p_q8, {"w": 2 * p_q8["w"] + noise}, s_q8, lr=0.01,
            weight_decay=0.0)
    drift = float(torch.linalg.norm(p_fp["w"] - p_q8["w"])
                  / torch.linalg.norm(p_fp["w"]))
    assert drift < 0.05, drift


@pytest.mark.parametrize("nd", [False, True], ids=["flat", "nd"])
def test_state_dtypes_are_int8(nd):
    state = (qm.q8nd_init if nd else qm.q8_init)({"w": torch.zeros(300)})
    assert state["mu"]["w"]["q"].dtype == torch.int8
    assert state["nu"]["w"]["q"].dtype == torch.int8


def test_memory_budget_math():
    """deepseek-v3-671b's optimizer + params per chip on a 256-chip pod
    drops below a 16 GB budget with int8 moments and bf16 params."""
    assert qm.moment_bytes_per_param() == ref_qm.moment_bytes_per_param()
    n, chips = 671e9, 256
    assert n * (2 + 2 + 2) / chips > 15.5e9
    assert n * (2 + qm.moment_bytes_per_param()) / chips < 11e9


def test_nd_roundtrip_keeps_the_leading_dims():
    x = _normal((4, 6, 520), 0, 0.1)
    q, s = qm.quantize_signed_nd(x)
    assert tuple(q.shape) == (4, 6, 3, 256) and tuple(s.shape) == (4, 6, 3)
    y = qm.dequantize_signed_nd(q, s, x.shape)
    assert float(torch.linalg.norm(y - x) / torch.linalg.norm(x)) < 0.01
