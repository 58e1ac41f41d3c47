"""Training with block-quantized int8 Adam moments in the port
(``train_step.init_state(moment_dtype="int8")``,
``make_train_step(q8_moments=True)``) against the reference on the CPU, and
int8-moment train states crossing between the packages through each one's
checkpoints.

danube-smoke (dense), qwen3moe-smoke (the MoE dispatch, its capacity factor
raised to E/k so no token is dropped) and vlm-smoke (cross-attention, every
``xgate`` at 0.5: the per-group 0-d gate whose moments are quantized over
its stacked leaf) on the same numpy params and ``SyntheticLMData``
batches.  One update given the same gradients holds codes (all but a few
at rounding boundaries, below) and params at 1e-6; whole steps, whose
gradients differ from the reference's by fp32 round-off, hold the losses at
the reference's own step tolerance, atol 2e-5 / rtol 2e-4
(``tests/test_substrate.py``).
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
from repro.train import checkpoint as ref_ckpt  # noqa: E402
from repro.train import train_step as ref_train_step  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import SyntheticLMData  # noqa: E402
from repro_torch.device import generator  # noqa: E402
from repro_torch.models import build, convert  # noqa: E402
from repro_torch.optim import quantized_moments as qm  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train import train_step  # noqa: E402

ARCHS = ["h2o-danube-1.8b", "qwen3-moe-235b-a22b", "llama-3.2-vision-90b"]
STEP_TOL = {"atol": 2e-5, "rtol": 2e-4}     # tests/test_substrate.py:213-215
PARAM_TOL = {"atol": 1e-6, "rtol": 1e-6}
BATCH, SEQ, STEPS = 4, 32, 5


def _configs(arch):
    """(reference config, port config): smoke, with the MoE capacity factor
    at E/k."""
    ref, port = ref_get_config(arch, smoke=True), get_config(arch, smoke=True)
    if port.n_experts:
        cf = port.n_experts / port.top_k
        ref, port = ref.replace(capacity_factor=cf), \
            port.replace(capacity_factor=cf)
    return ref, port


def _live_gates(tree):
    def fill(path, a):
        return np.full_like(a, 0.5) \
            if getattr(path[-1], "key", None) == "xgate" else a
    return jax.tree_util.tree_map_with_path(fill, tree)


@pytest.fixture(scope="module", params=ARCHS)
def case(request):
    """(arch, reference model, the reference's params as numpy)."""
    arch = request.param
    ref_model = ref_build(_configs(arch)[0])
    params = jax.jit(ref_model.init)(jax.random.PRNGKey(0))
    return arch, ref_model, _live_gates(jax.tree.map(np.asarray, params))


def _data(arch, seed=3, batch=BATCH):
    return SyntheticLMData(get_config(arch, smoke=True), batch=batch,
                           seq_len=SEQ, seed=seed)


def _port_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _ref_batch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(a) for p, a in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _assert_codes(got_opt, want_opt, exact=()):
    """fp32 leaves (scales, 0-d moments) at 1e-6; the int8 codes of the
    moments in ``exact`` equal, the others off by at most 1 in at most
    1e-4 of them (the gate of the card's run)."""
    got, want = _flat(got_opt), _flat(want_opt)
    assert got.keys() == want.keys()
    n = differ = 0
    for k, w in want.items():
        if w.dtype != np.int8:
            np.testing.assert_allclose(got[k], w, rtol=1e-6, err_msg=k)
        elif k.startswith(tuple(f"['{m}']" for m in exact)):
            np.testing.assert_array_equal(got[k], w, err_msg=k)
        else:
            d = np.abs(got[k].astype(np.int32) - w.astype(np.int32))
            assert d.max() <= 1, k
            n, differ = n + d.size, differ + int(np.count_nonzero(d))
    assert differ <= 1e-4 * n, (differ, n)


def _assert_close(got_tree, want_tree, tol):
    got, want = _flat(got_tree), _flat(want_tree)
    assert got.keys() == want.keys()
    for k, w in want.items():
        np.testing.assert_allclose(got[k], np.asarray(w, np.float32),
                                   err_msg=k, **tol)


def _numpy_tree(tree):
    return jax.tree.map(lambda t: t.numpy(), tree)


@pytest.mark.parametrize("clip", [0.0, 1.0], ids=["unclipped", "clipped"])
def test_one_update_matches_reference_given_the_same_grads(case, clip):
    """Unclipped, m's codes are equal; v's are codes of a log, and
    ``torch.log`` and XLA's may differ by an ulp, which moves a code at a
    rounding boundary by 1 (1 of vlm-smoke's 3.2e6).  Clipped, each package
    sums the global norm over its own leaves (the reference's stacked over
    the groups), so the clip factor may differ by an ulp too, and m's codes
    with it.  Codes that differ are held to the gate of the card's run: at
    most 1e-4 of them, by at most 1."""
    arch, ref_model, params = case
    model = convert.params_from_jax(params, _configs(arch)[1], device="cpu")
    state = train_step.init_state(model, moment_dtype="int8")
    loss, _ = model.loss_fn(_port_batch(_data(arch).batch_at(0)))
    loss.backward()
    grads = {k: p.grad for k, p in state["params"].items()}
    ref_grads = jax.tree.map(lambda t: jnp.asarray(t.numpy()),
                             convert.jax_layout(grads))
    ref_params, ref_opt, want = jax.jit(functools.partial(
        ref_qm.q8nd_adamw_update, lr=1e-3, max_grad_norm=clip))(
        jax.tree.map(jnp.asarray, params), ref_grads,
        jax.jit(ref_qm.q8nd_init)(jax.tree.map(jnp.asarray, params)))
    _, _, got = qm.q8nd_adamw_update(state["params"], grads, state["opt"],
                                     lr=1e-3, max_grad_norm=clip)
    np.testing.assert_allclose(float(got["grad_norm"]),
                               float(want["grad_norm"]), rtol=1e-6)
    tree = _numpy_tree(convert.state_to_jax(state))
    _assert_codes(tree["opt"], ref_opt, exact=() if clip else ("mu",))
    _assert_close(tree["params"], ref_params, PARAM_TOL)


def _train_pair(case, steps=STEPS, **kw):
    """The same steps in both packages, int8 moments; returns the losses
    (reference, port) and the final states."""
    arch, ref_model, params = case
    ref_state = ref_train_step.init_state(
        ref_model, jax.random.PRNGKey(1), moment_dtype="int8",
        compress_grads=kw.get("compress_grads", False))
    ref_state["params"] = jax.tree.map(jnp.asarray, params)
    ref_step = jax.jit(ref_train_step.make_train_step(
        ref_model, lr=1e-3, q8_moments=True, **kw))
    model = convert.params_from_jax(params, _configs(arch)[1], device="cpu")
    state = train_step.init_state(
        model, moment_dtype="int8",
        compress_grads=kw.get("compress_grads", False))
    step = train_step.make_train_step(model, lr=1e-3, q8_moments=True, **kw)
    data = _data(arch)
    want, got = [], []
    for i in range(steps):
        b = data.batch_at(i)
        b["labels"][i % BATCH, : 3 * i] = -100    # unequal valid counts
        ref_state, m = ref_step(ref_state, _ref_batch(b))
        want.append(float(m["loss"]))
        state, m = step(state, _port_batch(b))
        got.append(float(m["loss"]))
        assert np.isfinite(float(m["grad_norm"]))
    return want, got, ref_state, state


def test_train_steps_match_reference(case):
    want, got, ref_state, state = _train_pair(case)
    np.testing.assert_allclose(got, want, **STEP_TOL)
    tree = convert.state_to_jax(state)
    assert int(tree["opt"]["step"]) == STEPS
    mu = _flat(_numpy_tree(tree["opt"]["mu"]))
    assert mu.keys() == _flat(ref_state["opt"]["mu"]).keys()
    assert {a.dtype for k, a in mu.items() if k.endswith("['q']")} \
        == {np.dtype(np.int8)}


@pytest.mark.parametrize("kw", [{"microbatches": 2},
                                {"compress_grads": True}],
                         ids=["microbatches2", "compress_grads"])
def test_microbatched_and_compressed_steps_match_reference(kw):
    arch = "h2o-danube-1.8b"
    ref_model = ref_build(_configs(arch)[0])
    params = jax.tree.map(np.asarray,
                          jax.jit(ref_model.init)(jax.random.PRNGKey(0)))
    want, got, _, state = _train_pair((arch, ref_model, params), **kw)
    np.testing.assert_allclose(got, want, **STEP_TOL)
    if "compress_grads" in kw:
        assert all(t.dtype == torch.float32
                   for t in state["residuals"].values())


def test_q8_moments_smoke_training():
    """The reference's ``test_q8_moments_smoke_training`` on the port:
    minicpm-smoke, 20 steps at lr 3e-3, the loss falls by more than 0.1,
    and the moments are int8."""
    arch = "minicpm-2b"
    model = build(get_config(arch, smoke=True), "cpu")
    state = train_step.init_state(model, generator(0, "cpu"),
                                  moment_dtype="int8")
    step = train_step.make_train_step(model, lr=3e-3, q8_moments=True)
    data = _data(arch, seed=0, batch=8)
    losses = [float(step(state, _port_batch(data.batch_at(i)))[1]["loss"])
              for i in range(20)]
    assert sum(losses[-5:]) / 5 < sum(losses[:5]) / 5 - 0.1
    assert next(iter(state["opt"]["mu"].values()))["q"].dtype == torch.int8


def _port_state(arch, seed=0):
    model = build(_configs(arch)[1], "cpu")
    return model, train_step.init_state(model, generator(seed, "cpu"),
                                        moment_dtype="int8")


def _port_steps(model, state, arch, first, last):
    step = train_step.make_train_step(model, lr=1e-3, q8_moments=True)
    data = _data(arch)
    for i in range(first, last):
        step(state, _port_batch(data.batch_at(i)))
    return state


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_int8_moment_checkpoint_crosses_bit_for_bit(tmp_path, writer):
    """vlm-smoke after two int8-moment steps: a train state written by one
    package is read back by the other with every leaf's bits, the int8
    codes and scales stacked over the groups (``opt/mu/groups/b0/attn/wq/
    q``) and the 0-d ``xgate``'s moments in the reference's block layout."""
    arch = "llama-3.2-vision-90b"
    ref_model = ref_build(_configs(arch)[0])
    ref_state = ref_train_step.init_state(ref_model, jax.random.PRNGKey(0),
                                          moment_dtype="int8")
    model, state = _port_state(arch)
    path = str(tmp_path / "ckpt_000002")
    if writer == "reference":
        step = jax.jit(ref_train_step.make_train_step(ref_model, lr=1e-3,
                                                      q8_moments=True))
        data = _data(arch)
        for i in range(2):
            ref_state, _ = step(ref_state, _ref_batch(data.batch_at(i)))
        ref_ckpt.save(path, ref_state, step=2)
        tree, _ = ckpt.restore(path, convert.state_to_jax(state))
        convert.state_from_jax(tree, state)
        got, want = convert.state_to_jax(state), ref_state
    else:
        _port_steps(model, state, arch, 0, 2)
        ckpt.save(path, convert.state_to_jax(state), step=2)
        want = convert.state_to_jax(state)
        got, _ = ref_ckpt.restore(path, ref_state)
    leaves = ckpt.load_manifest(path)["leaves"]
    assert leaves["opt/mu/groups/b0/attn/wq/q"]["dtype"] == "int8"
    gate = next(k for k in leaves if k.startswith("opt/nu/")
                and k.endswith("xgate/scale"))
    assert leaves[gate]["shape"] == [1, 2]
    got, want = _flat(_numpy_tree(got) if writer == "reference" else got), \
        _flat(want if writer == "reference" else _numpy_tree(want))
    assert got.keys() == want.keys()
    for k, w in want.items():
        assert got[k].dtype == w.dtype, k
        np.testing.assert_array_equal(got[k], w, err_msg=k)
    assert int(got["['opt']['step']"]) == 2


def test_int8_moment_resume_is_bit_identical(tmp_path):
    """danube-smoke: 2 steps, a checkpoint, a fresh model and state restored
    from it, 2 more steps; every leaf equals the straight run's 4 steps."""
    arch = "h2o-danube-1.8b"
    model, state = _port_state(arch)
    _port_steps(model, state, arch, 0, 4)
    model2, state2 = _port_state(arch)
    _port_steps(model2, state2, arch, 0, 2)
    path = str(tmp_path / "ckpt_000002")
    ckpt.save(path, convert.state_to_jax(state2), step=2)
    model3, state3 = _port_state(arch, seed=7)
    tree, manifest = ckpt.restore(path, convert.state_to_jax(state3))
    convert.state_from_jax(tree, state3)
    assert manifest["step"] == 2
    _port_steps(model3, state3, arch, 2, 4)
    want = _flat(_numpy_tree(convert.state_to_jax(state)))
    got = _flat(_numpy_tree(convert.state_to_jax(state3)))
    assert got.keys() == want.keys()
    for k, w in want.items():
        np.testing.assert_array_equal(got[k], w, err_msg=k)
