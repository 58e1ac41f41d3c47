"""The port's optimizer, schedules, gradient compression and data pipeline
(``repro_torch.optim``, ``repro_torch.data``) against the JAX reference on
the CPU, on the same numpy inputs."""
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import optim as ref_optim  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.data import SyntheticLMData as RefData  # noqa: E402
from repro.optim import grad_compression as ref_gc  # noqa: E402
from repro.optim import schedule as ref_schedule  # noqa: E402
from repro_torch import optim  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import SyntheticLMData  # noqa: E402
from repro_torch.optim import grad_compression, schedule  # noqa: E402

SHAPES = {"w": (8, 12), "b": (12,), "e": (5, 3, 4)}


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {k: (rng.standard_normal(s) * scale).astype(np.float32)
            for k, s in SHAPES.items()}


SCHEDULES = [
    ("linear", dict(peak_lr=3e-4, warmup=5, total=40)),
    ("cosine", dict(peak_lr=3e-4, warmup=5, total=40)),
    ("cosine", dict(peak_lr=1e-2, warmup=0, total=7, min_ratio=0.3)),
    ("wsd", dict(peak_lr=3e-4, warmup=5, total=40)),
    ("wsd", dict(peak_lr=1.0, warmup=3, total=25, decay_fraction=0.4,
                 min_ratio=1e-8)),
]


@pytest.mark.parametrize("kind,kw", SCHEDULES,
                         ids=[f"{k}{i}" for i, (k, _) in
                              enumerate(SCHEDULES)])
def test_schedules_match_reference(kind, kw):
    ref = getattr(ref_schedule, f"{kind}_schedule")(**kw)
    port = getattr(schedule, f"{kind}_schedule")(**kw)
    steps = range(0, kw["total"] + 3)
    want = np.array([float(ref(s)) for s in steps], np.float32)
    got = np.array([float(port(s)) for s in steps], np.float32)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    as_tensor = [port(torch.tensor(s, dtype=torch.int32)) for s in steps]
    assert all(t.dtype == torch.float32 for t in as_tensor)
    np.testing.assert_array_equal([float(t) for t in as_tensor], got)


@pytest.mark.parametrize("arch", ["minicpm-2b", "h2o-danube-1.8b"])
def test_for_arch_picks_the_reference_schedule(arch):
    ref = ref_schedule.for_arch(arch, 1e-3, 5, 50)
    port = schedule.for_arch(arch, 1e-3, 5, 50)
    np.testing.assert_allclose([float(port(s)) for s in range(53)],
                               [float(ref(s)) for s in range(53)],
                               rtol=1e-6, atol=0)


ADAMW_CASES = [
    dict(lr=1e-2),
    dict(lr=1e-2, eps_root=1e-8),
    dict(lr=3e-3, max_grad_norm=0.0, weight_decay=0.0),
    dict(lr="cosine", eps_root=1e-8, max_grad_norm=0.5),
]


def _lr(spec, pkg):
    if spec == "cosine":
        return pkg.cosine_schedule(1e-2, 2, 6)
    return spec


@pytest.mark.parametrize("case", ADAMW_CASES,
                         ids=["plain", "eps_root", "no_clip", "callable_lr"])
def test_adamw_fp32_matches_reference_over_three_steps(case):
    p0 = _tree(0)
    ref_params = {k: jnp.asarray(v) for k, v in p0.items()}
    ref_state = ref_optim.adamw_init(ref_params)
    params = {k: torch.tensor(v) for k, v in p0.items()}
    state = optim.adamw_init(params)
    assert state["step"].dtype == torch.int32
    kw = dict(case)
    for step in range(3):
        g = _tree(10 + step, scale=0.5 + step)
        ref_params, ref_state, ref_m = ref_optim.adamw_update(
            ref_params, {k: jnp.asarray(v) for k, v in g.items()},
            ref_state, **dict(kw, lr=_lr(kw["lr"], ref_schedule)))
        out, state, m = optim.adamw_update(
            params, {k: torch.tensor(v) for k, v in g.items()}, state,
            **dict(kw, lr=_lr(kw["lr"], schedule)))
        assert out is params
        for k in SHAPES:
            np.testing.assert_allclose(params[k].numpy(),
                                       np.asarray(ref_params[k]),
                                       rtol=1e-6, atol=1e-6)
            np.testing.assert_allclose(state["mu"][k].numpy(),
                                       np.asarray(ref_state["mu"][k]),
                                       rtol=1e-6, atol=1e-6)
            np.testing.assert_allclose(state["nu"][k].numpy(),
                                       np.asarray(ref_state["nu"][k]),
                                       rtol=1e-6, atol=1e-7)
        assert int(state["step"]) == int(ref_state["step"]) == step + 1
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(ref_m["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(m["lr"]), float(ref_m["lr"]),
                                   rtol=1e-6)


def _bf16_ulp(x):
    """One bf16 unit in the last place of each |x| (the smallest normal's
    where x is 0)."""
    _, e = np.frexp(np.maximum(np.abs(x), np.float32(2.0 ** -126)))
    return np.ldexp(np.float32(1.0), e - 8)


@pytest.mark.parametrize("moment_dtype", [None, "float32"],
                         ids=["bf16_moments", "fp32_moments"])
def test_adamw_bf16_params_within_one_ulp_of_reference(moment_dtype):
    p0 = _tree(1)
    ref_params = {k: jnp.asarray(v, jnp.bfloat16) for k, v in p0.items()}
    ref_state = ref_optim.adamw_init(ref_params, moment_dtype=moment_dtype)
    params = {k: torch.tensor(v).to(torch.bfloat16) for k, v in p0.items()}
    state = optim.adamw_init(params, moment_dtype=moment_dtype)
    want_md = torch.bfloat16 if moment_dtype is None else torch.float32
    assert state["mu"]["w"].dtype == want_md
    for step in range(3):
        g = _tree(20 + step)
        ref_params, ref_state, _ = ref_optim.adamw_update(
            ref_params, {k: jnp.asarray(v, jnp.bfloat16)
                         for k, v in g.items()}, ref_state, lr=1e-2,
            eps_root=1e-8)
        optim.adamw_update(
            params, {k: torch.tensor(v).to(torch.bfloat16)
                     for k, v in g.items()}, state, lr=1e-2, eps_root=1e-8)
        for k in SHAPES:
            assert params[k].dtype == torch.bfloat16
            for got, want in ((params[k], ref_params[k]),
                              (state["mu"][k], ref_state["mu"][k]),
                              (state["nu"][k], ref_state["nu"][k])):
                got = got.float().numpy()
                want = np.asarray(want.astype(jnp.float32))
                bound = _bf16_ulp(np.maximum(np.abs(got), np.abs(want)))
                assert np.all(np.abs(got - want) <= bound), k


def test_clip_by_global_norm_matches_reference():
    g = _tree(3, scale=4.0)
    want, want_norm = ref_optim.clip_by_global_norm(
        {k: jnp.asarray(v) for k, v in g.items()}, 1.0)
    got, norm = optim.clip_by_global_norm(
        {k: torch.tensor(v) for k, v in g.items()}, 1.0)
    np.testing.assert_allclose(float(norm), float(want_norm), rtol=1e-6)
    for k in SHAPES:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-7)
    small, _ = optim.clip_by_global_norm({"a": torch.full((4,), 0.1)}, 1.0)
    assert torch.equal(small["a"], torch.full((4,), 0.1))


def test_compress_int8_rounds_half_to_even_as_reference():
    g = np.array([127.0, 0.5, 1.5, 2.5, -2.5, -0.5, 3.49, -127.0],
                 np.float32)
    q, s = grad_compression.compress_int8(torch.tensor(g))
    rq, rs = ref_gc.compress_int8(jnp.asarray(g))
    assert q.dtype == torch.int8 and float(s) == float(rs) == 1.0
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    np.testing.assert_array_equal(q.numpy()[1:5], [0, 2, 2, -2])
    np.testing.assert_array_equal(
        grad_compression.decompress_int8(q, s).numpy(),
        np.asarray(ref_gc.decompress_int8(rq, rs)))


def test_error_feedback_update_is_bit_for_bit():
    grads = _tree(4, scale=1e-3)
    res = _tree(5, scale=1e-5)
    ref_res = {k: jnp.asarray(v) for k, v in res.items()}
    port_res = {k: torch.tensor(v) for k, v in res.items()}
    zeros = grad_compression.init_residuals(
        {k: torch.tensor(v) for k, v in grads.items()})
    assert all(t.dtype == torch.float32 and not t.any()
               for t in zeros.values())
    for step in range(4):
        g = {k: v * (step + 1) for k, v in grads.items()}
        ref_deq, ref_res = ref_gc.error_feedback_update(
            {k: jnp.asarray(v) for k, v in g.items()}, ref_res)
        deq, port_res = optim.error_feedback_update(
            {k: torch.tensor(v) for k, v in g.items()}, port_res)
        for k in SHAPES:
            np.testing.assert_array_equal(deq[k].numpy(),
                                          np.asarray(ref_deq[k]))
            np.testing.assert_array_equal(port_res[k].numpy(),
                                          np.asarray(ref_res[k]))


@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "minicpm-2b",
                                  "mamba2-1.3b", "whisper-tiny",
                                  "llama-3.2-vision-90b"])
@pytest.mark.parametrize("seed", [0, 7])
def test_batches_equal_reference_bit_for_bit(arch, seed):
    ref = RefData(ref_get_config(arch, smoke=True), batch=3, seq_len=24,
                  seed=seed)
    port = SyntheticLMData(get_config(arch, smoke=True), batch=3,
                           seq_len=24, seed=seed)
    for step in (0, 1, 5, 1000):
        want, got = ref.batch_at(step), port.batch_at(step)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


def test_iter_batches_prefetches_from_the_start_step():
    data = SyntheticLMData(get_config("h2o-danube-1.8b", smoke=True),
                           batch=2, seq_len=8, seed=1)
    threads = threading.active_count()
    it = data.iter_batches(start_step=5)
    for step in (5, 6, 7):
        got = next(it)
        want = data.batch_at(step)
        np.testing.assert_array_equal(got["tokens"], want["tokens"])
        np.testing.assert_array_equal(got["labels"], want["labels"])
    assert threading.active_count() == threads + 1
    it.close()
