"""The port's training slice (``repro_torch``: ``model.loss_fn`` and remat,
``train.train_step``, ``launch.train``, ``models/convert``'s inverse maps)
against the JAX reference on the CPU: the same numpy parameters (carried
across by ``params_from_jax``), the same ``SyntheticLMData`` batches.

danube-smoke (SWA, GQA), minicpm-smoke (tied embeddings, logit scale,
residual scale, the WSD schedule), mamba2-smoke (the SSD scan's plain
chunked path), qwen3moe-smoke (the MoE dispatch and its aux loss) and
dsv3-smoke (MLA, a shared expert, the dense prefix, the MTP loss) cover the
four ported block kinds.  Tolerances: the loss and
its gradients at 1e-5; whole train steps at the reference's own
``test_grad_accum_matches_full_batch`` tolerance, atol 2e-5 / rtol 2e-4
(``tests/test_substrate.py``).
"""
import ast
import collections
import functools
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.models import build as ref_build  # noqa: E402
from repro.optim import adamw_update as ref_adamw_update  # noqa: E402
from repro.optim import error_feedback_update as ref_ef  # noqa: E402
from repro.optim import schedule as ref_schedule  # noqa: E402
from repro.train import train_step as ref_train_step  # noqa: E402
from repro_torch import device as port_device  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import SyntheticLMData  # noqa: E402
from repro_torch.launch import train as port_train  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.optim import schedule  # noqa: E402
from repro_torch.train import train_step  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
MOE_ARCHS = ["qwen3-moe-235b-a22b", "deepseek-v3-671b"]
MEMORY_ARCHS = ["whisper-tiny", "llama-3.2-vision-90b"]
ARCHS = (["h2o-danube-1.8b", "minicpm-2b", "mamba2-1.3b"] + MOE_ARCHS
         + ["recurrentgemma-9b"] + MEMORY_ARCHS)
GRAD_TOL = {"atol": 1e-5, "rtol": 1e-5}
STEP_TOL = {"atol": 2e-5, "rtol": 2e-4}     # tests/test_substrate.py:213-215
BATCH, SEQ, STEPS = 4, 32, 5


@pytest.fixture(scope="module", params=ARCHS)
def arch_params(request):
    """(arch, the reference's smoke params as numpy)."""
    arch = request.param
    params = ref_build(ref_get_config(arch, smoke=True)).init(
        jax.random.PRNGKey(0))
    return arch, jax.tree.map(np.asarray, params)


def _data(arch, seed=3):
    return SyntheticLMData(get_config(arch, smoke=True), batch=BATCH,
                           seq_len=SEQ, seed=seed)


def _port_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _ref_batch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _close(got_tree, want_tree, tol):
    """Every leaf of the port's reference-layout tree against the
    reference's."""
    flat_want = dict(jax.tree_util.tree_flatten_with_path(want_tree)[0])
    flat_got = dict(jax.tree_util.tree_flatten_with_path(
        jax.tree.map(lambda t: np.asarray(t), got_tree))[0])
    assert flat_got.keys() == flat_want.keys()
    for path, want in flat_want.items():
        np.testing.assert_allclose(flat_got[path],
                                   np.asarray(want, np.float32),
                                   err_msg=jax.tree_util.keystr(path), **tol)


def _grads(model):
    return convert.jax_layout({k: p.grad for k, p in
                               model.named_parameters()})


@pytest.mark.parametrize("masked", ["some", "all"])
def test_loss_and_grads_match_reference(arch_params, masked):
    arch, params = arch_params
    ref_model = ref_build(ref_get_config(arch, smoke=True))
    b = _data(arch).batch_at(0)
    if masked == "some":
        b["labels"][0, :7] = -100
        b["labels"][2, 20:] = -100
    else:
        b["labels"][:] = -100
    (want, want_m), want_g = jax.value_and_grad(
        ref_model.loss_fn, has_aux=True)(params, _ref_batch(b))
    model = convert.params_from_jax(params, get_config(arch, smoke=True),
                                    device="cpu")
    train_step.init_state(model)
    loss, metrics = model.loss_fn(_port_batch(b))
    loss.backward()
    loss = loss.detach()
    assert loss.dtype == torch.float32 and loss.dim() == 0
    np.testing.assert_allclose(float(loss), float(want), **GRAD_TOL)
    assert metrics.keys() == want_m.keys()      # xent, aux and, with MTP, mtp
    for key, want_v in want_m.items():
        np.testing.assert_allclose(float(metrics[key].detach()),
                                   float(want_v), err_msg=key, **GRAD_TOL)
    if arch not in MOE_ARCHS:
        assert float(metrics["aux"]) == float(want_m["aux"]) == 0.0
    _close(_grads(model), want_g, GRAD_TOL)
    if masked == "all":
        # no label left: the loss is the aux loss alone (0 but for MoE)
        assert float(metrics["xent"].detach()) == 0.0
        assert float(loss) == float(metrics["aux"].detach())
        if arch not in MOE_ARCHS:
            assert all(not p.grad.any() for p in model.parameters())


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_steps_match_reference(arch_params, microbatches):
    arch, params = arch_params
    ref_model = ref_build(ref_get_config(arch, smoke=True))
    ref_state = ref_train_step.init_state(ref_model, jax.random.PRNGKey(1))
    ref_state["params"] = jax.tree.map(jnp.asarray, params)
    ref_step = jax.jit(ref_train_step.make_train_step(
        ref_model, lr=ref_schedule.for_arch(arch, 1e-3, 2, 2 * STEPS),
        microbatches=microbatches))
    model = convert.params_from_jax(params, get_config(arch, smoke=True),
                                    device="cpu")
    state = train_step.init_state(model)
    step = train_step.make_train_step(
        model, lr=schedule.for_arch(arch, 1e-3, 2, 2 * STEPS),
        microbatches=microbatches)
    data = _data(arch)
    for i in range(STEPS):
        b = data.batch_at(i)
        b["labels"][i % BATCH, : 3 * i] = -100    # unequal valid counts
        ref_state, want = ref_step(ref_state, _ref_batch(b))
        state, got = step(state, _port_batch(b))
        for key in ("loss", "xent", "grad_norm", "lr"):
            np.testing.assert_allclose(float(got[key]), float(want[key]),
                                       err_msg=key, **STEP_TOL)
        _close(convert.state_to_jax(state)["params"], ref_state["params"],
               STEP_TOL)
    tree = convert.state_to_jax(state)
    _close(tree["opt"], ref_state["opt"], STEP_TOL)
    assert tree["opt"]["step"].dtype == torch.int32
    assert int(tree["opt"]["step"]) == STEPS


def test_compressed_steps_match_reference_given_the_same_gradients(
        arch_params, monkeypatch):
    """int8 error feedback is discontinuous: a gradient that differs from
    the reference's by fp32 round-off can round one element to the next
    quantum, after which the runs part by ~lr on that element (the
    reference's own jitted and eager runs do: ~1e-4 after 5 steps).  So the
    losses of compressed training are held to the reference's over 5
    steps, and each step's compression and update to the reference's
    ``error_feedback_update`` + ``adamw_update`` on the gradients the port
    computed, at 1e-6."""
    arch, params = arch_params
    ref_model = ref_build(ref_get_config(arch, smoke=True))
    ref_state = ref_train_step.init_state(ref_model, jax.random.PRNGKey(1),
                                          compress_grads=True)
    ref_state["params"] = jax.tree.map(jnp.asarray, params)
    ref_step = jax.jit(ref_train_step.make_train_step(
        ref_model, lr=1e-3, compress_grads=True))
    ref_manual = ref_state
    seen = []
    real = train_step._compress

    def spy(grads, residuals):
        seen.append(convert.jax_layout(grads))
        return real(grads, residuals)
    monkeypatch.setattr(train_step, "_compress", spy)
    ref_adamw_jit = jax.jit(functools.partial(
        ref_adamw_update, lr=1e-3, eps_root=train_step.EPS_ROOT))
    model = convert.params_from_jax(params, get_config(arch, smoke=True),
                                    device="cpu")
    state = train_step.init_state(model, compress_grads=True)
    assert all(t.dtype == torch.float32 for t in state["residuals"].values())
    step = train_step.make_train_step(model, lr=1e-3, compress_grads=True)
    data = _data(arch)
    for i in range(STEPS):
        b = data.batch_at(i)
        ref_state, want = ref_step(ref_state, _ref_batch(b))
        state, got = step(state, _port_batch(b))
        np.testing.assert_allclose(float(got["loss"]), float(want["loss"]),
                                   **STEP_TOL)
        g = jax.tree.map(lambda t: jnp.asarray(t.numpy()), seen[-1])
        g, res = ref_ef(g, ref_manual["residuals"])   # eager: XLA's fusion
        # may round the quantization differently
        p, opt, _ = ref_adamw_jit(ref_manual["params"], g, ref_manual["opt"])
        ref_manual = {"params": p, "opt": opt, "residuals": res}
        tree = convert.state_to_jax(state)
        _close(tree["params"], p, {"atol": 1e-6, "rtol": 1e-6})
        _close(tree["residuals"], res, {"atol": 1e-6, "rtol": 1e-6})
    assert len(seen) == STEPS


@pytest.mark.parametrize("remat", ["block", "full"])
def test_remat_gives_the_same_steps_and_keeps_less(arch_params, remat):
    arch, params = arch_params
    cfg = get_config(arch, smoke=True)
    data = _data(arch)
    runs = {}
    for mode in ("none", remat):
        model = convert.params_from_jax(params, cfg.replace(remat=mode),
                                        device="cpu")
        state = train_step.init_state(model)
        step = train_step.make_train_step(model, lr=1e-3)
        losses = [float(step(state, _port_batch(data.batch_at(i)))[1]
                        ["loss"]) for i in range(3)]
        runs[mode] = (losses, convert.params_to_jax(model))
    assert runs["none"][0] == runs[remat][0]
    jax.tree.map(np.testing.assert_array_equal, runs[remat][1],
                 runs["none"][1])


class _CountOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n[func] += 1
        return func(*args, **(kwargs or {}))


def test_remat_policies_recompute_what_they_say():
    """Products run by danube-smoke's backward pass: "block" keeps the
    weight products' outputs (``aten.mm``) and recomputes attention's
    batched products (``aten.bmm``, two a layer); "full" recomputes both."""
    cfg = get_config("h2o-danube-1.8b", smoke=True)
    batch = _port_batch(_data("h2o-danube-1.8b").batch_at(0))
    ran = {}
    for mode in ("none", "block", "full"):
        model = build(cfg.replace(remat=mode), "cpu").init(
            port_device.generator(0, "cpu")).requires_grad_(True)
        loss, _ = model.loss_fn(batch)
        with _CountOps() as count:
            loss.backward()
        ran[mode] = (count.n[torch.ops.aten.mm.default],
                     count.n[torch.ops.aten.bmm.default])
    assert ran["block"][0] == ran["none"][0]
    assert ran["block"][1] == ran["none"][1] + 2 * cfg.n_layers
    assert ran["full"][0] > ran["block"][0]
    assert ran["full"][1] == ran["block"][1]


def test_eval_step_matches_loss_without_grads(arch_params):
    arch, params = arch_params
    model = convert.params_from_jax(params, get_config(arch, smoke=True),
                                    device="cpu")
    train_step.init_state(model)
    b = _port_batch(_data(arch).batch_at(2))
    out = train_step.make_eval_step(model)(b)
    assert out["loss"].grad_fn is None
    assert float(out["loss"]) == float(model.loss_fn(b)[0].detach())


def test_params_to_jax_inverts_params_from_jax(arch_params):
    arch, params = arch_params
    cfg = get_config(arch, smoke=True)
    back = convert.params_to_jax(convert.params_from_jax(params, cfg,
                                                         device="cpu"))
    assert jax.tree.structure(back) == jax.tree.structure(params)
    jax.tree.map(np.testing.assert_array_equal, back, params)


def test_params_to_jax_keeps_bf16_bits():
    ml_dtypes = pytest.importorskip("ml_dtypes")
    cfg = get_config("h2o-danube-1.8b", smoke=True).replace(
        param_dtype="bfloat16")
    model = build(cfg, "cpu").init(port_device.generator(0, "cpu"))
    tree = convert.params_to_jax(model)
    wq = tree["groups"]["b0"]["attn"]["wq"]
    assert wq.dtype == ml_dtypes.bfloat16 and wq.shape == (2, 64, 320)
    assert torch.equal(torch.from_numpy(wq[1].astype(np.float32)),
                       model.groups[1]["b0"].attn.wq.float())
    again = convert.params_from_jax(tree, cfg, device="cpu")
    for a, b in zip(again.parameters(), model.parameters()):
        assert torch.equal(a, b)


def test_state_roundtrips_through_the_reference_layout():
    cfg = get_config("mamba2-1.3b", smoke=True)
    model = build(cfg, "cpu").init(port_device.generator(0, "cpu"))
    state = train_step.init_state(model, compress_grads=True)
    step = train_step.make_train_step(model, lr=1e-3, compress_grads=True)
    data = _data("mamba2-1.3b")
    state, _ = step(state, _port_batch(data.batch_at(0)))
    tree = convert.state_to_jax(state)
    assert sorted(tree) == ["opt", "params", "residuals"]
    other = train_step.init_state(
        build(cfg, "cpu").init(port_device.generator(1, "cpu")),
        compress_grads=True)
    convert.state_from_jax(jax.tree.map(lambda t: t.numpy(), tree), other)
    jax.tree.map(lambda a, b: torch.testing.assert_close(a, b, rtol=0,
                                                         atol=0),
                 convert.state_to_jax(other), tree)
    assert other["opt"]["step"].dtype == torch.int32
    tree["params"]["groups"]["b0"]["ln1"] = torch.zeros(2, 3)
    with pytest.raises(ValueError, match="ln1"):
        convert.state_from_jax(tree, other)
    del tree["params"]["final_norm"]
    with pytest.raises(KeyError, match="final_norm"):
        convert.state_from_jax(tree, other)


def test_int8_moments_raise_naming_the_roadmap():
    """The two int8 entry points raised, naming the roadmap's item, until
    the int8 moments were ported (``tests/test_torch_q8_train.py`` holds
    them against the reference).  Neither raises now: the state holds
    int8 codes and a step runs."""
    cfg = get_config("h2o-danube-1.8b", smoke=True)
    model = build(cfg, "cpu")
    state = train_step.init_state(model, port_device.generator(0, "cpu"),
                                  moment_dtype="int8")
    assert {m["q"].dtype for m in state["opt"]["mu"].values()} \
        == {torch.int8}
    step = train_step.make_train_step(model, lr=1e-3, q8_moments=True)
    batch = SyntheticLMData(cfg, batch=2, seq_len=32).batch_at(0)
    state, metrics = step(state, _port_batch(batch))
    assert torch.isfinite(metrics["loss"]) and int(state["opt"]["step"]) == 1


def test_training_through_a_kernel_raises_as_the_reference_does():
    cfg = get_config("h2o-danube-1.8b", smoke=True).replace(
        use_flash_kernel=True)
    model = build(cfg, "cpu").init(port_device.generator(0, "cpu"))
    state = train_step.init_state(model)
    step = train_step.make_train_step(model, lr=1e-3)
    batch = SyntheticLMData(cfg, batch=2, seq_len=128).batch_at(0)
    with pytest.raises(RuntimeError, match="forward-only"):
        step(state, _port_batch(batch))


def test_launch_train_on_cpu_learns(capsys):
    out = port_train.train("h2o-danube-1.8b", steps=30, batch=8, seq=32,
                           lr=3e-3, log_every=10, device="cpu")
    losses = out["losses"]
    assert len(losses) == len(out["history"]) == 30
    assert out["final_loss"] == losses[-1]
    assert all(np.isfinite(h["grad_norm"]) and h["ms"] > 0
               for h in out["history"])
    assert sum(losses[-5:]) / 5 < sum(losses[:5]) / 5 - 0.25
    assert capsys.readouterr().out.count("[train] step") == 3
    port_train.main(["--arch", "minicpm-2b", "--device", "cpu", "--steps",
                     "2", "--batch", "2", "--seq", "16",
                     "--microbatches", "2", "--compress-grads"])
    assert "[train] done; final loss" in capsys.readouterr().out


def test_launch_train_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_train.train("h2o-danube-1.8b", steps=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_train.main(["--arch", "h2o-danube-1.8b", "--steps", "1"])


NEW_MODULES = ["optim/__init__.py", "optim/adamw.py", "optim/schedule.py",
               "optim/grad_compression.py", "data/__init__.py",
               "data/pipeline.py", "train/train_step.py",
               "train/checkpoint.py", "launch/train.py", "models/model.py",
               "models/convert.py"]


@pytest.mark.parametrize("rel", NEW_MODULES)
def test_training_modules_import_no_jax_and_no_reference(rel):
    tree = ast.parse((ROOT / "src" / "repro_torch" / rel).read_text())
    mods = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
            for a in n.names]
    mods += [n.module for n in ast.walk(tree)
             if isinstance(n, ast.ImportFrom) and n.level == 0]
    assert not [m for m in mods
                if m.split(".")[0] in ("jax", "jaxlib", "repro")]


def test_train_launcher_subprocess_loads_no_jax(tmp_path):
    code = ("import sys\n"
            "from repro_torch.launch import train\n"
            "train.main(['--arch', 'mamba2-1.3b', '--device', 'cpu',\n"
            "            '--steps', '2', '--batch', '2', '--seq', '16',\n"
            f"            '--ckpt-dir', {str(tmp_path)!r}])\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"},
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "[train] done" in out.stdout
    assert (tmp_path / "ckpt_000002" / "manifest.json").is_file()
