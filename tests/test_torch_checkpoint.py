"""The port's checkpointing (``repro_torch.train.checkpoint``) on the CPU:
the reference's own checkpoint tests, run against the port, and
checkpoints crossing between the packages in both directions through each
package's ``launch.train.train`` (the port's train state goes through
``models/convert.state_to_jax``, so it is written under the reference's leaf
names in the reference's format)."""
import json
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.launch import train as ref_train  # noqa: E402
from repro.models import build as ref_build  # noqa: E402
from repro.train import checkpoint as ref_ckpt  # noqa: E402
from repro.train import train_step as ref_train_step  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.device import generator  # noqa: E402
from repro_torch.launch import train as port_train  # noqa: E402
from repro_torch.models import build, convert  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train import train_step  # noqa: E402

STEP_TOL = {"atol": 2e-5, "rtol": 2e-4}     # tests/test_substrate.py:213-215
RESUME_TOL = 1e-6                           # tests/test_substrate.py:263


def _tree():
    return {"a": torch.arange(10, dtype=torch.float32),
            "b": {"c": torch.linspace(-3, 3, 12).reshape(3, 4).to(
                torch.bfloat16),
                "step": torch.tensor(7, dtype=torch.int32)}}


def test_roundtrip_exact(tmp_path):
    tree = _tree()
    p = str(tmp_path / "ckpt_000001")
    assert ckpt.save(p, tree, step=1, extra={"seed": 3}) == p
    restored, manifest = ckpt.restore(p, tree)
    assert manifest["step"] == 1 and manifest["extra"] == {"seed": 3}
    assert sorted(manifest["leaves"]) == ["a", "b/c", "b/step"]
    assert manifest["leaves"]["b/c"]["dtype"] == "bfloat16"
    for got, want in ((restored["a"], tree["a"]),
                      (restored["b"]["c"], tree["b"]["c"]),
                      (restored["b"]["step"], tree["b"]["step"])):
        assert got.dtype == want.dtype and got.shape == want.shape
        assert torch.equal(got, want)
    as_fp32 = ckpt.restore(p, {"a": torch.zeros(10, dtype=torch.float64)})[0]
    assert as_fp32["a"].dtype == torch.float64


def test_corruption_detected(tmp_path):
    tree = {"a": torch.arange(8, dtype=torch.float32)}
    p = str(tmp_path / "ckpt_000001")
    ckpt.save(p, tree)
    man = ckpt.load_manifest(p)
    man["leaves"]["a"]["hash"] = "0" * 32
    with open(os.path.join(p, "manifest.json"), "w") as f:
        json.dump(man, f)
    with pytest.raises(IOError, match="corruption"):
        ckpt.restore(p, tree)
    restored, _ = ckpt.restore(p, tree, verify=False)
    assert torch.equal(restored["a"], tree["a"])


def test_shape_mismatch_and_missing_leaf_rejected(tmp_path):
    p = str(tmp_path / "ckpt_000001")
    ckpt.save(p, {"a": torch.zeros(4)})
    with pytest.raises(ValueError, match="shape mismatch"):
        ckpt.restore(p, {"a": torch.zeros(5)})
    with pytest.raises(KeyError, match="missing leaf 'b'"):
        ckpt.restore(p, {"b": torch.zeros(4)})


def test_async_save_snapshots_at_call_time(tmp_path):
    tree = {"a": torch.arange(100, dtype=torch.float32)}
    p = str(tmp_path / "ckpt_000002")
    saver = ckpt.AsyncCheckpointer()
    saver.save(p, tree, step=2)
    tree["a"].add_(1.0)                 # training goes on in place
    saver.wait()
    restored, man = ckpt.restore(p, tree)
    assert man["step"] == 2
    assert torch.equal(restored["a"], torch.arange(100, dtype=torch.float32))
    saver.save(str(tmp_path / "ckpt_000003"), {"a": object()})
    with pytest.raises(TypeError, match="numeric"):   # raised on wait()
        saver.wait()
    assert ckpt.latest_step_dir(str(tmp_path)).endswith("ckpt_000002")
    assert sorted(os.listdir(tmp_path)) == ["ckpt_000002"]


def test_latest_step_dir_and_retention(tmp_path):
    tree = {"a": torch.zeros(2)}
    assert ckpt.latest_step_dir(str(tmp_path / "none")) is None
    for s in (1, 2, 3, 4):
        ckpt.save(str(tmp_path / f"ckpt_{s:06d}"), tree, step=s,
                  keep_last=2)
    os.makedirs(tmp_path / ".ckpt_tmp_crashed")
    latest = ckpt.latest_step_dir(str(tmp_path))
    assert latest.endswith("ckpt_000004")
    remaining = sorted(d for d in os.listdir(tmp_path)
                       if d.startswith("ckpt_"))
    assert remaining == ["ckpt_000003", "ckpt_000004"]


def test_files_cross_between_packages(tmp_path):
    """The same tree written by each package reads back equal in the
    other, bf16 included, with the same manifest."""
    ml_dtypes = pytest.importorskip("ml_dtypes")
    tree = _tree()
    ckpt.save(str(tmp_path / "port"), tree, step=5)
    like = {"a": jax.ShapeDtypeStruct((10,), jnp.float32),
            "b": {"c": jax.ShapeDtypeStruct((3, 4), jnp.bfloat16),
                  "step": jax.ShapeDtypeStruct((), jnp.int32)}}
    got, man = ref_ckpt.restore(str(tmp_path / "port"), like)
    assert man["step"] == 5 and got["b"]["c"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(
        np.asarray(got["b"]["c"]).view(np.int16),
        tree["b"]["c"].view(torch.int16).numpy())
    assert int(got["b"]["step"]) == 7

    ref_tree = {"a": np.arange(10, dtype=np.float32),
                "b": {"c": np.linspace(-3, 3, 12, dtype=np.float32)
                      .reshape(3, 4).astype(ml_dtypes.bfloat16),
                      "step": np.int32(7)}}
    ref_ckpt.save(str(tmp_path / "ref"), ref_tree, step=5)
    back, _ = ckpt.restore(str(tmp_path / "ref"), tree)
    assert torch.equal(back["b"]["c"], tree["b"]["c"])
    assert torch.equal(back["a"], tree["a"])
    for name in ("port", "ref"):
        leaves = ckpt.load_manifest(str(tmp_path / name))["leaves"]
        assert {k: (v["file"], v["shape"], v["dtype"], v["hash"])
                for k, v in leaves.items()} == \
            {k: (v["file"], v["shape"], v["dtype"], v["hash"]) for k, v in
             ref_ckpt.load_manifest(str(tmp_path / "port"))[
                 "leaves"].items()}


# resume: N steps of training, a checkpoint at FIRST, the rest resumed
ARCH = "minicpm-2b"          # tied embeddings, WSD schedule
MOE_ARCH = "deepseek-v3-671b"
# whisper-smoke: the encoder's leaves (stacked over enc_layers under
# encoder/blocks) and the 0-d xgate stacked to (n_groups,); rg-smoke: the
# RG-LRU's leaves
NEW_ARCHS = ["whisper-tiny", "recurrentgemma-9b"]
TRAIN = dict(smoke=True, steps=6, batch=4, seq=32, lr=1e-3, log_every=0,
             ckpt_every=3)
FIRST = 3


def _ref_params(state):
    return jax.tree.map(np.asarray, state["params"])


def _port_params(state):
    return jax.tree.map(lambda t: t.numpy(),
                        convert.state_to_jax(state)["params"])


def _assert_params_close(got, want, tol):
    flat_want = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    flat_got = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    assert flat_got.keys() == flat_want.keys()
    for path, w in flat_want.items():
        np.testing.assert_allclose(flat_got[path], w, atol=tol, rtol=0,
                                   err_msg=jax.tree_util.keystr(path))


def _keep_first(d):
    """Drop the final checkpoint so that resuming starts at FIRST."""
    for name in os.listdir(d):
        if name != f"ckpt_{FIRST:06d}":
            shutil.rmtree(os.path.join(d, name))


def test_reference_checkpoint_resumed_by_the_port(tmp_path):
    """The reference trains to FIRST and checkpoints; the port resumes
    from it and trains on, as does the reference: the same losses, the
    same params at the reference's resume tolerance."""
    _reference_to_port(tmp_path, ARCH)


def test_reference_moe_checkpoint_resumed_by_the_port(tmp_path):
    """The same for dsv3-smoke: the MoE leaves (the fp32 router), MLA's,
    the dense prefix stacked over first_dense, the unstacked MTP head."""
    _reference_to_port(tmp_path, MOE_ARCH)


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_reference_checkpoint_of_the_new_families_resumed_by_the_port(
        tmp_path, arch):
    _reference_to_port(tmp_path, arch)


def _reference_to_port(tmp_path, arch):
    d = tmp_path / "ref"
    ref_train.train(arch, ckpt_dir=str(d), **dict(TRAIN, steps=FIRST))
    _keep_first(d)
    shutil.copytree(d, tmp_path / "port")
    want = ref_train.train(arch, ckpt_dir=str(d), **TRAIN)
    got = port_train.train(arch, ckpt_dir=str(tmp_path / "port"),
                           device="cpu", **TRAIN)
    assert len(got["losses"]) == TRAIN["steps"] - FIRST
    np.testing.assert_allclose(got["losses"], want["losses"], **STEP_TOL)
    _assert_params_close(_port_params(got["state"]),
                         _ref_params(want["state"]), RESUME_TOL)
    assert int(got["state"]["opt"]["step"]) == TRAIN["steps"]


def test_port_checkpoint_resumed_by_the_reference(tmp_path):
    """The port trains to FIRST (its own init) and checkpoints; the
    reference resumes from it and reaches the port's params."""
    _port_to_reference(tmp_path, ARCH)


def test_port_moe_checkpoint_resumed_by_the_reference(tmp_path):
    _port_to_reference(tmp_path, MOE_ARCH)


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_port_checkpoint_of_the_new_families_resumed_by_the_reference(
        tmp_path, arch):
    _port_to_reference(tmp_path, arch)


def _port_to_reference(tmp_path, arch):
    d = tmp_path / "port"
    port_train.train(arch, ckpt_dir=str(d), device="cpu",
                     **dict(TRAIN, steps=FIRST))
    _keep_first(d)
    shutil.copytree(d, tmp_path / "ref")
    got = port_train.train(arch, ckpt_dir=str(d), device="cpu", **TRAIN)
    want = ref_train.train(arch, ckpt_dir=str(tmp_path / "ref"), **TRAIN)
    np.testing.assert_allclose(got["losses"], want["losses"], **STEP_TOL)
    _assert_params_close(_port_params(got["state"]),
                         _ref_params(want["state"]), RESUME_TOL)
    # the final checkpoints hold the same leaves in the same format
    last = f"ckpt_{TRAIN['steps']:06d}"
    port_man = ckpt.load_manifest(str(d / last))["leaves"]
    ref_man = ckpt.load_manifest(str(tmp_path / "ref" / last))["leaves"]
    assert {k: (v["shape"], v["dtype"]) for k, v in port_man.items()} == \
        {k: (v["shape"], v["dtype"]) for k, v in ref_man.items()}


def test_port_resume_equals_straight_run(tmp_path):
    """The reference's test_train_resume_from_checkpoint_exact, on the
    port: stopping at FIRST and resuming gives the straight run's
    params."""
    straight = port_train.train(ARCH, device="cpu", **TRAIN)
    d = str(tmp_path / "c")
    port_train.train(ARCH, ckpt_dir=d, device="cpu",
                     **dict(TRAIN, steps=FIRST))
    _keep_first(d)
    resumed = port_train.train(ARCH, ckpt_dir=d, device="cpu", **TRAIN)
    assert resumed["losses"] == straight["losses"][FIRST:]
    _assert_params_close(_port_params(resumed["state"]),
                         _port_params(straight["state"]), RESUME_TOL)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_bf16_rglru_checkpoint_keeps_lam_fp32(tmp_path, writer):
    """rg-smoke with bf16 params: the RG-LRU's ``lam`` is an fp32 leaf in
    both packages' train states.  A state written by one package is stored
    with lam in fp32 and read back by the other with the same bits."""
    over = dict(param_dtype="bfloat16", dtype="bfloat16")
    ref_model = ref_build(ref_get_config("recurrentgemma-9b",
                                         smoke=True).replace(**over))
    ref_state = ref_train_step.init_state(ref_model, jax.random.PRNGKey(0))
    model = build(get_config("recurrentgemma-9b", smoke=True).replace(
        **over), "cpu")
    state = train_step.init_state(model, generator(0, "cpu"))
    path = str(tmp_path / "ckpt_000001")
    if writer == "reference":
        ref_ckpt.save(path, ref_state, step=1)
        tree, _ = ckpt.restore(path, convert.state_to_jax(state))
        convert.state_from_jax(tree, state)
        want = np.asarray(ref_state["params"]["groups"]["b0"]["lru"]["lam"])
        got = convert.state_to_jax(state)["params"]["groups"]["b0"]["lru"][
            "lam"].numpy()
    else:
        ckpt.save(path, convert.state_to_jax(state), step=1)
        tree, _ = ref_ckpt.restore(path, ref_state)
        want = convert.state_to_jax(state)["params"]["groups"]["b0"]["lru"][
            "lam"].numpy()
        got = np.asarray(tree["params"]["groups"]["b0"]["lru"]["lam"])
    leaves = ckpt.load_manifest(path)["leaves"]
    assert leaves["params/groups/b0/lru/lam"]["dtype"] == "float32"
    assert leaves["params/groups/b0/lru/wx"]["dtype"] == "bfloat16"
    assert got.dtype == np.float32 and want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert model.groups[0]["b0"].lru.lam.dtype == torch.float32
