"""The port's sharded paths on gloo process groups of CPU ranks, against its
one-device paths and the JAX reference's per-rank bodies: the expert-
parallel MoE (``models.moe.moe_apply_sharded``), the head-sharded SSD
(``models.ssm.ssd_apply_shard_map``), qwen3moe-smoke and mamba2-smoke
(``ssd_shard_map=True``) on a (1 x 2) mesh from the reference's weights,
DTensor placements of the batch spec, and the elastic restore
(``train.checkpoint.restore(..., shardings=)``) from 4 ranks and from 1
onto 2.

Each mesh is one spawn of its ranks (``tests/torch_sharded_ranks.py``), with
a timeout that fails the run and kills a hung rank, and a FileStore in a
temporary directory for the rendezvous.  The reference's sharded paths
cannot run as a mesh here (its four 8-device tests fail under this JAX), so
its per-rank bodies are the oracle: ``_moe_dispatch_local`` under
``jax.vmap(..., axis_name="model")`` over the stacked expert blocks (its
psum included) and ``_ssd_local_body`` on each rank's head slice.

Tolerances: the MoE's tests/test_moe.py atol 2e-5 / rtol 2e-4, the SSD's
tests/test_perf_switches.py atol 2e-4 / rtol 2e-3, whole models 1e-3, all
in fp32.  Capacity is E/k everywhere, so no assignment drops on either
side.
"""
import functools
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_config  # noqa: E402
from repro.models import build as ref_build  # noqa: E402
from repro.models import moe as ref_moe  # noqa: E402
from repro.models import ssm as ref_ssm  # noqa: E402
from repro_torch.device import generator  # noqa: E402
from repro_torch.kernels.ssd import ref as ssd_ref  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402

import torch_sharded_ranks as ranks  # noqa: E402

MESHES = [(2, 2), (1, 2), (2, 2, 2)]      # (2, 2) first: it writes a ckpt
IDS = ["2x2", "1x2", "2x2x2"]
SPAWN_TIMEOUT = 150.0
MOE_TOL = {"atol": 2e-5, "rtol": 2e-4}            # tests/test_moe.py
SSD_TOL = {"atol": 2e-4, "rtol": 2e-3}            # tests/test_perf_switches.py
MODEL_TOL = 1e-3
B, S = 8, 32
MODELS = {"qwen3moe": ("qwen3-moe-235b-a22b", {}),
          "mamba2": ("mamba2-1.3b", {"ssd_shard_map": True})}


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float32)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    cfg = ranks.MOE_CFG
    layer = moe.MoE(cfg, "cpu")
    layer.init(generator(0, "cpu"), cfg)
    h, p, n = 8, 16, 16
    ssd = {"xh": _t(rng.standard_normal((B, S, h, p))),
           "dt": _t(rng.uniform(0.01, 0.2, (B, S, h))),
           "a_log": _t(np.log(np.linspace(1.0, 16.0, h))),
           "b": _t(rng.standard_normal((B, S, n))),
           "c": _t(rng.standard_normal((B, S, n))),
           "w": _t(rng.standard_normal((B, S, h, p)))}
    models = {}
    for name, (arch, overrides) in MODELS.items():
        rcfg = ref_config(arch, smoke=True).replace(**overrides)
        params = jax.tree.map(np.asarray,
                              ref_build(rcfg).init(jax.random.PRNGKey(0)))
        tokens = rng.integers(0, rcfg.vocab, (2, 32), dtype=np.int32)
        models[name] = {"arch": arch, "overrides": overrides,
                        "params": params, "tokens": torch.from_numpy(tokens)}
    return {"moe": {"params": layer.state_dict(),
                    "x": _t(rng.standard_normal((B, S, cfg.d_model))),
                    "w": _t(rng.standard_normal((B, S, cfg.d_model)))},
            "ssd": ssd, "models": models,
            "ckpt_tree": {"w": torch.arange(64, dtype=torch.float32)
                          .reshape(8, 8)}}


@pytest.fixture(scope="module")
def runs(tmp_path_factory, inputs):
    """{mesh shape: [rank outputs]}, the meshes spawned in MESHES' order."""
    base = tmp_path_factory.mktemp("sharded")
    path1, path4 = str(base / "ckpt_1rank"), str(base / "ckpt_4ranks")
    ckpt.save(path1, inputs["ckpt_tree"], step=1)
    out = {}
    for shape in MESHES:
        case_dir = base / "x".join(map(str, shape))
        case_dir.mkdir()
        case = {"moe": inputs["moe"], "ssd": inputs["ssd"]}
        if shape == (2, 2):
            case["write_ckpt"] = {"tree": inputs["ckpt_tree"],
                                  "path": path4}
        if shape == (1, 2):
            case["models"] = inputs["models"]
            case["restore"] = {"paths": {"1rank": path1, "4ranks": path4},
                               "like": inputs["ckpt_tree"]}
        torch.save(case, case_dir / "inputs.pt")
        out[shape] = ranks.spawn(int(np.prod(shape)), str(case_dir), shape,
                                 timeout=SPAWN_TIMEOUT)
    return out


def _shape(mesh_shape):
    names = ("pod", "data", "model")[-len(mesh_shape):]
    return dict(zip(names, mesh_shape))


def _by_dp(outs, shape, model=0):
    """The ranks of model coordinate ``model``, in DP order."""
    sel = [o for o in outs if o["coords"]["model"] == model]
    return sorted(sel, key=lambda o: ranks.dp_index(o["coords"], shape))


def _one_device_moe(inputs):
    cfg = ranks.MOE_CFG
    layer = moe.MoE(cfg, "cpu")
    layer.load_state_dict(inputs["moe"]["params"])
    for p in layer.parameters():
        p.requires_grad_(True)
    x = inputs["moe"]["x"].clone().requires_grad_(True)
    out, aux = moe.moe_apply(layer, x, cfg)
    ((out * inputs["moe"]["w"]).sum() + aux).backward()
    return out.detach(), aux.detach(), x.grad, \
        {n: p.grad for n, p in layer.named_parameters()}


@pytest.mark.parametrize("mesh", MESHES, ids=IDS)
def test_moe_sharded_forward_matches_one_device(runs, inputs, mesh):
    shape = _shape(mesh)
    outs = runs[mesh]
    want, want_aux, _, _ = _one_device_moe(inputs)
    got = torch.cat([o["moe"]["out"] for o in _by_dp(outs, shape)])
    torch.testing.assert_close(got, want, **MOE_TOL)
    for o in outs:      # every rank of a model group holds the same rows
        same = _by_dp(outs, shape)[ranks.dp_index(o["coords"], shape)]
        torch.testing.assert_close(o["moe"]["out"], same["moe"]["out"])
        torch.testing.assert_close(o["moe"]["aux"], want_aux, **MOE_TOL)


@pytest.mark.parametrize("mesh", MESHES, ids=IDS)
def test_moe_sharded_grads_match_one_device(runs, inputs, mesh):
    """Each rank's gradients cover its rows: their sum over the DP ranks
    is the one-device gradient; the expert blocks are gathered over the
    model ranks."""
    shape = _shape(mesh)
    outs = runs[mesh]
    _, _, want_x, want = _one_device_moe(inputs)
    got_x = torch.cat([o["moe"]["x_grad"] for o in _by_dp(outs, shape)])
    torch.testing.assert_close(got_x, want_x, **MOE_TOL)
    for name, w in want.items():
        per_model = []
        for m in range(shape["model"]):
            per_model.append(sum(o["moe"]["grads"][name]
                                 for o in _by_dp(outs, shape, m)))
        if name.rsplit(".", 1)[-1] in moe.shd.EXPERT:
            got = torch.cat(per_model)
        else:
            got = per_model[0]
            for g in per_model[1:]:
                torch.testing.assert_close(g, got)
        torch.testing.assert_close(got, w, **MOE_TOL, msg=name)


@pytest.mark.parametrize("mesh", MESHES, ids=IDS)
def test_moe_body_matches_reference_body(runs, mesh):
    """The sum of the model ranks' ``_moe_dispatch_local`` is the
    reference's body (its psum) run under jax.vmap over the same expert
    blocks."""
    shape = _shape(mesh)
    outs = runs[mesh]
    for dp in range(len(_by_dp(outs, shape))):
        group = [_by_dp(outs, shape, m)[dp]
                 for m in range(shape["model"])]
        body = group[0]["moe"]["body"]
        blocks = {n: np.stack([o["moe"]["body"]["blocks"][n].numpy()
                               for o in group])
                  for n in ("we_g", "we_u", "we_d")}
        ref_body = functools.partial(
            ref_moe._moe_dispatch_local, cap_local=body["cap"],
            model_axis="model", dt=jnp.float32)
        want = jax.jit(jax.vmap(ref_body, in_axes=(None, None, None, 0, 0, 0),
                                axis_name="model"))(
            body["xt"].numpy(), body["gates"].numpy(),
            body["ids"].numpy(), blocks["we_g"], blocks["we_u"],
            blocks["we_d"])
        got = sum(o["moe"]["body"]["partial"] for o in group)
        for m in range(shape["model"]):
            np.testing.assert_allclose(got.numpy(), np.asarray(want[m]),
                                       **MOE_TOL)


def _one_device_ssd(inputs):
    leaves = {k: inputs["ssd"][k].clone().requires_grad_(True)
              for k in ("xh", "dt", "a_log", "b", "c")}
    y = ssd_ref.ssd_chunked(leaves["xh"], leaves["dt"], leaves["a_log"],
                            leaves["b"], leaves["c"], chunk=ranks.SSD_CHUNK)
    (y * inputs["ssd"]["w"]).sum().backward()
    return y.detach(), {k: v.grad for k, v in leaves.items()}


@pytest.mark.parametrize("mesh", MESHES, ids=IDS)
def test_ssd_shard_map_matches_one_device(runs, inputs, mesh):
    shape = _shape(mesh)
    outs = runs[mesh]
    want, want_grads = _one_device_ssd(inputs)
    for m in range(shape["model"]):
        got = torch.cat([o["ssd"]["y"] for o in _by_dp(outs, shape, m)])
        torch.testing.assert_close(got, want, **SSD_TOL)
    for name, w in want_grads.items():
        for m in range(shape["model"]):
            parts = [o["ssd"]["grads"][name] for o in _by_dp(outs, shape, m)]
            got = sum(parts) if name == "a_log" else torch.cat(parts)
            torch.testing.assert_close(got, w, **SSD_TOL, msg=name)


@pytest.mark.parametrize("tile", ["None", "torch.bfloat16"])
@pytest.mark.parametrize("mesh", MESHES, ids=IDS)
def test_ssd_body_matches_reference_body(runs, mesh, tile):
    """Each rank's ``_ssd_local_body`` on its head slice against the
    reference's on the same slice, with fp32 and bf16 tiles (both round
    the products' operands and sum in fp32)."""
    ref_body = jax.jit(functools.partial(
        ref_ssm._ssd_local_body, chunk=ranks.SSD_CHUNK, unroll_heads=False,
        tile_dtype=None if tile == "None" else jnp.bfloat16))
    for o in runs[mesh]:
        body = o["ssd"]["body"]
        want = ref_body(*(t.numpy() for t in body["inputs"]))
        np.testing.assert_allclose(body[tile].numpy(), np.asarray(want),
                                   **SSD_TOL)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_smoke_model_on_two_ranks_matches_reference(runs, inputs, name):
    """qwen3moe-smoke (its experts 4 a rank, capacity E/k) and mamba2-smoke
    with ssd_shard_map (its 8 heads 4 a rank) on a (1 x 2) mesh, from the
    reference's numpy weights, against the reference's one-device
    forward."""
    case = inputs["models"][name]
    rcfg = ref_config(case["arch"], smoke=True).replace(**case["overrides"])
    if rcfg.n_experts:
        assert rcfg.capacity_factor == rcfg.n_experts / rcfg.top_k
    want, want_aux = ref_build(rcfg).forward(
        case["params"], jnp.asarray(case["tokens"].numpy()))
    for o in runs[(1, 2)]:
        np.testing.assert_allclose(o[name]["logits"].numpy(),
                                   np.asarray(want), atol=MODEL_TOL,
                                   rtol=MODEL_TOL)
        np.testing.assert_allclose(float(o[name]["aux"]), float(want_aux),
                                   atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("mesh", MESHES, ids=IDS)
def test_batch_spec_places_rows_over_the_dp_axes(runs, inputs, mesh):
    """``batch_specs_tree`` under use_mesh -> DTensor placements: on the
    3-axis mesh the batch dim is split over ("pod", "data"), pod major, as
    the reference's P(("pod", "data"), ...) splits it."""
    shape = _shape(mesh)
    for o in runs[mesh]:
        got = o["batch"]
        n_dp = shape.get("pod", 1) * shape["data"]
        want_spec = (("pod", "data") if "pod" in shape else "data", None,
                     None)
        assert tuple(got["spec"]) == want_spec
        want = inputs["moe"]["x"].chunk(n_dp)[ranks.dp_index(o["coords"],
                                                             shape)]
        torch.testing.assert_close(got["local"], want, rtol=0, atol=0)


@pytest.mark.parametrize("mesh", MESHES, ids=IDS)
def test_constrain_redistributes_a_dtensor(runs, inputs, mesh):
    """constrain() to no mesh axis gathers the batch back whole on every
    rank (a plain tensor passes through, as outside a mesh)."""
    for o in runs[mesh]:
        got = o["batch"]
        assert set(got["constrained_placements"]) == {"Replicate"}
        torch.testing.assert_close(got["constrained"], inputs["moe"]["x"],
                                   rtol=0, atol=0)


@pytest.mark.parametrize("mesh", MESHES, ids=IDS)
def test_param_shardings_place_and_gather_back(runs, inputs, mesh):
    """param_shardings under DEFAULT_RULES (experts over "model", their d
    over "data"; the router's experts over "model"): each rank's block is
    the slice its spec names, and full_tensor() gives the parameter back."""
    shape = _shape(mesh)
    params = inputs["moe"]["params"]
    for o in runs[mesh]:
        got = o["params"]
        assert got["we_g"]["spec"] == ("model", "data", None)
        assert got["w_router"]["spec"] == ("data", "model")
        for name, g in got.items():
            torch.testing.assert_close(g["whole"], params[name], rtol=0,
                                       atol=0)
            want = params[name]
            for d, axes in enumerate(g["spec"]):
                for a in (axes,) if isinstance(axes, str) else (axes or ()):
                    want = want.chunk(shape[a], dim=d)[o["coords"][a]]
            torch.testing.assert_close(g["local"], want, rtol=0, atol=0)


@pytest.mark.parametrize("mesh", MESHES, ids=IDS)
def test_production_mesh_names_the_world_it_needs(runs, mesh):
    for o in runs[mesh]:
        assert "need a world of 256 ranks" in o["production_mesh_error"]


def test_sharded_moe_refuses_experts_not_placed(runs):
    """Under a mesh the experts must be placed over "model" (each rank its
    block); a whole layer raises rather than running another path."""
    for o in runs[(1, 2)]:
        assert "must be DTensors" in o["whole_experts_error"]


@pytest.mark.parametrize("src", ["1rank", "4ranks"])
def test_elastic_restore_onto_two_ranks(runs, inputs, src):
    """A checkpoint written by one process (from 1 rank, or gathered from 4
    and written by rank 0) restores onto a (1 x 2) mesh as DTensors split
    over "model", as the reference's test_elastic_checkpoint_reshard_8_to_4
    restores onto 4 devices."""
    w = inputs["ckpt_tree"]["w"]
    for o in runs[(1, 2)]:
        got = o["restore"][src]
        assert got["step"] == 1
        assert got["placements"] == [("Replicate", None), ("Shard", 0)]
        m = o["coords"]["model"]
        torch.testing.assert_close(got["local"], w.chunk(2)[m], rtol=0,
                                   atol=0)
        torch.testing.assert_close(got["full"], w, rtol=0, atol=0)


def test_spawned_ranks_fail_the_run_on_a_hang(tmp_path):
    """A rank that never reaches its collective partner fails the spawn
    within its timeout rather than hanging the suite."""
    torch.save({"hang": True}, tmp_path / "inputs.pt")
    with pytest.raises(AssertionError, match="still running|failed"):
        ranks.spawn(2, str(tmp_path), (1, 2), timeout=6.0)
    assert not os.path.exists(tmp_path / "rank0.pt")
