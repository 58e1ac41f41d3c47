"""The port's sharding rules (``repro_torch/distributed/sharding.py``) against
the reference's (``repro/distributed/sharding.py``) leaf by leaf, with no
process group: every parameter of all ten configs at full width (the
reference's params from ``jax.eval_shape`` of its init, the port's model
built on the meta device), on the (16, 16), (2, 16, 16), (4, 2) and
(2, 2, 2) meshes given as shape dicts, under DEFAULT_RULES and under the
dry run's overrides (``embed`` on "model", ``batch`` off); the
divisibility guard; the int8-moment leaves ``q`` / ``scale``;
``batch_specs_tree`` on ``make_batch_specs``; ``cache_specs_tree`` on each
family's decode cache; ``make_batch_specs`` itself; ``mesh_spec_of``.

The reference reads a mesh's ``axis_names`` and ``shape`` only (and enters
it as a context), so a stand-in of that shape takes a real mesh's place on
its side.  The port keeps no stacked leading dim: its spec of a stacked
leaf's slice is the reference's spec without the leading None.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import ARCH_IDS as REF_ARCH_IDS  # noqa: E402
from repro.configs import get_config as ref_config  # noqa: E402
from repro.data import make_batch_specs as ref_batch_specs  # noqa: E402
from repro.distributed import sharding as ref_shd  # noqa: E402
from repro.models import build as ref_build  # noqa: E402
from repro.train.train_step import init_state as ref_init_state  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.data import make_batch_specs  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.launch.mesh import mesh_spec_of  # noqa: E402
from repro_torch.models import LanguageModel  # noqa: E402
from repro_torch.models.convert import _is_stacked_leaf, split_stacked  # noqa: E402,E501
from repro_torch.train.train_step import init_state  # noqa: E402

MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16},
          "4x2": {"data": 4, "model": 2},
          "2x2x2": {"pod": 2, "data": 2, "model": 2}}
RULES = {"default": {}, "dryrun": {"embed": "model", "batch": None}}


class _MeshShape:
    """What the reference's rules read of a jax Mesh."""

    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, f"{prefix}{k}/")
    elif isinstance(tree, list):          # the port's per-group caches
        for i, v in enumerate(tree):
            yield from _paths(v, f"{prefix}{i}/")
    else:
        yield prefix.rstrip("/"), tree


def _ref_specs(fn, tree, mesh, rules):
    with ref_shd.use_mesh(_MeshShape(mesh), rules):
        specs = fn(tree)
    return {p: tuple(s) for p, s in _paths(specs)}


def _port_specs(fn, tree, mesh, rules):
    with shd.use_mesh(mesh, rules):
        return fn(tree)


@functools.lru_cache(maxsize=None)
def _ref_params(arch):
    model = ref_build(ref_config(arch))
    return jax.eval_shape(model.init, jax.random.PRNGKey(0))


def _ref_path(port_name):
    """(the reference's "/" path of a port parameter, whether the port's
    leaf is a slice of a stacked one).  A leaf the port holds stacked (a
    per-group 0-d parameter's int8 moments) is named by the reference's
    path already."""
    if _is_stacked_leaf(port_name.removesuffix(".q").removesuffix(".scale")):
        return port_name.replace(".", "/"), False
    stacked = split_stacked(port_name)
    name = stacked[0] if stacked else port_name
    return name.replace(".", "/"), stacked is not None


def _hold(port, ref):
    """Every port leaf's spec against the reference's; every reference leaf
    covered."""
    seen = set()
    for name, spec in port.items():
        path, stacked = _ref_path(name)
        want = ref[path]
        assert (tuple(want[1:]) if stacked else tuple(want)) == spec, \
            (name, spec, want)
        if stacked:
            assert want[0] is None, (name, want)
        seen.add(path)
    assert seen == set(ref), sorted(set(ref) ^ seen)


def test_every_arch_is_covered():
    assert sorted(ARCH_IDS) == sorted(REF_ARCH_IDS) and len(ARCH_IDS) == 10


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_match_reference_leaf_by_leaf(arch, mesh):
    shape = MESHES[mesh]
    model = LanguageModel(get_config(arch), device="meta")
    for rules in RULES.values():
        ref = _ref_specs(ref_shd.param_specs, _ref_params(arch), shape,
                         rules)
        port = _port_specs(shd.param_specs, model, shape, rules)
        _hold(port, ref)


def test_divisibility_guard_minicpm_vocab():
    """minicpm-2b's 122,753 vocab splits over no axis of size 2 or 16: the
    embedding keeps only its FSDP dim (2304 = 144 x 16)."""
    model = LanguageModel(get_config("minicpm-2b"), device="meta")
    for shape in MESHES.values():
        specs = shd.param_specs(model, mesh=shape)
        assert specs["tok_embed"] == (None, "data")
    assert "lm_head" not in specs          # tied: the head is the embedding
    specs = shd.param_specs({"tok_embed": torch.empty(127, 64)},
                            mesh={"data": 4, "model": 2})
    assert specs["tok_embed"] == (None, "data")     # the reference's case


@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "qwen3-moe-235b-a22b",
                                  "llama-3.2-vision-90b", "mamba2-1.3b"])
def test_int8_moment_leaves_match_reference(arch):
    """An int8-moment state's ``q`` (..., blocks, 256) and ``scale``
    (..., blocks[, 2]) leaves take their weight's spec on the leading dims,
    at the smoke size (every leaf kind, the per-group 0-d ``xgate``'s
    stacked moments included)."""
    ref_state = jax.eval_shape(
        lambda k: ref_init_state(ref_build(ref_config(arch, smoke=True)), k,
                                 moment_dtype="int8"),
        jax.random.PRNGKey(0))
    model = LanguageModel(get_config(arch, smoke=True), device="meta")
    state = init_state(model, moment_dtype="int8")
    for mesh in ({"data": 4, "model": 2}, {"pod": 2, "data": 2,
                                           "model": 2}):
        for part in ("mu", "nu"):
            named = {f"{n}.{k}": t for n, m in state["opt"][part].items()
                     for k, t in m.items()}
            assert any(n.endswith(".scale") for n in named)
            ref = _ref_specs(ref_shd.param_specs, ref_state["opt"][part],
                             mesh, {})
            port = _port_specs(shd.param_specs, named, mesh, {})
            _hold(port, ref)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_batch_specs_match_reference(arch, mesh):
    """make_batch_specs' shapes and dtypes, and batch_specs_tree over them
    (batch 4: split over 4 DP ranks, guarded off over 16 and 32)."""
    shape = MESHES[mesh]
    cfg = get_config(arch)
    for batch, seq in ((4, 64), (32, 1536)):
        ref = ref_batch_specs(ref_config(arch), batch=batch, seq_len=seq)
        port = make_batch_specs(cfg, batch=batch, seq_len=seq)
        assert sorted(port) == sorted(ref)
        for k, v in port.items():
            assert v.device.type == "meta"
            assert tuple(v.shape) == tuple(ref[k].shape), k
            assert str(v.dtype).removeprefix("torch.") == str(ref[k].dtype)
        for rules in RULES.values():
            want = _ref_specs(ref_shd.batch_specs_tree, ref, shape, rules)
            got = dict(_paths(_port_specs(shd.batch_specs_tree, port, shape,
                                          rules)))
            assert got == want


@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "mamba2-1.3b",
                                  "deepseek-v3-671b", "recurrentgemma-9b",
                                  "whisper-tiny", "llama3-405b"])
def test_cache_specs_match_reference(arch):
    """Each family's decode cache (KV, SSM conv/state, MLA latent and rope
    key with the dense prefix's KV, RG-LRU h/conv beside local KV, the
    decoder's KV) at full width: the port's per-group leaves against the
    reference's stacked ones."""
    ref_cache = ref_build(ref_config(arch)).init_cache(4, 64, abstract=True)
    port_cache = LanguageModel(get_config(arch),
                               device="meta").init_cache(4, 64)
    for shape in MESHES.values():
        for rules in RULES.values():
            ref = _ref_specs(ref_shd.cache_specs_tree, ref_cache, shape,
                             rules)
            port = dict(_paths(_port_specs(shd.cache_specs_tree,
                                           port_cache, shape, rules)))
            seen = set()
            for path, spec in port.items():
                parts = path.split("/")
                ref_path = "/".join(parts[:1] + parts[2:])
                assert ref[ref_path] == (None, *spec), (path, spec)
                seen.add(ref_path)
            assert seen == set(ref)


def test_mesh_spec_of_and_axis_size():
    spec = mesh_spec_of({"pod": 2, "data": 16, "model": 16})
    assert spec.axes == (("pod", 2), ("data", 16), ("model", 16))
    assert spec.num_devices == 512 and spec.size("model") == 16
    assert shd.axis_size("model") == 1           # outside use_mesh
    with shd.use_mesh({"data": 4, "model": 2}, {}):
        assert shd.axis_size("model") == 2 and shd.axis_size("pod") == 1
        assert shd.current_rules()["batch"] == ("data",)
        assert shd.dp_axes_of(shd.current_rules()) == ("data",)
    x = torch.ones(4, 4)
    assert shd.constrain(x, ("batch", None)) is x


def test_placements_need_the_mesh_order():
    """A dim over two axes shards in the mesh's order, as DTensor does;
    the other order, or one axis on two dims, is refused."""
    mesh = type("M", (), {"mesh_dim_names": ("pod", "data", "model")})()
    got = shd.placements((("pod", "data"), None, "model"), mesh)
    assert [repr(p) for p in got] == [repr(shd.Shard(0)), repr(shd.Shard(0)),
                                      repr(shd.Shard(2))]
    with pytest.raises(ValueError, match="order"):
        shd.placements((("data", "pod"), None), mesh)
    with pytest.raises(ValueError, match="two dims"):
        shd.placements(("model", "model"), mesh)


def test_leaf_spec_rules_by_name():
    """The reference's own test_param_specs_follow_naming, on the port."""
    mesh = {"data": 4, "model": 2}
    named = {"tok_embed": np.zeros((128, 64)), "lm_head": np.zeros((64, 128)),
             "groups.0.b0.attn.wq": np.zeros((64, 64)),
             "groups.0.b0.attn.wo": np.zeros((64, 64)),
             "norm": np.zeros((64,))}
    specs = shd.param_specs(named, mesh=mesh)
    assert specs["tok_embed"] == ("model", "data")
    assert specs["lm_head"] == ("data", "model")
    assert specs["groups.0.b0.attn.wq"] == ("data", "model")
    assert specs["groups.0.b0.attn.wo"] == ("model", "data")
    assert specs["norm"] == (None,)


def test_remat_recompute_reenters_the_mesh():
    """A checkpointed block's recompute runs in the autograd engine's
    thread (on the card), which does not see use_mesh()'s context: the
    model's context_fn re-enters the mesh there."""
    import threading
    from repro_torch.models import model as model_mod
    assert model_mod._remat_context("full") is \
        model_mod._REMAT_CONTEXTS["full"]            # outside a mesh
    seen = {}
    with shd.use_mesh({"data": 1, "model": 2}, {}):
        context_fn = model_mod._remat_context("block")

    def recompute():
        _, recompute_ctx = context_fn()
        with recompute_ctx:
            seen["model"] = shd.axis_size("model")
        seen["after"] = shd.active_mesh()
    t = threading.Thread(target=recompute)
    t.start()
    t.join()
    assert seen == {"model": 2, "after": None}
