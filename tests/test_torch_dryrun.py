"""The port's dry run (``repro_torch.launch.dryrun``) and collective count
(``repro_torch.launch.hlo_analysis``) against the JAX reference's.

* ``plan_for`` and ``model_flops_for`` equal the reference's for every cell
  of ``all_cells()``.
* The two-point group extrapolation of ``account_cell`` equals a trace of
  the whole depth (a smoke config at 3 groups).
* The collective counter gives each hand-placed redistribution's operand
  bytes exactly, on fake 1x2 and 2x2 worlds, and the per-rank regions'
  ``reduce_from`` / ``gather_from``; the reference's own ``hlo_analysis``
  cases are rewritten as traces.
* A tiny dense config, qwen3moe-smoke and mamba2-smoke on a (2, 2, 2) fake
  world beside the reference's ``account_cell`` on an 8-device mesh of Auto
  axes (in a subprocess: the reference's own mesh builder makes Explicit
  axes under this JAX).  FLOPs are held within FLOP_BAND of the
  reference's: both count every matmul of the same step, and XLA also
  counts the elementwise work and the MoE's one-hot dispatch, which the
  port's formulas (the matmuls') do not, while the port's eager step
  recomputes nothing XLA would fuse away.  Collective bytes are printed
  beside the reference's per op kind (the two partitioners choose
  differently) and held above 0.
* The report priced with TPU v5e's constants gives the reference's three
  terms; priced by default, the h100 file's bf16 peak and HBM rate and
  NVLink 4's one-way rate.
* One production cell on a 256-rank fake world, and a SKIP row.
* A kernel wrapper handed a traced tensor raises.

Every fake world is opened and closed inside its test (``fake_world``);
none is left behind (``torch.distributed.is_initialized()`` is False
after each).
"""
import gc
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from torch import distributed as dist  # noqa: E402
from torch.distributed.tensor import (DTensor, Partial, Replicate,  # noqa
                                      Shard)
from torch.distributed._functional_collectives import all_reduce  # noqa

from repro_torch.configs import all_cells, get_config  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.configs.registry import ShapeSpec  # noqa: E402
from repro_torch.core import hardware, tpu  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.launch import dryrun, hlo_analysis  # noqa: E402
from repro_torch.launch.mesh import (  # noqa: E402
    NVLINK_BYTES_PER_S_ONE_WAY, fake_world, make_test_mesh)

ROOT = Path(__file__).resolve().parents[1]
TINY = dict(name="t", family="dense", n_layers=2, d_model=64, n_heads=4,
            n_kv_heads=2, d_ff=128, vocab=256)
CONFIGS = {"tiny": ("t", None), "qwen3moe": ("qwen3-moe-235b-a22b", True),
           "mamba2": ("mamba2-1.3b", True)}
KINDS = (("train", "t"), ("prefill", "p"), ("decode", "d"))
B, S = 8, 32
# port FLOPs / reference FLOPs: 0.84-0.97 for every cell on the CPU but
# the tiny train step's 1.073 (printed by test_flops_within_band_of_the_
# reference); the band leaves ~10% on either side
FLOP_BAND = (0.75, 1.2)


@pytest.fixture(autouse=True)
def no_world_left():
    assert not dist.is_initialized()
    yield
    assert not dist.is_initialized(), "a test left its fake world open"


def _ref_dryrun():
    """The reference's dryrun module; its import sets XLA_FLAGS for 512
    host devices, which is put back so that no other test's JAX sees it."""
    saved = os.environ.get("XLA_FLAGS")
    from repro.launch import dryrun as ref
    if saved is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = saved
    return ref


def _port_cfg(name):
    arch, smoke = CONFIGS[name]
    return ModelConfig(**TINY) if smoke is None else get_config(arch,
                                                                smoke=True)


CELLS = [(a, s) for a, s, _, _ in all_cells()]


@pytest.mark.parametrize("arch,shape", CELLS)
def test_plan_for_matches_reference(arch, shape):
    from repro.configs import get_config as ref_config
    ref = _ref_dryrun()
    assert dryrun.plan_for(arch, shape, get_config(arch)) == \
        ref.plan_for(arch, shape, ref_config(arch))


@pytest.mark.parametrize("arch,shape", CELLS)
def test_model_flops_for_matches_reference(arch, shape):
    from repro.configs import get_config as ref_config
    ref = _ref_dryrun()
    assert dryrun.model_flops_for(get_config(arch), shape) == \
        ref.model_flops_for(ref_config(arch), shape)


def test_accounting_cfg_matches_reference():
    from repro.configs import get_config as ref_config
    ref = _ref_dryrun()
    for arch, _ in CELLS[::4]:
        for g in (1, 2):
            got = dryrun._accounting_cfg(get_config(arch), g)
            want = ref._accounting_cfg(ref_config(arch), g)
            assert (got.n_layers, got.attn_chunk, got.scan_layers,
                    got.attn_chunk_unroll) == \
                (want.n_layers, want.attn_chunk, want.scan_layers,
                 want.attn_chunk_unroll)


def _small_mesh(n):
    if n == 8:
        return make_test_mesh(devices=8, model=2, pod=2, device="cpu")
    return make_test_mesh(devices=n, model=2, device="cpu")


@pytest.mark.parametrize("kind,short", KINDS)
def test_extrapolation_equals_the_whole_depth(kind, short):
    """account_cell's 1- and 2-group traces extrapolated to 3 groups give
    a trace of all 3 groups (microbatches 1, as the accounting runs)."""
    cfg = get_config("h2o-danube-1.8b", smoke=True).replace(n_layers=3)
    shape = ShapeSpec(short, kind, S, B)
    plan = dryrun.plan_for(cfg.name, short, cfg)
    with fake_world(8):
        mesh = _small_mesh(8)
        acct = dryrun.account_cell(cfg, shape, mesh, plan, cfg.name)
        whole = dryrun.lower_cell(cfg.name, short, multi_pod=False,
                                  mesh=mesh, cfg=cfg, shape=shape,
                                  accounting=False)
    rep = whole["report"]
    assert acct["flops"] == pytest.approx(rep.hlo_flops, rel=1e-12)
    assert acct["bytes"] == pytest.approx(rep.hlo_bytes, rel=1e-12)
    assert acct["collective_bytes"] == pytest.approx(rep.collective_bytes,
                                                     rel=1e-12)
    assert acct["flops_g2"] > acct["flops_g1"] > 0


def test_peak_does_not_depend_on_the_cycle_collector(monkeypatch):
    """The traced peak is the same whether Python's cycle collector runs
    on its own or not at all, and lies within the tracker's share of the
    peak found by collecting before every rise: a storage held only by a
    reference cycle (DTensor keeps exceptions whose tracebacks hold
    tensors; a decode step's attention leaves such cycles) counts as free
    once it is garbage."""
    cfg = get_config("h2o-danube-1.8b", smoke=True).replace(n_layers=1)
    shape = ShapeSpec("d", "decode", S, B)

    def peak():
        with fake_world(4):
            mem = dryrun.lower_cell(
                cfg.name, "d", multi_pod=False, mesh=_small_mesh(4),
                cfg=cfg, shape=shape, accounting=False)["memory_analysis"]
        return mem["argument_bytes"] + mem["temp_bytes"]

    usual = peak()
    gc.disable()
    try:
        without = peak()
    finally:
        gc.enable()
    assert usual == without
    monkeypatch.setattr(dryrun.StepTrace, "PEAK_SLACK_SHIFT", 62)
    assert usual <= peak() < usual * (1 + 2 ** -6)


# --------------------------------------------------------------------------
# the collective counter
# --------------------------------------------------------------------------

MOVES = {  # name: (from, to, the collective, operand = the local block?)
    "shard_to_replicate": (Shard(0), Replicate(), "all-gather"),
    "partial_to_replicate": (Partial(), Replicate(), "all-reduce"),
    "partial_to_shard": (Partial(), Shard(0), "reduce-scatter"),
}


@pytest.mark.parametrize("world", [2, 4], ids=["1x2", "2x2"])
@pytest.mark.parametrize("move", sorted(MOVES))
def test_counter_on_a_redistribution(world, move):
    """A (16, 8) fp32 DTensor moved on the "model" axis of a (world/2, 2)
    mesh: the operand is the rank's block before the move (an all-gather's
    shard, an all-reduce's and a reduce-scatter's whole partial)."""
    src, dst, op = MOVES[move]
    with fake_world(world):
        mesh = _small_mesh(world)
        local = torch.empty((8 if src.is_shard() else 16, 8),
                            device="meta")
        x = DTensor.from_local(local, mesh, (Replicate(), src),
                               run_check=False, shape=(16, 8),
                               stride=(8, 1))
        counter = hlo_analysis.CollectiveCounter(mesh)
        with counter:
            x.redistribute(mesh, (Replicate(), dst))
    stats = counter.stats()
    assert stats.totals == {op: local.numel() * 4.0}
    assert stats.schedule == [(op, local.numel() * 4.0, ("model",))]


@pytest.mark.parametrize("world", [2, 4], ids=["1x2", "2x2"])
def test_counter_on_the_per_rank_regions(world):
    """``reduce_from`` sums in fp32 (a bf16 block is cast up first) over
    its group; ``gather_from`` gathers blocks along a dim."""
    with fake_world(world):
        mesh = _small_mesh(world)
        group = mesh.get_group("model")
        counter = hlo_analysis.CollectiveCounter(mesh)
        with counter:
            shd.reduce_from(torch.zeros(4, 6, dtype=torch.bfloat16), group)
            shd.gather_from(torch.zeros(3, 5), 1, group)
    assert counter.records == [("all-reduce", 4 * 6 * 4.0, ("model",)),
                               ("all-gather", 3 * 5 * 4.0, ("model",))]


def test_counter_reference_cases():
    """The reference's hlo_analysis cases as traces: an all-gather and an
    all-reduce of one f32[1024]; an all-reduce of f32[64] in a loop of 7
    (the reference's annotated while body) and of 12 (its default
    multiplier)."""
    with fake_world(2):
        mesh = make_test_mesh(devices=2, model=2, device="cpu")
        group = mesh.get_group("model")
        counter = hlo_analysis.CollectiveCounter(mesh)
        with counter:
            p0 = torch.zeros(1024)
            shd.gather_from(p0, 0, group)
            all_reduce(p0, "sum", group)
        stats = counter.stats()
        assert stats.totals == {"all-gather": 4096.0, "all-reduce": 4096.0}
        for trips in (7, 12):
            counter = hlo_analysis.CollectiveCounter(mesh)
            with counter:
                x = torch.zeros(64)
                for _ in range(trips):
                    x = all_reduce(x, "sum", group)
            assert counter.stats().totals == {"all-reduce": trips * 256.0}


def test_counter_skips_what_is_not_a_collective():
    with fake_world(2):
        mesh = make_test_mesh(devices=2, model=2, device="cpu")
        counter = hlo_analysis.CollectiveCounter(mesh)
        with counter:
            x = torch.zeros(8) + 1
            y = all_reduce(x, "sum", mesh.get_group("model"))
            (y * 2).sum()
    assert [r[0] for r in counter.records] == ["all-reduce"]
    assert set(hlo_analysis.COLLECTIVE_OPS) == {
        "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
        "collective-permute"}


def test_summarize_matches_reference():
    from repro.launch import hlo_analysis as ref
    stats = hlo_analysis.analyze([("all-reduce", 4096.0, ("model",)),
                                  ("all-gather", 1024.0, ("data",)),
                                  ("all-reduce", 256.0, ("model",))])
    want = ref.CollectiveStats(totals=dict(stats.totals))
    assert hlo_analysis.summarize(stats) == ref.summarize(want)
    assert stats.total_bytes == want.total_bytes == 5376.0


# --------------------------------------------------------------------------
# the port against the reference's account_cell
# --------------------------------------------------------------------------

REF_SCRIPT = textwrap.dedent("""
    import json, os
    from repro.launch import dryrun      # sets XLA_FLAGS for 512 devices
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax
    from jax.sharding import AxisType
    from repro.configs import get_config
    from repro.configs.base import ModelConfig
    from repro.configs.registry import ShapeSpec
    mesh = jax.make_mesh((2, 2, 2), ("pod", "data", "model"),
                         axis_types=(AxisType.Auto,) * 3)
    name = %(name)r
    cfg = (ModelConfig(**%(tiny)r) if name == "tiny" else
           get_config(%(arch)r, smoke=True))
    out = {}
    for kind, short in %(kinds)r:
        shape = ShapeSpec(short, kind, %(s)d, %(b)d)
        plan = dryrun.plan_for(cfg.name, short, cfg)
        out[name + "/" + kind] = dryrun.account_cell(cfg, shape, mesh, plan,
                                                     cfg.name)
    print("ROWS " + json.dumps(out))
""")



@pytest.fixture(scope="module", autouse=True)
def reference_rows():
    """The reference's account_cell of every (config, kind): one subprocess
    a config, all started with the module's first test, read when a test
    first needs them."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=str(ROOT / "src"))
    procs = [subprocess.Popen(
        [sys.executable, "-c", REF_SCRIPT % {
            "name": name, "arch": CONFIGS[name][0], "tiny": TINY,
            "kinds": KINDS, "s": S, "b": B}],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for name in sorted(CONFIGS)]
    rows = {}

    def get():
        if not rows:
            for proc in procs:
                out, err = proc.communicate(timeout=600)
                line = [ln for ln in out.splitlines()
                        if ln.startswith("ROWS ")]
                assert proc.returncode == 0 and line, err[-3000:]
                rows.update(json.loads(line[0][5:]))
        return rows
    yield get
    for proc in procs:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


@pytest.fixture(scope="module")
def port_rows():
    rows = {}

    def get(name, kind, short):
        key = f"{name}/{kind}"
        if key not in rows:
            cfg = _port_cfg(name)
            plan = dryrun.plan_for(cfg.name, short, cfg)
            with fake_world(8):
                rows[key] = dryrun.account_cell(
                    cfg, ShapeSpec(short, kind, S, B), _small_mesh(8), plan,
                    cfg.name)
        return rows[key]
    return get


@pytest.mark.parametrize("kind,short", KINDS)
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_flops_within_band_of_the_reference(name, kind, short, port_rows,
                                            reference_rows):
    got = port_rows(name, kind, short)
    want = reference_rows()[f"{name}/{kind}"]
    ratio = got["flops"] / want["flops"]
    coll, ref_coll = got["collective_bytes"], want["collective_bytes"]
    print(f"{name} {kind}: flops {got['flops']:.4e} / reference "
          f"{want['flops']:.4e} = {ratio:.4f}; bytes (unfused against "
          f"XLA's fused) {got['bytes']:.4e} / {want['bytes']:.4e} = "
          f"{got['bytes'] / want['bytes']:.4f}; collective bytes {coll:.4e} / "
          f"{ref_coll:.4e}; per op (2 groups) "
          f"{got['per_op_collectives_g2']} / "
          f"{want['per_op_collectives_g2']}")
    assert FLOP_BAND[0] <= ratio <= FLOP_BAND[1], ratio
    assert got["collective_bytes"] > 0 and got["bytes"] > 0
    assert set(got["per_op_collectives_g2"]) <= set(
        hlo_analysis.COLLECTIVE_OPS)


# --------------------------------------------------------------------------
# the report
# --------------------------------------------------------------------------

COUNTS = dict(num_chips=256, cost_analysis={"flops": 3.1e18,
                                            "bytes accessed": 2.2e16},
              collective_bytes=4.7e14, model_flops=2.5e18)


def test_report_with_tpu_constants_equals_the_reference():
    from repro.core import tpu as ref_tpu
    got = dryrun.RooflineReport(
        name="x", num_chips=256, hlo_flops=3.1e18, hlo_bytes=2.2e16,
        collective_bytes=4.7e14, model_flops=2.5e18,
        peak_flops=tpu.PEAK_FLOPS_BF16, hbm_bw=tpu.HBM_BW,
        link_bw=tpu.ICI_LINK_BW)
    want = ref_tpu.report_from_artifacts("x", **COUNTS)
    for term in ("compute_term", "memory_term", "collective_term",
                 "dominant", "bound_time", "useful_flops_ratio",
                 "roofline_fraction"):
        assert getattr(got, term) == getattr(want, term), term


def test_report_is_priced_on_the_h100_by_default():
    rep = dryrun.report_from_artifacts("x", **COUNTS)
    h100 = hardware.get("h100")
    assert rep.peak_flops == h100.tensor_peak_flops["bf16"] == 989e12
    assert rep.hbm_bw == h100.hbm_peak_bw == 3.35e12
    assert rep.link_bw == NVLINK_BYTES_PER_S_ONE_WAY == 450e9
    assert rep.compute_term == 3.1e18 / (256 * 989e12)
    assert rep.memory_term == 2.2e16 / (256 * 3.35e12)
    assert rep.collective_term == 4.7e14 / (256 * 450e9)


# --------------------------------------------------------------------------
# a production cell, a skipped one
# --------------------------------------------------------------------------

ROW_KEYS = {"arch", "shape", "mesh", "status", "chips", "hlo_flops",
            "hlo_bytes", "collective_bytes", "model_flops", "compute_term_s",
            "memory_term_s", "collective_term_s", "dominant",
            "useful_flops_ratio", "roofline_fraction", "compile_seconds",
            "collective_totals", "plan", "memory"}


def test_production_cell_on_256_ranks(tmp_path):
    out = tmp_path / "rows.jsonl"
    row = dryrun.run_cell("mamba2-1.3b", "decode_32k", multi_pod=False,
                          json_out=str(out), quiet=True)
    assert row["status"] == "ok" and row["chips"] == 256
    assert ROW_KEYS <= set(row) and "fits" in row
    assert set(row["memory"]) == {"argument_bytes", "output_bytes",
                                  "temp_bytes", "generated_code_bytes"}
    assert row["memory"]["generated_code_bytes"] is None
    assert row["fits"] is True
    assert row["hlo_flops"] > 0 and row["collective_bytes"] > 0
    assert json.loads(out.read_text()) == json.loads(json.dumps(row))


def test_long_context_skip_row():
    row = dryrun.run_cell("llama3-405b", "long_500k", multi_pod=True,
                          quiet=True)
    assert row == {"arch": "llama3-405b", "shape": "long_500k",
                   "mesh": "2x16x16", "status": "skipped",
                   "reason": "full attention: 500k KV/decode skipped "
                             "(DESIGN.md §4)"}


def test_the_dry_run_imports_no_jax():
    code = ("import sys; import repro_torch.launch.dryrun; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'repro.'))]; assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    subprocess.run([sys.executable, "-c", code], env=env, check=True,
                   timeout=120)


# --------------------------------------------------------------------------
# kernels refuse a traced tensor
# --------------------------------------------------------------------------

def _meta(*shape):
    return torch.empty(shape, device="meta")


WRAPPERS = {
    "flash_attention": lambda: __import__(
        "repro_torch.kernels.flash_attention.kernel", fromlist=["mha"]).mha(
        _meta(1, 2, 8, 16), _meta(1, 2, 8, 16), _meta(1, 2, 8, 16),
        sm_scale=0.25),
    "ssd": lambda: __import__(
        "repro_torch.kernels.ssd.kernel", fromlist=["ssd"]).ssd(
        _meta(1, 16, 2, 8), _meta(1, 16, 2), _meta(2), _meta(1, 16, 4),
        _meta(1, 16, 4), chunk=8),
    "matmul": lambda: __import__(
        "repro_torch.kernels.matmul.kernel",
        fromlist=["matmul_tiled"]).matmul_tiled(_meta(16, 16),
                                                _meta(16, 16)),
    "rmsnorm": lambda: __import__(
        "repro_torch.kernels.rmsnorm.kernel",
        fromlist=["rmsnorm_2d"]).rmsnorm_2d(_meta(4, 16), _meta(16)),
}


@pytest.mark.parametrize("kernel", sorted(WRAPPERS))
def test_kernel_wrapper_refuses_a_traced_tensor(kernel):
    import importlib
    module = importlib.import_module(f"repro_torch.kernels.{kernel}.kernel")
    before = module.launches
    with pytest.raises(ValueError, match="traced"):
        WRAPPERS[kernel]()
    assert module.launches == before
