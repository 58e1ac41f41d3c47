"""Model-driven tile selection in the port (``repro_torch.core.autotune``,
``repro_torch.kernels.matmul.ops.select_blocks`` / ``predict_block_time``)
against the reference's ``repro.core.autotune`` on the CPU.

``autotune`` is a verbatim copy (``tests/test_torch_core.py`` holds its
text); here its tile and plan outputs are the reference's bit for bit on
the B200 and H100 files, and ``select_blocks`` prices the Hopper kernel's
instantiated tiles exactly as the reference's ``enumerate_tiles`` prices
the same ``TileConfig``s on the reference's ``h100`` file.  Whether the
model's pick is the card's fastest tile is measured by ``chip_smoke.py``'s
``[tiles]`` phase, not here.
"""
import pytest

torch = pytest.importorskip("torch")

from repro.core import autotune as ref_autotune  # noqa: E402
from repro.core import collectives as ref_collectives  # noqa: E402
from repro.core import hardware as ref_hardware  # noqa: E402
from repro.core.workload import TileConfig as RefTile  # noqa: E402
from repro.core.workload import gemm_workload as ref_gemm  # noqa: E402
from repro_torch.core import autotune, collectives, hardware  # noqa: E402
from repro_torch.core.workload import TileConfig, gemm_workload  # noqa: E402
from repro_torch.kernels.matmul import kernel, ops  # noqa: E402

HW = ["b200", "h100"]
# chip_smoke.py's [tiles] shapes: the loop's gemm_kernel sizes, and
# h2o-danube-1.8b's prefill projections at S = 8192.
SHAPES = [(4096, 4096, 4096), (8192, 8192, 8192), (8192, 2560, 2560),
          (8192, 6912, 2560), (8192, 2560, 6912), (100, 257, 1000)]
LATTICE = [(bm, bn, bk) for bm in (64, 128, 256) for bn in (64, 128, 256)
           for bk in (32, 64)]


@pytest.mark.parametrize("hw_name", HW)
@pytest.mark.parametrize("precision", ["fp16", "bf16", "fp32"])
def test_select_and_enumerate_tiles_are_the_reference(hw_name, precision):
    hw, ref_hw = hardware.get(hw_name), ref_hardware.get(hw_name)
    for m, n, k in SHAPES:
        base = gemm_workload("sel", m, n, k, precision=precision)
        ref_base = ref_gemm("sel", m, n, k, precision=precision)
        tiles = [TileConfig(*t) for t in LATTICE]
        ref_tiles = [RefTile(*t) for t in LATTICE]
        costs = autotune.enumerate_tiles(base, hw, tiles)
        assert costs == ref_autotune.enumerate_tiles(ref_base, ref_hw,
                                                     ref_tiles)
        best, sel_costs = autotune.select_tile(base, hw, tiles)
        ref_best, ref_costs = ref_autotune.select_tile(ref_base, ref_hw,
                                                       ref_tiles)
        assert (best.bm, best.bn, best.bk) == (ref_best.bm, ref_best.bn,
                                               ref_best.bk)
        assert sel_costs == ref_costs == costs


@pytest.mark.parametrize("hw_name", HW)
def test_streamed_and_sharded_tile_pricing_is_the_reference(hw_name):
    """The chunked path (``chunk_size``) prices the same floats."""
    hw, ref_hw = hardware.get(hw_name), ref_hardware.get(hw_name)
    tiles = [TileConfig(*t) for t in LATTICE]
    ref_tiles = [RefTile(*t) for t in LATTICE]
    base = gemm_workload("sel", 8192, 2560, 6912, precision="bf16")
    ref_base = ref_gemm("sel", 8192, 2560, 6912, precision="bf16")
    got = autotune.enumerate_tiles(base, hw, tiles, chunk_size=5)
    assert got == ref_autotune.enumerate_tiles(ref_base, ref_hw, ref_tiles,
                                               chunk_size=5)
    assert got == autotune.enumerate_tiles(base, hw, tiles)


def _plans(coll):
    mesh = coll.MeshSpec(axes=(("data", 8), ("model", 4)))
    mod = autotune if coll is collectives else ref_autotune
    return [mod.PlanCandidate(name=f"p{i}", mesh=mesh, tp_degree=4,
                              microbatches=mb, remat=r, compressed_grads=c)
            for i, (mb, r, c) in enumerate([(1, "none", False),
                                            (8, "full", True),
                                            (4, "block", False)])]


@pytest.mark.parametrize("hw_name", HW)
def test_enumerate_plans_is_the_reference(hw_name):
    kw = dict(model_flops=1e18, param_bytes=2e11, activation_bytes=5e12,
              opt_state_bytes=4e11, activation_peak_bytes=1e12)
    got = autotune.enumerate_plans(_plans(collectives),
                                   hw=hardware.get(hw_name), **kw)
    want = ref_autotune.enumerate_plans(_plans(ref_collectives),
                                        hw=ref_hardware.get(hw_name), **kw)
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        assert a.plan.describe() == b.plan.describe()
        assert (a.compute_s, a.memory_s, a.collective_s,
                a.exposed_collective_s, a.total_s, a.hbm_bytes_per_chip) \
            == (b.compute_s, b.memory_s, b.collective_s,
                b.exposed_collective_s, b.total_s, b.hbm_bytes_per_chip)
        assert a.detail == b.detail


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("m,n,k", SHAPES)
def test_select_blocks_prices_the_instantiated_tiles_as_the_reference(
        precision, m, n, k):
    best, costs = ops.select_blocks(m, n, k, precision=precision,
                                    hw=hardware.get("h100"))
    dtype = {"fp32": torch.float32, "bf16": torch.bfloat16}[precision]
    assert [(bm, bn) for bm, bn, _ in costs] == list(kernel.TILES[dtype])
    assert all(bk == kernel.BK for _, _, bk in costs)
    want = ref_autotune.enumerate_tiles(
        ref_gemm(f"matmul_{m}x{n}x{k}", m, n, k, precision=precision),
        ref_hardware.get("h100"), [RefTile(*t) for t in costs])
    assert {f"{bm}x{bn}x{bk}": s for (bm, bn, bk), s in costs.items()} \
        == want
    assert costs[best] == min(costs.values())
    assert best[:2] in kernel.TILES[dtype]
    # the default parameter file is the datasheet H100's
    assert ops.select_blocks(m, n, k, precision=precision) == (best, costs)
    for blocks, secs in costs.items():
        assert ops.predict_block_time(m, n, k, blocks, precision) == secs


def test_select_blocks_takes_a_measured_file_and_candidates():
    sheet = hardware.get("h100")
    faster = sheet.with_updates(
        name="h100_test_measured",
        tensor_sustained_flops={"fp32": 2 * sheet.sustained_flops("fp32")})
    cands = ((64, 64, 64), (128, 128, 64))
    _, slow = ops.select_blocks(4096, 4096, 4096, candidates=cands,
                                precision="fp32", hw=sheet)
    best, fast = ops.select_blocks(4096, 4096, 4096, candidates=cands,
                                   precision="fp32", hw=faster)
    assert set(fast) == set(cands) and best in cands
    assert all(fast[c] < slow[c] for c in cands)


def test_kernel_blocks_refuse_what_the_kernel_does_not_take():
    assert ops.kernel_blocks("fp32") == tuple(
        (bm, bn, 64) for bm, bn in kernel.TILES[torch.float32])
    with pytest.raises(ValueError, match="fp16"):
        ops.kernel_blocks("fp16")


def test_matmul_does_not_select_blocks(monkeypatch):
    """As in the reference, the op's default dispatch is not the model's
    choice: ``select_blocks`` is a hook a caller uses."""
    def refuse(*a, **kw):
        raise AssertionError("matmul called select_blocks")
    monkeypatch.setattr(ops, "select_blocks", refuse)
    a, b = torch.ones(64, 32), torch.ones(32, 48)
    assert torch.equal(ops.matmul(a, b), torch.full((64, 48), 32.0))
