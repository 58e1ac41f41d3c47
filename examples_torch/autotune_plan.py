"""Model-driven plan selection: the paper's adaptive tile selection
(§IV-B) at two levels.

1. GEMM tiles on MI300A (the paper's own study: 16x16 beats 8x8).
2. Tile selection for the port's hand-written H100 matmul kernel: its
   instantiated output tiles priced on the ``h100`` parameter file.
3. SPMD execution-plan selection for llama3-405b train_4k on a 16x16
   H100 mesh (TP degree x microbatches x remat x int8-grads), priced as
   the dry run prices it: the ``h100`` file with NVLink 4 links.

The port's copy of ``examples/autotune_plan.py``: part 1 is the same host
code and prints the same lines; parts 2 and 3 price the H100 where the
reference prices its TPU.

Run:  PYTHONPATH=src python examples_torch/autotune_plan.py
"""
from repro_torch.core import autotune, cdna3, collectives, hardware
from repro_torch.core.workload import TileConfig, gemm_workload
from repro_torch.configs import get_config
from repro_torch.kernels.matmul.ops import select_blocks
from repro_torch.launch.mesh import NVLINK_BYTES_PER_S_ONE_WAY


def tile_selection_mi300a():
    print("=" * 60)
    print("1. MI300A tile selection (paper Eq. 14)")
    print("=" * 60)
    base = gemm_workload("g4096", 4096, 4096, 4096, precision="fp32")
    tiles = [TileConfig(s, s, 16) for s in (8, 16, 32, 64)]
    best, costs = cdna3.adaptive_tile_selection(base, hardware.MI300A,
                                                tiles)
    for tag, t in sorted(costs.items(), key=lambda kv: kv[1]):
        mark = " <- selected" if tag.startswith(f"{best.bm}x") else ""
        print(f"  tile {tag:12s}: {t * 1e6:9.2f} us{mark}")


def tile_selection_h100():
    print()
    print("=" * 60)
    print("2. Hopper tile selection (the H100 matmul kernel)")
    print("=" * 60)
    best, costs = select_blocks(8192, 8192, 8192)
    for blocks, t in sorted(costs.items(), key=lambda kv: kv[1]):
        mark = " <- selected" if blocks == best else ""
        print(f"  blocks {str(blocks):18s}: {t * 1e3:8.3f} ms{mark}")


def plan_selection_405b():
    print()
    print("=" * 60)
    print("3. SPMD plan selection: llama3-405b train_4k on 16x16 H100")
    print(f"   (NVLink 4, {NVLINK_BYTES_PER_S_ONE_WAY / 1e9:.0f} GB/s a "
          f"link one way)")
    print("=" * 60)
    cfg = get_config("llama3-405b")
    mesh = collectives.MeshSpec(axes=(("data", 16), ("model", 16)))
    hw = hardware.get("h100").with_updates(
        ici_link_bw=NVLINK_BYTES_PER_S_ONE_WAY)
    n = cfg.param_count()
    candidates = []
    for ub in (1, 8, 16):
        for remat in ("block", "full"):
            for comp in (False, True):
                candidates.append(autotune.PlanCandidate(
                    name=f"ub{ub}-{remat}{'-int8' if comp else ''}",
                    mesh=mesh, tp_degree=16, microbatches=ub,
                    remat=remat, compressed_grads=comp))
    tokens = 256 * 4096
    best, costs = autotune.select_plan(
        candidates,
        model_flops=6.0 * n * tokens,
        param_bytes=2.0 * n,
        activation_bytes=2.0 * tokens * cfg.d_model * cfg.n_layers * 4,
        opt_state_bytes=4.0 * n,
        activation_peak_bytes=2.0 * tokens * cfg.d_model * 2,
        hw=hw,
    )
    for c in sorted(costs, key=lambda c: c.total_s):
        feas = "fits " if c.detail.get("feasible") else "OOM  "
        mark = " <- selected" if c.plan.name == best.plan.name else ""
        print(f"  {c.plan.name:16s} [{feas}] step {c.total_s:7.3f}s "
              f"(compute {c.compute_s:6.3f} coll-exposed "
              f"{c.exposed_collective_s:6.3f}){mark}")


if __name__ == "__main__":
    tile_selection_mi300a()
    tile_selection_h100()
    plan_selection_405b()
