"""Cross-vendor performance prediction (the paper's §VI 'procurement
comparison between B200 and MI300A without access to both').

Sweeps a workload portfolio (GEMMs across sizes/precisions, bandwidth
kernels, a stencil app segment) over every parameter file, reporting
predicted time + bottleneck per platform — plus the TPU-v5e adaptation
with its collective stage on the production mesh, and two columnar sweeps
through ``WorkloadTable``: a ``tile_lattice`` + fused ``argmin_table``
tile search and a ``cartesian`` precision-x-concurrency what-if grid with
``topk_table``/``pareto_table`` (§IV-B adaptive tile selection at sweep
scale; the reference's benchmarks/sweep_bench.py is the 1,000-point
version).

Ends with the streaming path: a 10M-config lazy ``LatticeSpec`` priced to
a fused argmin in O(chunk) peak memory (tracemalloc-verified), optionally
sharded across every core via ``core.parallel`` — the regime where
materializing the table first would cost gigabytes.

The port's copy of ``examples/predict_performance.py``: the same
analytical model (``repro_torch.core``, host code), the same output.

Run:  PYTHONPATH=src python examples_torch/predict_performance.py
"""
import time
import tracemalloc

from repro_torch.core import collectives, hardware, predict, sweep, tpu
from repro_torch.core.workload import LatticeSpec, Segment, TileConfig, \
    Workload, WorkloadTable, gemm_workload, streaming_workload
from repro_torch.core.segments import predict_app

PLATFORMS = ("b200", "h200", "mi300a", "mi250x", "tpu_v5e")


def portfolio():
    out = []
    for n in (2048, 8192, 16384):
        out.append(gemm_workload(f"gemm_fp16_{n}", n, n, n,
                                 precision="fp16"))
    out.append(gemm_workload("gemm_fp8_16384", 16384, 16384, 16384,
                             precision="fp8"))
    out.append(streaming_workload("stream_1GB", 1e9))
    out.append(Workload(name="stencil_8192", wclass="stencil",
                        flops=15.0 * 8192 ** 2, bytes=8.0 * 8192 ** 2,
                        precision="fp32",
                        working_set_bytes=2 * 8192 ** 2 * 4))
    return out


def main():
    ws = portfolio()
    print(f"{'workload':18s} | " + " | ".join(f"{p:>12s}" for p in PLATFORMS))
    print("-" * (20 + 15 * len(PLATFORMS)))
    for w in ws:
        cells = []
        for p in PLATFORMS:
            hw = hardware.get(p)
            wv = w
            if p == "tpu_v5e" and w.precision in ("fp16", "fp8"):
                wv = w.replace(precision="bf16")
            t = predict.predict(wv, hw)
            cells.append(f"{t.total * 1e3:8.2f}ms {t.dominant[:3]}")
        print(f"{w.name:18s} | " + " | ".join(f"{c:>12s}" for c in cells))

    print()
    print("Multi-chip (TPU v5e pod): same GEMM data-parallel across 256"
          " chips with the gradient all-reduce priced by the collective"
          " model:")
    mesh = collectives.MeshSpec(axes=(("data", 16), ("model", 16)))
    w = gemm_workload("gemm_bf16_16384", 16384, 16384, 16384,
                      precision="bf16")
    shard = w.replace(flops=w.flops / 256, bytes=w.bytes / 256)
    out = tpu.predict(shard, hardware.TPU_V5E, mesh=mesh,
                      collective_ops=[("all-reduce",
                                       16384 * 16384 * 2 / 256, "data")])
    print(f"  per-chip step {out.total * 1e3:.3f} ms; "
          f"collective {out.collective * 1e3:.3f} ms "
          f"(exposed {out.detail['t_coll_exposed'] * 1e3:.3f} ms)")

    print()
    print("Columnar tile sweep (WorkloadTable.tile_lattice + argmin_table):")
    print("price every (bM, bN, bK) tile candidate for an 8192^3 fp16 GEMM")
    print("without building per-config Workload objects, and take the fused")
    print("argmin (paper §IV-B adaptive tile selection at sweep scale):")
    base = gemm_workload("gemm8k", 8192, 8192, 8192, precision="fp16")
    tiles = [TileConfig(bm, bn, bk)
             for bm in (32, 64, 128, 256, 512)
             for bn in (32, 64, 128, 256, 512)
             for bk in (16, 32, 64, 128, 256)]
    table = WorkloadTable.tile_lattice(base, tiles)
    for plat in ("b200", "mi300a", "tpu_v5e"):
        hw = hardware.get(plat)
        t0 = time.perf_counter()
        win = sweep.argmin_table(table, hw)
        dt = time.perf_counter() - t0
        t = tiles[win.index]
        print(f"  {plat:8s}: {len(table)} tiles in {dt * 1e3:6.2f} ms"
              f" ({len(table) / dt:9.0f} cfg/s) -> best"
              f" {t.bm}x{t.bn}x{t.bk} @ {win.total * 1e3:.3f} ms"
              f" ({win.breakdown.dominant}-bound)")

    print()
    print("Cartesian what-if grid (WorkloadTable.cartesian): sweep the same")
    print("GEMM over precision x concurrency in one columnar cross-product,")
    print("then read the top-3 and the compute/memory pareto front:")
    grid = WorkloadTable.cartesian(
        base, precision=["fp16", "bf16", "fp8"],
        concurrent_kernels=[1, 2, 4])
    top = sweep.topk_table(grid, hardware.B200, 3)
    for w in top:
        print(f"  top: row {w.index} ({w.name}) @ {w.total * 1e3:.3f} ms")
    front = sweep.pareto_table(grid, hardware.B200,
                               objectives=("compute", "memory"))
    print(f"  pareto(compute, memory): {[w.index for w in front]}")

    print()
    print("Streamed 10M-config lattice (LatticeSpec + argmin_stream): the")
    print("same GEMM swept over a k_tiles x num_ctas x multicast x")
    print("concurrency occupancy grid.  The spec never materializes — ")
    print("chunks price through the engine one at a time, so peak memory")
    print("stays O(chunk) while the winner is bit-identical to pricing the")
    print("materialized table (which would need ~2.2 GB of columns here):")
    lattice = LatticeSpec.cartesian(
        base,
        k_tiles=[8 + 2 * i for i in range(128)],
        num_ctas=[16 + 4 * i for i in range(128)],
        tma_participants=[1, 2, 4, 8] * 4,
        concurrent_kernels=[1, 2, 4, 8] * 10)
    print(f"  lattice rows: {len(lattice):,} "
          f"(~{lattice.estimated_bytes() / 1e9:.1f} GB if materialized)")
    tracemalloc.start()
    t0 = time.perf_counter()
    win = sweep.argmin_stream(lattice, hardware.B200)
    dt = time.perf_counter() - t0
    peak_mb = tracemalloc.get_traced_memory()[1] / 1e6
    tracemalloc.stop()
    print(f"  serial stream : {len(lattice) / dt:12,.0f} cfg/s "
          f"({dt:.2f} s), peak memory {peak_mb:.1f} MB")
    print(f"    winner row {win.index} ({win.name}) @ "
          f"{win.total * 1e3:.4f} ms ({win.breakdown.dominant}-bound)")
    t0 = time.perf_counter()
    win_p = sweep.argmin_stream(lattice, hardware.B200, jobs=0)
    dt_p = time.perf_counter() - t0
    print(f"  sharded jobs=auto: {len(lattice) / dt_p:9,.0f} cfg/s "
          f"({dt_p:.2f} s) -> same winner: "
          f"{(win_p.index, win_p.total) == (win.index, win.total)}")

    print()
    print("Application segments (hotspot-like stencil app, 1000 iters):")
    seg = Segment(workload=Workload(
        name="hs_calc", wclass="stencil", flops=15.0 * 1024 ** 2,
        bytes=2.0 * 1024 ** 2 * 4.0, precision="fp32",
        working_set_bytes=2 * 1024 ** 2 * 4), n_exec=1000)
    for p in PLATFORMS:
        hw = hardware.get(p)
        app = predict_app("hotspot_1024", [seg], hw)
        print(f"  {p:8s}: {app.total * 1e3:8.2f} ms")


if __name__ == "__main__":
    main()
