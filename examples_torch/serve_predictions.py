"""Serving predictions across processes (the repo's first wire scenario).

Starts the HTTP prediction server as a real subprocess, then drives it
with ``repro_torch.serve.PredictionClient``:

  1. a 10k-row GEMM tile-lattice ``WorkloadTable`` shipped over the wire
     and reduced server-side (argmin + top-k), answer checked bit-exact
     against the in-process fused reduction;
  2. the same request replayed — served from the engine's whole-table
     memo cache (watch the hit counters move);
  3. eight client threads firing small per-shape lattices concurrently —
     the server coalesces them into fused columnar evaluations;
  4. a ~1M-row lazy ``LatticeSpec`` sent as a tiny plan (a few hundred
     bytes on the wire) and streamed server-side in O(chunk) memory;
  5. the framed persistent-socket transport (binary framing v1): the
     server also opens ``--binary-port``, the client auto-negotiates it
     via ``/v1/health``, and a burst of single-row requests is pipelined
     over one socket — then deduped server-side when the tables repeat;
  6. the observability surface: everything above was instrumented as it
     ran, so the demo ends by fetching ``/v1/metrics`` and rendering the
     busiest latency histograms as a mini text dashboard.

``--metrics off`` and ``--slow-request-ms N`` are forwarded to the
server subprocess; the default slow threshold (250 ms) is low enough
that the ~1M-row streamed lattice emits a structured JSON slow-request
line on the server's stderr, trace id included.

The port's copy of ``examples/serve_predictions.py``: the port's server
(``repro_torch.serve``, host code that loads no torch) and client.

Run:  PYTHONPATH=src python examples_torch/serve_predictions.py
      PYTHONPATH=src python examples_torch/serve_predictions.py --metrics off
"""
import argparse
import re
import threading
import time

from repro_torch.core import hardware, sweep
from repro_torch.core.workload import LatticeSpec, TileConfig, \
    WorkloadTable, gemm_workload
from repro_torch.serve import PredictionClient
from repro_torch.serve.subproc import (start_server_subprocess,
                                       stop_server_subprocess)

TILES = [TileConfig(bm, bn, bk)
         for bm in (32, 64, 128, 256) for bn in (32, 64, 128, 256)
         for bk in (8, 16, 32, 64)]
SHAPES = [(2048 + 512 * s, 4096, 4096) for s in range(160)]


def _quantile_bound(buckets, count, q):
    """Smallest bucket bound holding at least the q-th observation."""
    target = q * count
    for bound, cum in buckets:
        if cum >= target:
            return bound
    return float("inf")


def _ms(bound):
    return "inf" if bound == float("inf") else f"{bound * 1e3:g}ms"


def metrics_dashboard(text, top=5):
    """The busiest ``*_seconds`` histograms from a Prometheus text
    exposition, one line each: count, mean, and p50/p99 upper bounds
    read off the fixed bucket ladder."""
    kinds = dict(
        re.findall(r"^# TYPE (\S+) (\S+)$", text, flags=re.MULTILINE))
    series = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        metric, _, val = line.rpartition(" ")
        base, _, lbl = metric.partition("{")
        lbl = lbl[:-1] if lbl.endswith("}") else ""
        for suffix in ("_bucket", "_sum", "_count"):
            fam = base[:-len(suffix)]
            if base.endswith(suffix) and kinds.get(fam) == "histogram" \
                    and fam.endswith("_seconds"):
                break
        else:
            continue
        le = None
        if suffix == "_bucket":
            le = re.search(r'le="([^"]*)"', lbl).group(1)
            lbl = re.sub(r',?le="[^"]*"', "", lbl).strip(",")
        s = series.setdefault((fam, lbl),
                              {"buckets": [], "sum": 0.0, "count": 0})
        if suffix == "_bucket":
            s["buckets"].append(
                (float("inf") if le == "+Inf" else float(le), float(val)))
        elif suffix == "_sum":
            s["sum"] = float(val)
        else:
            s["count"] = int(float(val))
    busiest = sorted(series.items(), key=lambda kv: -kv[1]["count"])
    lines = []
    for (fam, lbl), s in busiest[:top]:
        if not s["count"]:
            continue
        buckets = sorted(s["buckets"])
        name = f"{fam}{{{lbl}}}" if lbl else fam
        lines.append(
            f"{name:<58s} n={s['count']:<5d} "
            f"mean {s['sum'] / s['count'] * 1e3:8.2f}ms  "
            f"p50<={_ms(_quantile_bound(buckets, s['count'], 0.50))}  "
            f"p99<={_ms(_quantile_bound(buckets, s['count'], 0.99))}")
    return lines


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="prediction-serving demo (see module docstring)")
    ap.add_argument("--metrics", choices=("on", "off"), default="on",
                    help="forwarded to the server subprocess; 'off' shows "
                         "the kill switch (the dashboard renders empty)")
    ap.add_argument("--slow-request-ms", type=float, default=250.0,
                    help="forwarded: server logs a structured JSON line "
                         "for sweeps slower than this (trace id included)")
    args = ap.parse_args(argv)
    extra = ["--metrics", args.metrics,
             "--slow-request-ms", str(args.slow_request_ms)]
    proc, host, port, bport = start_server_subprocess(extra, binary=True)
    client = PredictionClient(host, port)
    try:
        print(f"server pid {proc.pid} at {host}:{port} -> "
              f"{client.health()['status']}")

        # -- 1. a 10k-row table over the wire ---------------------------
        parts = [WorkloadTable.tile_lattice(
            gemm_workload(f"shape{j}", m, n, k, precision="fp16"),
            TILES[:64]) for j, (m, n, k) in enumerate(SHAPES)]
        table = WorkloadTable.concat(parts)
        t0 = time.perf_counter()
        win = client.argmin(table, "b200")
        dt = time.perf_counter() - t0
        ref = sweep.argmin_table(table, hardware.B200,
                                 engine=sweep.SweepEngine(use_cache=False))
        same = (win.index == ref.index and win.total == ref.total
                and win.breakdown == ref.breakdown)
        print(f"argmin over {len(table):,} wire rows: {win.name} "
              f"{win.total * 1e3:.3f} ms  [{dt * 1e3:.1f} ms round-trip, "
              f"bit-identical to in-process: {same}]")
        top = client.topk(table, "b200", 3)
        print("top-3:", [(w.name, f"{w.total * 1e3:.3f} ms") for w in top])

        # -- 2. replay hits the server's memo cache ---------------------
        before = client.cache_stats()["hits"]
        t0 = time.perf_counter()
        client.argmin(table, "b200")
        dt_replay = time.perf_counter() - t0
        print(f"replayed argmin: {dt_replay * 1e3:.1f} ms "
              f"({dt / max(dt_replay, 1e-9):.1f}x faster; engine hits "
              f"{before} -> {client.cache_stats()['hits']})")

        # -- 3. concurrent small requests coalesce ----------------------
        def ask(j):
            client.argmin(parts[j], "b200")
        threads = [threading.Thread(target=ask, args=(j,))
                   for j in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        st = client.cache_stats()
        print(f"8 concurrent small sweeps -> "
              f"{st['coalescer_fused_evaluations']} fused evaluation(s), "
              f"{st['coalescer_coalesced_requests']} requests coalesced")

        # -- 4. a ~1M-row lattice as a tiny wire plan -------------------
        base = gemm_workload("big", 8192, 8192, 8192, precision="fp16")
        spec = LatticeSpec.cartesian(
            base,
            k_tiles=[8 + 4 * i for i in range(64)],
            num_ctas=[32 + 8 * i for i in range(64)],
            tma_participants=[1, 2, 4, 8] * 4,
            concurrent_kernels=[1, 2] * 8)
        t0 = time.perf_counter()
        win = client.argmin(spec, "b200")
        dt = time.perf_counter() - t0
        print(f"streamed {spec.n_rows:,}-row lattice server-side in "
              f"{dt:.2f} s -> {win.name} {win.total * 1e3:.3f} ms")

        # -- 5. pipelined single-row bursts over the binary socket ------
        singles = [WorkloadTable.tile_lattice(
            gemm_workload(f"pipe{j}", 2048 + 128 * j, 4096, 4096,
                          precision="fp16"), TILES[:1])
            for j in range(16)]
        t0 = time.perf_counter()
        wins = client.argmin_many(singles, "b200")
        dt_pipe = time.perf_counter() - t0
        # repeat the burst: identical tables dedup into one evaluation
        before = client.cache_stats()["coalescer_deduped_requests"]
        client.argmin_many([singles[0]] * 16, "b200")
        saved = (client.cache_stats()["coalescer_deduped_requests"]
                 - before)
        print(f"binary on port {bport}: 16 pipelined single-row argmins "
              f"in {dt_pipe * 1e3:.1f} ms "
              f"({len(wins) / max(dt_pipe, 1e-9):.0f} req/s); repeating "
              f"one table 16x deduped {saved} request(s) server-side")

        # -- 6. the observability surface: /v1/metrics ------------------
        text = client.metrics_text()
        dash = metrics_dashboard(text)
        print(f"/v1/metrics ({len(text.splitlines())} exposition lines), "
              f"busiest latency histograms:")
        for line in dash:
            print(f"  {line}")
        if not dash:
            print("  (metrics disabled — rerun without --metrics off)")
    finally:
        client.close()
        stop_server_subprocess(proc)


if __name__ == "__main__":
    main()
