#!/usr/bin/env python3
"""Every cell of the port's dry run (``all_cells()`` on the 16x16 and
2x16x16 meshes), each in its own ``python -m repro_torch.launch.dryrun``
process, ``--jobs`` at a time, and the table of its rows.  Needs no card.

    PYTHONPATH=src python3 scripts/dryrun_table.py <out.jsonl> [--jobs 8]
        [--arch A ...] [--table-only]

Rows are appended to ``<out.jsonl>`` in the CLI's keys; a cell that fails
is reported and the script exits 1; ``--table-only`` prints the table of
the rows already there.  The table has, per (arch, shape), the
three terms in seconds and the dominant one (C / M / X), a rank's GB
(arguments + temporaries of the deployed plan, "no" where it does not fit
80 GB), the deployed trace's seconds, for each mesh, and the useful FLOP
share on both.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

from repro_torch.configs.registry import all_cells


def _run(arch: str, shape: str, multi_pod: bool, out: str):
    """(error text or "", the process's seconds)"""
    t0 = time.time()
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
           "--shape", shape, "--json", out] + (["--multi-pod"]
                                              if multi_pod else [])
    p = subprocess.run(cmd, capture_output=True, text=True,
                       env=dict(os.environ))
    err = "" if p.returncode == 0 else \
        f"{arch} {shape} multi_pod={multi_pod}: rc {p.returncode}\n" \
        f"{p.stderr[-2000:]}"
    return err, time.time() - t0


_TERM = {"compute": "C", "memory": "M", "collective": "X"}


def _cell(row) -> str:
    mem = row["memory"]
    gb = (mem["argument_bytes"] + mem["temp_bytes"]) / 1e9
    terms = " / ".join(f"{row[k]:.3g}" for k in (
        "compute_term_s", "memory_term_s", "collective_term_s"))
    fits = "" if row["fits"] else " **no**"
    return (f"{terms} {_TERM[row['dominant']]} | {gb:.3g}{fits} | "
            f"{row['compile_seconds']:.0f}")


def table(rows) -> str:
    by = {(r["arch"], r["shape"], r["mesh"]): r for r in rows
          if r["status"] == "ok"}
    lines = ["| cell | 16x16: C / M / X s, dominant | GB a rank | s | "
             "2x16x16: C / M / X s, dominant | GB | s | useful |",
             "|---|---|---|---|---|---|---|---|"]
    for arch, shape, ok, _ in all_cells():
        pair = [by.get((arch, shape, m)) for m in ("16x16", "2x16x16")]
        if not ok or None in pair:
            continue
        useful = " / ".join(f"{r['useful_flops_ratio']:.3g}" for r in pair)
        lines.append(f"| {arch} {shape} | {_cell(pair[0])} | "
                     f"{_cell(pair[1])} | {useful} |")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("out")
    ap.add_argument("--jobs", type=int, default=8)
    ap.add_argument("--arch", action="append", default=None)
    ap.add_argument("--table-only", action="store_true")
    args = ap.parse_args(argv)
    if args.table_only:
        with open(args.out) as f:
            print(table([json.loads(line) for line in f]))
        return 0
    cells = [(a, s, mp) for a, s, _, _ in all_cells()
             if args.arch is None or a in args.arch for mp in (False, True)]
    # the longest (train) cells first
    cells.sort(key=lambda c: c[1] != "train_4k")
    t0 = time.time()
    with ThreadPoolExecutor(args.jobs) as pool:
        done = list(pool.map(lambda c: _run(*c, args.out), cells))
    errors = [e for e, _ in done if e]
    with open(args.out) as f:
        rows = [json.loads(line) for line in f]
    print(table(rows))
    n_ok = sum(r["status"] == "ok" for r in rows)
    n_skip = sum(r["status"] == "skipped" for r in rows)
    print(f"\n{n_ok} ok, {n_skip} skipped, {len(errors)} failed; "
          f"{time.time() - t0:.0f} s wall, "
          f"{sum(s for _, s in done):.0f} s of processes summed")
    for e in errors:
        print(e, file=sys.stderr)
    return 1 if errors else 0


if __name__ == "__main__":
    sys.exit(main())
