"""Run one cell of the port's benchmark once, on the card this machine holds.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Prints, as the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics with
``--trace 0``, its per-layer metrics with ``--trace 1``), ``device``,
``breakdown`` (with ``--trace 1``) and, last, ``checks``: each number the
correctness check compared, beside its limit, which are also the last lines
of standard error.  Exits with another code than 0, and prints no result,
when no CUDA card (or fewer than the cell asks for) is visible, or when
``jax``, ``jaxlib``, ``flax`` or the reference package ``repro`` was loaded.
"""
import time

T_START = time.perf_counter()        # set-up is counted from here

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# Every cache the run or the program writes lies at a fixed path in the
# checkout, so only a checkout's first run builds (the port's nvcc builds
# go to build/kernels by its own rule).
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
os.environ["USE_FLAX"] = "0"
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    from portbench import harness
    cell = harness.load_cell(args.workload)
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell.chips:
        print(f"portbench: the cell needs {cell.chips} CUDA card(s), "
              f"{have} visible", file=sys.stderr)
        return 2
    result = harness.run_cell(args.workload, seed=args.seed,
                              seconds=args.seconds, trace=bool(args.trace),
                              t_start=T_START)
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"portbench: loaded {loaded}; nothing the benchmark runs may "
              f"load jax, jaxlib, flax or repro", file=sys.stderr)
        return 3
    result.pop("_run")
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
