"""The readings the correctness limits are set from, on the card, at the
cell's own size: the program's on many seeds and the control's (the
reference in fp8 put in the program's place) or a planted fault's on a
few, in one process.

    python3 portbench/calibrate.py --workload <name> --seeds 12 \
        --control-seeds 3 --seconds 4 [--fault half_batch] [--base <seed>]

Prints one JSON line a seed (the readings, the control's, the reference's
seconds and, for training, the worst leaves) and a summary last: the
largest program reading and the smallest control reading of each number.
The benchmark's own runs never run this.
"""
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def worst(prog: dict, ref: dict, n: int = 4) -> list:
    import statistics
    median = statistics.median(ref.values())
    gaps = sorted(((abs(prog[k] - ref[k]) / max(ref[k], median), k,
                    prog[k], ref[k]) for k in ref), reverse=True)
    return [[k, g, p, r] for g, k, p, r in gaps[:n]]


def plant_half_batch():
    """The fault "half of the batch left out": every step of the program
    sees the first half of its rows, the loss a mean over them."""
    from repro_torch.train import train_step as ts
    whole = ts.make_train_step

    def make(*a, **kw):
        step = whole(*a, **kw)
        return lambda state, batch: step(state, {
            k: v[:v.shape[0] // 2] for k, v in batch.items()})
    ts.make_train_step = make


def main() -> int:
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--base", type=int, default=3_000_000_000)
    ap.add_argument("--fault", default=None)
    ap.add_argument("--program", default="{}",
                    help="JSON settings over the cell's model")
    args = ap.parse_args()
    from portbench import harness
    if args.fault == "half_batch":
        plant_half_batch()
    elif args.fault:
        raise SystemExit(f"no fault {args.fault!r}")
    lows, highs = {}, {}
    for i in range(args.seeds):
        seed = args.base + 7919 * i
        t0 = time.perf_counter()
        r = harness.run_cell(args.workload, seed=seed, seconds=args.seconds,
                             trace=False, control=i < args.control_seeds,
                             overrides=json.loads(args.program))
        run = r.pop("_run")
        line = {"seed": seed, "wall_s": time.perf_counter() - t0,
                "readings": run["readings"], "control": run["control"],
                "ref_s": run["ref_s"], "checked": run["checked"],
                "e2e": run["e2e"], "correct": r["correct"]}
        raw = run.get("raw")
        if raw:
            line["losses"] = {k: v["losses"] for k, v in raw.items()}
            ref = raw["reference"]
            for side in ("program", "control"):
                if side in raw:
                    line[f"worst_grad.{side}"] = worst(
                        raw[side]["first_grad"], ref["first_grad"])
                    line[f"worst_change.{side}"] = worst(
                        raw[side]["change"], ref["change"])
        print(json.dumps(line), flush=True)
        for k, v in run["readings"].items():
            highs[k] = max(highs.get(k, v), v)
        for k, v in (run["control"] or {}).items():
            lows[k] = min(lows.get(k, v), v)
    print(json.dumps({"summary": args.workload, "fault": args.fault,
                      "program_max": highs, "control_min": lows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
