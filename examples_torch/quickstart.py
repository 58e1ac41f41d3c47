"""Quickstart: the paper's model in 60 seconds.

1. Predict a GEMM's runtime on B200/MI300A/TPU-v5e with the analytical
   models (no hardware needed — the paper's procurement use case).
2. Show the naive-roofline failure the paper documents.
3. Train a tiny LM for a few steps with the full framework stack, on the
   CUDA card (``--device cpu`` runs it on the host).

The port's copy of ``examples/quickstart.py``: parts 1-2 are the same
host code and print the same lines; part 3 trains through
``repro_torch.launch.train``.

Run:  PYTHONPATH=src python examples_torch/quickstart.py
      PYTHONPATH=src python examples_torch/quickstart.py --device cpu
"""
import argparse

from repro_torch.core import hardware, predict, roofline
from repro_torch.core.workload import gemm_workload, streaming_workload
from repro_torch.launch.train import train


def perf_model_demo():
    print("=" * 64)
    print("1. Analytical prediction: GEMM 8192^3 across accelerators")
    print("=" * 64)
    w = gemm_workload("gemm_8192", 8192, 8192, 8192, precision="fp16")
    for name in ("b200", "mi300a", "h200", "mi250x", "tpu_v5e"):
        hw = hardware.get(name)
        wv = w.replace(precision="bf16") if name == "tpu_v5e" else w
        out = predict.predict(wv, hw)
        print(f"  {name:8s}: {out.total * 1e3:7.2f} ms "
              f"({out.dominant}-bound)")

    print()
    print("2. Why naive roofline fails (paper Table VI): a us-scale kernel")
    w2 = streaming_workload("vec_add_1MB", 1.5e6, flops_per_byte=1 / 12)
    for name in ("b200", "mi300a"):
        hw = hardware.get(name)
        t_model = predict.predict(w2, hw).total
        t_roof = roofline.predict(w2, hw).total
        print(f"  {name:8s}: model {t_model * 1e6:6.1f} us vs naive "
              f"roofline {t_roof * 1e6:6.2f} us "
              f"({t_model / t_roof:5.0f}x gap: launch + sustained-vs-peak)")


def training_demo(device=None):
    print()
    print("=" * 64)
    print("3. Train a tiny minicpm-family model (WSD schedule) 30 steps")
    print("=" * 64)
    out = train("minicpm-2b", smoke=True, steps=30, batch=8, seq=64,
                lr=3e-3, log_every=10, device=device)
    first, last = out["losses"][0], out["final_loss"]
    print(f"  loss {first:.3f} -> {last:.3f}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device for part 3 (default: the CUDA card; "
                         "'cpu' runs it on the host)")
    args = ap.parse_args(argv)
    perf_model_demo()
    training_demo(args.device)


if __name__ == "__main__":
    main()
