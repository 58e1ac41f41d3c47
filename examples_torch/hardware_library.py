"""The declarative hardware library, end to end.

The paper's portability claim (Obs. 6, §V-E) is that the models move
across accelerators by swapping parameter files, not formulas.  This CLI
drives that as data:

  list       every library entry (shipped data files + runtime registry)
  show       one entry: parameters, provenance tags, source citation
  diff       field-level delta between two entries — `diff b200 h200`
             prints exactly the §V-E port
  calibrate  the full served loop: start a prediction server subprocess,
             measure the device's real microbenchmark suite (the CUDA
             card unless --device cpu), upload it (POST /v1/calibrate),
             fit disclosed multipliers with train/holdout discipline
             server-side, register the fit, and price a tile sweep with
             and without it

The port's copy of ``examples/hardware_library.py``: list, show and diff
are the same host code and print the same lines; calibrate measures
through torch on the card where the reference measures its host through
JAX.

Run:  PYTHONPATH=src python examples_torch/hardware_library.py list
      PYTHONPATH=src python examples_torch/hardware_library.py show b200
      PYTHONPATH=src python examples_torch/hardware_library.py diff b200 h200
      PYTHONPATH=src python examples_torch/hardware_library.py calibrate
      PYTHONPATH=src python examples_torch/hardware_library.py calibrate \
          --device cpu
"""
import argparse

from repro_torch.core import hardware, hwlib


def cmd_list(args):
    print(f"{'name':14s} {'family':9s} {'units':>5s} "
          f"{'HBM GB':>7s} {'sust GB/s':>10s}  source")
    for name in sorted(hardware.REGISTRY):
        p = hardware.get(name)
        path = hwlib.library_file(name)
        src = ""
        if path is not None:
            entry = hwlib.load_file(path)
            if entry.params == p:
                src = entry.source.split(";")[0][:48]
        else:
            src = "(runtime registration)"
        print(f"{name:14s} {p.model_family:9s} {p.num_sms:5d} "
              f"{p.hbm_capacity / 1e9:7.0f} "
              f"{p.hbm_sustained_bw / 1e9:10.0f}  {src}")


def cmd_show(args):
    p = hardware.get(args.name)
    path = hwlib.library_file(args.name)
    entry = hwlib.load_file(path) if path else hwlib.HardwareEntry(params=p)
    print(f"{p.name}: {p.vendor} / {p.model_family}"
          + (f"  [{path}]" if path else "  [runtime registration]"))
    if entry.source:
        print(f"source: {entry.source}")
    if entry.notes:
        print(f"notes:  {entry.notes}")
    doc = hwlib.to_dict(p)
    for key in sorted(doc):
        tag = entry.provenance.get(key, "")
        unit = hwlib.FIELD_UNITS.get(key, "")
        print(f"  {key:28s} = {doc[key]!r:>40}  "
              f"{unit:8s} {('[' + tag + ']') if tag else ''}")


def cmd_diff(args):
    d = hwlib.diff(hardware.get(args.a), hardware.get(args.b))
    print(d.format())
    print(f"\nport touches {len(d.fields())} parameter field(s): "
          f"{', '.join(d.fields())}")


def cmd_calibrate(args):
    import numpy as np

    from repro_torch.core.microbench import base_params, \
        device_suite_result
    from repro_torch.core.workload import TileConfig, WorkloadTable, \
        gemm_workload
    from repro_torch.device import resolve_device
    from repro_torch.serve import PredictionClient
    from repro_torch.serve.subproc import (start_server_subprocess,
                                           stop_server_subprocess)

    device = resolve_device(args.device)
    hw_name = args.hw or base_params(device).name
    print(f"measuring the device microbenchmark suite on {device} "
          f"(quick=True, real timings through torch)...")
    suite = device_suite_result(quick=True, device=device)
    print(f"  {len(suite)} kernels measured: "
          f"{', '.join(w.name for w in suite.workloads[:4])}, ...")

    proc, host, port = start_server_subprocess()
    client = PredictionClient(host, port)
    try:
        print(f"server pid {proc.pid} at {host}:{port} -> "
              f"{client.health()['status']}")
        cal, report = client.calibrate(
            suite, hw_name, mode=args.mode, register_as="device_fit")
        print(f"server fitted mode={args.mode} against its own "
              f"predictions for '{hw_name}':")
        for key, mult in sorted(cal.disclose().items()):
            print(f"  {key:20s} {mult if isinstance(mult, list) else f'{mult:.4g}'}")
        print(f"  train MAE {report['train_mae']:.2f}%  "
              f"holdout MAE {report['holdout_mae']:.2f}%  "
              f"(n={report['n_train']:.0f}/{report['n_holdout']:.0f}, "
              f"skipped {report['n_skipped']:.0f})")

        tiles = [TileConfig(bm, bn, bk)
                 for bm in (64, 128, 256) for bn in (64, 128, 256)
                 for bk in (16, 32, 64)]
        table = WorkloadTable.tile_lattice(
            gemm_workload("port", 4096, 4096, 4096, precision="fp32"),
            tiles)
        raw = client.predict_totals(table, hw_name)
        calibrated = client.predict_totals(table, hw_name,
                                           calibration="device_fit")
        win = client.argmin(table, hw_name, calibration="device_fit")
        scale = float(np.median(calibrated / raw))
        print(f"priced {len(table)} tile configs on '{hw_name}': "
              f"calibrated totals = raw x {scale:.4f}; winner "
              f"{win.name} at {win.total * 1e3:.3f} ms")
    finally:
        client.close()
        stop_server_subprocess(proc)


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Browse, diff and served-calibrate the declarative "
                    "hardware library")
    sub = ap.add_subparsers(dest="cmd", required=True)
    sub.add_parser("list", help="every registry entry")
    show = sub.add_parser("show", help="one entry with provenance")
    show.add_argument("name")
    diffp = sub.add_parser("diff", help="field-level delta (the port)")
    diffp.add_argument("a")
    diffp.add_argument("b")
    calp = sub.add_parser(
        "calibrate",
        help="measure the device, upload, fit server-side, price with it")
    calp.add_argument("--device", default=None,
                      help="torch device to measure (default: the CUDA "
                           "card; 'cpu' measures the host)")
    calp.add_argument("--hw", default=None,
                      help="registry entry to fit against (default: the "
                           "measured device's, h100 or cpu_host)")
    calp.add_argument("--mode", default="class", choices=("case", "class"))
    args = ap.parse_args(argv)
    {"list": cmd_list, "show": cmd_show, "diff": cmd_diff,
     "calibrate": cmd_calibrate}[args.cmd](args)


if __name__ == "__main__":
    main()
