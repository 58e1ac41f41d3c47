"""repro_torch.core — the port's copy of the paper's contribution:
microbenchmark-driven analytical GPU/TPU performance models.

The numpy model (everything but ``microbench``) is a verbatim copy of
``repro.core``: only import lines differ, plus one deliberate change in
``parallel._mp_context`` (fork is refused once ``torch`` is loaded, where
the reference names ``jax``).  ``microbench`` is rewritten in torch and
measures the CUDA card.

Public API:
    hardware.get(name) / hardware.REGISTRY     parameter files
    workload.Workload / Segment                characterization schema
    predict.predict(w, hw)                     unified routed prediction
    roofline.predict(w, hw)                    naive baseline
    blackwell / cdna3 / tpu / generic          per-architecture models
    calibrate.Calibration / fit_*              disclosed multipliers
    validate.validate_suite                    MAE harness
    segments.predict_app                       multi-segment applications
    collectives.MeshSpec / collective_time     mesh collective costs
    autotune.select_plan / select_tile         model-driven plan and tile
                                               selection
    suites                                     the paper's published suites
                                               (Tables VI, X, XI, XII)
    sweep.SweepEngine                          batched + memoized prediction
    workload.WorkloadTable                     columnar sweep batches
    workload.LatticeSpec                       lazy sweep lattices (chunked)
    sweep.argmin_table / topk_table            fused sweep reductions
    sweep.argmin_stream / topk_stream          streaming fused reductions
    parallel.reduce_sharded                    multi-worker sweep pricing
    microbench.calibrate_device                real card microbenchmarks

``autotune``'s defaults name ``TPU_V5E``, as the reference's do: a caller
on the card passes ``hw`` (``kernels/matmul/ops.select_blocks`` does).
``suites`` holds the paper's published and reconstructed tables for B200,
MI300A, H200 and MI250X; no number in it was measured on this card.
"""
from . import (autotune, blackwell, cache, calibrate, cdna3, collectives,
               generic, hardware, parallel, predict, roofline, segments,
               sweep, tpu, validate, workload)

__all__ = [
    "autotune", "blackwell", "cache", "calibrate", "cdna3", "collectives",
    "generic", "hardware", "microbench", "parallel", "predict", "roofline",
    "segments", "sweep", "tpu", "validate", "workload",
]


def __getattr__(name):
    # microbench imports torch; keep it lazy so pure-model users (the
    # prediction server) stay light.
    if name == "microbench":
        import importlib
        mod = importlib.import_module(".microbench", __name__)
        globals()["microbench"] = mod
        return mod
    raise AttributeError(name)
