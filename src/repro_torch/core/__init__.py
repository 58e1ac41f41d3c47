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
    collectives.MeshSpec / collective_time     mesh collective costs
    sweep.SweepEngine                          batched + memoized prediction
    workload.WorkloadTable                     columnar sweep batches
    workload.LatticeSpec                       lazy sweep lattices (chunked)
    sweep.argmin_table / topk_table            fused sweep reductions
    sweep.argmin_stream / topk_stream          streaming fused reductions
    parallel.reduce_sharded                    multi-worker sweep pricing
    microbench.calibrate_device                real card microbenchmarks

Not ported yet (ROADMAP.md, Queue A): ``autotune``, ``segments``,
``suites``.
"""
from . import (blackwell, cache, calibrate, cdna3, collectives, generic,
               hardware, microbench, parallel, predict, roofline, sweep, tpu,
               validate, workload)

__all__ = [
    "blackwell", "cache", "calibrate", "cdna3", "collectives", "generic",
    "hardware", "microbench", "parallel", "predict", "roofline", "sweep",
    "tpu", "validate", "workload",
]
