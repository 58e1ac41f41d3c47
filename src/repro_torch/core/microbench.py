"""Runnable microbenchmarks (paper §V-A) for the device we can actually
measure: the CUDA card, through PyTorch.  Counterpart of
``repro/core/microbench.py``, which measures the host's CPU through JAX.

The paper's loop is microbenchmark -> parameters -> predict -> validate.
On B200/MI300A we rely on the paper's published measurements; HERE we close
the loop with real timings: measure sustained GEMM throughput, streaming
bandwidth and dispatch overhead, then emit a calibrated ``h100_measured``
parameter file (``cpu_host_measured`` with ``device="cpu"``) that
core.blackwell (core.generic) / core.predict consume.

Everything uses the paper's measurement protocol (warmups, repeats, median
of a host clock; core.validate.measure_median).  Every timed call ends in a
device synchronise, so the host clock covers the launch and the work: the
model's predictions include ``launch_latency_s``, which CUDA events would
leave out.

Where the reference's lambdas are one ``jax.jit`` program each, eager
PyTorch would launch one kernel an op; the multi-op cases (poly_chain, the
stencil, ``measure_vector_flops``' chain) are compiled with
``torch.compile(fullgraph=True)``, the counterpart of ``jax.jit``, so that
their characterizations (one pass over the data) hold.  A compile that
fails raises.  fp32 products run with TF32 off.

Entry points take ``device=None`` for the card and raise without one;
``device="cpu"`` runs on the host.
"""
from __future__ import annotations

import contextlib
import functools
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Tuple

import torch

from ..device import DeviceLike, generator, maybe_synchronize, resolve_device
from ..kernels.matmul import kernel as matmul_kernel
from ..kernels.rmsnorm import kernel as rmsnorm_kernel
from . import hardware
from .hardware import HardwareParams, register
from .validate import measure_median


@dataclass
class MeasuredSuite:
    """One microbenchmark suite run: workloads + their measured medians.

    This is the calibration artifact that travels over the wire
    (``serve.codec.encode_suite``): a client measures kernels locally,
    ships the suite, and the server fits disclosed multipliers against
    its own predictions (paper §IV-D loop, served).  ``meta`` carries
    free-form floats about the run (repeats, warmups, ...).
    """

    name: str
    workloads: List["Workload"]
    measured_s: List[float]
    meta: Dict[str, float] = field(default_factory=dict)

    def __post_init__(self):
        if len(self.workloads) != len(self.measured_s):
            raise ValueError(
                f"suite {self.name!r}: {len(self.workloads)} workloads "
                f"vs {len(self.measured_s)} measurements")

    def __len__(self) -> int:
        return len(self.workloads)

    # ------------------------------------------------------- serialization
    def to_dict(self) -> Dict:
        return {"name": self.name,
                "workloads": [w.to_dict() for w in self.workloads],
                "measured_s": [float(t) for t in self.measured_s],
                "meta": dict(self.meta)}

    @staticmethod
    def from_dict(d: Dict) -> "MeasuredSuite":
        from .workload import Workload
        if not isinstance(d, dict):
            raise ValueError(f"suite payload must be a dict, got "
                             f"{type(d).__name__}")
        try:
            return MeasuredSuite(
                name=str(d["name"]),
                workloads=[Workload.from_dict(w) for w in d["workloads"]],
                measured_s=[float(t) for t in d["measured_s"]],
                meta={str(k): float(v)
                      for k, v in (d.get("meta") or {}).items()})
        except (KeyError, TypeError) as e:
            raise ValueError(f"bad suite payload: {e}") from None


DEFAULT_REPEATS = 15
DEFAULT_WARMUPS = 3


@dataclass(frozen=True)
class Sizes:
    """The working sizes of one run of the loop (the formulas of each
    case's characterization do not depend on them)."""

    calib_repeats: int
    calib_gemm_n: int            # measure_matmul_flops
    calib_stream_bytes: int      # measure_stream_bandwidth
    calib_vector_n: int          # measure_vector_flops
    calib_vector_fmas: int       # its chain's length, FMAs an element
    repeats: int                 # device_suite
    warmups: int
    vector_n: int                # vec_copy, vec_add, reduction
    transpose_n: int
    gemms: Tuple[int, ...]       # torch.matmul, fp32
    gemm_kernels: Tuple[int, ...]  # the hand-written matmul, fp32
    poly_n: int
    stencil_n: int
    rmsnorm_rows: int            # the hand-written rmsnorm, fp32
    rmsnorm_d: int


# quick=True: the reference's quick sizes (the CPU tests), plus small cases
# of the two hand-written kernels.
QUICK = Sizes(calib_repeats=7, calib_gemm_n=512, calib_stream_bytes=1 << 24,
              calib_vector_n=1 << 20, calib_vector_fmas=4, repeats=7,
              warmups=2,
              vector_n=1 << 22, transpose_n=1024, gemms=(256, 512),
              gemm_kernels=(256,), poly_n=1 << 20, stencil_n=512,
              rmsnorm_rows=1024, rmsnorm_d=256)
# quick=False: the card's set (an H100).  Every memory-class working set is
# well above the card's 50 MB L2: vectors of 1<<26 fp32 (256 MB), transpose
# and stencil grids of 8192^2 (256 MB), rmsnorm 65536 x 2560 (danube's
# d_model; 671 MB in).  The GEMMs span 2048-8192, where a product is
# operation-bound on the card.  The vector-FLOP chain is 512 FMAs an
# element: 1024 flops per 8 bytes moved, 128 flops a byte, over 5x the
# card's ridge (67e12 FLOP/s fp32 over 3.35e12 B/s is 20), so the CUDA
# cores and not HBM bound it; the reference's 4 FMAs (1 flop a byte) would
# measure HBM's rate there.
CARD = Sizes(calib_repeats=DEFAULT_REPEATS, calib_gemm_n=4096,
             calib_stream_bytes=1 << 28, calib_vector_n=1 << 26,
             calib_vector_fmas=512, repeats=30,
             warmups=10, vector_n=1 << 26, transpose_n=8192,
             gemms=(2048, 4096, 8192), gemm_kernels=(4096, 8192),
             poly_n=1 << 26, stencil_n=8192, rmsnorm_rows=65536,
             rmsnorm_d=2560)


def sizes(quick: bool) -> Sizes:
    return QUICK if quick else CARD


@contextlib.contextmanager
def full_fp32_products():
    """fp32 matrix products in full fp32 (TF32 off) inside the block."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def compiled(fn: Callable) -> Callable:
    """``fn`` as one compiled program: the counterpart of ``jax.jit``.
    ``fullgraph=True`` makes a graph break an error instead of a silent
    fallback to eager ops."""
    return torch.compile(fn, fullgraph=True)


def _synced(fn: Callable[[], torch.Tensor], dev: torch.device
            ) -> Callable[[], None]:
    def run():
        fn()
        maybe_synchronize(dev)
    return run


def _timed(fn: Callable[[], torch.Tensor], dev: torch.device, *,
           repeats: int, warmups: int) -> float:
    med, _ = measure_median(_synced(fn, dev), repeats=repeats,
                            warmups=warmups)
    return med


def measure_matmul_flops(n: int = 1024, *, dtype=torch.float32,
                         repeats: int = DEFAULT_REPEATS,
                         warmups: int = DEFAULT_WARMUPS,
                         device: DeviceLike = None) -> float:
    """Sustained matrix FLOP/s: the tensor-throughput microbenchmark
    (``torch.matmul``, TF32 off)."""
    dev = resolve_device(device)
    gen = generator(0, dev)
    a = torch.randn((n, n), generator=gen, device=dev, dtype=dtype)
    b = torch.randn((n, n), generator=gen, device=dev, dtype=dtype)
    with full_fp32_products():
        _synced(lambda: torch.matmul(a, b), dev)()
        t = _timed(lambda: torch.matmul(a, b), dev, repeats=repeats,
                   warmups=warmups)
    return 2.0 * n ** 3 / t


def measure_stream_bandwidth(nbytes: int = 1 << 26, *,
                             repeats: int = DEFAULT_REPEATS,
                             warmups: int = DEFAULT_WARMUPS,
                             device: DeviceLike = None) -> float:
    """Sustained memory bandwidth via vector copy (2 bytes moved per
    element byte: read + write)."""
    dev = resolve_device(device)
    n = nbytes // 4
    x = torch.arange(n, dtype=torch.float32, device=dev)
    _synced(lambda: x + 1.0, dev)()
    t = _timed(lambda: x + 1.0, dev, repeats=repeats, warmups=warmups)
    return 2.0 * nbytes / t


def measure_launch_latency(*, repeats: int = 50, warmups: int = 10,
                           device: DeviceLike = None) -> float:
    """Dispatch overhead: time an O(1) program (one launch and the wait for
    it)."""
    dev = resolve_device(device)
    x = torch.tensor(1.0, dtype=torch.float32, device=dev)
    _synced(lambda: x * 2.0, dev)()
    return _timed(lambda: x * 2.0, dev, repeats=repeats, warmups=warmups)


def _vector_chain(v, fmas: int):
    for _ in range(fmas):
        v = v * 1.0001 + 0.5
    return v


def vector_chain_flops(n: int, fmas: int) -> float:
    """Flops of one pass of the vector chain: two an FMA, ``fmas`` of them
    on each of ``n`` elements."""
    return 2.0 * fmas * n


def measure_vector_flops(n: int = 1 << 22, *, fmas: int = 4,
                         repeats: int = DEFAULT_REPEATS,
                         warmups: int = DEFAULT_WARMUPS,
                         device: DeviceLike = None) -> float:
    """Non-matrix FLOP throughput: a fused elementwise chain of ``fmas``
    dependent multiply-adds on each of ``n`` fp32 elements, one compiled
    program that reads and writes each element once (the reference's chain
    is 4 FMAs, 8 flops an element).  The rate is counted from the chain's
    own length, ``vector_chain_flops(n, fmas) / t``."""
    dev = resolve_device(device)
    x = torch.ones((n,), dtype=torch.float32, device=dev)
    # The length is a constant of the compiled program (the loop unrolls).
    f = compiled(functools.partial(_vector_chain, fmas=fmas))
    _synced(lambda: f(x), dev)()                       # compile
    t = _timed(lambda: f(x), dev, repeats=repeats, warmups=warmups)
    return vector_chain_flops(n, fmas) / t


# The card ``hwdata/h100.json`` describes: the SXM5 H100 (HBM3, 132 SMs).
# The PCIe and NVL H100s have other memory rates and clocks.
H100_SXM_NAME = "NVIDIA H100 80GB HBM3"


def base_params(device: DeviceLike = None) -> HardwareParams:
    """The parameter file the measurements update: ``h100`` on the card,
    ``cpu_host`` on the host.  Raises on any card but the SXM5 H100 that
    ``h100.json`` describes (other H100 variants included): its datasheet
    values would price another card."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return hardware.get("cpu_host")
    if dev.type != "cuda":
        raise ValueError(f"the loop runs on cpu or cuda, not {dev}")
    h100 = hardware.get("h100")
    name = torch.cuda.get_device_name(dev)
    sms = (torch.cuda.get_device_properties(dev).multi_processor_count
           if name == H100_SXM_NAME else None)
    if sms != h100.num_sms:
        raise RuntimeError(f"calibration starts from the parameter file of "
                           f"the {H100_SXM_NAME!r} ({h100.num_sms} SMs) and "
                           f"this card is {name!r}"
                           + (f" with {sms} SMs" if sms is not None else "")
                           + "; add its own file to core/hwdata first")
    return h100


def calibrate_device(*, quick: bool = True,
                     device: DeviceLike = None) -> HardwareParams:
    """Run all microbenchmarks on the device and return a measured parameter
    file (registered as '<base>_measured': 'h100_measured' on the card,
    'cpu_host_measured' with ``device="cpu"``).  The update formulas are
    the reference's ``calibrate_host``."""
    dev = resolve_device(device)
    base = base_params(dev)
    sz = sizes(quick)
    reps = sz.calib_repeats

    mat = measure_matmul_flops(sz.calib_gemm_n, repeats=reps, device=dev)
    bw = measure_stream_bandwidth(sz.calib_stream_bytes, repeats=reps,
                                  device=dev)
    vec = measure_vector_flops(sz.calib_vector_n, fmas=sz.calib_vector_fmas,
                               repeats=reps, device=dev)
    launch = measure_launch_latency(device=dev)

    hw = base.with_updates(
        name=f"{base.name}_measured",
        tensor_peak_flops={"fp32": mat * 1.15, "fp64": mat * 0.6},
        tensor_sustained_flops={"fp32": mat, "fp64": mat * 0.5},
        vector_peak_flops={"fp32": vec * 1.15},
        vector_sustained_flops={"fp32": vec},
        hbm_peak_bw=bw * 1.2,
        hbm_sustained_bw=bw,
        launch_latency_s=launch,
        working_set_scale_bytes=0.0,  # disable Eq. 16 blend (caches
                                      # already folded into sustained number)
    )
    # overwrite: re-calibration legitimately replaces the previous run
    register(hw, overwrite=True)
    return hw


# ---------------------------------------------------------------------------
# The device validation suite: real kernels with real measured medians.
# Mirrors the paper's workload classes (Table IX).
# ---------------------------------------------------------------------------

def _poly(v):
    for _ in range(8):
        v = v * v + 0.1
    return v


def _stencil(g):
    return (g
            + 0.1 * (torch.roll(g, 1, 0) + torch.roll(g, -1, 0)
                     + torch.roll(g, 1, 1) + torch.roll(g, -1, 1)
                     - 4.0 * g))


def suite_cases(*, quick: bool = True, device: DeviceLike = None
                ) -> List[Tuple["Workload", Callable[[], torch.Tensor]]]:
    """The suite's (workload, call) pairs, built but not run: each call
    returns the case's output and does not synchronise.  Nothing is
    compiled or launched until a call is made.

    Classes: memory-bound (copy/add/transpose/reduction, the hand-written
    rmsnorm), compute-bound (GEMMs: ``torch.matmul`` and the hand-written
    matmul), balanced (elementwise-heavy), stencil (2D 5-point)."""
    from .workload import Workload

    dev = resolve_device(device)
    sz = sizes(quick)
    gen = generator(0, dev)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.float32)

    cases = []  # (workload, call)

    # --- memory-bound -----------------------------------------------------
    n = sz.vector_n
    x = torch.arange(n, dtype=torch.float32, device=dev)
    y = torch.ones((n,), dtype=torch.float32, device=dev)
    cases.append((Workload(name="vec_copy", wclass="memory", flops=0.0,
                           bytes=8.0 * n, precision="fp32",
                           working_set_bytes=8.0 * n),
                  lambda: x * 1.0))
    cases.append((Workload(name="vec_add", wclass="memory", flops=float(n),
                           bytes=12.0 * n, precision="fp32",
                           working_set_bytes=12.0 * n),
                  lambda: x + y))
    cases.append((Workload(name="reduction", wclass="memory", flops=float(n),
                           bytes=4.0 * n, precision="fp32",
                           working_set_bytes=4.0 * n),
                  lambda: torch.sum(x)))
    m2 = sz.transpose_n
    t2 = randn(m2, m2)
    # x.t() + 0.0 keeps the input's strides in PyTorch (a plain copy); the
    # case writes the transpose out as a contiguous (N, M) tensor.
    cases.append((Workload(name="transpose_2d", wclass="memory",
                           flops=float(m2 * m2), bytes=8.0 * m2 * m2,
                           precision="fp32",
                           working_set_bytes=8.0 * m2 * m2),
                  lambda: t2.t().contiguous()))
    rr, rd = sz.rmsnorm_rows, sz.rmsnorm_d
    xr, wr = randn(rr, rd), randn(rd)
    cases.append((Workload(name="rmsnorm_kernel", wclass="memory",
                           flops=4.0 * rr * rd, bytes=8.0 * rr * rd + 4.0 * rd,
                           precision="fp32",
                           working_set_bytes=8.0 * rr * rd + 4.0 * rd),
                  lambda: rmsnorm_kernel.rmsnorm_2d(xr, wr)))

    # --- compute-bound ----------------------------------------------------
    for gn in sz.gemms:
        a, b = randn(gn, gn), randn(gn, gn)
        # repro: allow[SWEEP-LOOP] one named, measured case per size: a
        # characterization list, not a sweep (nothing here is priced)
        cases.append((Workload(name=f"gemm_{gn}", wclass="compute",
                               flops=2.0 * gn ** 3, bytes=12.0 * gn * gn,
                               precision="fp32", matrix=True,
                               working_set_bytes=12.0 * gn * gn),
                      (lambda a=a, b=b: torch.matmul(a, b))))
    for gn in sz.gemm_kernels:
        a, b = randn(gn, gn), randn(gn, gn)
        # repro: allow[SWEEP-LOOP] one named, measured case per size: a
        # characterization list, not a sweep (nothing here is priced)
        cases.append((Workload(name=f"gemm_kernel_{gn}", wclass="compute",
                               flops=2.0 * gn ** 3, bytes=12.0 * gn * gn,
                               precision="fp32", matrix=True,
                               working_set_bytes=12.0 * gn * gn),
                      (lambda a=a, b=b: matmul_kernel.matmul_tiled(a, b))))

    # --- balanced ----------------------------------------------------------
    nb = sz.poly_n
    xb = torch.linspace(0.0, 1.0, nb, dtype=torch.float32, device=dev)
    fb = compiled(_poly)
    cases.append((Workload(name="poly_chain", wclass="balanced",
                           flops=16.0 * nb, bytes=8.0 * nb, precision="fp32",
                           working_set_bytes=8.0 * nb),
                  lambda: fb(xb)))

    # --- stencil -----------------------------------------------------------
    sg = sz.stencil_n
    grid = randn(sg, sg)
    fs = compiled(_stencil)
    cases.append((Workload(name="hotspot_like_stencil", wclass="stencil",
                           flops=7.0 * sg * sg, bytes=8.0 * sg * sg,
                           precision="fp32", working_set_bytes=8.0 * sg * sg),
                  lambda: fs(grid)))
    return cases


def device_suite(*, quick: bool = True, device: DeviceLike = None):
    """Returns (workloads, measured_seconds) for the device.

    Each case runs once first (which compiles the compiled cases and builds
    the hand-written kernels), then ``warmups`` + ``repeats`` timed calls,
    each ending in a device synchronise."""
    dev = resolve_device(device)
    sz = sizes(quick)
    workloads, measured = [], []
    with full_fp32_products():
        cases = suite_cases(quick=quick, device=dev)
        for _, call in cases:
            _synced(call, dev)()
        for w, call in cases:
            workloads.append(w)
            measured.append(_timed(call, dev, repeats=sz.repeats,
                                   warmups=sz.warmups))
    return workloads, measured


def device_suite_result(*, quick: bool = True,
                        device: DeviceLike = None) -> MeasuredSuite:
    """``device_suite`` packaged as a wire-shippable :class:`MeasuredSuite`
    (the payload ``PredictionClient.calibrate`` uploads)."""
    workloads, measured = device_suite(quick=quick, device=device)
    return MeasuredSuite(name="device_suite", workloads=workloads,
                         measured_s=measured,
                         meta={"quick": 1.0 if quick else 0.0})

