"""Hardware parameter registry.

Every coefficient in the analytical models is tied either to a
microbenchmark measurement or a vendor datasheet (paper Tables II and VII).
This module is the single source of truth for those values.

Since PR 6 the values themselves live as **data files** under
``core/hwdata/*.json`` (one schema-validated document per accelerator —
see ``core/hwlib.py`` for the schema, loader and diff tool), loaded
lazily by the registry below.  Adding an accelerator is a data entry,
not a code change: the paper's B200→H200 / MI300A→MI250X ports swap
parameter files, not formulas (Obs. 6, §V-E).

Parameter files distinguish PEAK (datasheet) from SUSTAINED (microbenchmark)
values for bandwidth and compute throughput, per paper §V-A ("Datasheet peaks
are not the sole inputs for validation"); each file's ``provenance``
section mirrors paper Table II's Source column.

Units: seconds, bytes, FLOP/s, bytes/s unless suffixed otherwise.

The classic preset names (``hardware.B200`` ... ``hardware.CPU_HOST``)
remain importable; they resolve through the registry, so every caller
shares one instance per entry (which keeps ``core.sweep.hardware_key``'s
per-instance token stash effective).
"""
from __future__ import annotations

import dataclasses
import os
import threading
from collections.abc import MutableMapping
from dataclasses import dataclass, field
from typing import Dict, Iterator, Optional

# ---------------------------------------------------------------------------
# Precision handling
# ---------------------------------------------------------------------------

BYTES_PER_ELEM = {
    "fp64": 8,
    "fp32": 4,
    "tf32": 4,
    "bf16": 2,
    "fp16": 2,
    "fp8": 1,
    "int8": 1,
    "fp6": 0.75,
    "fp4": 0.5,
}


@dataclass(frozen=True)
class CacheLevel:
    """One level of the memory hierarchy (paper Eq. 10 walk)."""

    name: str
    capacity_bytes: float
    latency_cycles: float
    bandwidth: float  # bytes/s, sustained


@dataclass(frozen=True)
class HardwareParams:
    """Parameter file for one accelerator.

    Fields map 1:1 onto paper Tables II / VII rows; the data file's
    ``provenance`` section records whether each came from a microbenchmark
    or a datasheet (Table II's Source column) for audit.
    """

    name: str
    vendor: str                      # "nvidia" | "amd" | "google" | "host"
    model_family: str                # "blackwell" | "cdna" | "tpu" | "generic"

    # --- compute units -----------------------------------------------------
    num_sms: int                     # SMs / CUs / TensorCores-per-chip
    warp_size: int
    max_resident_warps: int          # per SM/CU (microbench)
    clock_ghz: float

    # --- matrix-unit throughput: peak (datasheet) and sustained (microbench)
    # keyed by precision string.  FLOP/s for the WHOLE chip.
    tensor_peak_flops: Dict[str, float]
    tensor_sustained_flops: Dict[str, float]
    # vector (non-matrix) path throughput, FLOP/s whole chip
    vector_peak_flops: Dict[str, float] = field(default_factory=dict)
    vector_sustained_flops: Dict[str, float] = field(default_factory=dict)

    # --- memory ------------------------------------------------------------
    hbm_peak_bw: float = 0.0         # datasheet
    hbm_sustained_bw: float = 0.0    # microbench
    hbm_capacity: float = 0.0
    cache_levels: tuple = ()         # tuple[CacheLevel, ...] L1->LLC order
    hbm_latency_cycles: float = 0.0

    # --- accumulator / scratch space (TMEM on B200, LDS on MI300A, VMEM on TPU)
    accum_capacity_bytes: float = 0.0     # per SM/CU/core
    accum_read_bw: float = 0.0            # bytes/s whole chip (TMEM read)
    accum_write_bw: float = 0.0           # bytes/s whole chip (TMEM write)

    # --- Blackwell stage-model coefficients (microbench, Table VII) --------
    tma_latency_cycles: float = 0.0       # L_TMA = 420 cyc
    tma_bandwidth: float = 0.0            # B_TMA bytes/s
    mma_latency_cycles: float = 0.0       # tcgen05.mma 11-14 cyc
    mbarrier_latency_cycles: float = 0.0  # L_mbar 40-50 cyc
    commit_latency_cycles: float = 0.0    # L_commit
    decomp_engine_rate: float = 0.0       # R_DE bytes/s
    decomp_efficiency: float = 0.9        # eta_DE
    two_sm_speedup: float = 1.0           # S_2SM measured
    tmem_alloc_latency_s: float = 0.0     # L_alloc + L_dealloc (amortized)

    # --- CDNA wavefront-model coefficients ---------------------------------
    vgpr_per_cu: int = 0                  # 65536 on CDNA3
    llc_transition_alpha: float = 1.0     # Table III alpha
    llc_transition_beta: float = 1.0      # Table III beta
    llc_resident_mb: float = 205.0        # Table III boundary
    llc_capacity_mb: float = 256.0
    coherence_latency_s: float = 0.0      # 100-200 ns
    cross_xcd_latency_s: float = 0.0      # 50-100 ns NUMA
    mfma_utilization: float = 0.55        # Table IV: Util 0.4-0.7

    # --- interference / concurrency (paper §IV-A6, §IV-B) ------------------
    tau_interference_s: float = 0.0       # per extra concurrent kernel (50us MI300A)
    tau_interference_gpu_s: float = 0.0   # per extra device
    tau_fusion_s: float = 0.0             # fusion overhead

    # --- launch / host ------------------------------------------------------
    launch_latency_s: float = 5e-6        # kernel launch overhead
    h2d_bandwidth: float = 45e9           # B_eff H2D (Table VII default)
    d2h_bandwidth: float = 45e9
    tau_memcpy_s: float = 2e-6            # Table VII defaults
    tau_sync_s: float = 3e-6

    # --- generic-path knobs (paper §IV-F) -----------------------------------
    working_set_scale_bytes: float = 0.0  # w0 in Eq. 16; <=0 disables blend
    class_scales: Dict[str, float] = field(
        default_factory=lambda: {
            "memory": 1.0, "compute": 1.0, "balanced": 1.0, "stencil": 1.0}
    )
    precision_efficiency: Dict[str, float] = field(default_factory=dict)

    # --- interconnect (TPU extension; absent from the paper) ----------------
    ici_link_bw: float = 0.0              # bytes/s per link per direction
    ici_links_per_axis: int = 1
    dci_link_bw: float = 0.0              # cross-pod link
    pipeline_overlap_alpha: float = 0.9   # paper alpha in [0.85, 0.95]

    def cycles_to_seconds(self, cycles: float) -> float:
        return cycles / (self.clock_ghz * 1e9)

    def peak_flops(self, precision: str = "fp16", matrix: bool = True) -> float:
        if precision not in BYTES_PER_ELEM:
            raise KeyError(
                f"no peak flops for {precision!r} on {self.name}: unknown "
                f"precision (known: {sorted(BYTES_PER_ELEM)})")
        table = self.tensor_peak_flops if matrix else self.vector_peak_flops
        if precision in table:
            return table[precision]
        # fall back: scale from a known precision by byte ratio (wider = slower)
        if matrix and self.tensor_peak_flops:
            base_prec, base = next(iter(self.tensor_peak_flops.items()))
            return base * BYTES_PER_ELEM[base_prec] / BYTES_PER_ELEM[precision]
        raise KeyError(f"no peak flops for {precision} on {self.name}")

    def sustained_flops(self, precision: str = "fp16", matrix: bool = True) -> float:
        table = (self.tensor_sustained_flops if matrix
                 else self.vector_sustained_flops)
        if precision in table:
            return table[precision]
        return self.peak_flops(precision, matrix)

    def with_updates(self, **kw) -> "HardwareParams":
        """Parameter-file portability (paper Obs. 6): new GPU = new values,
        same formulas."""
        return dataclasses.replace(self, **kw)

    def __getstate__(self):
        """Strip process-local caches before pickling.

        ``core.sweep.hardware_key`` stashes its interned ``(name, id)``
        content token on the instance; the token is only meaningful
        against the interning process's own table.  Default pickling
        would ship it to spawn/forkserver workers (``core.parallel``,
        the serve worker pool), where a fresh intern table hands out the
        same ids for *different* parameter content — a stale inherited
        token could then collide with a live one and mix cache entries
        across hardware.  Workers must always re-derive the token from
        content."""
        return {k: v for k, v in self.__dict__.items()
                if k != "_sweep_content_token"}


# ---------------------------------------------------------------------------
# The registry: lazily backed by core/hwdata/*.json.
# ---------------------------------------------------------------------------

DATA_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "hwdata")


class _LazyRegistry(MutableMapping):
    """name -> HardwareParams, loading data files on first access.

    Iteration and membership see the union of already-loaded/registered
    entries and the on-disk library without parsing any file; an entry's
    JSON is validated and decoded exactly once (``get()`` then always
    returns that same instance, which keeps the sweep cache's
    per-instance token stash effective).  Thread-safe; the data directory
    is scanned once per process.
    """

    def __init__(self, data_dir: str = DATA_DIR):
        self._data_dir = data_dir
        self._loaded: Dict[str, HardwareParams] = {}
        self._files: Optional[Dict[str, str]] = None
        self._removed: set = set()
        self._lock = threading.RLock()

    def _scan(self) -> Dict[str, str]:
        files = self._files
        if files is None:
            files = {}
            if os.path.isdir(self._data_dir):
                for fn in sorted(os.listdir(self._data_dir)):
                    if fn.endswith(".json"):
                        files[fn[:-5]] = os.path.join(self._data_dir, fn)
            self._files = files
        return files

    def __getitem__(self, name: str) -> HardwareParams:
        with self._lock:
            p = self._loaded.get(name)
            if p is not None:
                return p
            if name in self._removed:
                raise KeyError(name)
            path = self._scan().get(name)
            if path is None:
                raise KeyError(name)
            from . import hwlib  # deferred: hwlib imports this module
            p = hwlib.load_file(path).params
            self._loaded[name] = p
            return p

    def __setitem__(self, name: str, params: HardwareParams) -> None:
        with self._lock:
            self._removed.discard(name)
            self._loaded[name] = params

    def __delitem__(self, name: str) -> None:
        with self._lock:
            if name not in self:
                raise KeyError(name)
            self._loaded.pop(name, None)
            if name in self._scan():
                self._removed.add(name)   # tombstone the file-backed entry

    def __contains__(self, name) -> bool:
        with self._lock:
            if name in self._loaded:
                return True
            return name not in self._removed and name in self._scan()

    def __iter__(self) -> Iterator[str]:
        with self._lock:
            names = (set(self._loaded) | set(self._scan())) - self._removed
        return iter(sorted(names))

    def __len__(self) -> int:
        with self._lock:
            return len((set(self._loaded) | set(self._scan()))
                       - self._removed)


REGISTRY: MutableMapping = _LazyRegistry()

# fork() clones one thread: another thread mid-load would leave the
# child's registry lock held forever (the FORK-LOCK contract).  Loaded
# params are immutable so the child keeps them; only the lock re-inits.
os.register_at_fork(
    after_in_child=lambda: setattr(REGISTRY, "_lock", threading.RLock()))


def get(name: str) -> HardwareParams:
    try:
        return REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown hardware '{name}'; known: {sorted(REGISTRY)}") from None


def register(params: HardwareParams, *, overwrite: bool = False) -> None:
    """Add a parameter file to the registry.

    Collisions raise: a typo'd or malicious entry must not silently
    shadow a shipped one (``b200`` et al. count — the library's data
    files are part of the namespace even before they're loaded).  Pass
    ``overwrite=True`` for intentional replacement, e.g. re-registering
    a re-calibrated ``cpu_host_measured``.
    """
    if not isinstance(params, HardwareParams):
        raise TypeError(f"register() takes a HardwareParams, got "
                        f"{type(params).__name__}")
    if not overwrite and params.name in REGISTRY:
        raise ValueError(
            f"hardware '{params.name}' is already registered; pass "
            f"overwrite=True to replace it")
    REGISTRY[params.name] = params


# Classic preset attribute names resolve through the registry (module
# ``__getattr__``): ``hardware.B200`` lazy-loads hwdata/b200.json once.
_PRESET_ATTRS = {
    "B200": "b200", "H200": "h200", "MI300A": "mi300a",
    "MI250X": "mi250x", "TPU_V5E": "tpu_v5e", "CPU_HOST": "cpu_host",
}


def __getattr__(name: str):
    key = _PRESET_ATTRS.get(name)
    if key is not None:
        return get(key)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
