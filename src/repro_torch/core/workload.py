"""Workload / segment schema.

The paper characterizes every kernel or application segment by FLOPs, bytes,
class, tile geometry, working set and execution count, then routes it to the
appropriate model path (§IV-D workflow step 1, §V-B Rodinia segment files).

``Workload`` is a single kernel-level description; ``Segment`` wraps it with
an execution count and optional host phases (memcpy/sync, paper §IV-E);
applications are lists of Segments (``core/segments.py``).
"""
from __future__ import annotations

import dataclasses
import hashlib
import struct
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

VALID_CLASSES = ("memory", "compute", "balanced", "stencil")

#: default streaming chunk (rows) — ~1.7 MB of columns so chunk + result
#: columns stay LLC-resident (measured optimum: 8192-row chunks stream a
#: 1M-row lattice ~4x faster than materialize-then-reduce, which pays a
#: DRAM round-trip per column op; see benchmarks/sweep_bench.py), while
#: still amortizing per-chunk NumPy dispatch to noise.
DEFAULT_CHUNK_ROWS = 8_192

#: hard ceiling on one-shot materialization (``LatticeSpec.materialize`` /
#: ``WorkloadTable.cartesian``): beyond this the cartesian product is a
#: host-OOM, not a table.  Streaming (``LatticeSpec.chunks`` + the
#: ``core.sweep`` *_stream reductions) has no such bound.
MAX_MATERIALIZE_ROWS = 2 ** 31

# Layout of the packed numeric vector stashed on every Workload (column
# indices into the float64 matrix the batch backends build with one
# zero-copy np.frombuffer over the concatenated per-workload buffers).
# This is also the column layout of ``WorkloadTable.cols`` — the two forms
# are interconvertible row-for-row, byte-for-byte.
NV_FLOPS, NV_BYTES, NV_WS_OR_BYTES, NV_WS, NV_IRREGULAR, NV_CONCURRENT, \
    NV_DEVICES, NV_K_TILES, NV_NUM_CTAS, NV_BYTES_PER_CTA, NV_TMA_P, \
    NV_COMP_BYTES, NV_COMP_RATIO, NV_VGPR, NV_MATRIX, NV_HAS_GEMM, \
    NV_GM, NV_GN, NV_GK, NV_GMN, NV_BM, NV_BN, NV_BK, \
    NV_NUM_LOADS, NV_ATOMICS, NV_HAS_TILE = range(26)

NV_COLS = 26

_NVEC_PACK = struct.Struct(f"{NV_COLS}d").pack


@dataclass(frozen=True)
class TileConfig:
    """GEMM-style tile geometry (bM, bN, bK per CTA; paper Eq. 3)."""

    bm: int = 128
    bn: int = 128
    bk: int = 32

    @property
    def flops_per_tile_step(self) -> float:
        # one K-step of an MMA tile: 2*bM*bN*bK
        return 2.0 * self.bm * self.bn * self.bk

    def accum_bytes(self, accum_bytes_per_elem: float = 4.0) -> float:
        # accumulator tile resident in TMEM/VGPR: bM x bN
        return self.bm * self.bn * accum_bytes_per_elem


_DEFAULT_TILE = TileConfig()


@dataclass(frozen=True)
class GemmShape:
    m: int
    n: int
    k: int

    @property
    def flops(self) -> float:
        return 2.0 * self.m * self.n * self.k

    def bytes_moved(self, in_bytes: float, out_bytes: float) -> float:
        return (self.m * self.k + self.k * self.n) * in_bytes + \
            self.m * self.n * out_bytes


@dataclass(frozen=True)
class Workload:
    """One kernel: the model's unit of prediction.

    Required inputs per paper §IV-G: for Blackwell, tile dims, K_tiles, bytes
    per CTA, TMA participants P, alpha; for MI300A, tile dims, K_tiles,
    bytes, hit rates, occupancy.  All optional fields default to values that
    route the workload through the generic path.
    """

    name: str
    wclass: str                      # memory | compute | balanced | stencil
    flops: float                     # total FLOPs (profiler- or FP-derived)
    bytes: float                     # total bytes moved to/from HBM
    precision: str = "fp32"
    matrix: bool = False             # uses tensor/matrix units?
    working_set_bytes: float = 0.0   # W for h_LLC(W) / B_eff(W)

    # --- tiled-GEMM path inputs (Blackwell stage model / MI300A tile model)
    gemm: Optional[GemmShape] = None
    tile: Optional[TileConfig] = None
    num_ctas: int = 0                # grid size (Eq. 14)
    k_tiles: int = 0                 # K-step count per CTA
    tma_participants: int = 1        # multicast P (Eq. 4)
    bytes_per_cta: float = 0.0

    # --- MI300A occupancy inputs
    vgpr_per_workitem: int = 64      # -> VGPR per wavefront = 64*vgpr
    hit_rates: Dict[str, float] = field(default_factory=dict)  # h_l1,h_l2,h_llc
    num_loads: float = 0.0           # N_loads for Eq. 10 latency walk

    # --- decompression (Blackwell Eq. 5)
    compressed_bytes: float = 0.0
    compression_ratio: float = 1.0

    # --- irregularity flags (paper Obs. 2: accuracy boundary)
    irregular: bool = False          # pointer-chasing / data-dependent access
    atomics: bool = False

    # --- concurrency (paper §IV-A6 / §IV-B)
    concurrent_kernels: int = 1
    num_devices: int = 1

    def __post_init__(self):
        if self.wclass not in VALID_CLASSES:
            raise ValueError(
                f"workload class {self.wclass!r} not in {VALID_CLASSES}")
        if self.flops < 0 or self.bytes < 0:
            raise ValueError("flops/bytes must be non-negative")

    @property
    def _nvec(self) -> bytes:
        """Packed NV_COLS-double numeric vector, memoized on the (frozen)
        instance.  Lazy so plain construction / ``replace()`` round-trips do
        not pay the struct repack; the buffer is built once on first use by
        the batch backends or the engine's content keys."""
        buf = self.__dict__.get("_nvec_buf")
        if buf is None:
            g, t = self.gemm, self.tile
            buf = _NVEC_PACK(
                self.flops, self.bytes,
                self.working_set_bytes or self.bytes, self.working_set_bytes,
                self.irregular, self.concurrent_kernels, self.num_devices,
                self.k_tiles, self.num_ctas, self.bytes_per_cta,
                self.tma_participants, self.compressed_bytes,
                self.compression_ratio, self.vgpr_per_workitem,
                self.matrix, g is not None,
                g.m if g is not None else 0, g.n if g is not None else 0,
                g.k if g is not None else 0,
                g.m * g.n if g is not None else 0,
                (t or _DEFAULT_TILE).bm, (t or _DEFAULT_TILE).bn,
                (t or _DEFAULT_TILE).bk,
                self.num_loads, self.atomics, t is not None)
            object.__setattr__(self, "_nvec_buf", buf)
        return buf

    @property
    def arithmetic_intensity(self) -> float:
        return self.flops / max(self.bytes, 1.0)

    def replace(self, **kw) -> "Workload":
        return dataclasses.replace(self, **kw)

    # ------------------------------------------------------- serialization
    def to_dict(self) -> Dict:
        """JSON-safe dict of every field (nested GemmShape/TileConfig as
        dicts) — the wire form ``repro.serve.codec`` ships spec bases in."""
        return dataclasses.asdict(self)

    @staticmethod
    def from_dict(d: Dict) -> "Workload":
        """Inverse of ``to_dict`` (tolerates the plain dicts json emits)."""
        d = dict(d)
        if d.get("gemm") is not None:
            d["gemm"] = GemmShape(**d["gemm"])
        if d.get("tile") is not None:
            d["tile"] = TileConfig(**d["tile"])
        d["hit_rates"] = dict(d.get("hit_rates") or {})
        return Workload(**d)


@dataclass(frozen=True)
class HostPhase:
    """Host-device transfer or sync episode (paper Eq. 15, §IV-E)."""

    kind: str                        # "h2d" | "d2h" | "sync"
    bytes: float = 0.0
    count: int = 1


@dataclass(frozen=True)
class Segment:
    """One application segment: a kernel repeated n_exec times plus host
    phases (paper §V-B 'Rodinia multi-segment modeling')."""

    workload: Workload
    n_exec: int = 1
    host_phases: Tuple[HostPhase, ...] = ()
    extra_kernels: int = 0           # multi-kernel segments (paper §IV-F)

    def __post_init__(self):
        if self.n_exec < 0:
            raise ValueError("n_exec must be >= 0")


@dataclass(frozen=True)
class TimeBreakdown:
    """Prediction output: total + per-stage terms (all seconds)."""

    total: float
    compute: float = 0.0
    memory: float = 0.0
    io_effective: float = 0.0
    sync: float = 0.0
    launch: float = 0.0
    writeback: float = 0.0
    collective: float = 0.0
    overhead: float = 0.0
    detail: Dict[str, float] = field(default_factory=dict)

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute,
                 "memory": max(self.memory, self.io_effective),
                 "collective": self.collective}
        return max(terms, key=terms.get)

    def scaled(self, factor: float) -> "TimeBreakdown":
        return TimeBreakdown(
            total=self.total * factor,
            compute=self.compute * factor,
            memory=self.memory * factor,
            io_effective=self.io_effective * factor,
            sync=self.sync * factor,
            launch=self.launch * factor,
            writeback=self.writeback * factor,
            collective=self.collective * factor,
            overhead=self.overhead * factor,
            detail={k: v * factor for k, v in self.detail.items()},
        )


# ---------------------------------------------------------------------------
# Compact row form of TimeBreakdown (SweepEngine hot path).
#
# A row is ((total, compute, memory, io_effective, sync, launch, writeback,
# collective, overhead), detail_keys, detail_values) — three immutable
# tuples.  Vectorized model backends emit rows via C-level zips of
# ``.tolist()`` columns, the engine memoizes them without defensive copies,
# and full TimeBreakdown objects materialize lazily on access.
# ---------------------------------------------------------------------------

TB_FIELDS = ("total", "compute", "memory", "io_effective", "sync", "launch",
             "writeback", "collective", "overhead")

#: (field_values, detail_keys, detail_values)
Row = Tuple[Tuple[float, ...], Tuple[str, ...], Tuple[float, ...]]


def nvec_matrix(ws) -> np.ndarray:
    """(n, NV_COLS) float64 view over the packed per-workload vectors — the
    zero-copy bulk extraction the batch backends build columns from."""
    return np.frombuffer(b"".join([w._nvec for w in ws]),
                         dtype=np.float64).reshape(len(ws), NV_COLS)


def tb_from_row(row: Row) -> TimeBreakdown:
    """Materialize a TimeBreakdown from its row form (bypasses the frozen
    dataclass __init__/__setattr__ — the row is already validated model
    output)."""
    tb = TimeBreakdown.__new__(TimeBreakdown)
    d = dict(zip(TB_FIELDS, row[0]))
    d["detail"] = dict(zip(row[1], row[2]))
    object.__setattr__(tb, "__dict__", d)
    return tb


def row_from_tb(tb: TimeBreakdown) -> Row:
    """Inverse of ``tb_from_row`` (scalar-fallback paths)."""
    return ((tb.total, tb.compute, tb.memory, tb.io_effective, tb.sync,
             tb.launch, tb.writeback, tb.collective, tb.overhead),
            tuple(tb.detail.keys()), tuple(tb.detail.values()))


# ---------------------------------------------------------------------------
# Columnar prediction output (WorkloadTable hot path).
#
# A model backend's table core returns its nine TimeBreakdown fields and its
# detail terms as whole columns — NumPy arrays, or plain floats for terms
# constant across the batch.  Reductions (argmin/top-k/pareto) run on these
# columns directly; per-row ``Row`` tuples / TimeBreakdowns materialize only
# for the winners.
# ---------------------------------------------------------------------------

class TableCols:
    """Columnar prediction result: one route, uniform detail keys."""

    __slots__ = ("n", "fields", "detail_keys", "detail_vals")

    def __init__(self, n: int, fields: Tuple, detail_keys: Tuple[str, ...],
                 detail_vals: Tuple):
        self.n = n
        self.fields = fields            # 9 items: ndarray or python float
        self.detail_keys = detail_keys
        self.detail_vals = detail_vals  # ndarray or python float each
        # results are cached whole by the engine and column reads hand out
        # these arrays directly — freeze them so a caller's in-place edit
        # (res.totals *= 1e3) raises instead of poisoning the cache
        for c in fields + detail_vals:
            if isinstance(c, np.ndarray) and c.flags.writeable:
                c.flags.writeable = False

    def totals(self) -> np.ndarray:
        t = self.fields[0]
        return t if isinstance(t, np.ndarray) else np.full(self.n, t)

    def field_col(self, j: int) -> np.ndarray:
        f = self.fields[j]
        return f if isinstance(f, np.ndarray) else np.full(self.n, f)

    def row(self, i: int) -> Row:
        f = tuple(float(c[i]) if isinstance(c, np.ndarray) else c
                  for c in self.fields)
        d = tuple(float(v[i]) if isinstance(v, np.ndarray) else v
                  for v in self.detail_vals)
        return (f, self.detail_keys, d)

    def rows(self) -> List[Row]:
        from itertools import repeat
        n = self.n
        cols = [c.tolist() if isinstance(c, np.ndarray) else repeat(c, n)
                for c in self.fields]
        dcols = [v.tolist() if isinstance(v, np.ndarray) else repeat(v, n)
                 for v in self.detail_vals]
        return list(zip(zip(*cols), repeat(self.detail_keys, n),
                        zip(*dcols)))


class RowsCols:
    """Column-interface adapter over precomputed Row tuples (scalar-fallback
    segments, e.g. CDNA3 workloads with explicit hit rates)."""

    __slots__ = ("n", "_rows")

    def __init__(self, rows: List[Row]):
        self._rows = rows
        self.n = len(rows)

    def totals(self) -> np.ndarray:
        return np.fromiter((r[0][0] for r in self._rows), np.float64, self.n)

    def field_col(self, j: int) -> np.ndarray:
        return np.fromiter((r[0][j] for r in self._rows), np.float64, self.n)

    def row(self, i: int) -> Row:
        return self._rows[i]

    def rows(self) -> List[Row]:
        return self._rows


class SegmentedCols:
    """Columnar result assembled from disjoint row-index segments (mixed
    routing inside one table, e.g. tiled-GEMM vs streaming rows on the
    Blackwell stage model — the segments carry different detail keys)."""

    __slots__ = ("n", "segments", "_owner", "_local")

    def __init__(self, n: int, segments: List[Tuple[np.ndarray, object]]):
        self.n = n
        self.segments = segments
        owner = np.empty(n, dtype=np.intp)
        local = np.empty(n, dtype=np.intp)
        for s, (idx, _) in enumerate(segments):
            owner[idx] = s
            local[idx] = np.arange(len(idx))
        self._owner = owner
        self._local = local

    def totals(self) -> np.ndarray:
        out = np.empty(self.n, dtype=np.float64)
        for idx, seg in self.segments:
            out[idx] = seg.totals()
        return out

    def field_col(self, j: int) -> np.ndarray:
        out = np.empty(self.n, dtype=np.float64)
        for idx, seg in self.segments:
            out[idx] = seg.field_col(j)
        return out

    def row(self, i: int) -> Row:
        return self.segments[self._owner[i]][1].row(int(self._local[i]))

    def rows(self) -> List[Row]:
        out: List[Optional[Row]] = [None] * self.n
        for idx, seg in self.segments:
            for i, row in zip(idx.tolist(), seg.rows()):
                out[i] = row
        return out  # type: ignore[return-value]


# ---------------------------------------------------------------------------
# WorkloadTable: struct-of-arrays workload batch.
#
# Sweeps (tile lattices, precision ladders, cartesian what-if grids) never
# need per-config ``Workload`` dataclasses: the table holds the NV_COLS
# float64 matrix directly plus vocab-coded non-numeric columns, and the
# model backends consume the columns as-is.  Scalar ``Workload`` objects
# materialize lazily (``workload(i)``) for winners only.
# ---------------------------------------------------------------------------

#: Workload fields settable as cartesian grid axes -> their NV column.
CARTESIAN_COLS = {
    "flops": NV_FLOPS, "bytes": NV_BYTES,
    "working_set_bytes": NV_WS, "k_tiles": NV_K_TILES,
    "num_ctas": NV_NUM_CTAS, "bytes_per_cta": NV_BYTES_PER_CTA,
    "tma_participants": NV_TMA_P, "compressed_bytes": NV_COMP_BYTES,
    "compression_ratio": NV_COMP_RATIO, "vgpr_per_workitem": NV_VGPR,
    "num_loads": NV_NUM_LOADS, "concurrent_kernels": NV_CONCURRENT,
    "num_devices": NV_DEVICES, "irregular": NV_IRREGULAR,
    "matrix": NV_MATRIX,
}


def _encode(values: List[str]):
    """Small-vocabulary string column -> (codes intp array, vocab tuple)."""
    vocab: Dict[str, int] = {}
    sd = vocab.setdefault
    codes = [sd(v, len(vocab)) for v in values]
    return np.array(codes, dtype=np.intp), tuple(vocab)


def _canonical_codes(codes: np.ndarray, vocab: Tuple[str, ...]):
    """(int64 code bytes, vocab tuple) in a construction-order-invariant
    form: only vocab entries actually used by ``codes`` survive, sorted by
    string, with the codes remapped to match.  Two tables whose rows decode
    to the same per-row strings hash identically no matter which insertion
    order (``concat`` operand order, wire decode order, ``take`` leftovers)
    their vocabularies accumulated in — raw codes would memo-miss them.
    int64 on both 32/64-bit hosts so digests are platform-stable."""
    used = np.unique(codes)
    uniq = sorted({vocab[int(c)] for c in used})
    remap = np.zeros(len(vocab), dtype=np.int64)
    for c in used:
        remap[int(c)] = uniq.index(vocab[int(c)])
    return remap[codes].tobytes(), tuple(uniq)


class WorkloadTable:
    """Struct-of-arrays batch of workloads (the columnar sweep unit).

    Treat instances as immutable: the engine caches results under a content
    token computed once per table.  ``cols`` is the (n, NV_COLS) float64
    matrix in ``NV_*`` column order; ``precision``/``wclass`` are vocab-coded
    per-row; ``hit_rates`` (rarely used — CDNA3 Eq. 10 inputs) is either
    None or a per-row tuple of dicts.
    """

    __slots__ = ("cols", "precision_codes", "precision_vocab",
                 "wclass_codes", "wclass_vocab", "names", "hit_rates",
                 "name_offset", "_token")

    def __init__(self, cols: np.ndarray, precision_codes: np.ndarray,
                 precision_vocab: Tuple[str, ...],
                 wclass_codes: np.ndarray, wclass_vocab: Tuple[str, ...],
                 names=None, hit_rates=None, name_offset: int = 0):
        self.cols = cols
        self.precision_codes = precision_codes
        self.precision_vocab = precision_vocab
        self.wclass_codes = wclass_codes
        self.wclass_vocab = wclass_vocab
        self.names = names          # tuple per-row | shared str | None
        self.hit_rates = hit_rates  # None | tuple of (dict | None)
        # chunk tables cut from a larger lattice keep their global row
        # numbering through this offset, so streamed winners carry the same
        # names a full materialization would
        self.name_offset = name_offset
        self._token = None
        # freeze the code arrays too: a zero-copy wire decode over a
        # writable buffer (bytearray/memoryview) would otherwise hand out
        # mutable codes whose cached content_token goes stale
        for arr in (cols, precision_codes, wclass_codes):
            if arr.flags.writeable:
                arr.flags.writeable = False

    # ------------------------------------------------------------ basics
    def __len__(self) -> int:
        return self.cols.shape[0]

    @property
    def n(self) -> int:
        return self.cols.shape[0]

    def name(self, i: int) -> str:
        if isinstance(self.names, tuple):
            return self.names[i]
        return f"{self.names or 'table'}#{i + self.name_offset}"

    def content_token(self) -> Tuple:
        """Hashable content identity (what the engine's whole-table cache is
        keyed on): a fixed-size blake2b digest of the column bytes + the
        small vocab/hit-rate tuples, so neither the token nor the cache key
        retains a raw copy of the table.  Vocab-coded columns are hashed in
        canonical (used-and-sorted) form, so semantically identical tables
        built with different precision/wclass insertion orders — ``concat``
        operand order, decoded wire tables, ``take`` subsets — share one
        token and hit the memo cache.  Computed once and cached — replays
        of the same table object skip even the digest."""
        tok = self._token
        if tok is None:
            hr = None if self.hit_rates is None else tuple(
                tuple(sorted(h.items())) if h else ()
                for h in self.hit_rates)
            pb, pv = _canonical_codes(self.precision_codes,
                                      self.precision_vocab)
            wb, wv = _canonical_codes(self.wclass_codes, self.wclass_vocab)
            h = hashlib.blake2b(digest_size=16)
            h.update(self.cols.tobytes())
            h.update(pb)
            h.update(wb)
            tok = (h.digest(), len(self), pv, wv, hr)
            self._token = tok
        return tok

    # --------------------------------------------------- vocab broadcasts
    def per_precision(self, fn) -> np.ndarray:
        """Broadcast fn(precision) over rows — fn runs once per distinct
        precision, exactly like the list-path per-batch lookup maps."""
        vals = np.array([fn(p) for p in self.precision_vocab],
                        dtype=np.float64)
        return vals[self.precision_codes]

    def per_precision_matrix(self, fn) -> np.ndarray:
        """Broadcast fn(precision, matrix_flag) over rows; fn runs once per
        distinct (precision, matrix) pair actually present."""
        mat = (self.cols[:, NV_MATRIX] != 0).astype(np.intp)
        pair = self.precision_codes * 2 + mat
        vals = np.empty(2 * len(self.precision_vocab), dtype=np.float64)
        for pid in np.unique(pair):
            vals[pid] = fn(self.precision_vocab[int(pid) // 2],
                           bool(int(pid) % 2))
        return vals[pair]

    def per_wclass(self, fn) -> np.ndarray:
        vals = np.array([fn(c) for c in self.wclass_vocab], dtype=np.float64)
        return vals[self.wclass_codes]

    # ------------------------------------------------------------- views
    def _slice(self, lo: int, hi: int) -> "WorkloadTable":
        """Contiguous zero-copy row window [lo, hi); the cut keeps global
        row naming via ``name_offset``."""
        names = self.names
        offset = 0
        if isinstance(names, tuple):
            names = names[lo:hi]
        else:
            offset = self.name_offset + lo
        hr = self.hit_rates
        if hr is not None:
            hr = hr[lo:hi]
        return WorkloadTable(
            self.cols[lo:hi], self.precision_codes[lo:hi],
            self.precision_vocab, self.wclass_codes[lo:hi],
            self.wclass_vocab, names, hr, name_offset=offset)

    def chunks(self, size: int = DEFAULT_CHUNK_ROWS
               ) -> Iterator["WorkloadTable"]:
        """Yield contiguous row windows of ``size`` rows (zero-copy views)
        — the streaming unit for tables that are already built."""
        size = max(int(size), 1)
        for lo in range(0, len(self), size):
            yield self._slice(lo, min(lo + size, len(self)))

    def take(self, idx: np.ndarray) -> "WorkloadTable":
        """Row-subset table (mixed-route splits inside the backends)."""
        names = self.names
        if isinstance(names, tuple):
            names = tuple(names[i] for i in idx.tolist())
        hr = self.hit_rates
        if hr is not None:
            hr = tuple(hr[i] for i in idx.tolist())
        return WorkloadTable(
            np.ascontiguousarray(self.cols[idx]),
            self.precision_codes[idx], self.precision_vocab,
            self.wclass_codes[idx], self.wclass_vocab, names, hr)

    def workload(self, i: int) -> Workload:
        """Materialize row ``i`` as a scalar Workload (winners / scalar
        fallbacks only — never the sweep hot path)."""
        r = self.cols[i]
        g = GemmShape(int(r[NV_GM]), int(r[NV_GN]), int(r[NV_GK])) \
            if r[NV_HAS_GEMM] != 0 else None
        t = TileConfig(int(r[NV_BM]), int(r[NV_BN]), int(r[NV_BK])) \
            if r[NV_HAS_TILE] != 0 else None
        hr = {}
        if self.hit_rates is not None and self.hit_rates[i]:
            hr = dict(self.hit_rates[i])
        return Workload(
            name=self.name(i),
            wclass=self.wclass_vocab[self.wclass_codes[i]],
            flops=float(r[NV_FLOPS]), bytes=float(r[NV_BYTES]),
            precision=self.precision_vocab[self.precision_codes[i]],
            matrix=bool(r[NV_MATRIX]),
            working_set_bytes=float(r[NV_WS]),
            gemm=g, tile=t,
            num_ctas=int(r[NV_NUM_CTAS]), k_tiles=int(r[NV_K_TILES]),
            tma_participants=int(r[NV_TMA_P]),
            bytes_per_cta=float(r[NV_BYTES_PER_CTA]),
            vgpr_per_workitem=int(r[NV_VGPR]),
            hit_rates=hr, num_loads=float(r[NV_NUM_LOADS]),
            compressed_bytes=float(r[NV_COMP_BYTES]),
            compression_ratio=float(r[NV_COMP_RATIO]),
            irregular=bool(r[NV_IRREGULAR]), atomics=bool(r[NV_ATOMICS]),
            concurrent_kernels=int(r[NV_CONCURRENT]),
            num_devices=int(r[NV_DEVICES]))

    # ------------------------------------------------------ constructors
    @classmethod
    def from_workloads(cls, ws: Sequence[Workload]) -> "WorkloadTable":
        """Columnar view over existing Workload objects (one zero-copy
        frombuffer over the packed per-workload vectors)."""
        pc, pv = _encode([w.precision for w in ws])
        wc, wv = _encode([w.wclass for w in ws])
        hit_rates = None
        if any(w.hit_rates for w in ws):
            hit_rates = tuple(w.hit_rates or None for w in ws)
        return cls(nvec_matrix(ws), pc, pv, wc, wv,
                   tuple(w.name for w in ws), hit_rates)

    @classmethod
    def _from_base(cls, base: Workload, n: int) -> "WorkloadTable":
        cols = np.tile(np.frombuffer(base._nvec, dtype=np.float64), (n, 1))
        codes = np.zeros(n, dtype=np.intp)
        hr = tuple([base.hit_rates] * n) if base.hit_rates else None
        return cls(cols, codes, (base.precision,), codes.copy(),
                   (base.wclass,), base.name, hr)

    @classmethod
    def tile_lattice(cls, base: Workload,
                     tiles: Sequence[TileConfig]) -> "WorkloadTable":
        """Re-tile ``base`` with every candidate tile — columnar analogue of
        ``cdna3._retile`` per candidate, with the derived grid quantities
        (num_ctas, k_tiles, bytes_per_cta) recomputed vectorized when the
        base carries a GEMM shape."""
        return LatticeSpec.tile_lattice(base, tiles).materialize()

    @classmethod
    def cartesian(cls, base: Workload, **field_grids) -> "WorkloadTable":
        """Cross-product sweep over Workload fields, columnar end to end.

        Grid keys: any numeric field in ``CARTESIAN_COLS``, plus
        ``precision`` / ``wclass`` (strings, vocab-coded) and ``tile``
        (TileConfig — sets the raw bM/bN/bK columns only; use
        ``tile_lattice`` when the GEMM grid quantities must follow the
        tile).  Row order is C-order over the grids in keyword order.

        Refuses grids beyond ``MAX_MATERIALIZE_ROWS`` — build the
        ``LatticeSpec`` instead and stream it chunk-wise.
        """
        return LatticeSpec.cartesian(base, **field_grids).materialize()

    @classmethod
    def concat(cls, tables: Sequence["WorkloadTable"]) -> "WorkloadTable":
        """Stack tables row-wise (e.g. per-shape tile lattices into one
        sweep).  Vocabularies are merged and re-coded."""
        if not tables:
            raise ValueError("concat of zero tables")
        cols = np.vstack([t.cols for t in tables])

        def merge(code_attr, vocab_attr):
            vocab: Dict[str, int] = {}
            parts = []
            for t in tables:
                tv = getattr(t, vocab_attr)
                remap = np.array([vocab.setdefault(v, len(vocab))
                                  for v in tv], dtype=np.intp)
                parts.append(remap[getattr(t, code_attr)])
            return np.concatenate(parts), tuple(vocab)

        pc, pv = merge("precision_codes", "precision_vocab")
        wc, wv = merge("wclass_codes", "wclass_vocab")
        names = None
        if all(isinstance(t.names, tuple) for t in tables):
            names = tuple(nm for t in tables for nm in t.names)
        hit_rates = None
        if any(t.hit_rates is not None for t in tables):
            hit_rates = tuple(
                h for t in tables
                for h in (t.hit_rates or (None,) * len(t)))
        return cls(cols, pc, pv, wc, wv, names, hit_rates)


# ---------------------------------------------------------------------------
# LatticeSpec: lazy sweep plans.
#
# A spec knows ``n_rows`` without materializing anything and yields
# WorkloadTable chunks via vectorized index arithmetic (divmod of the global
# row index into grid coordinates, written straight into preallocated column
# buffers — no per-row Python).  Chunks are row-for-row, byte-for-byte
# identical to the corresponding window of the materialized table, so the
# streaming reductions in ``core.sweep`` return bit-identical winners.
# Specs are small (a base workload + grid arrays) and picklable, which is
# what lets ``core.parallel`` ship them to worker processes instead of
# shipping columns.
# ---------------------------------------------------------------------------

class LatticeSpec:
    """Lazy description of a sweep lattice (cartesian / tile-lattice /
    concat algebra over ``WorkloadTable`` construction)."""

    @property
    def n_rows(self) -> int:
        raise NotImplementedError

    def __len__(self) -> int:
        return self.n_rows

    def chunk(self, lo: int, hi: int) -> WorkloadTable:
        """Materialize rows [lo, hi) as a WorkloadTable (bit-identical to
        the same window of ``materialize()``).  Raises on windows outside
        [0, n_rows] — a silently wrapped window would price phantom rows."""
        raise NotImplementedError

    def _check_window(self, lo: int, hi: int) -> None:
        if not 0 <= lo <= hi <= self.n_rows:
            raise ValueError(
                f"chunk window [{lo}, {hi}) outside lattice rows "
                f"[0, {self.n_rows})")

    def _has_row_names(self) -> bool:
        """True when chunks carry per-row name tuples (mirrors
        ``WorkloadTable.concat``'s naming rule)."""
        return False

    def estimated_bytes(self) -> int:
        """Estimated resident size of the fully materialized columns."""
        per_row = NV_COLS * 8 + 2 * np.dtype(np.intp).itemsize
        return self.n_rows * per_row

    def chunks(self, size: int = DEFAULT_CHUNK_ROWS, lo: int = 0,
               hi: Optional[int] = None) -> Iterator[WorkloadTable]:
        """Yield chunk tables of ``size`` rows covering [lo, hi)."""
        size = max(int(size), 1)
        hi = self.n_rows if hi is None else min(hi, self.n_rows)
        for start in range(lo, hi, size):
            yield self.chunk(start, min(start + size, hi))

    def materialize(self) -> WorkloadTable:
        """One-shot table build; refuses lattices beyond
        ``MAX_MATERIALIZE_ROWS`` instead of OOM-killing the host."""
        n = self.n_rows
        if n > MAX_MATERIALIZE_ROWS:
            est = self.estimated_bytes()
            raise ValueError(
                f"materializing this lattice needs {n:,} rows "
                f"(~{est / 1e9:,.1f} GB of columns, > "
                f"{MAX_MATERIALIZE_ROWS:,} rows); keep it as a LatticeSpec "
                f"and stream it instead (LatticeSpec.chunks or the "
                f"core.sweep argmin_stream/topk_stream/pareto_stream "
                f"reductions, optionally sharded via core.parallel)")
        return self.chunk(0, n)

    # --------------------------------------------------------- constructors
    @staticmethod
    def cartesian(base: Workload, **field_grids) -> "LatticeSpec":
        """Lazy cross-product over Workload fields (same grid keys and row
        order as ``WorkloadTable.cartesian``)."""
        return _CartesianSpec(base, field_grids)

    @staticmethod
    def tile_lattice(base: Workload,
                     tiles: Sequence[TileConfig]) -> "LatticeSpec":
        """Lazy per-candidate re-tiling of ``base`` (same semantics as
        ``WorkloadTable.tile_lattice``)."""
        return _TileLatticeSpec(base, tiles)

    @staticmethod
    def concat(specs: Sequence["LatticeSpec"]) -> "LatticeSpec":
        """Row-wise stack of specs (and/or tables via ``from_table``)."""
        return _ConcatSpec(specs)

    @staticmethod
    def from_table(table: WorkloadTable) -> "LatticeSpec":
        """Wrap an already-built table so it streams through the same
        chunked machinery (zero-copy row windows)."""
        return _TableSpec(table)

    # ------------------------------------------------------- serialization
    def to_plan(self, table_sink=None) -> Dict:
        """JSON-safe structural description of this spec — the wire form
        ``repro.serve.codec`` ships lattice plans in (a plan is tiny even
        when the lattice it describes has 10^9 rows).

        Built tables nested in the plan cannot be JSON: ``table_sink``
        is called once per table and must return a small JSON-safe
        reference (the codec appends the table's columns as a binary
        section and returns its index).
        """
        raise NotImplementedError

    @staticmethod
    def from_plan(plan: Dict,
                  tables: Sequence["WorkloadTable"] = ()) -> "LatticeSpec":
        """Rebuild a spec from ``to_plan`` output.  ``tables`` resolves the
        references a ``table_sink`` handed out during encoding."""
        kind = plan.get("kind")
        if kind == "cartesian":
            grids = {}
            for key, vals in plan["grids"].items():
                if key == "tile":
                    vals = [TileConfig(*map(int, t)) for t in vals]
                grids[key] = vals
            return _CartesianSpec(Workload.from_dict(plan["base"]), grids)
        if kind == "tile_lattice":
            return _TileLatticeSpec(
                Workload.from_dict(plan["base"]),
                [TileConfig(*map(int, t)) for t in plan["tiles"]])
        if kind == "concat":
            return _ConcatSpec([LatticeSpec.from_plan(p, tables)
                                for p in plan["children"]])
        if kind == "table":
            ref = plan.get("ref")
            if not isinstance(ref, int) or not 0 <= ref < len(tables):
                raise ValueError(
                    f"plan references table {ref!r} but only "
                    f"{len(tables)} table(s) were provided")
            return _TableSpec(tables[ref])
        raise ValueError(f"unknown lattice plan kind {kind!r}")


class _CartesianSpec(LatticeSpec):
    """Cartesian grid: each chunk decodes global row indices into per-axis
    grid coordinates with one divmod per axis."""

    def __init__(self, base: Workload, field_grids: Dict):
        self.base = base
        self.keys = tuple(field_grids)
        self._plan_grids: Dict[str, List] = {}
        sizes = []
        prepped = []
        for key in self.keys:
            vals = list(field_grids[key])
            # _plan_grids is filled per branch, after validation, so an
            # invalid axis still raises the documented ValueError below
            # (floats for numeric axes keep the plan json-safe even for
            # numpy scalars).
            if key == "precision":
                strs = [str(v) for v in vals]
                codes, vocab = _encode(strs)
                prepped.append(("precision", codes, vocab))
                self._plan_grids[key] = strs
            elif key == "wclass":
                for v in vals:
                    if v not in VALID_CLASSES:
                        raise ValueError(f"workload class {v!r} not in "
                                         f"{VALID_CLASSES}")
                strs = [str(v) for v in vals]
                codes, vocab = _encode(strs)
                prepped.append(("wclass", codes, vocab))
                self._plan_grids[key] = strs
            elif key == "tile":
                prepped.append((
                    "tile",
                    np.array([c.bm for c in vals], dtype=np.float64),
                    np.array([c.bn for c in vals], dtype=np.float64),
                    np.array([c.bk for c in vals], dtype=np.float64)))
                self._plan_grids[key] = [[c.bm, c.bn, c.bk] for c in vals]
            elif key in CARTESIAN_COLS:
                arr = np.array(vals, dtype=np.float64)
                prepped.append(("col", CARTESIAN_COLS[key], arr))
                self._plan_grids[key] = [float(v) for v in arr]
            else:
                raise ValueError(
                    f"cartesian cannot sweep field {key!r}; valid: "
                    f"{sorted(CARTESIAN_COLS)} + precision/wclass/tile")
            sizes.append(len(vals))
        n = 1
        for s in sizes:
            n *= s
        if n == 0:
            raise ValueError("empty cartesian grid")
        self._n = n
        self._sizes = sizes
        strides = []
        acc = 1
        for s in reversed(sizes):
            strides.append(acc)
            acc *= s
        self._strides = list(reversed(strides))
        self._prepped = prepped
        self._ws_fix = ("bytes" in field_grids
                        or "working_set_bytes" in field_grids)

    @property
    def n_rows(self) -> int:
        return self._n

    def to_plan(self, table_sink=None) -> Dict:
        return {"kind": "cartesian", "base": self.base.to_dict(),
                "grids": {k: list(v) for k, v in self._plan_grids.items()}}

    def chunk(self, lo: int, hi: int) -> WorkloadTable:
        self._check_window(lo, hi)
        base = self.base
        t = WorkloadTable._from_base(base, hi - lo)
        cols = t.cols
        cols.flags.writeable = True
        ridx = np.arange(lo, hi, dtype=np.intp)
        prec_codes, prec_vocab = t.precision_codes, t.precision_vocab
        wcls_codes, wcls_vocab = t.wclass_codes, t.wclass_vocab
        for size, stride, prep in zip(self._sizes, self._strides,
                                      self._prepped):
            take = (ridx // stride) % size
            kind = prep[0]
            if kind == "precision":
                prec_codes, prec_vocab = prep[1][take], prep[2]
            elif kind == "wclass":
                wcls_codes, wcls_vocab = prep[1][take], prep[2]
            elif kind == "tile":
                cols[:, NV_BM] = prep[1][take]
                cols[:, NV_BN] = prep[2][take]
                cols[:, NV_BK] = prep[3][take]
                cols[:, NV_HAS_TILE] = 1.0
            else:
                cols[:, prep[1]] = prep[2][take]
        if self._ws_fix:
            ws_col = cols[:, NV_WS]
            cols[:, NV_WS_OR_BYTES] = np.where(ws_col != 0, ws_col,
                                               cols[:, NV_BYTES])
        cols.flags.writeable = False
        return WorkloadTable(cols, prec_codes, prec_vocab, wcls_codes,
                             wcls_vocab, base.name, t.hit_rates,
                             name_offset=lo)


class _TileLatticeSpec(LatticeSpec):
    def __init__(self, base: Workload, tiles: Sequence[TileConfig]):
        self.base = base
        self._bm = np.array([c.bm for c in tiles], dtype=np.int64)
        self._bn = np.array([c.bn for c in tiles], dtype=np.int64)
        self._bk = np.array([c.bk for c in tiles], dtype=np.int64)

    @property
    def n_rows(self) -> int:
        return len(self._bm)

    def to_plan(self, table_sink=None) -> Dict:
        return {"kind": "tile_lattice", "base": self.base.to_dict(),
                "tiles": [[int(m), int(n), int(k)] for m, n, k in
                          zip(self._bm.tolist(), self._bn.tolist(),
                              self._bk.tolist())]}

    def chunk(self, lo: int, hi: int) -> WorkloadTable:
        self._check_window(lo, hi)
        from .hardware import BYTES_PER_ELEM
        base = self.base
        t = WorkloadTable._from_base(base, hi - lo)
        cols = t.cols
        cols.flags.writeable = True
        bm, bn, bk = self._bm[lo:hi], self._bn[lo:hi], self._bk[lo:hi]
        cols[:, NV_BM] = bm
        cols[:, NV_BN] = bn
        cols[:, NV_BK] = bk
        cols[:, NV_HAS_TILE] = 1.0
        if base.gemm is not None:
            g = base.gemm
            cols[:, NV_NUM_CTAS] = (-(-g.m // bm)) * (-(-g.n // bn))
            cols[:, NV_K_TILES] = -(-g.k // bk)
            in_b = BYTES_PER_ELEM[base.precision]
            cols[:, NV_BYTES_PER_CTA] = (bm * bk + bk * bn) * in_b
        cols.flags.writeable = False
        t.name_offset = lo
        return t


class _TableSpec(LatticeSpec):
    def __init__(self, table: WorkloadTable):
        self.table = table

    @property
    def n_rows(self) -> int:
        return len(self.table)

    def _has_row_names(self) -> bool:
        return isinstance(self.table.names, tuple)

    def to_plan(self, table_sink=None) -> Dict:
        if table_sink is None:
            raise TypeError("plan contains a built table; provide a "
                            "table_sink to reference it")
        return {"kind": "table", "ref": table_sink(self.table)}

    def chunk(self, lo: int, hi: int) -> WorkloadTable:
        self._check_window(lo, hi)
        return self.table._slice(lo, hi)

    def materialize(self) -> WorkloadTable:
        return self.table


class _ConcatSpec(LatticeSpec):
    def __init__(self, specs: Sequence[LatticeSpec]):
        if not specs:
            raise ValueError("concat of zero specs")
        self.specs = list(specs)
        self._offsets = [0]
        for s in self.specs:
            self._offsets.append(self._offsets[-1] + s.n_rows)
        self._row_names = all(s._has_row_names() for s in self.specs)

    @property
    def n_rows(self) -> int:
        return self._offsets[-1]

    def to_plan(self, table_sink=None) -> Dict:
        return {"kind": "concat",
                "children": [s.to_plan(table_sink) for s in self.specs]}

    def _has_row_names(self) -> bool:
        return self._row_names

    def chunk(self, lo: int, hi: int) -> WorkloadTable:
        self._check_window(lo, hi)
        parts = []
        for child, start, end in zip(self.specs, self._offsets,
                                     self._offsets[1:]):
            a, b = max(lo, start), min(hi, end)
            if a < b:
                parts.append(child.chunk(a - start, b - start))
        if not parts:                       # empty window (lo == hi)
            parts = [self.specs[0].chunk(0, 0)]
        t = parts[0] if len(parts) == 1 else WorkloadTable.concat(parts)
        if not self._row_names:
            # mirror WorkloadTable.concat naming ("table#<global row>")
            # regardless of which children this window happens to touch
            t.names = None
            t.name_offset = lo
        return t


def gemm_workload(name: str, m: int, n: int, k: int, *,
                  precision: str = "fp16",
                  tile: TileConfig = TileConfig(),
                  wclass: str = "compute",
                  out_precision: Optional[str] = None) -> Workload:
    """Convenience constructor for tiled-GEMM workloads (the paper's
    compute-bound validation class)."""
    from .hardware import BYTES_PER_ELEM

    in_b = BYTES_PER_ELEM[precision]
    out_b = BYTES_PER_ELEM[out_precision or precision]
    shape = GemmShape(m, n, k)
    num_ctas = -(-m // tile.bm) * -(-n // tile.bn)
    k_tiles = -(-k // tile.bk)
    # per-CTA HBM traffic for one K-step: an A tile + a B tile
    bytes_per_cta = (tile.bm * tile.bk + tile.bk * tile.bn) * in_b
    ws = min(shape.bytes_moved(in_b, out_b),
             (m * k + k * n + m * n) * in_b)
    return Workload(
        name=name, wclass=wclass,
        flops=shape.flops,
        bytes=shape.bytes_moved(in_b, out_b),
        precision=precision, matrix=True,
        working_set_bytes=ws,
        gemm=shape, tile=tile,
        num_ctas=num_ctas, k_tiles=k_tiles,
        bytes_per_cta=bytes_per_cta,
    )


def streaming_workload(name: str, nbytes: float, *,
                       flops_per_byte: float = 0.125,
                       precision: str = "fp32",
                       wclass: str = "memory",
                       irregular: bool = False) -> Workload:
    """Memory-bound vector ops (add/copy/transpose/reduction class)."""
    return Workload(
        name=name, wclass=wclass,
        flops=nbytes * flops_per_byte,
        bytes=nbytes,
        precision=precision, matrix=False,
        working_set_bytes=nbytes,
        irregular=irregular,
    )
