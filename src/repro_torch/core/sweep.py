"""Batched + columnar sweep-prediction engine with two-tier memoization.

The paper's headline workflow prices thousands of candidate
(workload x hardware x precision x tile) configurations through the
analytical models and returns the argmin (§IV-B adaptive tile selection,
§IV-D routing).  A scalar Python ``predict()`` call per configuration makes
that the slowest path in the repo; microbenchmark sweeps span 10^3-10^4
points per kernel family — exactly the regime where batching pays off.

Two batched front ends share the NumPy-vectorized model backends
(``blackwell``/``cdna3``/``tpu``/``generic``/``roofline``):

``SweepEngine.predict_batch(workloads, hw)``
    List-of-``Workload`` batches.  Backends emit compact immutable row
    tuples; ``TimeBreakdown`` objects materialize lazily when a result is
    indexed.  Rows are memoized per row under a content key (the workload's
    packed ``_nvec`` buffer + non-numeric fields + HardwareParams content +
    route) in a bounded LRU, and whole batches short-circuit through a
    batch-digest tier so replaying an identical sweep never walks the
    per-row cache.

``predict_table(table, hw)`` / ``SweepEngine.predict_table``
    Columnar ``WorkloadTable`` sweeps.  The backends run directly on the
    table's column arrays and return columns; nothing per-row is built
    until a winner is materialized.  Fused reductions ``argmin_table``,
    ``topk_table`` and ``pareto_table`` reduce on the column arrays and
    materialize only the winning rows' ``TimeBreakdown``s.  Whole tables
    memoize under a per-table content token (tier 1); there is no per-row
    tier for tables — a table is the unit of reuse.

Columnar-table contract (when to use what):

  * scalar ``predict.predict(w, hw)`` — one-off questions, host phases,
    anything that wants a single ``TimeBreakdown`` now.  Delegates here as
    a batch of one and is memoized per row.
  * ``predict_batch`` — you already hold ``Workload`` objects (validation
    suites, calibration fits that need per-case TimeBreakdowns).
  * ``WorkloadTable`` + ``predict_table``/``argmin_table``/``topk_table``
    — sweeps you *construct*: tile lattices (``WorkloadTable.tile_lattice``),
    cartesian what-if grids (``WorkloadTable.cartesian``).  Never builds
    per-config Workload dataclasses, never builds per-config rows; ~an
    order of magnitude faster end to end than predict_batch over a
    freshly-built Workload list (benchmarks/sweep_bench.py).

Guarantees:
  * batch-of-1 results are bit-identical to the pre-refactor scalar
    ``predict(w, hw)`` for every route (verified by tests/test_sweep.py),
    and table results are bit-identical per row to predict_batch
    (tests/test_workload_table.py),
  * cached rows are immutable tuples — no defensive copies, no
    cache-poisoning via caller-mutated detail dicts,
  * calibration is applied at materialization time, after the cache, so
    one cache entry serves calibrated and uncalibrated callers,
  * all caches are LRU-bounded (``max_entries`` rows, ``max_batch_entries``
    batch digests, ``max_table_entries`` table results) and lock-protected;
    concurrent ``predict_batch`` calls from many threads return identical
    results with the bounds maintained.
"""
from __future__ import annotations

import dataclasses
import hashlib
import heapq
import math
import os
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass
from functools import partial
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from . import blackwell, cdna3, generic, roofline
from ..obs import metrics
from .hardware import HardwareParams
from .workload import DEFAULT_CHUNK_ROWS, LatticeSpec, Row, TB_FIELDS, \
    TimeBreakdown, Workload, WorkloadTable, row_from_tb, tb_from_row

ROUTES = ("stage", "wavefront", "tpu", "generic", "roofline")

#: below this many cache misses the engine evaluates via the scalar model
#: functions — NumPy dispatch overhead on near-empty arrays costs more than
#: the per-call Python it saves (crossover measured ~10-15 workloads).
SCALAR_CUTOFF = 16

_FAMILY_ROUTE = {
    "blackwell": "stage",
    "cdna": "wavefront",
    "tpu": "tpu",
    "generic": "generic",
}


def default_route(hw: HardwareParams) -> str:
    """Architecture routing (paper §IV-D workflow step 2/3)."""
    return _FAMILY_ROUTE.get(hw.model_family, "generic")


def _rows_fn(route: str):
    if route == "stage":
        return blackwell.predict_rows
    if route == "wavefront":
        return cdna3.predict_rows
    if route == "tpu":
        from . import tpu  # local import: tpu.py depends on collectives
        return tpu.predict_rows
    if route == "generic":
        return generic.predict_rows
    if route == "roofline":
        return roofline.predict_rows
    raise ValueError(f"unknown model route {route!r}")


def _cols_fn(route: str):
    if route == "stage":
        return blackwell.predict_table_cols
    if route == "wavefront":
        return cdna3.predict_table_cols
    if route == "tpu":
        from . import tpu
        return tpu.predict_table_cols
    if route == "generic":
        return generic.predict_table_cols
    if route == "roofline":
        return roofline.predict_table_cols
    raise ValueError(f"unknown model route {route!r}")


def _scalar_fn(route: str):
    if route == "stage":
        return blackwell.predict
    if route == "wavefront":
        return cdna3.predict
    if route == "tpu":
        from . import tpu
        return tpu.predict
    if route == "generic":
        return generic.predict
    if route == "roofline":
        return roofline.predict
    raise ValueError(f"unknown model route {route!r}")


def _eval_rows(route: str, ws: Sequence[Workload],
               hw: HardwareParams) -> List[Row]:
    """Vectorized for real batches, scalar-reference for tiny ones
    (identical results either way — that equivalence is the engine's core
    invariant, enforced by tests/test_sweep.py)."""
    if len(ws) < SCALAR_CUTOFF:
        fn = _scalar_fn(route)
        return [row_from_tb(fn(w, hw)) for w in ws]
    return _rows_fn(route)(ws, hw)


def workload_key(w: Workload) -> Tuple:
    """Content key for a workload: the packed numeric vector (every
    model-visible numeric field, one memoized bytes object) plus the
    non-numeric fields.  ``name`` is excluded — predictions depend only on
    the characterization, so renamed duplicates share cache entries."""
    return (w._nvec, w.wclass, w.precision,
            tuple(sorted(w.hit_rates.items())) if w.hit_rates else ())


_HW_TOKENS: Dict[Tuple, Tuple[str, int]] = {}
_HW_TOKENS_LOCK = threading.Lock()


def hardware_key(hw: HardwareParams) -> Tuple[str, int]:
    """Compact content token for a parameter file.  The registry allows
    re-registering updated parameters under the same name (e.g. a
    re-calibrated ``cpu_host``), so the name alone would serve stale
    predictions.  The full field tuple is interned to a small (name, id)
    token — cache keys must stay cheap to hash, and the content tuple is
    ~50 nested fields — and the token is stashed on the (frozen) instance
    so the content walk happens once per HardwareParams object."""
    cached = getattr(hw, "_sweep_content_token", None)
    if cached is not None:
        return cached
    out = []
    for f in dataclasses.fields(hw):
        v = getattr(hw, f.name)
        if isinstance(v, dict):
            v = tuple(sorted(v.items()))
        out.append(v)
    content = tuple(out)
    with _HW_TOKENS_LOCK:
        token = _HW_TOKENS.get(content)
        if token is None:
            token = (hw.name, len(_HW_TOKENS))
            _HW_TOKENS[content] = token
    try:
        object.__setattr__(hw, "_sweep_content_token", token)
    except Exception:
        pass
    return token


class BatchResult(Sequence):
    """Lazy sequence view over prediction rows.

    Indexing / iterating materializes ``TimeBreakdown`` objects (with
    calibration applied, when given); ``totals`` exposes the raw totals as
    a NumPy array without materializing anything — the argmin fast path.
    """

    __slots__ = ("_rows", "_calibration", "_workloads")

    def __init__(self, rows: List[Row], workloads: Sequence[Workload],
                 calibration: Optional[object] = None):
        self._rows = rows
        self._workloads = workloads
        self._calibration = calibration

    def __len__(self) -> int:
        return len(self._rows)

    def _materialize(self, i: int) -> TimeBreakdown:
        tb = tb_from_row(self._rows[i])
        if self._calibration is not None:
            tb = self._calibration.apply(self._workloads[i], tb)
        return tb

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self._materialize(j) for j in range(len(self))[i]]
        return self._materialize(range(len(self))[i])

    def __iter__(self) -> Iterator[TimeBreakdown]:
        return (self._materialize(i) for i in range(len(self)))

    @property
    def totals(self) -> np.ndarray:
        """Total seconds per workload (calibration applied if present)."""
        t = np.fromiter((r[0][0] for r in self._rows), np.float64,
                        len(self._rows))
        if self._calibration is not None:
            m = np.fromiter(
                (self._calibration.multiplier(w) for w in self._workloads),
                np.float64, len(self._rows))
            t = t * m
        return t

    def argmin(self) -> int:
        """Index of the cheapest configuration (the paper's argmin)."""
        return int(np.argmin(self.totals))


class TableResult(Sequence):
    """Lazy sequence view over a columnar table prediction.

    ``totals`` (and ``field_totals``) are whole-column NumPy reads with
    calibration folded in; indexing materializes a single row's
    ``TimeBreakdown`` — the only per-row Python in the table path.
    """

    __slots__ = ("_cols", "_table", "_calibration", "_mult", "_totals")

    def __init__(self, cols, table: WorkloadTable,
                 calibration: Optional[object] = None):
        self._cols = cols
        self._table = table
        self._calibration = calibration
        self._mult = None
        self._totals = None

    def __len__(self) -> int:
        return self._cols.n

    def _multipliers(self) -> Optional[np.ndarray]:
        """Per-row calibration multipliers replicating
        ``Calibration.multiplier`` (exact name, then class, then global)."""
        cal = self._calibration
        if cal is None:
            return None
        m = self._mult
        if m is None:
            t = self._table
            if cal.per_class:
                m = t.per_wclass(
                    lambda c: cal.per_class.get(c, cal.global_scale))
            else:
                m = np.full(len(t), cal.global_scale)
            if cal.per_case:
                m = m.copy()
                for i in range(len(t)):
                    v = cal.per_case.get(t.name(i))
                    if v is not None:
                        m[i] = v
            self._mult = m
        return m

    @property
    def totals(self) -> np.ndarray:
        t = self._totals
        if t is None:
            t = self._cols.totals()
            m = self._multipliers()
            if m is not None:
                t = t * m
            self._totals = t
        return t

    def field_totals(self, field: str) -> np.ndarray:
        """One TimeBreakdown field as a column (calibration applied) —
        the pareto-front input."""
        t = self._cols.field_col(TB_FIELDS.index(field))
        m = self._multipliers()
        return t if m is None else t * m

    def _materialize(self, i: int) -> TimeBreakdown:
        tb = tb_from_row(self._cols.row(i))
        m = self._multipliers()
        if m is not None:
            scale = float(m[i])
            tb = tb.scaled(scale)
            tb.detail["m_case"] = scale
        return tb

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self._materialize(j) for j in range(len(self))[i]]
        return self._materialize(range(len(self))[i])

    def __iter__(self) -> Iterator[TimeBreakdown]:
        return (self._materialize(i) for i in range(len(self)))

    def argmin(self) -> int:
        return int(np.argmin(self.totals))


class SweepEngine:
    """Batched, memoizing front end over the analytical model backends."""

    def __init__(self, *, use_cache: bool = True,
                 max_entries: int = 200_000,
                 max_batch_entries: int = 32,
                 max_table_entries: int = 32):
        self.use_cache = use_cache
        self.max_entries = max_entries
        self.max_batch_entries = max_batch_entries
        self.max_table_entries = max_table_entries
        self._cache: "OrderedDict[Tuple, Row]" = OrderedDict()
        self._batch_cache: "OrderedDict[Tuple, List[Row]]" = OrderedDict()
        self._table_cache: "OrderedDict[Tuple, object]" = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self._m_table_s = {c: metrics.histogram(
            "repro_sweep_predict_table_seconds",
            "predict_table latency split by cache outcome", cache=c)
            for c in ("hit", "miss")}
        self._m_rows = {c: metrics.counter(
            "repro_sweep_rows_total",
            "Rows priced through the engine, split by cache outcome",
            cache=c) for c in ("hit", "miss")}

    # ------------------------------------------------------------- queries
    def predict_batch(self, workloads: Sequence[Workload],
                      hw: HardwareParams, *,
                      model: Optional[str] = None,
                      calibration: Optional[object] = None) -> BatchResult:
        """Predict every workload on ``hw``; order-preserving.

        ``model`` overrides routing exactly as in ``predict.predict``;
        ``calibration`` (core.calibrate.Calibration) is applied per result
        on materialization.  Returns a lazy ``BatchResult`` sequence whose
        items equal the scalar ``predict`` outputs bit-for-bit.
        """
        route = model or default_route(hw)
        _rows_fn(route)                       # raises on unknown route
        n = len(workloads)

        if not self.use_cache:
            with self._lock:
                self.misses += n
            self._m_rows["miss"].inc(n)
            return BatchResult(_eval_rows(route, workloads, hw),
                               workloads, calibration)

        hwk = hardware_key(hw)

        # tier 1: whole-batch digest — an identical replayed sweep returns
        # its cached rows without touching the per-row cache at all.  The
        # key is a fixed-size blake2b digest (plus the tiny string tuples),
        # not the concatenated buffers, so cached batches don't pin a raw
        # copy of every workload vector.
        bkey = None
        if n >= SCALAR_CUTOFF:
            h = hashlib.blake2b(b"".join([w._nvec for w in workloads]),
                                digest_size=16)
            bkey = (hwk, route, h.digest(), n,
                    tuple(w.precision for w in workloads),
                    tuple(w.wclass for w in workloads),
                    tuple(tuple(sorted(w.hit_rates.items()))
                          if w.hit_rates else () for w in workloads)
                    if any(w.hit_rates for w in workloads) else None)
            with self._lock:
                hit = self._batch_cache.get(bkey)
                if hit is not None:
                    self._batch_cache.move_to_end(bkey)
                    self.hits += n
                    self._m_rows["hit"].inc(n)
                    return BatchResult(hit, workloads, calibration)

        # tier 2: per-row content keys (LRU)
        rows: List[Optional[Row]] = [None] * n
        miss_idx: List[int] = []
        keys: List[Tuple] = [None] * n  # type: ignore[list-item]
        cache_get = self._cache.get
        move_to_end = self._cache.move_to_end
        with self._lock:
            for i, w in enumerate(workloads):
                k = (hwk, route, workload_key(w))
                keys[i] = k
                row = cache_get(k)
                if row is not None:
                    move_to_end(k)
                    rows[i] = row
                else:
                    miss_idx.append(i)
            self.hits += n - len(miss_idx)
            self.misses += len(miss_idx)
        if n > len(miss_idx):
            self._m_rows["hit"].inc(n - len(miss_idx))
        if miss_idx:
            self._m_rows["miss"].inc(len(miss_idx))

        if miss_idx:
            if len(miss_idx) == n:
                fresh = _eval_rows(route, workloads, hw)
                rows = fresh
            else:
                fresh = _eval_rows(
                    route, [workloads[i] for i in miss_idx], hw)
                for i, row in zip(miss_idx, fresh):
                    rows[i] = row
            with self._lock:
                for i, row in zip(miss_idx, fresh):
                    self._cache[keys[i]] = row
                while len(self._cache) > self.max_entries:
                    self._cache.popitem(last=False)

        if bkey is not None:
            with self._lock:
                self._batch_cache[bkey] = rows
                while len(self._batch_cache) > self.max_batch_entries:
                    self._batch_cache.popitem(last=False)

        return BatchResult(rows, workloads, calibration)  # type: ignore

    def predict_table(self, table: WorkloadTable, hw: HardwareParams, *,
                      model: Optional[str] = None,
                      calibration: Optional[object] = None,
                      cache: Optional[bool] = None) -> TableResult:
        """Columnar prediction over a WorkloadTable.

        Runs the route's table core directly on the column arrays; the
        result is memoized whole under the table's content token, so
        replaying a sweep is one token hash + dict hit (strictly faster
        than recomputing — benchmarks/sweep_bench.py asserts it).

        ``cache`` overrides ``self.use_cache`` for this call — the
        streaming reductions pass ``cache=False`` so transient lattice
        chunks neither pay the content-token hash nor churn the table LRU.
        """
        route = model or default_route(hw)
        cols_fn = _cols_fn(route)
        n = len(table)
        t0 = time.monotonic()

        if not (self.use_cache if cache is None else cache):
            cols = cols_fn(table, hw)
            with self._lock:
                self.misses += n
            self._m_rows["miss"].inc(n)
            self._m_table_s["miss"].observe(time.monotonic() - t0)
            return TableResult(cols, table, calibration)

        key = (hardware_key(hw), route, table.content_token())
        with self._lock:
            hit = self._table_cache.get(key)
            if hit is not None:
                self._table_cache.move_to_end(key)
                self.hits += n
        if hit is not None:
            self._m_rows["hit"].inc(n)
            self._m_table_s["hit"].observe(time.monotonic() - t0)
            return TableResult(hit, table, calibration)
        cols = cols_fn(table, hw)
        with self._lock:
            self.misses += n
            self._table_cache[key] = cols
            while len(self._table_cache) > self.max_table_entries:
                self._table_cache.popitem(last=False)
        self._m_rows["miss"].inc(n)
        self._m_table_s["miss"].observe(time.monotonic() - t0)
        return TableResult(cols, table, calibration)

    def predict(self, w: Workload, hw: HardwareParams, *,
                model: Optional[str] = None,
                calibration: Optional[object] = None) -> TimeBreakdown:
        """Scalar entry point: a batch of one."""
        return self.predict_batch(
            [w], hw, model=model, calibration=calibration)[0]

    # --------------------------------------------------------------- admin
    def cache_stats(self) -> Dict[str, int]:
        """Consistent snapshot: counters and sizes read under the cache
        lock, so ``hits + misses`` can never tear mid-update."""
        with self._lock:
            return {"hits": self.hits, "misses": self.misses,
                    "entries": len(self._cache),
                    "batch_entries": len(self._batch_cache),
                    "table_entries": len(self._table_cache)}

    def clear_cache(self) -> None:
        with self._lock:
            self._cache.clear()
            self._batch_cache.clear()
            self._table_cache.clear()
            self.hits = self.misses = 0


_DEFAULT: Optional[SweepEngine] = None
_DEFAULT_LOCK = threading.Lock()


def default_engine() -> SweepEngine:
    """Process-wide shared engine (what ``predict.predict`` delegates to)."""
    global _DEFAULT
    if _DEFAULT is None:
        with _DEFAULT_LOCK:
            if _DEFAULT is None:
                _DEFAULT = SweepEngine()
    return _DEFAULT


def _reinit_after_fork_in_child() -> None:
    """Fork safety for the module-level engine (``core.parallel`` workers).

    A forked child inherits the parent's engine through copy-on-write; its
    locks may be held by parent threads that do not exist in the child, and
    any entries it appends would silently diverge from the parent's LRU
    accounting.  Re-key every module lock and start the child's caches
    empty — workers must never rely on (or appear to mutate) parent cache
    state."""
    global _DEFAULT_LOCK, _HW_TOKENS_LOCK
    _DEFAULT_LOCK = threading.Lock()
    _HW_TOKENS_LOCK = threading.Lock()
    eng = _DEFAULT
    if eng is not None:
        eng._lock = threading.Lock()
        eng._cache.clear()
        eng._batch_cache.clear()
        eng._table_cache.clear()
        eng.hits = eng.misses = 0


if hasattr(os, "register_at_fork"):
    os.register_at_fork(after_in_child=_reinit_after_fork_in_child)


# ---------------------------------------------------------------------------
# Table-native entry points + fused reductions (paper's argmin, columnar).
# ---------------------------------------------------------------------------

def predict_table(table: WorkloadTable, hw: HardwareParams, *,
                  model: Optional[str] = None,
                  calibration: Optional[object] = None,
                  engine: Optional[SweepEngine] = None) -> TableResult:
    """Module-level columnar prediction through the shared engine."""
    return (engine or default_engine()).predict_table(
        table, hw, model=model, calibration=calibration)


@dataclass(frozen=True)
class SweepWinner:
    """One selected configuration from a fused table reduction."""

    index: int
    name: str
    total: float
    breakdown: TimeBreakdown


def _winner(res: TableResult, table: WorkloadTable, i: int) -> SweepWinner:
    return SweepWinner(index=i, name=table.name(i),
                       total=float(res.totals[i]), breakdown=res[i])


# The *_from_result reductions operate on an already-priced TableResult
# window [lo, hi): this is what lets one fused columnar evaluation answer
# many independent requests (the serving front end coalesces concurrent
# small tables into one ``predict_table`` call and reduces each request's
# row window separately).  ``table`` names the window's rows locally (row
# ``lo`` of ``res`` is row 0 of ``table``); winner indices are local to
# the window, so the answers are bit-identical to evaluating each window's
# table on its own — the model backends are row-elementwise.

def argmin_from_result(res: TableResult, table: WorkloadTable,
                       lo: int = 0, hi: Optional[int] = None) -> SweepWinner:
    """Fused argmin over a priced window: reduce on the totals column,
    materialize one row.  Ties resolve to the lowest row index (matching a
    stable sort of the full materialization)."""
    t = res.totals[lo:hi]
    if not len(t):
        raise ValueError("argmin of an empty sweep")
    i = int(np.argmin(t))
    return SweepWinner(index=i, name=table.name(i), total=float(t[i]),
                       breakdown=res[lo + i])


def topk_from_result(res: TableResult, table: WorkloadTable, k: int,
                     lo: int = 0, hi: Optional[int] = None
                     ) -> List[SweepWinner]:
    """Top-k cheapest rows of a priced window, ascending; ties break by
    row index (stable argsort)."""
    t = res.totals[lo:hi]
    order = np.argsort(t, kind="stable")[:max(k, 0)]
    return [SweepWinner(index=int(i), name=table.name(int(i)),
                        total=float(t[i]), breakdown=res[lo + int(i)])
            for i in order]


def pareto_from_result(res: TableResult, table: WorkloadTable,
                       objectives: Sequence[str] = ("compute", "memory"),
                       lo: int = 0, hi: Optional[int] = None
                       ) -> List[SweepWinner]:
    """Non-dominated rows of a priced window, ordered by (first objective,
    index)."""
    if not objectives:
        raise ValueError("pareto needs at least one objective")
    pts = np.stack([res.field_totals(f)[lo:hi] for f in objectives],
                   axis=1)
    t = res.totals[lo:hi]
    front = np.flatnonzero(_pareto_front_mask(pts))
    order = front[np.argsort(pts[front, 0], kind="stable")]
    return [SweepWinner(index=int(i), name=table.name(int(i)),
                        total=float(t[i]), breakdown=res[lo + int(i)])
            for i in order]


def argmin_table(table: WorkloadTable, hw: HardwareParams, *,
                 model: Optional[str] = None,
                 calibration: Optional[object] = None,
                 engine: Optional[SweepEngine] = None) -> SweepWinner:
    """Fused argmin: reduce on the totals column, materialize one row.

    Ties resolve to the lowest row index (matching a stable sort of the
    full materialization)."""
    res = predict_table(table, hw, model=model, calibration=calibration,
                        engine=engine)
    return argmin_from_result(res, table)


def topk_table(table: WorkloadTable, hw: HardwareParams, k: int, *,
               model: Optional[str] = None,
               calibration: Optional[object] = None,
               engine: Optional[SweepEngine] = None) -> List[SweepWinner]:
    """Fused top-k cheapest configurations, ascending; ties break by row
    index (stable argsort — bit-identical ordering to sorting a full
    materialization by (total, index))."""
    res = predict_table(table, hw, model=model, calibration=calibration,
                        engine=engine)
    return topk_from_result(res, table, k)


def pareto_table(table: WorkloadTable, hw: HardwareParams, *,
                 objectives: Sequence[str] = ("compute", "memory"),
                 model: Optional[str] = None,
                 calibration: Optional[object] = None,
                 engine: Optional[SweepEngine] = None) -> List[SweepWinner]:
    """Non-dominated (all objectives minimized) configurations.

    ``objectives`` are TimeBreakdown field names (``total``, ``compute``,
    ``memory``, ...).  A row is dominated if some other row is <= on every
    objective and < on at least one.  Duplicate points are all kept.
    Returns winners ordered by (first objective, index).  Reduction runs on
    the column arrays (chunked O(n^2/chunk) dominance test); only the
    front's rows materialize.
    """
    if not objectives:
        raise ValueError("pareto_table needs at least one objective")
    res = predict_table(table, hw, model=model, calibration=calibration,
                        engine=engine)
    return pareto_from_result(res, table, objectives)


def _dominated_mask(points: np.ndarray, against: np.ndarray) -> np.ndarray:
    """Row mask: points strictly dominated (<= everywhere, < somewhere) by
    some row of ``against``.  Blocked O(|points|*|against|/block) so the
    broadcast temporaries stay bounded."""
    n = points.shape[0]
    out = np.zeros(n, dtype=bool)
    if not len(against):
        return out
    block_rows = max(1, 262_144 // max(len(against), 1))
    for lo in range(0, n, block_rows):
        block = points[lo:lo + block_rows]            # (c, d)
        le = (against[None, :, :] <= block[:, None, :]).all(-1)   # (c, m)
        lt = (against[None, :, :] < block[:, None, :]).any(-1)
        out[lo:lo + block_rows] = (le & lt).any(1)
    return out


def _pareto_front_mask(pts: np.ndarray) -> np.ndarray:
    """True for non-dominated rows (duplicates all kept — equal points
    never strictly dominate each other)."""
    return ~_dominated_mask(pts, pts)


# ---------------------------------------------------------------------------
# Streaming fused reductions (O(chunk) peak memory, bit-identical winners).
#
# ``reduce_stream`` walks a LatticeSpec (or an already-built table) chunk by
# chunk, prices each chunk through the columnar path with the table cache
# bypassed, and folds the chunk's columns into constant-size reducer state:
# argmin keeps one winner, top-k a bounded heap, pareto an incremental
# frontier.  Winners (index, total, tie-order, name, breakdown) are
# bit-identical to the materialized argmin_table/topk_table/pareto_table —
# chunk columns are byte-identical windows of the full table and every
# comparison uses the same floats in the same order.
#
# Reducers are picklable and mergeable: ``core.parallel`` ships fresh ones
# to worker processes (each worker streams its own shard through its own
# SweepEngine) and merges the partials in shard order.
# ---------------------------------------------------------------------------

def as_spec(source) -> LatticeSpec:
    """Coerce a sweep source (LatticeSpec | WorkloadTable) to a spec."""
    if isinstance(source, LatticeSpec):
        return source
    if isinstance(source, WorkloadTable):
        return LatticeSpec.from_table(source)
    raise TypeError(f"expected LatticeSpec or WorkloadTable, "
                    f"got {type(source).__name__}")


def effective_jobs(jobs) -> int:
    """Worker-count policy: ``None``/1 -> in-process serial; 0 or "auto" ->
    ``os.cpu_count()``; N -> N."""
    if jobs is None:
        return 1
    if jobs == 0 or jobs == "auto":
        return max(1, os.cpu_count() or 1)
    return max(1, int(jobs))


class ArgminStream:
    """O(1)-state streaming argmin; cross-chunk ties keep the earlier
    global row (strict <), matching ``np.argmin`` over the full column —
    including NaN semantics (``np.argmin`` returns the first NaN position
    when any total is NaN, so an incoming NaN beats any finite best and an
    established NaN best is never displaced)."""

    def __init__(self):
        self.best_total = math.inf
        self.best_index = -1
        self.best_name = None
        self.best_tb = None

    def _beats(self, total: float) -> bool:
        if self.best_index < 0:
            return True
        if math.isnan(self.best_total):
            return False                     # earliest NaN already won
        return math.isnan(total) or total < self.best_total

    def update(self, offset: int, table: WorkloadTable,
               res: TableResult) -> None:
        t = res.totals
        i = int(np.argmin(t))                # first NaN if the chunk has one
        if self._beats(float(t[i])):
            self.best_total = float(t[i])
            self.best_index = offset + i
            self.best_name = table.name(i)
            self.best_tb = res[i]

    def merge(self, other: "ArgminStream") -> None:
        """``other`` covers a LATER shard (merge runs in shard order)."""
        if other.best_index >= 0 and self._beats(other.best_total):
            self.best_total = other.best_total
            self.best_index = other.best_index
            self.best_name = other.best_name
            self.best_tb = other.best_tb

    def result(self) -> SweepWinner:
        if self.best_index < 0:
            raise ValueError("argmin of an empty sweep")
        return SweepWinner(index=self.best_index, name=self.best_name,
                           total=self.best_total, breakdown=self.best_tb)


class TopkStream:
    """Bounded max-heap of the k cheapest rows ordered by (total, index) —
    the same lexicographic order a stable argsort of the full totals column
    yields, so the final list is bit-identical to ``topk_table``.  NaN
    totals sort after every finite total in original index order (stable
    argsort semantics): they are kept in a side list and only surface when
    the whole sweep has fewer than k finite rows."""

    def __init__(self, k: int):
        self.k = int(k)
        self._heap: List[Tuple] = []   # (-total, -gidx, name, breakdown)
        self._nans: List[Tuple] = []   # (gidx, name, total, breakdown)

    def update(self, offset: int, table: WorkloadTable,
               res: TableResult) -> None:
        k = self.k
        if k <= 0:
            return
        t = res.totals
        heap = self._heap
        if len(heap) == k and float(t.min()) >= -heap[0][0]:
            # chunks stream in ascending index order, so an incoming row
            # that merely equals the current worst loses the tie (a NaN
            # t.min() compares False and falls through to the full scan)
            return
        kk = min(k, len(t))
        thresh = np.partition(t, kk - 1)[kk - 1]
        if math.isnan(thresh):
            # fewer than kk finite totals in this chunk: every finite row
            # is a candidate, NaN rows go to the side list below
            cand = np.flatnonzero(~np.isnan(t))
        else:
            cand = np.flatnonzero(t <= thresh)   # NaN compares False
        cand = cand[np.argsort(t[cand], kind="stable")]
        for li in cand.tolist():
            total = float(t[li])
            gidx = offset + li
            if len(heap) < k:
                heapq.heappush(heap, (-total, -gidx, table.name(li),
                                      res[li]))
            elif (-total, -gidx) > heap[0][:2]:
                heapq.heapreplace(heap, (-total, -gidx, table.name(li),
                                         res[li]))
            else:
                break   # candidates are ascending: the rest lose too
        if len(heap) < k and len(self._nans) < k:
            # NaNs can only surface when the whole sweep has < k finite
            # rows, i.e. when the heap never fills — so a full heap makes
            # this scan (and all future ones) unnecessary
            for li in np.flatnonzero(np.isnan(t)).tolist():
                if len(self._nans) >= k:
                    break
                self._nans.append((offset + li, table.name(li),
                                   float(t[li]), res[li]))

    def merge(self, other: "TopkStream") -> None:
        entries = sorted(self._heap + other._heap,
                         key=lambda e: (-e[0], -e[1]))[:self.k]
        self._heap = entries
        heapq.heapify(self._heap)
        self._nans = sorted(self._nans + other._nans,
                            key=lambda e: e[0])[:self.k]

    def result(self) -> List[SweepWinner]:
        entries = sorted(self._heap, key=lambda e: (-e[0], -e[1]))
        out = [SweepWinner(index=-e[1], name=e[2], total=-e[0],
                           breakdown=e[3]) for e in entries]
        for gidx, name, total, tb in self._nans[:self.k - len(out)]:
            out.append(SweepWinner(index=gidx, name=name, total=total,
                                   breakdown=tb))
        return out


class ParetoStream:
    """Incremental pareto frontier: each chunk's non-dominated rows are
    cross-filtered against the running frontier both ways.  Dominance is
    transitive, so pruning dominated points early never changes the final
    front; ordering is restored at ``result()``."""

    def __init__(self, objectives: Sequence[str] = ("compute", "memory")):
        if not objectives:
            raise ValueError("pareto needs at least one objective")
        self.objectives = tuple(objectives)
        self.pts = np.empty((0, len(self.objectives)))
        self.entries: List[Tuple] = []   # (gidx, name, total, breakdown)

    def update(self, offset: int, table: WorkloadTable,
               res: TableResult) -> None:
        pts = np.stack([res.field_totals(f) for f in self.objectives],
                       axis=1)
        keep = _pareto_front_mask(pts)
        if self.entries:
            kidx = np.flatnonzero(keep)
            if len(kidx):
                keep[kidx[_dominated_mask(pts[kidx], self.pts)]] = False
        cand = np.flatnonzero(keep)
        if not len(cand):
            return
        cand_pts = pts[cand]
        if self.entries:
            dead = _dominated_mask(self.pts, cand_pts)
            if dead.any():
                alive = ~dead
                self.pts = self.pts[alive]
                self.entries = [e for e, a in zip(self.entries, alive) if a]
        t = res.totals
        for li in cand.tolist():
            self.entries.append((offset + li, table.name(li), float(t[li]),
                                 res[li]))
        self.pts = np.concatenate([self.pts, cand_pts], axis=0)

    def merge(self, other: "ParetoStream") -> None:
        if not other.entries:
            return
        if not self.entries:
            self.pts, self.entries = other.pts, other.entries
            return
        mine_dead = _dominated_mask(self.pts, other.pts)
        theirs_dead = _dominated_mask(other.pts, self.pts)
        self.pts = np.concatenate([self.pts[~mine_dead],
                                   other.pts[~theirs_dead]], axis=0)
        self.entries = \
            [e for e, d in zip(self.entries, mine_dead) if not d] + \
            [e for e, d in zip(other.entries, theirs_dead) if not d]

    def result(self) -> List[SweepWinner]:
        def key(j):
            v = self.pts[j, 0]
            # stable-argsort order: finite ascending, NaN last by index
            if math.isnan(v):
                return (1, 0.0, self.entries[j][0])
            return (0, float(v), self.entries[j][0])

        order = sorted(range(len(self.entries)), key=key)
        return [SweepWinner(index=self.entries[j][0],
                            name=self.entries[j][1],
                            total=self.entries[j][2],
                            breakdown=self.entries[j][3]) for j in order]


class TotalsStream:
    """Collects the (calibrated) totals column chunk by chunk — the
    streaming analogue of ``TableResult.totals`` for consumers that need
    every row's total (validation suites) but not the result columns."""

    def __init__(self):
        self._parts: List[Tuple[int, np.ndarray]] = []

    def update(self, offset: int, table: WorkloadTable,
               res: TableResult) -> None:
        self._parts.append((offset, res.totals))

    def merge(self, other: "TotalsStream") -> None:
        self._parts.extend(other._parts)

    def result(self) -> np.ndarray:
        if not self._parts:
            return np.empty(0)
        return np.concatenate([p for _, p in sorted(self._parts,
                                                    key=lambda x: x[0])])


def reduce_stream(source, hw: HardwareParams, reducers: Sequence, *,
                  chunk_size: Optional[int] = None,
                  model: Optional[str] = None,
                  calibration: Optional[object] = None,
                  engine: Optional[SweepEngine] = None,
                  lo: int = 0, hi: Optional[int] = None,
                  offset_base: int = 0) -> Sequence:
    """Price ``source`` chunk by chunk and fold every chunk into the given
    reducers.  Peak memory is O(chunk): one chunk's columns + its result
    columns are live at a time; nothing is memoized (``cache=False``).

    ``offset_base`` shifts the reducers' global row numbering — sharded
    workers that hold only a window of the full lattice pass the window's
    global start so merged winners keep full-lattice indices."""
    spec = as_spec(source)
    eng = engine or default_engine()
    size = int(chunk_size or DEFAULT_CHUNK_ROWS)
    offset = offset_base + lo
    for chunk in spec.chunks(size, lo=lo, hi=hi):
        res = eng.predict_table(chunk, hw, model=model,
                                calibration=calibration, cache=False)
        for r in reducers:
            r.update(offset, chunk, res)
        offset += len(chunk)
    return reducers


def _run_reducers(source, hw: HardwareParams,
                  factories: Sequence[Callable[[], object]], *,
                  chunk_size: Optional[int], model: Optional[str],
                  calibration: Optional[object],
                  engine: Optional[SweepEngine], jobs,
                  pool=None) -> Sequence:
    njobs = pool.njobs if (pool is not None and jobs is None) \
        else effective_jobs(jobs)
    if njobs > 1:
        from . import parallel
        return parallel.reduce_sharded(
            source, hw, factories, jobs=njobs, chunk_size=chunk_size,
            model=model, calibration=calibration, pool=pool)
    return reduce_stream(source, hw, [f() for f in factories],
                         chunk_size=chunk_size, model=model,
                         calibration=calibration, engine=engine)


def argmin_stream(source, hw: HardwareParams, *,
                  chunk_size: Optional[int] = None,
                  model: Optional[str] = None,
                  calibration: Optional[object] = None,
                  engine: Optional[SweepEngine] = None,
                  jobs=None, pool=None) -> SweepWinner:
    """Streaming argmin over a LatticeSpec or WorkloadTable — bit-identical
    winner to ``argmin_table`` on the materialized lattice, peak memory
    O(chunk).  ``jobs`` > 1 (or 0/"auto" for ``os.cpu_count()``) shards the
    lattice across a worker pool (``core.parallel``)."""
    (red,) = _run_reducers(source, hw, [ArgminStream],
                           chunk_size=chunk_size, model=model,
                           calibration=calibration, engine=engine, jobs=jobs,
                           pool=pool)
    return red.result()


def topk_stream(source, hw: HardwareParams, k: int, *,
                chunk_size: Optional[int] = None,
                model: Optional[str] = None,
                calibration: Optional[object] = None,
                engine: Optional[SweepEngine] = None,
                jobs=None, pool=None) -> List[SweepWinner]:
    """Streaming top-k cheapest (bounded heap) — bit-identical list to
    ``topk_table`` including tie order."""
    (red,) = _run_reducers(source, hw, [partial(TopkStream, k)],
                           chunk_size=chunk_size, model=model,
                           calibration=calibration, engine=engine, jobs=jobs,
                           pool=pool)
    return red.result()


def pareto_stream(source, hw: HardwareParams, *,
                  objectives: Sequence[str] = ("compute", "memory"),
                  chunk_size: Optional[int] = None,
                  model: Optional[str] = None,
                  calibration: Optional[object] = None,
                  engine: Optional[SweepEngine] = None,
                  jobs=None, pool=None) -> List[SweepWinner]:
    """Streaming pareto frontier (incremental) — bit-identical front and
    ordering to ``pareto_table``."""
    (red,) = _run_reducers(source, hw,
                           [partial(ParetoStream, tuple(objectives))],
                           chunk_size=chunk_size, model=model,
                           calibration=calibration, engine=engine, jobs=jobs,
                           pool=pool)
    return red.result()


def predict_totals_stream(source, hw: HardwareParams, *,
                          chunk_size: Optional[int] = None,
                          model: Optional[str] = None,
                          calibration: Optional[object] = None,
                          engine: Optional[SweepEngine] = None,
                          jobs=None, pool=None) -> np.ndarray:
    """Every row's (calibrated) total, streamed — same floats as
    ``predict_table(...).totals`` with intermediates bounded by chunk."""
    (red,) = _run_reducers(source, hw, [TotalsStream],
                           chunk_size=chunk_size, model=model,
                           calibration=calibration, engine=engine, jobs=jobs,
                           pool=pool)
    return red.result()
