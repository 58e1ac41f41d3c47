"""HTTP prediction server: one ``SweepEngine``, micro-batched requests.

Stdlib only (``http.server``): the server owns one memoizing
``SweepEngine`` (so repeated sweeps hit the whole-table content-token
cache across requests and clients), one optional ``core.parallel``
``WorkerPool`` (reused across streamed-lattice requests instead of paying
pool startup per query), and one request coalescer.

Endpoints (wire bodies are ``repro_torch.serve.codec`` messages):

    GET  /v1/health        liveness + wire version + known hardware
    GET  /v1/metrics       Prometheus text exposition (no auth, read-only)
    GET  /v1/cache_stats   engine cache counters + coalescer counters
    GET  /v1/hardware      JSON directory of the hardware library
    GET  /v1/hardware/<n>  one entry as a HARDWARE message
    POST /v1/hardware      HARDWARE -> register a new entry (?overwrite=1)
    POST /v1/calibrate     CALREQ(suite) -> CALIBRATION (fit w/ holdout)
    POST /v1/predict_table REQUEST(table|spec) -> TOTALS
    POST /v1/argmin        REQUEST(table|spec) -> WINNERS (list of one)
    POST /v1/topk          REQUEST(table|spec) -> WINNERS
    POST /v1/pareto        REQUEST(table|spec) -> WINNERS
    POST /v1/predict       REQUEST, op taken from the request meta
    POST /v1/clear_cache   admin: drop every engine cache tier

Calibration-as-data: ``/v1/calibrate`` accepts a measured microbench
suite, fits per-case/per-class multipliers against this server's own
predictions with the paper's train/holdout discipline, and returns the
fitted ``Calibration`` with its full §IV-D disclosure.  ``register_as``
stores it server-side; sweep requests that name it
(``calibration=<name>``) price with its multipliers applied (and group
separately in the coalescer — calibrated and raw answers never fuse).
Registering a calibration or hardware entry is idempotent (same payload
-> same state), preserving the client's retry contract.

Micro-batching contract: concurrent **table** requests that share
(hardware, model route) and did not opt out (``coalesce=False``) are
fused — their tables concatenate into one columnar evaluation and each
request's answer reduces over its own row window
(``sweep.*_from_result``).  The model backends are row-elementwise, so
fused answers are bit-identical to evaluating each request alone; the
fused table prices with the memo cache bypassed so transient
concatenations never churn the table LRU.  Single-request groups take the
normal cached path, which is what makes identical replayed sweeps a
content-token hit.  **Spec** (streamed-lattice) requests are never
coalesced — each one already streams O(chunk) and may shard across the
worker pool.

Failures decode-side (bad magic, truncation, unknown hardware, wrong op)
return HTTP 400 with an ERROR message body; unexpected server faults
return 500.  The serving loop itself never dies on a bad request.

Fault tolerance (the full status-code contract lives in ``README.md``
and ``errors.py``): the coalescer queue is depth-bounded — past
``max_queue_depth`` the server sheds load with 503 + ``Retry-After``
instead of piling up handler threads; requests carrying a deadline
budget (``X-Repro-Deadline-S``) are shed once the budget is spent; the
mutating endpoints (``POST /v1/hardware``, ``DELETE /v1/hardware/<n>``,
``POST /v1/calibrate``, ``POST /v1/clear_cache``) can be gated behind a
shared-secret token (401) and a token-bucket rate limit (429); one
poisoned request inside a fused batch fails alone with 400 while its
batchmates answer normally; and SIGTERM triggers a graceful drain —
stop accepting, 503 new work, finish in-flight batches, snapshot
``--state-dir`` calibrations, reap the pool.
"""
from __future__ import annotations

import argparse
import hmac
import json
import os
import sys
import threading
import time
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core import hardware, sweep
from ..core.workload import LatticeSpec, WorkloadTable
from ..obs import metrics, trace
from . import codec, errors

#: refuse request bodies beyond this (a 2^31-row table is a streamed
#: lattice, not an upload)
MAX_BODY_BYTES = 1 << 30

#: coalescer admission bound: submissions beyond this many parked
#: requests are shed with 503 + Retry-After (load shedding instead of an
#: unbounded handler-thread pile-up)
DEFAULT_MAX_QUEUE_DEPTH = 1024

#: Retry-After hint (seconds) sent with drain/overload 503s
SHED_RETRY_AFTER_S = 0.05
DRAIN_RETRY_AFTER_S = 1.0

#: extra seconds the coalescer holds a batch open for companions.  The
#: default is 0: batching happens naturally — requests that arrive while
#: an evaluation is in flight pile up and drain as one batch — so a lone
#: sequential request never pays artificial latency.  Raise it to force
#: deterministic fusion (tests) or on high-RTT links.
DEFAULT_COALESCE_WINDOW_S = 0.0

#: fused evaluations stop growing past this estimated row-cost budget —
#: a coalesced batch should stay LLC-friendly, not become an accidental
#: materialization.  The budget is in *vectorized-row units*: a plain row
#: costs 1 unit, a scalar-fallback row costs ``SCALAR_ROW_COST`` (so a
#: batch of expensive rows fuses ~50x fewer rows and stays inside the
#: same latency envelope as a vectorized one)
MAX_FUSED_ROWS = 262_144

#: estimated cost of one scalar-fallback row (explicit hit-rate rows take
#: the wavefront model's per-row latency walk, ~10us vs ~0.2us
#: vectorized) relative to a vectorized row
SCALAR_ROW_COST = 50

CONTENT_TYPE = "application/x-repro-wire"
METRICS_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

_STAGE_HELP = ("Per-stage request latency "
               "(parse/queue_wait/fuse/evaluate/encode/write)")


_STAGE_HISTS: dict = {}


def _stage_hist(stage: str) -> metrics.Histogram:
    # memoized: the registry's get-or-create takes its lock and
    # re-validates names (~2.4us) — too much for twice per request
    h = _STAGE_HISTS.get(stage)
    if h is None:
        h = _STAGE_HISTS[stage] = metrics.histogram(
            "repro_serve_stage_seconds", _STAGE_HELP, stage=stage)
    return h


class _Pending:
    """One in-flight table request parked in the coalescer."""

    __slots__ = ("op", "table", "k", "objectives", "event", "result",
                 "error", "deadline", "max_rows", "on_done", "trace_id",
                 "t_submit")

    def __init__(self, op: str, table: WorkloadTable, k: Optional[int],
                 objectives: Optional[Tuple[str, ...]],
                 deadline: Optional[float] = None,
                 max_rows: Optional[int] = None,
                 on_done=None,
                 trace_id: Optional[str] = None):
        self.op = op
        self.table = table
        self.k = k
        self.objectives = objectives
        self.deadline = deadline          # time.monotonic() cutoff or None
        #: per-request fused-batch budget hint (clamped to the server's
        #: bound — a hint tightens, never raises)
        self.max_rows = max_rows
        #: completion callback for event-loop callers (invoked on the
        #: coalescer thread after result/error is set)
        self.on_done = on_done
        #: client trace id (16-hex) riding the request through fusion,
        #: dedup, and poison-isolation solo re-runs
        self.trace_id = trace_id
        self.t_submit = time.monotonic()
        self.event = threading.Event()
        self.result = None
        self.error: Optional[BaseException] = None


class TokenBucket:
    """Thread-safe token bucket: ``rate_per_s`` refill, ``burst`` cap.

    ``try_acquire()`` returns 0.0 on admit, else the seconds until a
    token will exist (the 429 ``Retry-After`` hint)."""

    def __init__(self, rate_per_s: float, burst: int):
        if rate_per_s <= 0 or burst < 1:
            raise ValueError(f"need rate > 0 and burst >= 1, got "
                             f"rate={rate_per_s} burst={burst}")
        self.rate = float(rate_per_s)
        self.burst = float(burst)
        self._tokens = float(burst)
        self._stamp = time.monotonic()
        self._lock = threading.Lock()

    def try_acquire(self) -> float:
        with self._lock:
            now = time.monotonic()
            self._tokens = min(self.burst,
                               self._tokens + (now - self._stamp) * self.rate)
            self._stamp = now
            if self._tokens >= 1.0:
                self._tokens -= 1.0
                return 0.0
            return (1.0 - self._tokens) / self.rate


class _NamedCalibration:
    """A registered calibration: the object plus its registry name (the
    name is the coalescer group key — two requests naming the same
    registered calibration may fuse; raw and calibrated never do)."""

    __slots__ = ("name", "cal")

    def __init__(self, name: str, cal):
        self.name = name
        self.cal = cal


class Coalescer:
    """Fuses concurrent small table requests into one columnar evaluation.

    Handler threads ``submit()`` and block; one worker thread drains the
    queue (optionally holding each batch open ``window_s`` for
    companions), groups by (hardware token, model route), prices each
    group once, and answers every request from its own row window.
    """

    def __init__(self, engine: sweep.SweepEngine,
                 window_s: float = DEFAULT_COALESCE_WINDOW_S,
                 max_fused_rows: int = MAX_FUSED_ROWS,
                 max_queue_depth: int = DEFAULT_MAX_QUEUE_DEPTH):
        self.engine = engine
        self.window_s = window_s
        self.max_fused_rows = max_fused_rows
        #: admission bound: submissions finding this many requests already
        #: parked are shed with ``ServerOverloaded`` (-> 503) instead of
        #: blocking another handler thread behind an unbounded queue
        self.max_queue_depth = max_queue_depth
        self._q: deque = deque()
        self._cv = threading.Condition()
        self._closed = False
        self.stats = {"requests": 0, "batches": 0, "fused_evaluations": 0,
                      "coalesced_requests": 0, "fused_rows": 0,
                      "deduped_requests": 0, "dedup_rows_saved": 0,
                      "shed_overload": 0, "shed_deadline": 0,
                      "isolated_failures": 0}
        #: one lock covers every stats mutation AND the snapshot read, so
        #: ``/v1/cache_stats`` can never observe a torn combination (e.g.
        #: ``deduped_requests`` updated by the worker thread while
        #: ``requests`` still shows the pre-submit value)
        self._stats_lock = threading.Lock()
        # metric series (get-or-create against the process registry)
        self._m_queue_wait = _stage_hist("queue_wait")
        self._m_fuse = _stage_hist("fuse")
        self._m_evaluate = _stage_hist("evaluate")
        self._m_batch_reqs = metrics.histogram(
            "repro_serve_fused_batch_requests",
            "Requests answered per fused evaluation",
            buckets=metrics.COUNT_BUCKETS)
        self._m_batch_rows = metrics.histogram(
            "repro_serve_fused_batch_rows",
            "Rows in each fused columnar evaluation",
            buckets=metrics.COUNT_BUCKETS)
        self._m_batch_cost = metrics.histogram(
            "repro_serve_fused_batch_cost",
            "Estimated row-cost units of each fused evaluation",
            buckets=metrics.COUNT_BUCKETS)
        self._m_dedup = metrics.counter(
            "repro_serve_deduped_requests_total",
            "Requests answered from another request's evaluation")
        self._m_dedup_rows = metrics.counter(
            "repro_serve_dedup_rows_saved_total",
            "Rows not re-evaluated thanks to cross-request dedup")
        self._m_shed = {
            reason: metrics.counter(
                "repro_serve_shed_total",
                "Requests shed instead of evaluated", reason=reason)
            for reason in ("overload", "deadline")}
        self._m_isolated = metrics.counter(
            "repro_serve_isolated_failures_total",
            "Fused batches that failed and were re-run solo")
        self._m_depth = metrics.gauge(
            "repro_serve_queue_depth",
            "Requests parked in the coalescer queue")
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="serve-coalescer")
        self._thread.start()

    def _bump(self, **deltas) -> None:
        """Apply one consistent multi-counter stats update."""
        with self._stats_lock:
            for k, n in deltas.items():
                self.stats[k] += n

    def stats_snapshot(self) -> Dict[str, int]:
        """A mutually consistent copy of every coalescer counter."""
        with self._stats_lock:
            return dict(self.stats)

    # ---------------------------------------------------------- client side
    def submit_async(self, op: str, table: WorkloadTable, hw,
                     model: Optional[str] = None, *,
                     k: Optional[int] = None,
                     objectives: Optional[Tuple[str, ...]] = None,
                     calibration: Optional[_NamedCalibration] = None,
                     deadline: Optional[float] = None,
                     max_rows: Optional[int] = None,
                     on_done=None,
                     trace_id: Optional[str] = None) -> _Pending:
        """Park a request without blocking: the returned ``_Pending``'s
        ``event`` fires (and ``on_done`` runs, on the coalescer thread)
        once ``result``/``error`` is set.  This is the binary front end's
        entry point — its event loop must never block on an evaluation."""
        req = _Pending(op, table, k, objectives, deadline,
                       max_rows=max_rows, on_done=on_done,
                       trace_id=trace_id)
        group = (sweep.hardware_key(hw), model or sweep.default_route(hw),
                 calibration.name if calibration else None)
        with self._cv:
            if self._closed:
                raise RuntimeError("coalescer is shut down")
            if len(self._q) >= self.max_queue_depth:
                self._bump(shed_overload=1)
                self._m_shed["overload"].inc()
                raise errors.ServerOverloaded(
                    f"coalescer queue at its depth bound "
                    f"({self.max_queue_depth} requests parked) — load "
                    f"shed, retry after backoff",
                    retry_after_s=SHED_RETRY_AFTER_S)
            self._q.append((group, hw, model, calibration, req))
            self._bump(requests=1)
            self._m_depth.set(len(self._q))
            self._cv.notify()
        return req

    def submit(self, op: str, table: WorkloadTable, hw, model: Optional[str],
               k: Optional[int] = None,
               objectives: Optional[Tuple[str, ...]] = None,
               calibration: Optional[_NamedCalibration] = None,
               deadline: Optional[float] = None,
               max_rows: Optional[int] = None,
               trace_id: Optional[str] = None):
        req = self.submit_async(op, table, hw, model, k=k,
                                objectives=objectives,
                                calibration=calibration, deadline=deadline,
                                max_rows=max_rows, trace_id=trace_id)
        req.event.wait()
        if req.error is not None:
            raise req.error
        return req.result

    def _finish(self, r: _Pending) -> None:
        """Fire a parked request's completion: event first (blocking
        submitters wake), then the event-loop callback.  A callback that
        throws must not kill the coalescer thread."""
        r.event.set()
        cb = r.on_done
        if cb is not None:
            try:
                cb(r)
            except Exception:                # noqa: BLE001
                pass

    # ---------------------------------------------------------- worker side
    def _loop(self) -> None:
        while True:
            with self._cv:
                while not self._q and not self._closed:
                    self._cv.wait()
                if self._closed and not self._q:
                    return
            # batch is open: let concurrent companions land before draining
            if self.window_s > 0:
                time.sleep(self.window_s)
            with self._cv:
                drained = list(self._q)
                self._q.clear()
                self._m_depth.set(0)
            if drained:
                self._run_batch(drained)

    def _run_batch(self, drained: List) -> None:
        self._bump(batches=1)
        groups: Dict[Tuple, List] = {}
        for group, hw, model, calibration, req in drained:
            groups.setdefault(group, []).append((hw, model, calibration,
                                                 req))
        for members in groups.values():
            hw, model, calibration = members[0][:3]
            reqs = [m[3] for m in members]
            try:
                self._run_group(hw, model, calibration, reqs)
            except BaseException as e:       # noqa: BLE001 — reply, not die
                for r in reqs:
                    if not r.event.is_set():
                        r.error = e
                        self._finish(r)

    @staticmethod
    def _est_cost(table: WorkloadTable) -> int:
        """Estimated evaluation cost of a table in vectorized-row units.
        Rows with explicit hit rates take the wavefront model's scalar
        latency-walk fallback (~``SCALAR_ROW_COST``x a vectorized row), so
        a fused batch of them must stay ~50x smaller to hit the same
        latency budget."""
        if table.hit_rates is None:
            return len(table)
        n_scalar = sum(1 for h in table.hit_rates if h)
        return len(table) + (SCALAR_ROW_COST - 1) * n_scalar

    def _run_group(self, hw, model: Optional[str],
                   calibration: Optional[_NamedCalibration],
                   reqs: List[_Pending]) -> None:
        # split oversized groups so one fused evaluation stays inside the
        # adaptive cost budget (estimated units, not raw rows); a member's
        # ``max_rows`` hint tightens the budget for the batch it joins —
        # it is clamped to the server bound, never raises it
        start = 0
        while start < len(reqs):
            budget = float(self.max_fused_rows)
            cost = 0
            end = start
            while end < len(reqs):
                r = reqs[end]
                b = budget if r.max_rows is None \
                    else min(budget, float(r.max_rows))
                c = self._est_cost(r.table)
                if end > start and cost + c > b:
                    break
                budget = b
                cost += c
                end += 1
            self._run_fused(hw, model, calibration, reqs[start:end])
            start = end

    def _run_fused(self, hw, model: Optional[str],
                   calibration: Optional[_NamedCalibration],
                   reqs: List[_Pending]) -> None:
        cal = calibration.cal if calibration else None
        # shed requests whose deadline budget was spent while parked —
        # evaluating them would be work the client has already abandoned
        now = time.monotonic()
        live = []
        for r in reqs:
            self._m_queue_wait.observe(now - r.t_submit,
                                       trace_id=r.trace_id)
            if r.deadline is not None and now >= r.deadline:
                self._bump(shed_deadline=1)
                self._m_shed["deadline"].inc()
                r.error = errors.DeadlineExceeded(
                    "request deadline expired while queued — result would "
                    "arrive after the client stopped waiting")
                self._finish(r)
            else:
                live.append(r)
        if not live:
            return
        # cross-request dedup: requests whose tables share a content token
        # (within this group the hardware/route/calibration already match)
        # price once.  The token ignores row names — exactly like the memo
        # cache — and each request is answered from its OWN table, so
        # names stay per-request and answers remain bit-identical.
        order: List[Tuple] = []            # unique tokens, arrival order
        dedup: Dict[Tuple, List[_Pending]] = {}
        for r in live:
            tok = r.table.content_token()
            if tok in dedup:
                dedup[tok].append(r)
            else:
                dedup[tok] = [r]
                order.append(tok)
        n_dup = len(live) - len(order)
        if n_dup:
            rows_saved = sum(
                len(r.table) for tok in order for r in dedup[tok][1:])
            self._bump(deduped_requests=n_dup, dedup_rows_saved=rows_saved)
            self._m_dedup.inc(n_dup)
            self._m_dedup_rows.inc(rows_saved)
        if len(order) == 1:
            # one distinct table (a lone request, or all duplicates): the
            # memoizing solo path — identical replayed sweeps stay
            # whole-table content-token hits, and concurrent duplicates
            # now share one evaluation instead of fusing into 2N rows
            self._run_solo(dedup[order[0]], hw, model, cal)
            return
        t_fuse = time.monotonic()
        fused = WorkloadTable.concat([dedup[tok][0].table for tok in order])
        t_eval = time.monotonic()
        self._m_fuse.observe(t_eval - t_fuse, trace_id=live[0].trace_id)
        try:
            res = self.engine.predict_table(fused, hw, model=model,
                                            cache=False, calibration=cal)
        except BaseException:                # noqa: BLE001
            # one poisoned table must not share fate with its batchmates:
            # re-run each table alone so only the culprit(s) error (the
            # coalescing contract makes solo answers bit-identical)
            self._bump(isolated_failures=1)
            self._m_isolated.inc()
            for tok in order:
                self._run_solo(dedup[tok], hw, model, cal)
            return
        dt_eval = time.monotonic() - t_eval
        self._m_evaluate.observe(dt_eval, trace_id=live[0].trace_id)
        self._m_batch_reqs.observe(len(live))
        self._m_batch_rows.observe(len(fused))
        self._m_batch_cost.observe(self._est_cost(fused))
        self._bump(fused_evaluations=1, coalesced_requests=len(live),
                   fused_rows=len(fused))
        lo = 0
        for tok in order:
            members = dedup[tok]
            hi = lo + len(members[0].table)
            for i, r in enumerate(members):
                try:
                    r.result = self._answer(res, r, lo=lo, hi=hi)
                except BaseException as e:   # noqa: BLE001
                    r.error = e
                trace.record_span("serve.eval", r.trace_id,
                                  time.monotonic() - r.t_submit,
                                  op=r.op, fused=len(live),
                                  dedup=i > 0)
                self._finish(r)
            lo = hi

    def _run_solo(self, rs: List[_Pending], hw, model: Optional[str],
                  cal) -> None:
        """Evaluate one distinct table (cached path) and answer every
        request that shares its content."""
        if isinstance(rs, _Pending):
            rs = [rs]
        t_eval = time.monotonic()
        try:
            res = self.engine.predict_table(rs[0].table, hw, model=model,
                                            calibration=cal)
        except BaseException as e:           # noqa: BLE001
            for r in rs:
                r.error = e
                trace.record_span("serve.eval", r.trace_id,
                                  time.monotonic() - r.t_submit,
                                  op=r.op, solo=True, error=True)
                self._finish(r)
            return
        self._m_evaluate.observe(time.monotonic() - t_eval,
                                 trace_id=rs[0].trace_id)
        for i, r in enumerate(rs):
            try:
                r.result = self._answer(res, r, lo=0, hi=None)
            except BaseException as e:       # noqa: BLE001
                r.error = e
            trace.record_span("serve.eval", r.trace_id,
                              time.monotonic() - r.t_submit,
                              op=r.op, solo=True, dedup=i > 0)
            self._finish(r)

    @staticmethod
    def _answer(res, r: _Pending, lo: int, hi: Optional[int]):
        if r.op == "argmin":
            return [sweep.argmin_from_result(res, r.table, lo, hi)]
        if r.op == "topk":
            # k=0 must round-trip to [] like topk_table, not coerce to 1
            k = 1 if r.k is None else int(r.k)
            return sweep.topk_from_result(res, r.table, k, lo, hi)
        if r.op == "pareto":
            return sweep.pareto_from_result(
                res, r.table, r.objectives or ("compute", "memory"), lo, hi)
        # predict_table: the window's totals column
        return np.array(res.totals[lo:hi])

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        self._thread.join(timeout=5.0)


class PredictionServer:
    """The serving front end: HTTP endpoints over one engine + coalescer.

    ``port=0`` binds an ephemeral port (read it back from ``address``).
    ``jobs`` > 1 (or 0 for every core) starts a reusable ``WorkerPool``
    for streamed-lattice requests; table requests never need it.
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 0, *,
                 engine: Optional[sweep.SweepEngine] = None,
                 jobs=None,
                 coalesce_window_s: float = DEFAULT_COALESCE_WINDOW_S,
                 use_threads: Optional[bool] = None,
                 quiet: bool = True,
                 auth_token: Optional[str] = None,
                 max_queue_depth: Optional[int] = None,
                 mutate_rps: Optional[float] = None,
                 mutate_burst: int = 5,
                 state_dir: Optional[str] = None,
                 straggler_timeout_s: Optional[float] = None,
                 binary_port: Optional[int] = None,
                 max_fused_rows: Optional[int] = None,
                 metrics_enabled: Optional[bool] = None,
                 slow_request_ms: Optional[float] = None,
                 slow_log_sink=None):
        # --metrics off|on flips the process-global registry; None (the
        # in-process default) leaves whatever the host process chose
        if metrics_enabled is not None:
            metrics.set_enabled(metrics_enabled)
        #: slow-request threshold in ms (None = slow log off); lines are
        #: structured JSON carrying the request's trace id
        self.slow_request_ms = slow_request_ms
        self._slow_log_sink = slow_log_sink
        self._m_requests = {
            t: metrics.counter("repro_serve_requests_total",
                               "Sweep requests answered", transport=t)
            for t in ("http", "binary")}
        self._m_request_s = {
            t: metrics.histogram("repro_serve_request_seconds",
                                 "End-to-end sweep request latency",
                                 transport=t)
            for t in ("http", "binary")}
        self._m_slow = metrics.counter(
            "repro_serve_slow_requests_total",
            "Requests above the --slow-request-ms threshold")
        self.engine = engine or sweep.SweepEngine()
        self.coalescer = None
        self.pool = None
        self.binary = None
        self.started_at = time.time()
        self.n_requests = 0
        #: registered calibrations by name — what sweep requests with
        #: ``calibration=<name>`` resolve against
        self.calibrations: Dict[str, _NamedCalibration] = {}
        self._cal_lock = threading.Lock()
        #: shared secret gating mutating endpoints (None = open)
        self._auth_token = auth_token
        #: token bucket over mutating endpoints (None = unlimited)
        self._mutate_bucket = (TokenBucket(mutate_rps, mutate_burst)
                               if mutate_rps else None)
        self.state_dir = state_dir
        self._draining = False
        self._inflight = 0
        self._inflight_cv = threading.Condition()
        if state_dir:
            self._load_state()
        server = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):  # noqa: N802
                if not quiet:
                    BaseHTTPRequestHandler.log_message(self, fmt, *args)

            def _reply(self, status: int, body: bytes,
                       retry_after_s: Optional[float] = None,
                       content_type: str = CONTENT_TYPE) -> None:
                self.send_response(status)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(body)))
                if retry_after_s is not None:
                    self.send_header("Retry-After", f"{retry_after_s:g}")
                if self.close_connection:
                    self.send_header("Connection", "close")
                self.end_headers()
                self.wfile.write(body)

            def _track(self, handler) -> None:
                """Count the request in-flight so a graceful shutdown can
                wait for it to finish before tearing down the engine."""
                with server._inflight_cv:
                    server._inflight += 1
                try:
                    handler()
                finally:
                    with server._inflight_cv:
                        server._inflight -= 1
                        server._inflight_cv.notify_all()

            def _shed_draining(self) -> bool:
                if not server._draining:
                    return False
                self.close_connection = True
                self._reply(503, codec.encode_error(errors.ServerOverloaded(
                    "server is draining — no new work accepted",
                    retry_after_s=DRAIN_RETRY_AFTER_S)),
                    retry_after_s=DRAIN_RETRY_AFTER_S)
                return True

            def _admit_mutation(self) -> bool:
                """Auth + rate-limit gate for mutating endpoints, checked
                BEFORE the body is read (an unauthorized client should not
                get to stream a 1 GiB payload in)."""
                try:
                    server._admit_mutation(self.headers)
                    return True
                except errors.Unauthorized as e:
                    self.close_connection = True
                    self._reply(401, codec.encode_error(e))
                except errors.RateLimited as e:
                    self.close_connection = True
                    self._reply(429, codec.encode_error(e),
                                retry_after_s=e.retry_after_s)
                return False

            def do_GET(self):  # noqa: N802
                self._track(self._get)

            def do_POST(self):  # noqa: N802
                self._track(self._post)

            def do_DELETE(self):  # noqa: N802
                self._track(self._delete)

            def _get(self):
                server.n_requests += 1
                if self.path == "/v1/health":
                    self._reply(200, codec.encode_json(server.health()))
                elif self.path == "/v1/metrics":
                    # Prometheus scrape surface: plain text, no auth,
                    # read-only; still answers while draining (like
                    # health) so the last scrape sees the drain counters
                    self._reply(200,
                                server.metrics_text().encode("utf-8"),
                                content_type=METRICS_CONTENT_TYPE)
                elif self.path == "/v1/cache_stats":
                    self._reply(200, codec.encode_json(server.stats()))
                elif self.path == "/v1/hardware":
                    self._reply(200, codec.encode_json(
                        server.hardware_directory()))
                elif self.path.startswith("/v1/hardware/"):
                    name = self.path[len("/v1/hardware/"):]
                    try:
                        self._reply(200, server.hardware_entry(name))
                    except KeyError as e:
                        self._reply(404, codec.encode_error(e))
                else:
                    self._reply(404, codec.encode_error(
                        LookupError(f"unknown endpoint {self.path}")))

            def _delete(self):
                server.n_requests += 1
                if self._shed_draining():
                    return
                if not self.path.startswith("/v1/hardware/"):
                    self._reply(404, codec.encode_error(
                        LookupError(f"unknown endpoint {self.path}")))
                    return
                if not self._admit_mutation():
                    return
                name = self.path[len("/v1/hardware/"):]
                try:
                    self._reply(200, server.delete_hardware(name))
                except KeyError as e:
                    self._reply(404, codec.encode_error(e))
                except Exception as e:       # noqa: BLE001
                    self._reply(500, codec.encode_error(e))

            def _post(self):
                server.n_requests += 1
                if self._shed_draining():
                    return
                path, _, query = self.path.partition("?")
                if path in ("/v1/hardware", "/v1/calibrate",
                            "/v1/clear_cache") \
                        and not self._admit_mutation():
                    return
                deadline = None
                raw = self.headers.get(errors.DEADLINE_HEADER)
                if raw is not None:
                    try:
                        budget = float(raw)
                    except ValueError:
                        self.close_connection = True
                        self._reply(400, codec.encode_error(ValueError(
                            f"invalid {errors.DEADLINE_HEADER} header "
                            f"{raw!r}: want a relative seconds budget")))
                        return
                    if budget <= 0:
                        # the budget was spent in flight — shed before
                        # reading the body, let alone evaluating
                        self.close_connection = True
                        self._reply(503, codec.encode_error(
                            errors.DeadlineExceeded(
                                "deadline budget already spent on "
                                "arrival")))
                        return
                    deadline = time.monotonic() + budget
                # every error reply below leaves the request body unread,
                # which would desync the next request on this keep-alive
                # socket — drop the connection after answering
                try:
                    length = int(self.headers.get("Content-Length", ""))
                except ValueError:
                    self.close_connection = True
                    self._reply(411, codec.encode_error(
                        ValueError("Content-Length required")))
                    return
                if length < 0:
                    # rfile.read(-1) would block on a keep-alive socket
                    self.close_connection = True
                    self._reply(400, codec.encode_error(ValueError(
                        f"invalid Content-Length {length}")))
                    return
                if length > MAX_BODY_BYTES:
                    self.close_connection = True
                    self._reply(413, codec.encode_error(ValueError(
                        f"body of {length} bytes exceeds "
                        f"{MAX_BODY_BYTES}")))
                    return
                body = self.rfile.read(length)
                if path == "/v1/clear_cache":
                    server.engine.clear_cache()
                    self._reply(200, codec.encode_json({"cleared": True}))
                    return
                if path == "/v1/hardware":
                    overwrite = "overwrite=1" in query.split("&")
                    try:
                        self._reply(200, server.register_hardware(
                            body, overwrite=overwrite))
                    except (codec.WireFormatError, ValueError,
                            TypeError) as e:
                        self._reply(400, codec.encode_error(e))
                    except Exception as e:   # noqa: BLE001
                        self._reply(500, codec.encode_error(e))
                    return
                if path == "/v1/calibrate":
                    try:
                        self._reply(200, server.calibrate(body))
                    except (codec.WireFormatError, KeyError, ValueError,
                            TypeError) as e:
                        self._reply(400, codec.encode_error(e))
                    except Exception as e:   # noqa: BLE001
                        self._reply(500, codec.encode_error(e))
                    return
                op = path.rsplit("/", 1)[-1]
                if path not in (
                        "/v1/predict", "/v1/predict_table", "/v1/argmin",
                        "/v1/topk", "/v1/pareto"):
                    self._reply(404, codec.encode_error(
                        LookupError(f"unknown endpoint {self.path}")))
                    return
                trace_id = trace.coerce_trace_id(
                    self.headers.get(trace.TRACE_HEADER))
                t0 = time.monotonic()
                status = 200
                try:
                    out = server.handle_request(
                        body, expect_op=None if op == "predict" else op,
                        deadline=deadline, trace_id=trace_id)
                    t_w = time.monotonic()
                    self._reply(200, out)
                    _stage_hist("write").observe(time.monotonic() - t_w,
                                                 trace_id=trace_id)
                except errors.ServerOverloaded as e:
                    status = 503
                    self._reply(503, codec.encode_error(e),
                                retry_after_s=e.retry_after_s)
                except errors.DeadlineExceeded as e:
                    status = 503
                    self._reply(503, codec.encode_error(e))
                except (codec.WireFormatError, KeyError, ValueError,
                        TypeError) as e:
                    status = 400
                    self._reply(400, codec.encode_error(e))
                except Exception as e:       # noqa: BLE001
                    status = 500
                    self._reply(500, codec.encode_error(e))
                server._observe_request("http", op, trace_id,
                                        time.monotonic() - t0, status)

        # bind before starting the coalescer thread / worker processes: a
        # bind failure (port in use) must not leak children the caller
        # has no handle to reap
        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self.httpd.daemon_threads = True
        try:
            self.coalescer = Coalescer(
                self.engine, window_s=coalesce_window_s,
                max_fused_rows=(MAX_FUSED_ROWS if max_fused_rows is None
                                else int(max_fused_rows)),
                max_queue_depth=(DEFAULT_MAX_QUEUE_DEPTH
                                 if max_queue_depth is None
                                 else max_queue_depth))
            if jobs is not None and sweep.effective_jobs(jobs) > 1:
                from ..core import parallel
                self.pool = parallel.WorkerPool(
                    jobs, use_threads=use_threads,
                    straggler_timeout_s=straggler_timeout_s)
            if binary_port is not None:
                from .binserver import BinaryFrontend
                self.binary = BinaryFrontend(self, host, binary_port)
        except BaseException:
            self.httpd.server_close()
            if self.coalescer is not None:
                self.coalescer.close()
            if self.pool is not None:
                self.pool.close()
            raise

    # ------------------------------------------------------------ plumbing
    @property
    def address(self) -> Tuple[str, int]:
        return self.httpd.server_address[:2]

    @property
    def url(self) -> str:
        host, port = self.address
        return f"http://{host}:{port}"

    @property
    def binary_address(self) -> Optional[Tuple[str, int]]:
        return self.binary.address if self.binary is not None else None

    def start(self) -> "PredictionServer":
        """Serve on a daemon thread (tests, in-process demos)."""
        self._serving = True
        if self.binary is not None:
            self.binary.start()
        t = threading.Thread(target=self.httpd.serve_forever, daemon=True,
                             name="serve-http")
        t.start()
        return self

    def serve_forever(self) -> None:
        self._serving = True
        if self.binary is not None:
            self.binary.start()
        self.httpd.serve_forever()

    def begin_drain(self) -> None:
        """Graceful-drain entry point (the SIGTERM handler): flag the
        server as draining — new POST/DELETE work gets 503 +
        ``Retry-After`` while GETs (health probes) still answer — and
        stop the accept loop.  ``shutdown()`` then finishes in-flight
        requests and snapshots state.  Idempotent."""
        if self._draining:
            return
        self._draining = True
        if self.binary is not None:
            self.binary.begin_drain()
        if getattr(self, "_serving", False):
            # httpd.shutdown() blocks until serve_forever exits; the
            # SIGTERM handler runs *on* the serve_forever thread, so the
            # call must come from elsewhere or it deadlocks
            threading.Thread(target=self.httpd.shutdown, daemon=True,
                             name="serve-drain").start()

    def shutdown(self) -> None:
        self._draining = True
        # httpd.shutdown() blocks on serve_forever's exit event, which
        # never fires for a server that was bound but never started
        if getattr(self, "_serving", False):
            self.httpd.shutdown()
        # let in-flight handler threads finish before tearing down the
        # engine/coalescer they are using
        with self._inflight_cv:
            self._inflight_cv.wait_for(lambda: self._inflight == 0,
                                       timeout=10.0)
        if self.state_dir:
            self._save_state()
        self.httpd.server_close()
        if self.binary is not None:
            self.binary.close()
        self.coalescer.close()
        if self.pool is not None:
            self.pool.close()

    def __enter__(self) -> "PredictionServer":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()

    # ------------------------------------------------------------- queries
    def health(self) -> Dict:
        with self._cal_lock:
            n_cal = len(self.calibrations)
        bin_addr = self.binary_address
        return {"status": "draining" if self._draining else "ok",
                "draining": self._draining,
                "wire_version": codec.WIRE_VERSION,
                "hardware": sorted(hardware.REGISTRY),
                "n_calibrations": n_cal,
                "uptime_s": time.time() - self.started_at,
                "n_requests": self.n_requests,
                "pool_jobs": self.pool.njobs if self.pool else 0,
                # binary auto-negotiation: clients probe health over HTTP
                # and upgrade when a binary port is advertised
                "binary_port": bin_addr[1] if bin_addr else None}

    def stats(self) -> Dict:
        """One stats schema for both transports: HTTP's
        ``GET /v1/cache_stats`` and the binary ``OP_CACHE_STATS`` frame
        both return exactly this document — engine cache counters,
        every coalescer counter (dedup/shed/isolation included), the
        live fused-row budget, and binary-frontend connection counters
        (zeroed when no binary port is bound, so the schema never
        changes shape between transports).

        Every component contributes a *consistent* snapshot taken under
        its own counter lock — the document can never show a torn
        combination like ``deduped_requests`` > ``requests``."""
        out = dict(self.engine.cache_stats())
        out.update({f"coalescer_{k}": v
                    for k, v in self.coalescer.stats_snapshot().items()})
        out["coalescer_max_fused_rows"] = self.coalescer.max_fused_rows
        if self.binary is not None:
            out.update({f"binary_{k}": v
                        for k, v in self.binary.stats_snapshot().items()})
        else:
            from .binserver import BinaryFrontend
            out.update({f"binary_{k}": 0
                        for k in BinaryFrontend.STAT_KEYS})
        return out

    def metrics_text(self) -> str:
        """The Prometheus text exposition both transports serve:
        ``GET /v1/metrics`` returns it verbatim as ``text/plain`` (so a
        stock Prometheus scraper needs no adapter) and the binary
        ``OP_METRICS`` frame wraps the same string in a MSG_JSON."""
        return metrics.render_prometheus()

    def _observe_request(self, transport: str, op: str,
                         trace_id: Optional[str], duration_s: float,
                         status: int) -> None:
        """Transport-level request accounting: counter + latency
        histogram (exemplar = this trace), plus a structured slow-log
        line when the request crossed ``--slow-request-ms``."""
        self._m_requests[transport].inc()
        self._m_request_s[transport].observe(duration_s, trace_id=trace_id)
        if self.slow_request_ms is not None \
                and duration_s * 1e3 >= self.slow_request_ms:
            self._m_slow.inc()
            trace.slow_log({"event": "slow_request",
                            "transport": transport, "op": op,
                            "trace_id": trace_id,
                            "duration_ms": round(duration_s * 1e3, 3),
                            "status": status,
                            "threshold_ms": self.slow_request_ms},
                           sink=self._slow_log_sink)

    # ------------------------------------------------ admission control
    def _admit_mutation(self, headers) -> None:
        """Gate a mutating request: shared-secret auth first (401 beats
        429 — an attacker must not be able to probe the rate limiter),
        then the token bucket."""
        if self._auth_token is not None:
            supplied = headers.get(errors.AUTH_HEADER)
            if supplied is None:
                bearer = headers.get("Authorization", "")
                if bearer.startswith("Bearer "):
                    supplied = bearer[len("Bearer "):]
            if supplied is None or not hmac.compare_digest(
                    supplied.encode("utf-8", "replace"),
                    self._auth_token.encode("utf-8")):
                raise errors.Unauthorized(
                    f"mutating endpoints require the shared token in the "
                    f"{errors.AUTH_HEADER} header (or Authorization: "
                    f"Bearer)")
        if self._mutate_bucket is not None:
            wait = self._mutate_bucket.try_acquire()
            if wait > 0:
                raise errors.RateLimited(
                    f"mutation rate limit "
                    f"({self._mutate_bucket.rate:g}/s) exceeded",
                    retry_after_s=wait)

    # ------------------------------------------------ state persistence
    def _state_file(self) -> str:
        return os.path.join(self.state_dir, "calibrations.json")

    def _load_state(self) -> None:
        """Reload ``register_as`` calibrations snapshotted by a previous
        instance's drain.  A corrupt snapshot is a warning, not a crash —
        the server must come up (clients re-calibrate idempotently)."""
        path = self._state_file()
        try:
            with open(path, "r", encoding="utf-8") as f:
                blob = json.load(f)
            from ..core.calibrate import Calibration
            for name, d in dict(blob.get("calibrations", {})).items():
                self.calibrations[str(name)] = _NamedCalibration(
                    str(name), Calibration.from_dict(d))
        except FileNotFoundError:
            return
        except Exception as e:               # noqa: BLE001
            print(f"[serve] ignoring corrupt state file {path}: {e}",
                  file=sys.stderr)
            self.calibrations.clear()

    def _save_state(self) -> None:
        """Atomic snapshot (tmp + rename): a kill mid-write leaves the
        previous snapshot intact, never a half-written one."""
        os.makedirs(self.state_dir, exist_ok=True)
        path = self._state_file()
        with self._cal_lock:
            blob = {"calibrations": {name: nc.cal.to_dict()
                                     for name, nc in
                                     self.calibrations.items()}}
        tmp = path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(blob, f, indent=2, sort_keys=True)
        os.replace(tmp, path)

    # ------------------------------------------------- hardware library
    def hardware_directory(self) -> Dict:
        """GET /v1/hardware: every registry entry with a one-line summary
        (loads each entry — the directory is a browsing endpoint, not the
        hot path)."""
        out: Dict[str, Dict] = {}
        for name in sorted(hardware.REGISTRY):
            p = hardware.get(name)
            out[name] = {
                "vendor": p.vendor, "model_family": p.model_family,
                "num_sms": p.num_sms,
                "hbm_capacity_bytes": p.hbm_capacity,
                "hbm_sustained_bw": p.hbm_sustained_bw,
            }
        return {"hardware": out, "count": len(out)}

    def hardware_entry(self, name: str) -> bytes:
        """GET /v1/hardware/<name>: one entry as a HARDWARE message.

        File-backed entries travel with their full audit trail
        (provenance/units/source); runtime registrations (or entries that
        shadowed their file) travel as bare parameters."""
        from ..core import hwlib
        p = hardware.get(name)       # pointed KeyError when unknown
        path = hwlib.library_file(name)
        if path is not None:
            entry = hwlib.load_file(path)
            if entry.params == p:
                return codec.encode_hardware(entry)
        return codec.encode_hardware(p)

    def register_hardware(self, body: bytes, *,
                          overwrite: bool = False) -> bytes:
        """POST /v1/hardware: schema-validate and register an entry.

        Idempotent under the client's retry contract: re-posting a
        payload identical to the live entry succeeds without
        ``overwrite``; a *different* payload for a taken name still
        raises the collision error."""
        entry = codec.decode_hardware(body)
        p = entry.params
        existed = p.name in hardware.REGISTRY
        if existed and not overwrite and hardware.get(p.name) == p:
            return codec.encode_json({"registered": p.name,
                                      "replaced": False})
        hardware.register(p, overwrite=overwrite)
        return codec.encode_json({"registered": p.name,
                                  "replaced": existed})

    def delete_hardware(self, name: str) -> bytes:
        """DELETE /v1/hardware/<name>: tombstone-delete a registry entry
        (file-backed entries stay masked until re-registered).

        Raises ``KeyError`` (-> 404) on unknown names.  Under the retry
        contract a re-sent DELETE may observe the 404 its own first
        attempt caused — clients treat 404-on-retry as success."""
        del hardware.REGISTRY[name]          # KeyError -> 404
        return codec.encode_json({"deleted": name})

    # ---------------------------------------------- calibration-as-data
    def calibrate(self, body: bytes) -> bytes:
        """POST /v1/calibrate: fit disclosed multipliers for an uploaded
        measured suite against this server's own predictions, with the
        paper's train/holdout discipline (§IV-D).

        Deterministic (seeded split), so a client retry re-fits to the
        identical calibration — ``register_as`` stays idempotent."""
        from ..core import calibrate as calibrate_mod
        suite, params = codec.decode_calibrate_request(body)
        hw = hardware.get(params["hw"])
        model = params.get("model")

        def predict_fn(w):
            return self.engine.predict(w, hw, model=model)

        cal, report = calibrate_mod.fit_with_holdout(
            suite.workloads, suite.measured_s, predict_fn,
            mode=params["mode"],
            holdout_fraction=float(params.get("holdout_fraction", 0.3)),
            seed=int(params.get("seed", 0)))
        name = params.get("register_as")
        if name:
            with self._cal_lock:
                self.calibrations[str(name)] = _NamedCalibration(
                    str(name), cal)
        return codec.encode_calibration(cal, report)

    def _resolve_calibration(self, meta: Dict
                             ) -> Optional[_NamedCalibration]:
        name = meta.get("calibration")
        if name is None:
            return None
        with self._cal_lock:
            cal = self.calibrations.get(name)
        if cal is None:
            with self._cal_lock:
                known = sorted(self.calibrations)
            raise KeyError(
                f"unknown calibration '{name}' (registered: {known}); "
                f"POST /v1/calibrate with register_as first")
        return cal

    def handle_request(self, body: bytes,
                       expect_op: Optional[str] = None,
                       deadline: Optional[float] = None,
                       trace_id: Optional[str] = None) -> bytes:
        """Decode one REQUEST message, answer it, encode the reply.

        ``deadline`` is a ``time.monotonic()`` cutoff (from the client's
        ``X-Repro-Deadline-S`` budget): coalesced requests carry it into
        the queue and are shed there; direct paths check it once before
        evaluating.  ``trace_id`` (the transport's, e.g. the
        ``X-Repro-Trace`` header) wins over the request meta's.  Split
        out from the HTTP layer so tests can drive the full
        decode-dispatch-encode path without sockets."""
        t0 = time.monotonic()
        op, source, meta = codec.decode_request(body)
        _stage_hist("parse").observe(time.monotonic() - t0,
                                     trace_id=trace_id)
        if expect_op is not None and op != expect_op:
            raise codec.WireFormatError(
                f"endpoint /v1/{expect_op} got a request for op {op!r}")
        return self.answer_decoded(op, source, meta, deadline=deadline,
                                   trace_id=trace_id)

    def _resolve_sweep(self, meta: Dict):
        """Resolve a decoded request's metadata against server state:
        ``(hw, model, k, objectives, calibration, max_rows)``.  Raises
        the same typed errors as the HTTP path (KeyError for unknown
        hardware/calibration, ValueError for a bad hint)."""
        hw = hardware.get(meta["hw"])
        model = meta.get("model")
        k = meta.get("k")
        objectives = tuple(meta["objectives"]) if meta.get("objectives") \
            else None
        calibration = self._resolve_calibration(meta)
        max_rows = meta.get("max_fused_rows")
        if max_rows is not None:
            # a hint, clamped server-side: it may tighten the fused-batch
            # budget for batches this request joins, never widen it
            if not isinstance(max_rows, int) or isinstance(max_rows, bool) \
                    or max_rows < 1:
                raise ValueError(
                    f"invalid max_fused_rows hint {max_rows!r}: want an "
                    f"int >= 1")
            max_rows = min(max_rows, self.coalescer.max_fused_rows)
        return hw, model, k, objectives, calibration, max_rows

    def answer_decoded(self, op: str, source, meta: Dict,
                       deadline: Optional[float] = None,
                       trace_id: Optional[str] = None) -> bytes:
        """Answer one already-decoded request (shared by the HTTP handler
        via ``handle_request`` and the binary front end, which decodes on
        its event loop but answers here on a worker)."""
        if trace_id is None:
            # the codec meta's additive trace_id field — the only channel
            # on the binary transport (frames have no headers)
            trace_id = trace.coerce_trace_id(meta.get("trace_id"))
        hw, model, k, objectives, calibration, max_rows = \
            self._resolve_sweep(meta)
        if deadline is not None and time.monotonic() >= deadline \
                and not (isinstance(source, WorkloadTable)
                         and meta.get("coalesce", True)):
            # coalesced requests get shed inside the queue instead, so
            # the shed is attributed (stats) and ordered with batchmates
            raise errors.DeadlineExceeded(
                "request deadline expired before evaluation")
        if isinstance(source, WorkloadTable):
            if meta.get("coalesce", True):
                result = self.coalescer.submit(op, source, hw, model,
                                               k=k, objectives=objectives,
                                               calibration=calibration,
                                               deadline=deadline,
                                               max_rows=max_rows,
                                               trace_id=trace_id)
            else:
                t_eval = time.monotonic()
                res = self.engine.predict_table(
                    source, hw, model=model,
                    calibration=calibration.cal if calibration else None)
                result = Coalescer._answer(
                    res, _Pending(op, source, k, objectives), 0, None)
                trace.record_span("serve.eval", trace_id,
                                  time.monotonic() - t_eval,
                                  op=op, solo=True, coalesce=False)
            t_enc = time.monotonic()
            out = (codec.encode_totals(result) if op == "predict_table"
                   else codec.encode_winners(result))
            _stage_hist("encode").observe(time.monotonic() - t_enc,
                                          trace_id=trace_id)
            return out
        return self._handle_spec(op, source, hw, model, k, objectives,
                                 meta, calibration)

    def _handle_spec(self, op: str, spec: LatticeSpec, hw,
                     model: Optional[str], k, objectives, meta,
                     calibration: Optional[_NamedCalibration] = None
                     ) -> bytes:
        kw = dict(chunk_size=meta.get("chunk_size"), model=model,
                  engine=self.engine, jobs=meta.get("jobs"),
                  pool=self.pool,
                  calibration=calibration.cal if calibration else None)
        if op == "argmin":
            return codec.encode_winners([sweep.argmin_stream(spec, hw,
                                                             **kw)])
        if op == "topk":
            return codec.encode_winners(sweep.topk_stream(
                spec, hw, 1 if k is None else int(k), **kw))
        if op == "pareto":
            return codec.encode_winners(sweep.pareto_stream(
                spec, hw, objectives=objectives or ("compute", "memory"),
                **kw))
        return codec.encode_totals(
            sweep.predict_totals_stream(spec, hw, **kw))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="Serve analytical sweep predictions over HTTP "
                    "(wire format: repro_torch.serve.codec)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8707,
                    help="0 binds an ephemeral port (printed on start)")
    ap.add_argument("--binary-port", type=int, default=None,
                    help="also serve the length-prefixed binary protocol "
                         "(repro_torch.serve.framing) on this port; 0 binds an "
                         "ephemeral port (printed on start); omit to "
                         "serve HTTP only")
    ap.add_argument("--max-fused-rows", type=int, default=None,
                    help="coalescer fused-batch cost budget in estimated "
                         "vectorized-row units (scalar-fallback rows "
                         f"count {SCALAR_ROW_COST}x; default "
                         f"{MAX_FUSED_ROWS})")
    ap.add_argument("--jobs", type=int, default=None,
                    help="worker pool size for streamed-lattice requests "
                         "(0 = every core; omit for serial)")
    ap.add_argument("--coalesce-window-ms", type=float,
                    default=DEFAULT_COALESCE_WINDOW_S * 1e3)
    ap.add_argument("--max-queue-depth", type=int, default=None,
                    help="coalescer admission bound: submissions past "
                         "this many parked requests are shed with 503 "
                         f"(default {DEFAULT_MAX_QUEUE_DEPTH})")
    ap.add_argument("--auth-token",
                    default=os.environ.get("REPRO_SERVE_TOKEN"),
                    help="shared secret gating mutating endpoints "
                         "(default: $REPRO_SERVE_TOKEN; unset = open)")
    ap.add_argument("--mutate-rps", type=float, default=None,
                    help="token-bucket rate limit (requests/s) on "
                         "mutating endpoints (unset = unlimited)")
    ap.add_argument("--mutate-burst", type=int, default=5,
                    help="token-bucket burst for --mutate-rps")
    ap.add_argument("--state-dir", default=None,
                    help="snapshot register_as calibrations here on "
                         "drain and reload them on startup")
    ap.add_argument("--straggler-timeout-s", type=float, default=None,
                    help="re-dispatch a worker-pool shard that exceeds "
                         "this many seconds (unset = wait forever)")
    ap.add_argument("--metrics", choices=("on", "off"), default="on",
                    help="observability kill switch: 'off' disables every "
                         "counter/histogram/span process-wide (the "
                         "/v1/metrics surface stays up but stops moving)")
    ap.add_argument("--slow-request-ms", type=float, default=None,
                    help="emit a structured JSON log line to stderr for "
                         "every sweep request slower than this many ms "
                         "(carries the request's trace id; unset = off)")
    ap.add_argument("--verbose", action="store_true")
    args = ap.parse_args(argv)
    server = PredictionServer(
        args.host, args.port, jobs=args.jobs,
        coalesce_window_s=args.coalesce_window_ms / 1e3,
        quiet=not args.verbose,
        auth_token=args.auth_token,
        max_queue_depth=args.max_queue_depth,
        mutate_rps=args.mutate_rps,
        mutate_burst=args.mutate_burst,
        state_dir=args.state_dir,
        straggler_timeout_s=args.straggler_timeout_s,
        binary_port=args.binary_port,
        max_fused_rows=args.max_fused_rows,
        metrics_enabled=(args.metrics == "on"),
        slow_request_ms=args.slow_request_ms)
    host, port = server.address
    # SIGTERM begins a graceful drain: stop accepting, 503 new work,
    # finish in-flight requests, snapshot --state-dir, reap the pool —
    # a bare process kill would instead orphan worker-pool children
    # (supervisors and benchmarks terminate the server with SIGTERM)
    import signal
    signal.signal(signal.SIGTERM, lambda *_: server.begin_drain())
    # parsed by clients that spawn the server as a subprocess — keep stable
    print(f"[serve] listening on http://{host}:{port}", flush=True)
    if server.binary is not None:
        bhost, bport = server.binary_address
        # second banner line, also parsed by subprocess spawners
        print(f"[serve] binary on {bhost}:{bport}", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.shutdown()


if __name__ == "__main__":
    main()
