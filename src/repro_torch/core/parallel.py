"""Sharded sweep execution: price lattice shards across a worker pool.

The streaming reductions in ``core.sweep`` bound peak memory by pricing one
chunk at a time; this module adds the throughput half of the contract —
pricing scales with cores instead of leaving N-1 of them idle.  The lattice
row range is split into one contiguous shard per worker; each worker
streams its shard through its own cache-free ``SweepEngine`` and returns
its reducers; the parent merges the partials in shard order.  Merged
winners (index, total, tie-order, breakdown) are bit-identical to a
single-process reduction, which is itself bit-identical to the
materialized ``argmin_table``/``topk_table``/``pareto_table``.

Inputs cross the process boundary two ways:

  * ``LatticeSpec``s are tiny (a base workload + grid arrays) and are
    pickled; workers rebuild their chunks locally via the spec's vectorized
    index arithmetic — zero bulk column traffic.
  * already-built ``WorkloadTable``s (passed directly, the top-level
    source) export their columns into ``multiprocessing.shared_memory``
    once (``SharedTable``); workers attach zero-copy NumPy views, so no
    column bytes are pickled.  A built table nested inside a concat spec
    does NOT get this treatment — it travels inside the pickled spec, so
    pass big built tables directly (or concat them into one table first)
    when sharding.

Portability: the pool prefers the ``fork`` start method (cheapest on
Linux) but passes everything workers need as task arguments, so ``spawn``
/ ``forkserver`` work identically; once ``torch`` is loaded in the parent —
or the parent has ANY live helper thread (a multithreaded process can
hold a malloc/runtime mutex at fork time and deadlock the child; the
serve front end's HTTP handler threads hit exactly this) — the pool
switches to ``forkserver``, whose server process is launched fork+exec
clean and single-threaded, so its forks are safe.  When process pools are unusable at all
(sandboxed /dev/shm, missing semaphores) a thread pool runs the same shard
function in-process — NumPy releases the GIL on the large column kernels,
so threads still overlap.  Worker exceptions propagate to the caller
(``future.result()`` re-raises; a hard worker death surfaces as
``BrokenProcessPool``) — never a silent hang.  With a
``straggler_timeout_s``, a worker past its deadline (or a dead pool) gets
its shard re-dispatched once in the parent — safe because shard pricing
is a pure function and chunk reductions are idempotent and bit-identical
— and ``StragglerError`` surfaces only when both attempts die.  Forked
workers start with
cleared engine caches (``sweep._reinit_after_fork_in_child``) so parent
cache state is never trusted or mutated through copy-on-write.
"""
from __future__ import annotations

import math
import multiprocessing
import sys
import threading
import time
from concurrent.futures import BrokenExecutor, ProcessPoolExecutor, \
    ThreadPoolExecutor
from concurrent.futures import TimeoutError as _FutTimeout
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from . import sweep as sweep_mod
from . import workload as workload_mod
from ..obs import metrics
from .hardware import HardwareParams

__all__ = ["SharedTable", "StragglerError", "WorkerPool", "map_jobs",
           "processes_available", "reduce_sharded", "reduce_sharded_multi",
           "resolve_jobs"]


# pool-level series (process registry; near-free when metrics are off)
_M_SHARD_S = metrics.histogram(
    "repro_pool_shard_seconds",
    "Shard wall clock from submit to worker completion")
_M_STRAGGLER = metrics.counter(
    "repro_pool_straggler_redispatch_total",
    "Shards re-dispatched in the parent after a straggler timeout or "
    "dead pool")


def _observe_shard(t_submit: float):
    def _cb(_fut) -> None:
        _M_SHARD_S.observe(time.monotonic() - t_submit)
    return _cb


class StragglerError(RuntimeError):
    """A shard failed on its worker AND on the in-parent re-dispatch.

    One straggler (a worker past ``straggler_timeout_s``) or a dead pool
    (``BrokenProcessPool``) is recovered transparently: the shard is
    re-run once in the parent — safe because ``_price_shard`` is pure and
    chunk reductions are idempotent and bit-identical, so a duplicated
    evaluation can only produce the same answer.  Only when that second
    attempt also dies does this error surface, naming the shard and both
    causes."""


def resolve_jobs(jobs=None) -> int:
    """CLI-flag policy: ``None``/0/"auto" -> ``os.cpu_count()``, else N.

    NOTE the deliberate asymmetry with ``sweep.effective_jobs``: at the
    sweep API (``argmin_stream(jobs=None)``) omitting ``jobs`` means
    SERIAL — parallelism is opt-in; calling into THIS module is already
    the opt-in, so here an omitted ``jobs`` means every core."""
    if jobs in (None, 0, "auto"):
        return sweep_mod.effective_jobs(0)
    return sweep_mod.effective_jobs(jobs)


# --------------------------------------------------------------------------
# Shared-memory column transport (zero-pickle table shipping).
# --------------------------------------------------------------------------

def _share_array(arr: np.ndarray):
    from multiprocessing import shared_memory
    shm = shared_memory.SharedMemory(create=True, size=max(arr.nbytes, 1))
    view = np.ndarray(arr.shape, dtype=arr.dtype, buffer=shm.buf)
    view[...] = arr
    return shm, (shm.name, arr.shape, str(arr.dtype))


class SharedTable:
    """A WorkloadTable's columns exported to POSIX shared memory.

    ``handle`` / ``window_handle(lo, hi)`` are small picklable descriptors;
    ``attach`` rebuilds a zero-copy table view in another process.  Window
    handles carry only the window's slice of the per-row ``names`` /
    ``hit_rates`` tuples, so sharding an n-row table pickles n small
    objects in total across all shards — never n per shard.  The creating
    process owns the segments: call ``close()`` + ``unlink()`` when the
    consumers are done.
    """

    def __init__(self, table: workload_mod.WorkloadTable):
        self._shms = []
        descs = []
        try:
            for arr in (table.cols, table.precision_codes,
                        table.wclass_codes):
                shm, desc = _share_array(np.ascontiguousarray(arr))
                self._shms.append(shm)
                descs.append(desc)
        except Exception:
            self.close(unlink=True)
            raise
        self._descs = tuple(descs)
        self._pv = table.precision_vocab
        self._wv = table.wclass_vocab
        self._names = table.names
        self._hit_rates = table.hit_rates
        self._name_offset = table.name_offset
        self.handle = ("shm_table", self._descs, self._pv, self._wv,
                       self._names, self._hit_rates, self._name_offset,
                       0, None)

    def window_handle(self, lo: int, hi: int):
        """Descriptor for rows [lo, hi): full shm arrays (sliced on
        attach), per-row metadata sliced here so only the window's share
        crosses the pickle boundary."""
        names = self._names
        offset = 0
        if isinstance(names, tuple):
            names = names[lo:hi]
        else:
            offset = self._name_offset + lo
        hr = self._hit_rates
        if hr is not None:
            hr = hr[lo:hi]
        return ("shm_table", self._descs, self._pv, self._wv, names, hr,
                offset, lo, hi)

    @staticmethod
    def attach(handle):
        """(table, shms) from a handle; caller closes the shms when done."""
        from multiprocessing import shared_memory
        _, descs, pv, wv, names, hr, offset, lo, hi = handle
        shms, arrs = [], []
        for name, shape, dtype in descs:
            shm = shared_memory.SharedMemory(name=name)
            shms.append(shm)
            a = np.ndarray(shape, dtype=np.dtype(dtype), buffer=shm.buf)
            a = a[lo:hi] if hi is not None else a[lo:]
            a.flags.writeable = False
            arrs.append(a)
        table = workload_mod.WorkloadTable(
            arrs[0], arrs[1], pv, arrs[2], wv, names, hr,
            name_offset=offset)
        return table, shms

    def close(self, unlink: bool = False) -> None:
        for shm in self._shms:
            try:
                shm.close()
                if unlink:
                    shm.unlink()
            except OSError:
                pass


# --------------------------------------------------------------------------
# Pool plumbing.
# --------------------------------------------------------------------------

_PROC_OK: Optional[bool] = None


def _probe() -> int:
    return 42


def _mp_context(allow_fork: bool = True):
    methods = multiprocessing.get_all_start_methods()
    # The reference's condition names "jax".  In the port the hazard is
    # torch: it starts its intra-op thread pool when imported, and a forked
    # child cannot use the parent's CUDA context.  In the port this refuses
    # fork always: importing this module runs core/__init__, which imports
    # microbench and so torch.  Every pool is a forkserver (or spawn).
    if allow_fork and "fork" in methods and "torch" not in sys.modules \
            and threading.active_count() <= 1:
        return multiprocessing.get_context("fork")   # COW, no re-import
    if "forkserver" in methods:
        # forking a multithreaded process (torch loaded, or any live helper
        # thread — e.g. the serve front end's HTTP handlers) can deadlock
        # in a mutex some other thread held at fork time (malloc arenas,
        # runtime locks).  The forkserver's server process is launched
        # fork+exec clean and single-threaded, so its forks are safe — at
        # the cost of workers re-importing repro_torch.core.
        return multiprocessing.get_context("forkserver")
    return multiprocessing.get_context("spawn")


def processes_available() -> bool:
    """One-shot probe that a worker process can actually start (sandboxes
    commonly break semaphores or /dev/shm); memoized per process."""
    global _PROC_OK
    if _PROC_OK is None:
        try:
            with ProcessPoolExecutor(max_workers=1,
                                     mp_context=_mp_context()) as ex:
                _PROC_OK = ex.submit(_probe).result() == 42
        except Exception:
            _PROC_OK = False
    return _PROC_OK


def _make_pool(njobs: int, use_threads: Optional[bool],
               allow_fork: bool = True):
    """(pool, is_processes).  ``use_threads`` forces the fallback."""
    if use_threads is None:
        use_threads = not processes_available()
    if use_threads:
        return ThreadPoolExecutor(max_workers=njobs), False
    return ProcessPoolExecutor(
        max_workers=njobs, mp_context=_mp_context(allow_fork)), True


class WorkerPool:
    """A reusable worker pool for repeated sharded reductions.

    ``reduce_sharded``/``reduce_sharded_multi`` normally build and tear
    down an executor per call — the right trade for one big sweep, and
    ~100ms of pure overhead per request for a serving front end that
    answers streamed-lattice queries all day.  A ``WorkerPool`` is that
    executor kept alive: pass it as the ``pool=`` argument (or through
    ``argmin_stream(..., pool=...)``) and the shard tasks reuse the same
    worker processes.  Shard workers never retain sweep state between
    tasks — each ``_price_shard`` call builds a fresh cache-free
    ``SweepEngine`` — so reuse cannot serve stale predictions.  Close
    (or use as a context manager) when done.
    """

    def __init__(self, jobs=None, use_threads: Optional[bool] = None,
                 straggler_timeout_s: Optional[float] = None):
        self.njobs = resolve_jobs(jobs)
        #: default per-shard deadline for reductions run through this
        #: pool: a worker past it is treated as a straggler and its shard
        #: re-dispatched once (see ``reduce_sharded_multi``); ``None``
        #: waits forever (the historical behavior)
        self.straggler_timeout_s = straggler_timeout_s
        self._use_threads = use_threads
        self._lock = threading.Lock()
        # never fork: ProcessPoolExecutor starts workers lazily at first
        # submit, so a fork approved while single-threaded here could
        # execute after the caller starts helper threads (the held-mutex
        # child deadlock _mp_context avoids).  Per-call reduce_sharded
        # pools submit immediately inside the same call, so only this
        # long-lived pool needs to give up COW for safety.
        self.executor, self.is_processes = _make_pool(
            self.njobs, use_threads, allow_fork=False)
        self._closed = False

    def recover(self, broken=None) -> None:
        """Replace a broken executor with a fresh one so the *next*
        reduction gets real workers again (a ``BrokenProcessPool`` poisons
        every future submitted to that executor forever).  ``broken``
        guards against concurrent recoveries rebuilding twice: the swap
        only happens if the live executor is still the one that broke."""
        with self._lock:
            if self._closed:
                return
            if broken is not None and self.executor is not broken:
                return
            old = self.executor
            self.executor, self.is_processes = _make_pool(
                self.njobs, self._use_threads, allow_fork=False)
        try:
            old.shutdown(wait=False, cancel_futures=True)
        except Exception:                   # noqa: BLE001 — best effort
            pass

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            _shutdown(self.executor)

    def __enter__(self) -> "WorkerPool":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _shutdown(pool) -> None:
    try:
        pool.shutdown(wait=True, cancel_futures=True)
    except TypeError:                        # pragma: no cover (<3.9)
        pool.shutdown(wait=True)


def _open_source(payload):
    """Worker side: payload -> (spec, shms-to-close)."""
    if payload[0] == "shm_table":
        table, shms = SharedTable.attach(payload)
        return sweep_mod.as_spec(table), shms
    return payload[1], []


#: test seam for fault injection: when set, called as ``hook(lo, hi)`` at
#: the top of every shard evaluation.  Lets the fault-injection tests
#: make a specific shard hang or die inside a *threads* pool (process
#: workers re-import this module, so a monkeypatched hook never reaches
#: them — which is exactly why the straggler path needs the seam).
_SHARD_FAULT_HOOK: Optional[Callable[[int, int], None]] = None


def _price_shard(payload, hw: HardwareParams, passes: Sequence[Tuple],
                 lo: int, hi: int, offset_base: int,
                 chunk_size: int) -> List[Sequence]:
    """Worker body: stream rows [lo, hi) of the opened source through a
    private engine, once per (factories, model, calibration) pass, so one
    pool prices every route a caller needs (e.g. model + roofline)."""
    if _SHARD_FAULT_HOOK is not None:
        _SHARD_FAULT_HOOK(lo, hi)
    spec, shms = _open_source(payload)
    try:
        out = []
        for factories, model, calibration in passes:
            reducers = [f() for f in factories]
            sweep_mod.reduce_stream(
                spec, hw, reducers, chunk_size=chunk_size, model=model,
                calibration=calibration,
                engine=sweep_mod.SweepEngine(use_cache=False),
                lo=lo, hi=hi, offset_base=offset_base)
            out.append(reducers)
        return out
    finally:
        for shm in shms:
            shm.close()


def _shard_bounds(n: int, njobs: int, chunk_size: int) -> List[Tuple[int,
                                                                     int]]:
    """Contiguous per-worker row ranges, chunk-aligned so no worker pays a
    ragged sub-chunk in the middle of its shard."""
    chunks_total = math.ceil(n / chunk_size)
    per = math.ceil(chunks_total / njobs)
    bounds = []
    for j in range(njobs):
        lo = min(j * per * chunk_size, n)
        hi = min((j + 1) * per * chunk_size, n)
        if hi > lo:
            bounds.append((lo, hi))
    return bounds


def _shard_result(fut, task: Tuple, timeout_s: Optional[float],
                  pool: Optional["WorkerPool"], executor):
    """One shard's partials, with straggler/dead-worker recovery.

    ``timeout_s=None`` waits forever (historical behavior).  Otherwise a
    worker past the deadline — or a pool that died under it
    (``BrokenProcessPool``) — triggers ONE re-dispatch of the shard,
    executed synchronously in the parent: ``_price_shard`` is a pure
    function of its arguments and chunk reductions are idempotent and
    bit-identical, so pricing the shard twice can only yield the same
    partials (the abandoned worker's result, if it ever lands, is simply
    dropped with its future).  Genuine worker exceptions (a bad model
    name, a ValueError from the backend) propagate unchanged — retrying
    deterministic errors just doubles the cost of raising them.
    """
    if timeout_s is None:
        return fut.result()
    try:
        return fut.result(timeout=timeout_s)
    except (_FutTimeout, BrokenExecutor) as first:
        fut.cancel()
        _M_STRAGGLER.inc()
        if pool is not None and isinstance(first, BrokenExecutor):
            pool.recover(broken=executor)
        payload, hw, passes, lo, hi, base, size = task
        try:
            return _price_shard(payload, hw, passes, lo, hi, base, size)
        except BaseException as second:
            raise StragglerError(
                f"shard rows [{base + lo}, {base + hi}) failed twice: "
                f"worker attempt: {type(first).__name__}: {first}; "
                f"in-parent re-dispatch: {type(second).__name__}: "
                f"{second}") from second


def reduce_sharded(source, hw: HardwareParams,
                   factories: Sequence[Callable[[], object]], *,
                   jobs=None, chunk_size: Optional[int] = None,
                   model: Optional[str] = None,
                   calibration=None,
                   use_threads: Optional[bool] = None,
                   pool: Optional[WorkerPool] = None,
                   straggler_timeout_s: Optional[float] = None) -> Sequence:
    """Run the streaming reducers sharded across a worker pool.

    Returns the merged reducers (same shapes ``sweep.reduce_stream``
    returns); results are bit-identical to a serial reduction.  A worker
    exception (or a hard worker death) propagates to the caller.
    ``pool`` reuses a live ``WorkerPool`` instead of starting (and tearing
    down) an executor for this call.  ``straggler_timeout_s`` bounds each
    shard's wall clock: a straggling or dead worker gets its shard
    re-dispatched once in the parent (bit-identical — see
    ``_shard_result``), and ``StragglerError`` surfaces only when both
    attempts die.
    """
    return reduce_sharded_multi(
        source, hw, [(tuple(factories), model, calibration)], jobs=jobs,
        chunk_size=chunk_size, use_threads=use_threads, pool=pool,
        straggler_timeout_s=straggler_timeout_s)[0]


def reduce_sharded_multi(source, hw: HardwareParams,
                         passes: Sequence[Tuple], *,
                         jobs=None, chunk_size: Optional[int] = None,
                         use_threads: Optional[bool] = None,
                         pool: Optional[WorkerPool] = None,
                         straggler_timeout_s: Optional[float] = None
                         ) -> List[Sequence]:
    """``reduce_sharded`` for several (factories, model, calibration)
    passes over the same source: one pool (and one shared-memory export)
    prices every pass per shard — callers that need multiple routes (e.g.
    ``validate_suite``'s model + roofline columns) pay the pool start
    once.  Returns one merged reducer list per pass, in order."""
    spec = sweep_mod.as_spec(source)
    n = len(spec)
    size = int(chunk_size or workload_mod.DEFAULT_CHUNK_ROWS)
    if straggler_timeout_s is None and pool is not None:
        straggler_timeout_s = pool.straggler_timeout_s
    if pool is not None and jobs is None:
        jobs = pool.njobs
    njobs = min(resolve_jobs(jobs), max(1, math.ceil(n / size)))
    if njobs <= 1:
        return [sweep_mod.reduce_stream(
            spec, hw, [f() for f in factories], chunk_size=size,
            model=model, calibration=calibration,
            engine=sweep_mod.SweepEngine(use_cache=False))
            for factories, model, calibration in passes]

    bounds = _shard_bounds(n, njobs, size)
    procs_ok = pool.is_processes if pool is not None else (
        use_threads is not True and processes_available())
    shared = None
    if isinstance(spec, workload_mod._TableSpec) and procs_ok:
        try:
            shared = SharedTable(spec.table)
        except OSError:
            shared = None                    # pickle the table instead
    if shared is not None:
        # window payloads: shm arrays + only this shard's names/hit_rates
        tasks = [(shared.window_handle(lo, hi), 0, hi - lo, lo)
                 for lo, hi in bounds]
    else:
        tasks = [(("spec", spec), lo, hi, 0) for lo, hi in bounds]

    passes = [(tuple(fs), model, calibration)
              for fs, model, calibration in passes]
    if pool is not None:
        executor, owned = pool.executor, False
    else:
        executor, _procs = _make_pool(njobs, use_threads)
        owned = True
    try:
        futs = []
        for payload, lo, hi, base in tasks:
            t_submit = time.monotonic()
            f = executor.submit(_price_shard, payload, hw, passes,
                                lo, hi, base, size)
            f.add_done_callback(_observe_shard(t_submit))
            futs.append(f)
        partials = [
            _shard_result(f, (payload, hw, passes, lo, hi, base, size),
                          straggler_timeout_s, pool, executor)
            for f, (payload, lo, hi, base) in zip(futs, tasks)]
    finally:
        if owned:
            _shutdown(executor)
        if shared is not None:
            shared.close(unlink=True)

    merged = [list(reducers) for reducers in partials[0]]
    for part in partials[1:]:
        for merged_pass, part_pass in zip(merged, part):
            for r, p in zip(merged_pass, part_pass):
                r.merge(p)
    return merged


def map_jobs(fn: Callable, args_list: Sequence[Tuple], *,
             jobs=None, use_threads: Optional[bool] = None) -> List:
    """Order-preserving parallel map of ``fn(*args)`` over ``args_list``
    (generic shard runner for non-table work, e.g. plan pricing).  Serial
    when one worker suffices (a single task, or ``jobs=1``); an omitted
    ``jobs`` means every core (see ``resolve_jobs``).  Worker exceptions
    propagate."""
    if not args_list:
        return []
    njobs = min(resolve_jobs(jobs), len(args_list))
    if njobs <= 1:
        return [fn(*a) for a in args_list]
    pool, _procs = _make_pool(njobs, use_threads)
    try:
        futs = [pool.submit(fn, *a) for a in args_list]
        return [f.result() for f in futs]
    finally:
        _shutdown(pool)
