"""Blocking client for the prediction server (stdlib ``http.client``).

One ``PredictionClient`` is safe to share across threads: each thread
keeps its own persistent HTTP/1.1 connection (``threading.local``), so a
load generator with N threads holds N sockets — reconnecting per request
would dominate the microsecond-scale model latencies being measured.

The client speaks exactly the in-process sweep API shapes:
``argmin``/``topk``/``pareto`` return ``SweepWinner`` objects and
``predict_totals`` returns the float64 totals column, all bit-identical
to calling ``sweep.argmin_table``/... locally (the acceptance criterion
tests/test_serve_server.py pins).  Pass a built ``WorkloadTable`` for
sweeps you hold, or a lazy ``LatticeSpec`` to let the server stream a
lattice far bigger than the wire could carry materialized.

Fault tolerance (the full contract lives in ``serve/README.md``):

* **Split timeouts** — ``connect_timeout`` (default 5 s) bounds the TCP
  handshake independently of ``timeout`` (the read budget); a dead host
  no longer costs a full read timeout just to fail to connect.
* **Retries with backoff** — transport faults (reset, stale keep-alive,
  truncated frame), corrupt replies (the codec's CRC32 catches bit
  flips in transit) and retryable statuses (429/503) are re-sent up to
  ``max_retries`` times with exponential backoff + jitter, honoring the
  server's ``Retry-After`` hint.  Safe because every endpoint is
  idempotent (the server's documented contract).
* **Deadlines** — ``deadline_s=...`` on any call bounds the *whole*
  call, connect + reads + every retry; the budget is computed once at
  entry, so retries and reconnects shrink it rather than reset it.  The
  remaining budget travels in the ``X-Repro-Deadline-S`` header so the
  server can shed work the caller has already abandoned.
* **Circuit breaker** — ``breaker_threshold`` consecutive connection
  failures open the circuit: further calls fail fast with
  ``CircuitOpenError`` instead of each paying a connect timeout, until
  a ``breaker_cooldown_s`` half-open probe succeeds.
* **Auth** — ``auth_token`` is stamped on every request
  (``X-Auth-Token``) for servers gating their mutating endpoints.

Transports: sweeps ride the length-prefixed binary protocol
(:mod:`repro_torch.serve.framing`) when the server offers one, falling back
to HTTP otherwise.  ``transport="auto"`` (the default) probes
``/v1/health`` once for an advertised ``binary_port``; ``"binary"``
requires it; ``"http"`` never upgrades.  The binary path keeps one
persistent socket per thread, supports **pipelining** (see
:meth:`argmin_many`: many request ids in flight, replies demuxed by
id), and carries the exact same deadline/backoff/circuit-breaker
semantics — server faults arrive as typed in-band error frames instead
of status codes, and every retryable case (severed socket, corrupt
frame, overload shed) re-sends under the same budget rules as HTTP.
"""
from __future__ import annotations

import argparse
import http.client
import random
import socket
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..obs import metrics, trace
from . import codec, errors
from .framing import (FLAG_ERROR, OP_CACHE_STATS, OP_HEALTH, OP_METRICS,
                      OP_SWEEP, FrameParser, pack_frame)

#: server fault classes rebuilt from binary error frames by name —
#: parity with the HTTP status mapping (401/429/503)
_FAULT_BY_NAME = {
    "Unauthorized": errors.Unauthorized,
    "RateLimited": errors.RateLimited,
    "ServerOverloaded": errors.ServerOverloaded,
    "DeadlineExceeded": errors.DeadlineExceeded,
}

#: faults the binary path retries in-band, mirroring HTTP's 429/503
#: handling (DeadlineExceeded replies only happen when the caller set a
#: budget, so the caller's own deadline bounds the retries)
_RETRYABLE_NAMES = ("RateLimited", "ServerOverloaded", "DeadlineExceeded")

# client-side series (process registry; near-free when metrics are off)
_M_ATTEMPTS = {t: metrics.counter("repro_client_attempts_total",
                                  "Request attempts (retries included)",
                                  transport=t)
               for t in ("http", "binary")}
_M_ATTEMPT_S = {t: metrics.histogram("repro_client_attempt_seconds",
                                     "Per-attempt request latency",
                                     transport=t)
                for t in ("http", "binary")}
_M_RETRIES = metrics.counter("repro_client_retries_total",
                             "Attempts that were retried after backoff")
_M_BACKOFF_S = metrics.counter("repro_client_backoff_seconds_total",
                               "Cumulative seconds slept in backoff")
_M_BREAKER_OPEN = metrics.counter("repro_client_breaker_open_total",
                                  "Circuit breaker closed->open "
                                  "transitions")


def _observe_attempt(transport: str, trace_id, t0: float,
                     status=None, error=None) -> None:
    """One per-attempt span + latency observation (both transports)."""
    dt = time.monotonic() - t0
    _M_ATTEMPTS[transport].inc()
    _M_ATTEMPT_S[transport].observe(dt, trace_id=trace_id)
    attrs = {"transport": transport}
    if status is not None:
        attrs["status"] = status
    if error is not None:
        attrs["error"] = type(error).__name__
    trace.record_span("client.attempt", trace_id, dt, **attrs)


class _CircuitBreaker:
    """Consecutive-connect-failure breaker with half-open probing."""

    def __init__(self, threshold: int, cooldown_s: float):
        self.threshold = int(threshold)
        self.cooldown_s = float(cooldown_s)
        self._fails = 0
        self._opened_at: Optional[float] = None
        self._probing = False
        self._lock = threading.Lock()

    def admit(self) -> None:
        """Raise ``CircuitOpenError`` while open; after the cooldown let
        exactly one caller through as the half-open probe."""
        if self.threshold <= 0:
            return
        with self._lock:
            if self._opened_at is None:
                return
            if (time.monotonic() - self._opened_at >= self.cooldown_s
                    and not self._probing):
                self._probing = True
                return
            raise errors.CircuitOpenError(
                f"circuit open after {self._fails} consecutive "
                f"connection failures — failing fast (half-open probe "
                f"every {self.cooldown_s:g}s)")

    def success(self) -> None:
        with self._lock:
            self._fails = 0
            self._opened_at = None
            self._probing = False

    def failure(self) -> None:
        with self._lock:
            self._fails += 1
            self._probing = False
            if self._fails >= self.threshold > 0:
                if self._opened_at is None:
                    _M_BREAKER_OPEN.inc()
                self._opened_at = time.monotonic()


class PredictionClient:
    """Client for one server address."""

    def __init__(self, host: str = "127.0.0.1", port: int = 8707, *,
                 timeout: float = 120.0,
                 connect_timeout: float = 5.0,
                 max_retries: int = 3,
                 backoff_base_s: float = 0.05,
                 backoff_cap_s: float = 2.0,
                 breaker_threshold: int = 3,
                 breaker_cooldown_s: float = 1.0,
                 auth_token: Optional[str] = None,
                 transport: str = "auto",
                 binary_port: Optional[int] = None,
                 http_fallback: bool = True):
        if transport not in ("auto", "binary", "http"):
            raise ValueError(f"transport must be 'auto', 'binary' or "
                             f"'http', got {transport!r}")
        self.host = host
        self.port = port
        self.timeout = timeout
        self.connect_timeout = connect_timeout
        self.max_retries = int(max_retries)
        self.backoff_base_s = float(backoff_base_s)
        self.backoff_cap_s = float(backoff_cap_s)
        self.auth_token = auth_token
        self.transport = transport
        #: explicit binary port skips the health probe; ``None`` under
        #: auto/binary means "discover via /v1/health"
        self._binary_port = binary_port
        self._http_fallback = bool(http_fallback)
        self._breaker = _CircuitBreaker(breaker_threshold,
                                        breaker_cooldown_s)
        self._rng = random.Random()
        self._local = threading.local()
        self._conns: set = set()      # every thread's conn, for close()
        self._conns_lock = threading.Lock()
        self._bin_lock = threading.Lock()
        self._bin_resolved = False
        self._bin_target: Optional[Tuple[str, int]] = None
        #: set when auto-negotiation downgrades to HTTP for good (binary
        #: connect failed but HTTP works — e.g. a proxy in the way)
        self._bin_disabled = False

    # ------------------------------------------------------------ plumbing
    def _conn(self) -> http.client.HTTPConnection:
        conn = getattr(self._local, "conn", None)
        if conn is None:
            # the constructor timeout governs connect(); reads get their
            # own budget via sock.settimeout() once connected
            conn = http.client.HTTPConnection(
                self.host, self.port, timeout=self.connect_timeout)
            self._local.conn = conn
        with self._conns_lock:
            # re-registering on every request keeps the set accurate even
            # when http.client transparently reconnects a closed conn
            self._conns.add(conn)
        return conn

    def _discard_conn(self) -> None:
        """Drop only the calling thread's socket (stale keep-alive
        rebuild) — other threads' in-flight connections stay up."""
        conn = getattr(self._local, "conn", None)
        if conn is not None:
            with self._conns_lock:
                self._conns.discard(conn)
            try:
                conn.close()
            finally:
                self._local.conn = None

    def _once(self, method: str, path: str, body: Optional[bytes],
              headers: dict, remaining: Optional[float]
              ) -> Tuple[int, Optional[str], bytes]:
        """One attempt: connect (breaker-gated) if needed, send, read.
        Returns ``(status, retry_after_header, body_bytes)``."""
        conn = self._conn()
        if conn.sock is None:
            self._breaker.admit()
            connect_t = self.connect_timeout
            if remaining is not None:
                connect_t = min(connect_t, max(1e-3, remaining))
            conn.timeout = connect_t
            try:
                conn.connect()
            except OSError:
                self._breaker.failure()
                raise
            self._breaker.success()
        read_t = self.timeout
        if remaining is not None:
            read_t = min(read_t, max(1e-3, remaining))
        conn.sock.settimeout(read_t)
        conn.request(method, path, body=body, headers=headers)
        resp = conn.getresponse()
        data = resp.read()
        retry_after = resp.getheader("Retry-After")
        if resp.will_close:
            # the server asked us to drop the socket (Connection: close);
            # http.client already closed the conn — forget it so the next
            # attempt builds a fresh one instead of poking a dead object
            self._discard_conn()
        return resp.status, retry_after, data

    def _request(self, method: str, path: str,
                 body: Optional[bytes] = None, *,
                 deadline_s: Optional[float] = None,
                 trace_id: Optional[str] = None,
                 raw: bool = False) -> bytes:
        """Send with retries/backoff/deadline; return the verified reply.

        The deadline is computed ONCE here — reconnects, retries and
        ``close()`` shrink the remaining budget, never reset it.
        ``trace_id`` rides the ``X-Repro-Trace`` header; ``raw`` skips
        the codec envelope check for non-codec bodies (``/v1/metrics``
        is plain Prometheus text)."""
        base_headers = {}
        if body is not None:
            base_headers["Content-Type"] = "application/x-repro-wire"
        if self.auth_token is not None:
            base_headers[errors.AUTH_HEADER] = self.auth_token
        if trace_id is not None:
            base_headers[trace.TRACE_HEADER] = trace_id
        deadline = None if deadline_s is None \
            else time.monotonic() + float(deadline_s)
        last_exc: Optional[BaseException] = None
        attempt = 0
        while True:
            remaining = None
            if deadline is not None:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise errors.DeadlineExceeded(
                        f"deadline_s={deadline_s:g} spent after "
                        f"{attempt} attempt(s) on {method} {path}"
                    ) from last_exc
            headers = dict(base_headers)
            if remaining is not None:
                headers[errors.DEADLINE_HEADER] = f"{remaining:.6f}"
            ta = time.monotonic()
            try:
                status, retry_after, data = self._once(
                    method, path, body, headers, remaining)
            except (http.client.HTTPException, ConnectionError,
                    OSError) as e:
                _observe_attempt("http", trace_id, ta, error=e)
                # Severed/stale socket or truncated frame.  The failure
                # usually surfaces at getresponse(), after the request
                # bytes went out, so a retry can re-execute a POST the
                # server already ran — every endpoint must therefore
                # stay idempotent (the server's documented contract).
                self._discard_conn()
                if deadline is not None and time.monotonic() >= deadline:
                    # the read was already capped to the remaining
                    # budget, so a timeout here IS the deadline expiring
                    raise errors.DeadlineExceeded(
                        f"deadline_s={deadline_s:g} expired during "
                        f"attempt {attempt + 1} ({type(e).__name__})"
                    ) from e
                last_exc = e
                attempt = self._backoff_or_raise(attempt, e, None,
                                                 deadline)
                continue
            _observe_attempt("http", trace_id, ta, status=status)
            if status == 401:
                raise errors.Unauthorized(self._remote_message(data))
            if status in (429, 503):
                ra = _parse_retry_after(retry_after)
                cls = errors.RateLimited if status == 429 \
                    else errors.ServerOverloaded
                e = cls(self._remote_message(data),
                        retry_after_s=0.05 if ra is None else ra)
                last_exc = e
                attempt = self._backoff_or_raise(attempt, e, ra, deadline)
                continue
            if raw and status < 400:
                return data
            try:
                codec.raise_if_error(data)    # CRC-verifies the envelope
            except codec.WireFormatError as e:
                # reply corrupted in transit (bit flip caught by the
                # codec checksum, or a garbled envelope): the request
                # itself succeeded server-side, so re-asking is safe
                self._discard_conn()
                last_exc = e
                attempt = self._backoff_or_raise(attempt, e, None,
                                                 deadline)
                continue
            return data

    def _backoff_or_raise(self, attempt: int, exc: BaseException,
                          retry_after: Optional[float],
                          deadline: Optional[float]) -> int:
        """Sleep the backoff for ``attempt`` and return ``attempt + 1``,
        or raise ``exc`` when retries/deadline budget are exhausted."""
        if attempt >= self.max_retries:
            raise exc
        delay = min(self.backoff_cap_s,
                    self.backoff_base_s * (2.0 ** attempt))
        delay *= 0.5 + self._rng.random() * 0.5       # full-ish jitter
        if retry_after is not None:
            delay = max(delay, retry_after)
        if deadline is not None:
            remaining = deadline - time.monotonic()
            if remaining <= delay:
                raise errors.DeadlineExceeded(
                    f"deadline would expire during the {delay:.3f}s "
                    f"backoff before retry {attempt + 1}") from exc
        _M_RETRIES.inc()
        _M_BACKOFF_S.inc(delay)
        time.sleep(delay)
        return attempt + 1

    @staticmethod
    def _remote_message(data: bytes) -> str:
        """Best-effort text of an ERROR reply body."""
        try:
            codec.raise_if_error(data)
        except codec.RemoteError as e:
            return str(e)
        except codec.WireFormatError:
            pass
        return "(no server detail)"

    # ---------------------------------------------------- binary transport
    def _binary_target(self, deadline_s: Optional[float] = None
                       ) -> Optional[Tuple[str, int]]:
        """The binary address to use, or ``None`` for HTTP.  Resolved
        once: an explicit ``binary_port`` wins; otherwise ``auto`` and
        ``binary`` probe ``/v1/health`` for the advertised port.
        ``transport="binary"`` raises if the server offers none.
        ``deadline_s`` bounds the one-time probe so a stalled server
        can't eat more than the caller's budget before the caller's own
        attempt (which is charged for the probe's time) even starts."""
        if self.transport == "http" or self._bin_disabled:
            return None
        with self._bin_lock:
            if self._bin_resolved:
                return self._bin_target
            if self._binary_port is not None:
                self._bin_target = (self.host, int(self._binary_port))
                self._bin_resolved = True
                return self._bin_target
            try:
                port = codec.decode_json(self._request(
                    "GET", "/v1/health",
                    deadline_s=deadline_s)).get("binary_port")
            except Exception:                # noqa: BLE001
                if self.transport == "binary":
                    raise
                # can't probe — leave unresolved so the sweep's own HTTP
                # attempt surfaces the real connectivity error
                return None
            if port is None and self.transport == "binary":
                raise RuntimeError(
                    f"transport='binary' but the server at {self.host}:"
                    f"{self.port} advertises no binary port")
            self._bin_target = (self.host, int(port)) if port else None
            self._bin_resolved = True
            return self._bin_target

    def _bconn(self, remaining: Optional[float]) -> socket.socket:
        """The calling thread's persistent binary socket (breaker-gated
        connect on first use, like the HTTP path)."""
        sock = getattr(self._local, "bsock", None)
        if sock is None:
            self._breaker.admit()
            connect_t = self.connect_timeout
            if remaining is not None:
                connect_t = min(connect_t, max(1e-3, remaining))
            try:
                sock = socket.create_connection(self._bin_target,
                                                timeout=connect_t)
            except OSError:
                self._breaker.failure()
                raise
            self._breaker.success()
            # one sendall per frame + NODELAY: no Nagle/delayed-ACK
            # stall (the HTTP path's split writes pay ~40 ms here)
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._local.bsock = sock
            self._local.bparser = FrameParser()
            self._local.bgot: Dict[int, object] = {}
            self._local.bnext_id = 0
        with self._conns_lock:
            self._conns.add(sock)
        return sock

    def _discard_bconn(self) -> None:
        """Drop the calling thread's binary socket.  Any replies still
        in flight on it are lost — the retry loop re-sends under fresh
        ids, so nothing can demux onto a stale request."""
        sock = getattr(self._local, "bsock", None)
        if sock is not None:
            with self._conns_lock:
                self._conns.discard(sock)
            try:
                sock.close()
            finally:
                self._local.bsock = None
                self._local.bparser = None
                self._local.bgot = {}

    def _read_frame_into(self, expected: set) -> None:
        """Read from the thread's binary socket until at least one more
        frame lands in ``self._local.bgot``.  A reply id outside
        ``expected`` means the stream can no longer be trusted."""
        st = self._local
        before = len(st.bgot)
        while len(st.bgot) == before:
            data = st.bsock.recv(1 << 18)
            if not data:
                raise ConnectionError(
                    "server closed the binary connection")
            st.bparser.feed(data)
            for frame in st.bparser.frames():
                if frame.req_id not in expected:
                    raise codec.WireFormatError(
                        f"reply for unknown request id {frame.req_id} — "
                        f"stream desynchronized")
                st.bgot[frame.req_id] = frame

    def _rebuild_fault(self, payload: bytes) -> BaseException:
        """Typed exception from an error frame's payload (parity with
        the HTTP status mapping + ``raise_if_error`` message shape)."""
        name, message, retry_after = codec.decode_error(payload)
        cls = _FAULT_BY_NAME.get(name)
        if cls is None:
            return codec.RemoteError(f"{name}: {message}")
        if name in ("RateLimited", "ServerOverloaded"):
            return cls(message, retry_after_s=(0.05 if retry_after is None
                                               else retry_after))
        return cls(message)

    def _request_binary_many(self, bodies: List[bytes], *,
                             deadline_s: Optional[float] = None,
                             trace_ids: Optional[List[Optional[str]]] = None
                             ) -> List[bytes]:
        """Pipelined sweep round-trips: every outstanding request goes
        out in ONE write burst, replies demux by id in any order.  Same
        budget rules as ``_request``: one deadline computed at entry,
        retries/backoff/breaker shared with HTTP.  ``trace_ids`` aligns
        with ``bodies`` (per-request attempt spans/exemplars)."""
        deadline = None if deadline_s is None \
            else time.monotonic() + float(deadline_s)
        results: List[Optional[bytes]] = [None] * len(bodies)
        outstanding = list(range(len(bodies)))
        last_exc: Optional[BaseException] = None
        attempt = 0
        while outstanding:
            remaining = None
            if deadline is not None:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise errors.DeadlineExceeded(
                        f"deadline_s={deadline_s:g} spent after "
                        f"{attempt} attempt(s), "
                        f"{len(outstanding)} reply(ies) outstanding"
                    ) from last_exc
            ta = time.monotonic()
            try:
                outstanding, retry_after, fault = self._bin_round(
                    bodies, outstanding, results, remaining, trace_ids)
            except (OSError, ConnectionError) as e:
                _observe_attempt(
                    "binary",
                    trace_ids[outstanding[0]] if trace_ids else None,
                    ta, error=e)
                self._discard_bconn()
                if deadline is not None and time.monotonic() >= deadline:
                    raise errors.DeadlineExceeded(
                        f"deadline_s={deadline_s:g} expired during "
                        f"attempt {attempt + 1} ({type(e).__name__})"
                    ) from e
                last_exc = e
                attempt = self._backoff_or_raise(attempt, e, None,
                                                 deadline)
                continue
            except codec.WireFormatError as e:
                # reply corrupted or stream desynced: the socket's frame
                # offsets are unusable — rebuild and re-ask (idempotent)
                self._discard_bconn()
                last_exc = e
                attempt = self._backoff_or_raise(attempt, e, None,
                                                 deadline)
                continue
            if outstanding:
                # only retryable in-band faults (overload shed, rate
                # limit) remain — back off like HTTP's 429/503 handling
                last_exc = fault
                attempt = self._backoff_or_raise(attempt, fault,
                                                 retry_after, deadline)
        return results                       # type: ignore[return-value]

    def _bin_round(self, bodies, outstanding, results, remaining,
                   trace_ids=None):
        """One pipelined attempt over the current socket.  Returns
        ``(still_outstanding, retry_after, fault)``; raises transport /
        wire errors for the caller's retry loop."""
        t0 = time.monotonic()
        sock = self._bconn(remaining)
        st = self._local
        read_t = self.timeout
        if remaining is not None:
            read_t = min(read_t, max(1e-3, remaining))
        sock.settimeout(read_t)
        ids = {}
        burst = bytearray()
        for idx in outstanding:
            req_id = st.bnext_id
            st.bnext_id += 1
            ids[req_id] = idx
            burst += pack_frame(OP_SWEEP, req_id, bodies[idx],
                                deadline_s=remaining or 0.0)
        sock.sendall(burst)
        expected = set(ids)
        still, retry_after, fault = [], None, None
        pending = set(ids)
        while pending:
            self._read_frame_into(expected)
            for req_id in list(pending):
                frame = st.bgot.pop(req_id, None)
                if frame is None:
                    continue
                pending.discard(req_id)
                idx = ids[req_id]
                tid = trace_ids[idx] if trace_ids else None
                if frame.flags & FLAG_ERROR:
                    exc = self._rebuild_fault(frame.payload)
                    _observe_attempt("binary", tid, t0, error=exc)
                    if type(exc).__name__ in _RETRYABLE_NAMES:
                        still.append(idx)
                        ra = getattr(exc, "retry_after_s", None)
                        if ra is not None:
                            retry_after = ra if retry_after is None \
                                else max(retry_after, ra)
                        fault = exc
                        continue
                    raise exc
                try:
                    codec.raise_if_error(frame.payload)  # CRC check
                except codec.RemoteError:
                    # an ERROR payload without FLAG_ERROR: the frame
                    # header and payload disagree (header bit flip) —
                    # trust neither
                    raise codec.WireFormatError(
                        "error payload in a success-flagged frame — "
                        "frame header untrustworthy") from None
                _observe_attempt("binary", tid, t0, status=200)
                results[idx] = frame.payload
        still.sort()
        return still, retry_after, fault

    def _request_binary(self, body: bytes, *,
                        deadline_s: Optional[float] = None) -> bytes:
        return self._request_binary_many([body],
                                         deadline_s=deadline_s)[0]

    def _simple_binary(self, op: int, *,
                       deadline_s: Optional[float] = None) -> bytes:
        """Health/stats over the binary transport (no retry loop
        subtleties needed beyond the shared one: reuse the sweep path's
        machinery with an empty payload)."""
        deadline = None if deadline_s is None \
            else time.monotonic() + float(deadline_s)
        last_exc: Optional[BaseException] = None
        attempt = 0
        while True:
            remaining = None
            if deadline is not None:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise errors.DeadlineExceeded(
                        f"deadline_s={deadline_s:g} spent after "
                        f"{attempt} attempt(s)") from last_exc
            try:
                sock = self._bconn(remaining)
                st = self._local
                read_t = self.timeout
                if remaining is not None:
                    read_t = min(read_t, max(1e-3, remaining))
                sock.settimeout(read_t)
                req_id = st.bnext_id
                st.bnext_id += 1
                sock.sendall(pack_frame(op, req_id, b"",
                                        deadline_s=remaining or 0.0))
                self._read_frame_into({req_id})
                frame = st.bgot.pop(req_id)
                if frame.flags & FLAG_ERROR:
                    raise self._rebuild_fault(frame.payload)
                return frame.payload
            except (OSError, ConnectionError, codec.WireFormatError) as e:
                self._discard_bconn()
                last_exc = e
                attempt = self._backoff_or_raise(attempt, e, None,
                                                 deadline)

    def close(self) -> None:
        """Close every thread's persistent connection (the per-thread
        sockets a shared client accumulates), not just the caller's.
        Does not touch in-flight call deadlines — those were computed at
        call entry and keep counting."""
        self._discard_conn()
        with self._conns_lock:
            conns, self._conns = list(self._conns), set()
        for conn in conns:
            try:
                conn.close()
            except Exception:       # noqa: BLE001 — best-effort teardown
                pass

    def __enter__(self) -> "PredictionClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------- queries
    def health(self, *, deadline_s: Optional[float] = None) -> dict:
        if self.transport == "binary" and self._binary_target(deadline_s):
            return codec.decode_json(self._simple_binary(
                OP_HEALTH, deadline_s=deadline_s))
        return codec.decode_json(
            self._request("GET", "/v1/health", deadline_s=deadline_s))

    def cache_stats(self, *, deadline_s: Optional[float] = None) -> dict:
        """One stats schema regardless of transport: the binary
        ``OP_CACHE_STATS`` frame and ``GET /v1/cache_stats`` return the
        identical document (engine cache + coalescer dedup/shed/
        isolation counters + binary frontend counters)."""
        if self.transport == "binary" and self._binary_target(deadline_s):
            return codec.decode_json(self._simple_binary(
                OP_CACHE_STATS, deadline_s=deadline_s))
        return codec.decode_json(
            self._request("GET", "/v1/cache_stats",
                          deadline_s=deadline_s))

    def clear_cache(self, *, deadline_s: Optional[float] = None) -> dict:
        return codec.decode_json(
            self._request("POST", "/v1/clear_cache", b"",
                          deadline_s=deadline_s))

    def metrics_text(self, *, deadline_s: Optional[float] = None) -> str:
        """The server's Prometheus text exposition — the same snapshot
        whether fetched as raw ``GET /v1/metrics`` or a binary
        ``OP_METRICS`` frame (the frame wraps the identical text in a
        JSON codec message)."""
        if self.transport == "binary" and self._binary_target(deadline_s):
            return codec.decode_json(self._simple_binary(
                OP_METRICS, deadline_s=deadline_s))
        return self._request("GET", "/v1/metrics", deadline_s=deadline_s,
                             raw=True).decode("utf-8")

    def _sweep(self, op: str, source, hw: str,
               deadline_s: Optional[float],
               trace_id: Optional[str] = None, **kw) -> bytes:
        if trace_id is None:
            trace_id = trace.new_trace_id()
        body = codec.encode_request(op, source, hw=hw,
                                    trace_id=trace_id, **kw)
        t0 = time.monotonic()
        if self._binary_target(deadline_s) is not None:
            try:
                return self._request_binary_many(
                    [body], deadline_s=deadline_s,
                    trace_ids=[trace_id])[0]
            except (OSError, ConnectionError):
                # the binary port is unreachable (stale advertisement,
                # proxy in the way): under auto-negotiation downgrade to
                # HTTP for good rather than paying this again per call
                if self.transport != "auto" or not self._http_fallback:
                    raise
                self._discard_bconn()
                self._bin_disabled = True
        if deadline_s is not None:
            # one budget per call: the probe / failed binary attempt
            # already spent part of it
            deadline_s -= time.monotonic() - t0
        return self._request("POST", f"/v1/{op}", body,
                             deadline_s=deadline_s, trace_id=trace_id)

    def argmin_many(self, tables, hw: str, *,
                    model: Optional[str] = None,
                    coalesce: bool = True,
                    calibration: Optional[str] = None,
                    max_fused_rows: Optional[int] = None,
                    deadline_s: Optional[float] = None,
                    trace_ids: Optional[List[Optional[str]]] = None):
        """Pipelined ``argmin`` over many tables: every request goes out
        in one burst on the thread's binary socket and the coalescer
        fuses (and dedups) them into shared evaluations — the intended
        operating mode of the binary transport.  Falls back to
        sequential HTTP calls when no binary port is available.
        Returns one ``SweepWinner`` per table, in order.  ``trace_ids``
        aligns with ``tables`` (one fresh id per table by default)."""
        tables = list(tables)
        if trace_ids is None:
            trace_ids = [trace.new_trace_id() for _ in tables]
        bodies = [codec.encode_request(
            "argmin", t, hw=hw, model=model, coalesce=coalesce,
            calibration=calibration, max_fused_rows=max_fused_rows,
            trace_id=tid)
            for t, tid in zip(tables, trace_ids)]
        t0 = time.monotonic()
        if self._binary_target(deadline_s) is not None:
            try:
                replies = self._request_binary_many(
                    bodies, deadline_s=deadline_s, trace_ids=trace_ids)
                return [codec.decode_winners(d)[0] for d in replies]
            except (OSError, ConnectionError):
                if self.transport != "auto" or not self._http_fallback:
                    raise
                self._discard_bconn()
                self._bin_disabled = True
        if deadline_s is not None:
            deadline_s = deadline_s - (time.monotonic() - t0)
        return [codec.decode_winners(self._request(
            "POST", "/v1/argmin", b, deadline_s=deadline_s,
            trace_id=tid))[0]
            for b, tid in zip(bodies, trace_ids)]

    def predict_totals(self, source, hw: str, *,
                       model: Optional[str] = None,
                       chunk_size: Optional[int] = None, jobs=None,
                       coalesce: bool = True,
                       calibration: Optional[str] = None,
                       max_fused_rows: Optional[int] = None,
                       deadline_s: Optional[float] = None,
                       trace_id: Optional[str] = None) -> np.ndarray:
        """Every row's total seconds (the ``predict_table(...).totals``
        column, served).  ``calibration`` names a server-side calibration
        (see :meth:`calibrate`) whose multipliers scale the totals.
        ``max_fused_rows`` caps the estimated row-cost of any coalesced
        batch this request joins (a hint — clamped server-side)."""
        data = self._sweep("predict_table", source, hw, deadline_s,
                           trace_id,
                           model=model, chunk_size=chunk_size, jobs=jobs,
                           coalesce=coalesce, calibration=calibration,
                           max_fused_rows=max_fused_rows)
        return codec.decode_totals(data)

    def argmin(self, source, hw: str, *, model: Optional[str] = None,
               chunk_size: Optional[int] = None, jobs=None,
               coalesce: bool = True, calibration: Optional[str] = None,
               max_fused_rows: Optional[int] = None,
               deadline_s: Optional[float] = None,
               trace_id: Optional[str] = None):
        """The cheapest configuration (a ``SweepWinner``)."""
        data = self._sweep("argmin", source, hw, deadline_s, trace_id,
                           model=model,
                           chunk_size=chunk_size, jobs=jobs,
                           coalesce=coalesce, calibration=calibration,
                           max_fused_rows=max_fused_rows)
        return codec.decode_winners(data)[0]

    def topk(self, source, hw: str, k: int, *,
             model: Optional[str] = None,
             chunk_size: Optional[int] = None, jobs=None,
             coalesce: bool = True, calibration: Optional[str] = None,
             max_fused_rows: Optional[int] = None,
             deadline_s: Optional[float] = None,
             trace_id: Optional[str] = None):
        data = self._sweep("topk", source, hw, deadline_s, trace_id,
                           model=model,
                           k=int(k), chunk_size=chunk_size, jobs=jobs,
                           coalesce=coalesce, calibration=calibration,
                           max_fused_rows=max_fused_rows)
        return codec.decode_winners(data)

    def pareto(self, source, hw: str, *,
               objectives: Sequence[str] = ("compute", "memory"),
               model: Optional[str] = None,
               chunk_size: Optional[int] = None, jobs=None,
               coalesce: bool = True, calibration: Optional[str] = None,
               max_fused_rows: Optional[int] = None,
               deadline_s: Optional[float] = None,
               trace_id: Optional[str] = None):
        data = self._sweep("pareto", source, hw, deadline_s, trace_id,
                           model=model,
                           objectives=tuple(objectives),
                           chunk_size=chunk_size, jobs=jobs,
                           coalesce=coalesce, calibration=calibration,
                           max_fused_rows=max_fused_rows)
        return codec.decode_winners(data)

    # ------------------------------------------------- hardware library
    def hardware_list(self, *, deadline_s: Optional[float] = None) -> dict:
        """GET /v1/hardware: {name: summary} directory of the server's
        hardware library."""
        return codec.decode_json(
            self._request("GET", "/v1/hardware", deadline_s=deadline_s))

    def hardware_get(self, name: str, *,
                     deadline_s: Optional[float] = None):
        """GET /v1/hardware/<name> -> ``hwlib.HardwareEntry`` (file-backed
        entries arrive with their provenance/units audit trail)."""
        return codec.decode_hardware(
            self._request("GET", f"/v1/hardware/{name}",
                          deadline_s=deadline_s))

    def hardware_register(self, entry, *, overwrite: bool = False,
                          deadline_s: Optional[float] = None) -> dict:
        """POST /v1/hardware: register a ``HardwareParams`` or
        ``hwlib.HardwareEntry`` server-side.  Collides (HTTP 400) on a
        taken name with different parameters unless ``overwrite``;
        re-posting the identical payload is a no-op success."""
        path = "/v1/hardware?overwrite=1" if overwrite else "/v1/hardware"
        return codec.decode_json(
            self._request("POST", path, codec.encode_hardware(entry),
                          deadline_s=deadline_s))

    def hardware_delete(self, name: str, *,
                        deadline_s: Optional[float] = None) -> dict:
        """DELETE /v1/hardware/<name>: tombstone-delete a registry entry.

        404 (``RemoteError``) on unknown names.  A *retried* DELETE may
        see the 404 its own first attempt caused — treat 404-on-retry as
        success if you need exactly-once semantics."""
        return codec.decode_json(
            self._request("DELETE", f"/v1/hardware/{name}",
                          deadline_s=deadline_s))

    # ---------------------------------------------- calibration-as-data
    def calibrate(self, suite, hw: str, *, mode: str = "class",
                  holdout_fraction: float = 0.3, seed: int = 0,
                  model: Optional[str] = None,
                  register_as: Optional[str] = None,
                  deadline_s: Optional[float] = None):
        """POST /v1/calibrate: upload a measured ``MeasuredSuite``, get
        back ``(Calibration, report)`` fitted against the *server's*
        predictions with train/holdout discipline (paper §IV-D).

        ``register_as`` stores the fit server-side so follow-up sweeps
        can price with it (``calibration=<name>`` on the query methods).
        """
        body = codec.encode_calibrate_request(
            suite, hw=hw, mode=mode, holdout_fraction=holdout_fraction,
            seed=seed, model=model, register_as=register_as)
        return codec.decode_calibration(
            self._request("POST", "/v1/calibrate", body,
                          deadline_s=deadline_s))


def _parse_retry_after(value: Optional[str]) -> Optional[float]:
    if value is None:
        return None
    try:
        return max(0.0, float(value))
    except ValueError:
        return None


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="Query a running prediction server")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8707)
    ap.add_argument("--transport", choices=("auto", "binary", "http"),
                    default="auto",
                    help="auto probes /v1/health for a binary port and "
                         "upgrades sweeps when one is advertised")
    sub = ap.add_subparsers(dest="cmd", required=True)
    sub.add_parser("health")
    sub.add_parser("cache-stats")
    sub.add_parser("metrics",
                   help="dump the server's Prometheus text exposition")
    demo = sub.add_parser(
        "argmin-demo",
        help="price a GEMM tile lattice on the server and print the "
             "winning tile")
    demo.add_argument("--hw", default="b200")
    demo.add_argument("--gemm", default="8192,8192,8192",
                      help="m,n,k")
    demo.add_argument("--precision", default="fp16")
    args = ap.parse_args(argv)

    client = PredictionClient(args.host, args.port,
                              transport=args.transport)
    if args.cmd == "health":
        print(client.health())
    elif args.cmd == "cache-stats":
        print(client.cache_stats())
    elif args.cmd == "metrics":
        print(client.metrics_text(), end="")
    else:
        from ..core.workload import TileConfig, WorkloadTable, gemm_workload
        m, n, k = (int(x) for x in args.gemm.split(","))
        tiles = [TileConfig(bm, bn, bk)
                 for bm in (64, 128, 256) for bn in (64, 128, 256)
                 for bk in (16, 32, 64)]
        table = WorkloadTable.tile_lattice(
            gemm_workload("demo", m, n, k, precision=args.precision),
            tiles)
        win = client.argmin(table, args.hw)
        tile = tiles[win.index]
        print(f"argmin over {len(tiles)} tiles on {args.hw}: "
              f"bm={tile.bm} bn={tile.bn} bk={tile.bk} "
              f"-> {win.total * 1e3:.3f} ms ({win.breakdown.dominant}"
              f"-bound)")


if __name__ == "__main__":
    main()
